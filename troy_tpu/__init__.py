"""troy_tpu — a homomorphic encryption framework in JAX.

A from-scratch JAX/XLA implementation of the BFV, BGV and CKKS RLWE
schemes with Microsoft-SEAL-compatible semantics (capability reference:
lightbulb128/troy). Ciphertexts, plaintexts and keys are pytrees of uint64
device arrays; every modulus and precomputed Barrett/Shoup constant is baked
statically into the traced computation.
"""

import jax as _jax

# The whole framework computes on uint64 arrays. This must be set before any
# array is created, hence at package import.
_jax.config.update("jax_enable_x64", True)

from .modulus import (  # noqa: E402
    Modulus, CoeffModulus, PlainModulus, SecurityLevel,
)
from .params import (  # noqa: E402
    EncryptionParameters, SchemeType, ParmsID, PARMS_ID_ZERO,
)
from .context import HeContext, ContextData  # noqa: E402
from .he_types import (  # noqa: E402
    Plaintext, Ciphertext, SecretKey, PublicKey,
    KSwitchKeys, RelinKeys, GaloisKeys,
)
from .keygen import KeyGenerator  # noqa: E402
from .encryptor import Encryptor  # noqa: E402
from .decryptor import Decryptor  # noqa: E402
from .encoder import BatchEncoder  # noqa: E402
from .ckks import CKKSEncoder  # noqa: E402
from .evaluator import Evaluator  # noqa: E402
from . import valcheck  # noqa: E402
from .hexpoly import (  # noqa: E402
    poly_to_hex_string, hex_string_to_poly,
    plaintext_to_string, plaintext_from_string,
)

__version__ = "0.1.0"

__all__ = [
    "Modulus", "CoeffModulus", "PlainModulus", "SecurityLevel",
    "EncryptionParameters", "SchemeType", "ParmsID",
    "HeContext", "ContextData",
    "Plaintext", "Ciphertext", "SecretKey", "PublicKey",
    "KSwitchKeys", "RelinKeys", "GaloisKeys",
    "KeyGenerator", "Encryptor", "Decryptor", "BatchEncoder", "CKKSEncoder",
    "Evaluator", "valcheck",
    "poly_to_hex_string", "hex_string_to_poly",
    "plaintext_to_string", "plaintext_from_string",
]
