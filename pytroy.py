"""Drop-in alias for the reference's ``pytroy`` pybind11 module
(reference: binder/binder.cu PYBIND11_MODULE(pytroy)).

``import pytroy`` from the repo root gives reference users the exact
binder API, backed by troy_tpu."""

from troy_tpu.compat import *  # noqa: F401,F403
from troy_tpu.compat import (  # noqa: F401
    initialize_kernel, SchemeType, SecurityLevel, Modulus, CoeffModulus,
    PlainModulus, EncryptionParameters, SEALContext, ContextData,
    Plaintext, Ciphertext, LWECiphertext, SecretKey, PublicKey,
    KSwitchKeys, RelinKeys, GaloisKeys, KeyGenerator, BatchEncoder,
    CKKSEncoder, Encryptor, Decryptor, Evaluator,
    Plain2d, Cipher2d, MatmulHelper, Conv2dHelper,
)
