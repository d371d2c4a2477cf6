"""HE object model: plaintexts, ciphertexts, and keys as JAX pytrees.

Semantics-compatible with the reference's containers
(reference: src/plaintext.h:51-720, src/ciphertext.h:52-696 /
src/ciphertext_cuda.cuh:12-310, src/secretkey.h:31, src/publickey.h:26,
src/kswitchkeys.h:34, src/relinkeys.h:46, src/galoiskeys.h:36).

Data lives in uint64 device arrays —
``Ciphertext.data`` is (size, limbs, n); metadata (chain level, NTT flag,
CKKS scale, BGV correction factor) is static, so the jit trace of every
evaluator op specializes to it. Key-switching keys are stored *densely* as a
single (decomp, 2, key_limbs, n) array per key — the layout the
key-switch contraction consumes directly, instead of the reference's
vector-of-vector-of-PublicKey (kswitchkeys.h:34).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax.numpy as jnp
from .utils import struct


class Plaintext(struct.PyTreeNode):
    """A plaintext polynomial (plaintext.h:51).

    Two representations, as in the reference:
      * mod-t coefficient form (BFV/BGV): data (n,), level None;
      * mod-q NTT form (CKKS, or NTT-transformed BFV plain): data (limbs, n),
        level = chain index it was encoded at.
    """

    data: jnp.ndarray
    level: Optional[int] = struct.field(pytree_node=False, default=None)
    is_ntt_form: bool = struct.field(pytree_node=False, default=False)
    scale: float = struct.field(pytree_node=False, default=1.0)

    @property
    def coeff_count(self) -> int:
        return self.data.shape[-1]


class Ciphertext(struct.PyTreeNode):
    """An RLWE ciphertext: ``data[j]`` is the j-th polynomial, RNS limb-major
    (ciphertext.h:52; device twin ciphertext_cuda.cuh:12-215).

    seed: 64-bit regeneration seed for symmetric ciphertexts whose c1 is
    XOF-expandable (ciphertext_cuda.cu:27-41); 0 means "not compressible".
    Any evaluator op that rewrites c1 resets it.
    """

    data: jnp.ndarray                 # (size, limbs, n) uint64
    level: int = struct.field(pytree_node=False, default=1)
    is_ntt_form: bool = struct.field(pytree_node=False, default=False)
    scale: float = struct.field(pytree_node=False, default=1.0)
    correction_factor: int = struct.field(pytree_node=False, default=1)
    seed: int = struct.field(pytree_node=False, default=0)

    @property
    def size(self) -> int:
        return self.data.shape[0]

    @property
    def limbs(self) -> int:
        return self.data.shape[1]

    @property
    def n(self) -> int:
        return self.data.shape[2]


class LWECiphertext(struct.PyTreeNode):
    """An extracted LWE sample per RNS limb (troy extension;
    ciphertext_cuda.cuh:270-310): decrypts to <c1, s-coeffs> + c0."""

    c1: jnp.ndarray                   # (limbs, n)
    c0: jnp.ndarray                   # (limbs,)
    level: int = struct.field(pytree_node=False, default=1)
    scale: float = struct.field(pytree_node=False, default=1.0)
    correction_factor: int = struct.field(pytree_node=False, default=1)


class SecretKey(struct.PyTreeNode):
    """Secret key: NTT form over the full (key level) modulus
    (secretkey.h:31). data: (key_limbs, n)."""

    data: jnp.ndarray

    @property
    def limbs(self) -> int:
        return self.data.shape[0]


class PublicKey(struct.PyTreeNode):
    """Public key = encryption of zero at the key level, NTT form
    (publickey.h:26). data: (2, key_limbs, n)."""

    data: jnp.ndarray
    seed: int = struct.field(pytree_node=False, default=0)

    @property
    def as_ciphertext(self) -> Ciphertext:
        return Ciphertext(data=self.data, level=0, is_ntt_form=True)


class KSwitchKeys(struct.PyTreeNode):
    """Generic key-switching keys (kswitchkeys.h:34) in a dense layout.

    keys maps a key index (power of s for relin, Galois element for
    rotation) to an array of shape (decomp, 2, key_limbs, n):
      keys[idx][j, c] = c-th component of the j-th decomposition ciphertext,
      over the full key-level base, NTT form.
    """

    keys: Dict[int, jnp.ndarray]

    def has_key(self, idx: int) -> bool:
        return idx in self.keys


class RelinKeys(KSwitchKeys):
    """Relinearization keys: keys[p] switches s^p -> s for p >= 2
    (relinkeys.h:46; index convention p-2 in the reference, here the power
    itself)."""


class GaloisKeys(KSwitchKeys):
    """Galois keys: keys[elt] switches s(x^elt) -> s (galoiskeys.h:36)."""
