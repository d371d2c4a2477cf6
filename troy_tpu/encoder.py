"""BatchEncoder: BFV/BGV SIMD slot encoding.

Semantics-compatible with the reference's batch encoder
(reference: src/batchencoder.h:48, src/batchencoder.cpp:67-241,
src/batchencoder_cuda.cu:27-118): the 2x(N/2) slot matrix maps onto NTT
evaluation points through the bit-reversed 3^i orbit index map, then an
inverse NTT over the plain modulus produces coefficients.

The index map is a host-precomputed gather/scatter table; both
encode and decode are a single device gather plus one NTT.
"""

from __future__ import annotations

from functools import partial

from typing import Sequence, Union

import numpy as np
import jax
import jax.numpy as jnp

from .context import HeContext
from .he_types import Plaintext
from .ops import ntt as dntt
from .utils import numth


class BatchEncoder:
    """(batchencoder.h:48)"""

    def __init__(self, context: HeContext):
        cd = context.first_context_data
        self.context = context
        self.n = cd.n
        self.plain_modulus = int(cd.plain_modulus)
        self._tables = context.plain_ntt
        # SIMD slot encoding needs t = 1 mod 2N; without it only the
        # coefficient-domain encode_polynomial path is available (matching
        # the reference, whose encodePolynomial works for any t —
        # batchencoder_cuda.cuh:65-75)
        self._batching = cd.qualifiers.using_batching
        if not self._batching:
            self._index_map = None
            return

        # matrix_reps_index_map (batchencoder.cpp:67-82): slot i of row 0 sits
        # at eval index brv((3^i - 1)/2); row 1 mirrors through -3^i.
        n = self.n
        log_n = numth.get_power_of_two(n)
        m = 2 * n
        index_map = np.zeros(n, dtype=np.int64)
        pos = 1
        for i in range(n // 2):
            index_map[i] = numth.reverse_bits((pos - 1) >> 1, log_n)
            index_map[n // 2 + i] = numth.reverse_bits((m - pos - 1) >> 1, log_n)
            pos = (pos * 3) % m
        self._index_map = jnp.asarray(index_map)

    @property
    def slot_count(self) -> int:
        return self.n

    def _require_batching(self):
        if not self._batching:
            raise ValueError("SIMD batching requires plain_modulus = 1 "
                             "mod 2N; use encode_polynomial instead")

    def encode(self, values: Union[Sequence[int], np.ndarray]) -> Plaintext:
        """Unsigned slot values (mod t) -> coefficient plaintext.
        One upload (padded values) + one fused scatter+iNTT executable."""
        self._require_batching()
        values = np.asarray(values, dtype=np.uint64)
        if values.ndim != 1 or len(values) > self.n:
            raise ValueError("too many slot values")
        t = self.plain_modulus
        if (values >= t).any():
            values = values % t
        if len(values) < self.n:
            values = np.pad(values, (0, self.n - len(values)))
        coeffs = _encode_core(jnp.asarray(values), self._index_map,
                              self._tables)
        return Plaintext(data=coeffs)

    def encode_signed(self, values: Union[Sequence[int], np.ndarray]) -> Plaintext:
        """Signed slot values, centered mod t."""
        values = np.asarray(values, dtype=np.int64)
        t = self.plain_modulus
        return self.encode((values % t).astype(np.uint64))

    def decode(self, plain: Plaintext) -> np.ndarray:
        """Coefficient plaintext -> unsigned slot values."""
        if plain.is_ntt_form:
            raise ValueError("cannot decode an NTT-form plaintext")
        self._require_batching()
        data = plain.data
        if data.shape[-1] < self.n:
            data = jnp.pad(data, (0, self.n - data.shape[-1]))
        return np.asarray(_decode_core(data, self._index_map, self._tables))

    def decode_signed(self, plain: Plaintext) -> np.ndarray:
        vals = self.decode(plain).astype(np.int64)
        t = self.plain_modulus
        return np.where(vals >= (t + 1) // 2, vals - t, vals)

    # ---- troy extension: raw coefficient (non-SIMD) encoding
    # (batchencoder_cuda.cuh:65-75 encodePolynomial) ----
    def encode_polynomial(self, values: Union[Sequence[int], np.ndarray]) -> Plaintext:
        values = np.asarray(values, dtype=np.uint64) % self.plain_modulus
        if len(values) > self.n:
            raise ValueError("too many coefficients")
        data = np.zeros(self.n, dtype=np.uint64)
        data[:len(values)] = values
        return Plaintext(data=jnp.asarray(data))

    def decode_polynomial(self, plain: Plaintext, count: int = None) -> np.ndarray:
        out = np.asarray(plain.data)
        return out if count is None else out[:count]


@jax.jit
def _encode_core(values: jnp.ndarray, index_map: jnp.ndarray,
                 tables) -> Plaintext:
    """Fused slot scatter + inverse plain-NTT
    (batchencoder_cuda.cu:42-73 equivalent, one executable)."""
    evals = jnp.zeros(values.shape[0], dtype=jnp.uint64)
    evals = evals.at[index_map].set(values)
    return dntt.ntt_inverse(evals, tables)


@jax.jit
def _decode_core(data: jnp.ndarray, index_map: jnp.ndarray,
                 tables) -> jnp.ndarray:
    """Fused plain-NTT + slot gather (batchencoder_cuda.cu:75-118)."""
    evals = dntt.ntt_forward(data, tables)
    return jnp.take(evals, index_map)
