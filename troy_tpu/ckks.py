"""CKKSEncoder: canonical-embedding encoding of complex vectors.

Semantics-compatible with the reference's CKKS encoder
(reference: src/ckks.h:97, src/ckks.cpp:91-579 and the GPU complex-FFT
path src/ckks_cuda.cu:103-454): N/2 complex slots map onto the odd powers
of the 2N-th root of unity through the 3^i orbit (so slot rotations are the
same Galois automorphisms the batch encoder uses), conjugate symmetry makes
the inverse embedding real, and coefficients are scaled, rounded exactly,
and decomposed into RNS.

The DEFAULT path runs on the device (ops/embedding.py): the canonical
embedding is a complex128 FFT (the reference's double FFT), rounding to
RNS is exact at any magnitude via radix-2^32 chunk extraction, and
decode's CRT composition is multiword-exact. A host numpy path
(``host=True``) is kept as the independent oracle; the two agree to the
last rounded bit on every pinned vector (tests/test_ckks_device_encoder.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from .context import HeContext, ContextData
from .he_types import Plaintext
from .params import SchemeType
from .ops import ntt as dntt
from .ops import embedding as emb
from .utils import numth


def _round_to_rns(coeffs: np.ndarray, cd: ContextData) -> np.ndarray:
    """Host oracle: round scaled float coefficients and decompose into RNS.

    Vectorized int64 fast path for |c| < 2^62 (float64 is exact there up to
    its 53-bit mantissa, matching the reference's double rounding,
    ckks_cuda.cu:211-302); exact Python-int fallback for coefficients
    beyond 64 bits (scale * value can approach Q/2)."""
    n = coeffs.shape[0]
    rns = np.zeros((cd.limbs, n), dtype=np.uint64)
    if np.max(np.abs(coeffs), initial=0.0) < 2.0 ** 62:
        ints = np.rint(coeffs).astype(np.int64)
        for i, q in enumerate(cd.coeff_values):
            rns[i] = (ints % np.int64(q)).astype(np.uint64)
        return rns
    exact = [int(round(float(c))) for c in coeffs]
    for i, q in enumerate(cd.coeff_values):
        rns[i] = np.array([c % q for c in exact], dtype=np.uint64)
    return rns


@dataclass
class EncodeStats:
    """Device-computed encode statistics (reference: src/ckks_cuda.cu:178-209
    gMaxReal, consumed at :386-407 for the exact magnitude check).

    ``max_abs`` is a DEVICE f64 scalar, max |round(c)| over the scaled
    coefficients; the properties below read it back to the host."""

    max_abs: object            # device f64 scalar

    @property
    def max_coeff_bit_count(self) -> int:
        """ceil(log2(max|coeff|)) + 1, the reference's validity measure
        (ckks_cuda.cu:404 max_coeff_bit_count)."""
        m = float(np.asarray(self.max_abs))
        return (math.ceil(math.log2(m)) if m > 1.0 else 0) + 1

    @property
    def max_coeff_log2(self) -> float:
        m = float(np.asarray(self.max_abs))
        return math.log2(m) if m > 0 else 0.0


class CKKSEncoder:
    """(ckks.h:97; device kernels: ckks_cuda.cu:103-454 equivalents)"""

    def __init__(self, context: HeContext, host: bool = False):
        if context.scheme != SchemeType.ckks:
            raise ValueError("CKKSEncoder requires a CKKS context")
        self.context = context
        self.n = context.n
        self.slots = self.n // 2
        self.host = host

        # slot i <-> evaluation point zeta^(3^i): natural index j = (3^i-1)/2
        # (ckks.cpp matrix_reps_index_map analogue, natural-order variant)
        n = self.n
        m = 2 * n
        idx = np.zeros(self.slots, dtype=np.int64)
        pos = 1
        for i in range(self.slots):
            idx[i] = (pos - 1) >> 1
            pos = (pos * 3) % m
        self._slot_index = idx
        # zeta^k twist factors: evaluation at odd powers via length-n FFT
        k = np.arange(n)
        self._twist = np.exp(1j * np.pi * k / n)        # zeta^k
        self._untwist = np.exp(-1j * np.pi * k / n)
        self._emb = None if host else emb.make_embed_tables(n)

    @property
    def slot_count(self) -> int:
        return self.slots

    def _round_tables(self, cd: ContextData) -> "emb.RnsRoundTables":
        return emb.make_rns_round_tables(tuple(cd.coeff_values))

    # ---- encode (ckks.cpp encode_internal; device: encode_pipeline) ----
    def encode(self, values: Union[Sequence[complex], np.ndarray],
               scale: float, level: Optional[int] = None) -> Plaintext:
        ctx = self.context
        if level is None:
            level = ctx.first_level
        cd = ctx.get_context_data(level)
        values = np.asarray(values, dtype=np.complex128)
        if values.ndim != 1 or len(values) > self.slots:
            raise ValueError("too many slot values")
        if self.host:
            return self._encode_host(values, scale, level, cd)
        # conservative magnitude gate without a device readback:
        # |coeffs| <= scale * max|values| (|FFT(V)/n| <= max|V|)
        bound = float(scale) * float(np.max(np.abs(values), initial=0.0))
        if 2 * bound >= cd.total_coeff_modulus:
            # the conservative bound can overestimate by up to the crest
            # factor of the embedding; fall back to the reference's EXACT
            # device check (ckks_cuda.cu:386-407 gMaxReal path), which
            # reads the statistic back: only borderline encodes pay it.
            plain, stats = self.encode_with_stats(values, scale, level)
            if stats.max_coeff_bit_count >= cd.total_coeff_modulus.bit_length():
                raise ValueError("encoded values are too large for the "
                                 "coefficient modulus at this level")
            return plain
        return self._encode_on_device(jnp.asarray(values), scale, level, cd)

    def _encode_on_device(self, values, scale: float, level: int,
                          cd: ContextData) -> Plaintext:
        data = emb.encode_pipeline(
            values, jnp.asarray(scale, dtype=jnp.float64),
            self._emb, self._round_tables(cd), cd.ntt)
        return Plaintext(data=data, level=level, is_ntt_form=True,
                         scale=scale)

    def encode_device(self, values_re, values_im, scale: float,
                      max_abs: float, level: Optional[int] = None
                      ) -> Plaintext:
        """Device-resident encode: slot values already ON DEVICE as f64
        (re, im) arrays, so a timed window holds no host upload
        (counterpart of decode_device). ``max_abs`` is a host-known bound
        on max |values|, so the magnitude check needs no readback.
        Raises if the conservative bound scale*max_abs cannot fit."""
        ctx = self.context
        if level is None:
            level = ctx.first_level
        cd = ctx.get_context_data(level)
        if self.host:
            raise ValueError("encode_device requires the device encoder")
        if 2 * float(scale) * float(max_abs) >= cd.total_coeff_modulus:
            raise ValueError("encoded values are too large for the "
                             "coefficient modulus at this level")
        return self._encode_on_device(jax.lax.complex(values_re, values_im),
                                      scale, level, cd)

    def encode_with_stats(self, values: Union[Sequence[complex], np.ndarray],
                          scale: float, level: Optional[int] = None
                          ) -> Tuple[Plaintext, EncodeStats]:
        """Device encode plus the max-|coefficient| statistic the
        reference computes with gMaxReal (ckks_cuda.cu:178-209, :386-407).
        The statistic stays a device scalar; materializing it (via the
        EncodeStats properties) is a readback."""
        ctx = self.context
        if level is None:
            level = ctx.first_level
        cd = ctx.get_context_data(level)
        values = np.asarray(values, dtype=np.complex128)
        if values.ndim != 1 or len(values) > self.slots:
            raise ValueError("too many slot values")
        if self.host:
            plain = self._encode_host(values, scale, level, cd)
            coeffs = self._compose_centered(plain)
            return plain, EncodeStats(
                max_abs=np.float64(np.max(np.abs(coeffs), initial=0.0)))
        data, max_abs = emb.encode_stats_pipeline(
            jnp.asarray(values), jnp.asarray(scale, dtype=jnp.float64),
            self._emb, self._round_tables(cd), cd.ntt)
        plain = Plaintext(data=data, level=level, is_ntt_form=True,
                          scale=scale)
        return plain, EncodeStats(max_abs=max_abs)

    def _encode_host(self, values, scale, level, cd) -> Plaintext:
        n = self.n
        # scatter into conjugate-symmetric evaluation vector
        V = np.zeros(n, dtype=np.complex128)
        j = self._slot_index[:len(values)]
        V[j] = values
        V[n - 1 - j] = np.conj(values)

        # invert the embedding: coeffs = untwist(FFT(V)/n)
        u = np.fft.fft(V) / n
        coeffs = (u * self._untwist).real * scale

        if (2 * float(np.max(np.abs(coeffs), initial=0.0))
                >= cd.total_coeff_modulus):
            raise ValueError("encoded values are too large for the "
                             "coefficient modulus at this level")

        rns = _round_to_rns(coeffs, cd)
        data = dntt.rns_ntt_forward(jnp.asarray(rns), cd.ntt)
        return Plaintext(data=data, level=level, is_ntt_form=True,
                         scale=scale)

    def encode_constant(self, value: Union[float, complex], scale: float,
                        level: Optional[int] = None) -> Plaintext:
        """Encode one number into every slot — a constant polynomial
        (ckks_cuda.cu:636,749 double/int64 constant encodes)."""
        if isinstance(value, complex) and value.imag != 0:
            return self.encode(np.full(self.slots, value), scale, level)
        ctx = self.context
        if level is None:
            level = ctx.first_level
        cd = ctx.get_context_data(level)
        v = int(round(float(value) * scale))
        if 2 * abs(v) >= cd.total_coeff_modulus:
            raise ValueError("value too large")
        rns = np.zeros((cd.limbs, self.n), dtype=np.uint64)
        for i, q in enumerate(cd.coeff_values):
            rns[i, 0] = v % q
        # a constant is NTT-invariant only in value; transform properly
        data = dntt.rns_ntt_forward(jnp.asarray(rns), cd.ntt)
        return Plaintext(data=data, level=level, is_ntt_form=True,
                         scale=scale)

    def encode_int64(self, value: int,
                     level: Optional[int] = None) -> Plaintext:
        """Integer constant at scale 1 (exact; ckks.cpp int64 encode)."""
        return self.encode_constant(float(value), 1.0, level)

    # ---- troy extension: raw real coefficients (ckks_cuda.cu:455) ----
    def encode_polynomial(self, coeffs: Union[Sequence[float], np.ndarray],
                          scale: float,
                          level: Optional[int] = None) -> Plaintext:
        ctx = self.context
        if level is None:
            level = ctx.first_level
        cd = ctx.get_context_data(level)
        coeffs = np.asarray(coeffs, dtype=np.float64)
        if len(coeffs) > self.n:
            raise ValueError("too many coefficients")
        scaled = np.zeros(self.n, dtype=np.float64)
        scaled[:len(coeffs)] = coeffs
        if self.host:
            rns = _round_to_rns(scaled * scale, cd)
            data = dntt.rns_ntt_forward(jnp.asarray(rns), cd.ntt)
        else:
            data = emb.encode_polynomial_pipeline(
                jnp.asarray(scaled), jnp.asarray(scale, dtype=jnp.float64),
                self._round_tables(cd), cd.ntt)
        return Plaintext(data=data, level=level, is_ntt_form=True,
                         scale=scale)

    # ---- decode (ckks.cpp decode_internal; device: decode_pipeline) ----
    def _compose_centered(self, plain: Plaintext) -> np.ndarray:
        """RNS -> centered big-int coefficients (host CRT compose oracle)."""
        cd = self.context.get_context_data(plain.level)
        coeffs_rns = np.asarray(dntt.rns_ntt_inverse(plain.data, cd.ntt))
        base = cd.rns_tool.base_q
        Q = cd.total_coeff_modulus
        k = cd.limbs
        from . import native
        if native.available():
            w = (Q.bit_length() + 63) // 64
            words = lambda v: [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                               for i in range(w)]
            invp = [base.inv_punctured(i) for i in range(k)]
            out = native.crt_compose_centered_double(
                coeffs_rns, list(base.values), invp,
                [(x << 64) // q for x, q in zip(invp, base.values)],
                np.array([words(base.punctured_prod(i)) for i in range(k)],
                         dtype=np.uint64),
                np.array(words(Q), dtype=np.uint64), 1.0)
            if out is not None:
                return out
        half = Q // 2
        acc = np.zeros(self.n, dtype=object)
        for i in range(k):
            qi, inv, pp = base.values[i], base.inv_punctured(i), \
                base.punctured_prod(i)
            acc += coeffs_rns[i].astype(object) * inv % qi * pp
        acc %= Q
        acc = np.where(acc > half, acc - Q, acc)
        return acc.astype(np.float64)

    def decode_device(self, plain: Plaintext):
        """Device-resident decode: returns (re, im) f64 DEVICE arrays of
        slot values — the perf-surface entry (no host readback; use
        np.asarray on the results to materialize)."""
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("CKKS decode expects an NTT-form plaintext")
        cd = self.context.get_context_data(plain.level)
        return emb.decode_pipeline(
            plain.data, jnp.asarray(1.0 / plain.scale, dtype=jnp.float64),
            self._emb, self._round_tables(cd), cd.ntt)

    def decode_device_with_stats(self, plain: Plaintext):
        """Device-resident decode plus a max-error estimate: returns
        (re, im, max_err) with max_err a DEVICE f64 scalar — the
        conjugate-symmetry residual of the embedding output, a pure
        measure of the decode transform's rounding error in slot units
        (decode-side counterpart of the reference's device max-tracking,
        ckks_cuda.cu:178-209 gMaxReal). No host readback."""
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("CKKS decode expects an NTT-form plaintext")
        cd = self.context.get_context_data(plain.level)
        return emb.decode_stats_pipeline(
            plain.data, jnp.asarray(1.0 / plain.scale, dtype=jnp.float64),
            self._emb, self._round_tables(cd), cd.ntt)

    def decode_max_error(self, plain: Plaintext) -> float:
        """Max rounding-error estimate of decoding `plain`, in slot units.

        PERF WARNING: materializes a device scalar (readback) — use
        decode_device_with_stats inside timed windows."""
        if self.host:
            # host oracle: conjugate-symmetry residual of the full ifft
            coeffs = self._compose_centered(plain) / plain.scale
            V = np.fft.ifft(coeffs * self._twist) * self.n
            idx = self._slot_index
            conj = np.conj(V[self.n - 1 - idx])
            return float(np.max(np.abs(V[idx] - conj), initial=0.0))
        _, _, err = self.decode_device_with_stats(plain)
        return float(np.asarray(err))

    def decode(self, plain: Plaintext) -> np.ndarray:
        """Slot values as a host numpy array.

        Materializing the result is a device->host readback; inside a
        timed window use decode_device() (device-resident) instead."""
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("CKKS decode expects an NTT-form plaintext")
        if self.host:
            coeffs = self._compose_centered(plain) / plain.scale
            V = np.fft.ifft(coeffs * self._twist) * self.n
            return V[self._slot_index]
        re, im = self.decode_device(plain)
        return np.asarray(re) + 1j * np.asarray(im)

    def decode_polynomial(self, plain: Plaintext,
                          count: Optional[int] = None) -> np.ndarray:
        if self.host:
            coeffs = self._compose_centered(plain) / plain.scale
        else:
            cd = self.context.get_context_data(plain.level)
            coeffs = np.asarray(emb.decode_polynomial_pipeline(
                plain.data,
                jnp.asarray(1.0 / plain.scale, dtype=jnp.float64),
                self._round_tables(cd), cd.ntt))
        return coeffs if count is None else coeffs[:count]
