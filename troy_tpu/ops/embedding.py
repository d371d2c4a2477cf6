"""Device CKKS canonical embedding: a complex128 FFT, exact rounding to
RNS and exact CRT composition, all on device.

The reference runs the embedding as a double-precision FFT kernel
(reference: src/ckks_cuda.cu:118 gFftTransferFromRevLayered, :833 ToRev,
scale+round kernels :211-302, decode :103-209). This module does the
same with ``jnp.fft`` on complex128, in the operation order of the host
oracle (``CKKSEncoder(host=True)``, which uses ``np.fft``):

    encode: V = conj-symmetric scatter of the slots; u = FFT(V) / n;
            coeffs = Re(u * zeta^-k) * scale; round; decompose mod q_i;
    decode: compose the centered integers; V = IFFT(coeffs * zeta^k) * n;
            gather the slots at the 3^i orbit.

Both f64 <-> RNS conversions are exact at any magnitude:
    - rounding: round-to-nearest-even in f64, then exact radix-2^32
      chunk extraction (power-of-two scalings and integral subtractions
      are exact in IEEE f64), then per-prime Shoup folds of the chunks;
    - composition: x_i = r_i * invp_i mod q_i, multiword accumulate of
      x_i * P_i in u64 words, conditional subtracts of Q, centering, then
      top-down f64 conversion.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import ntt as dntt
from . import u64ops as u
from ..utils import struct
from ..utils.rns import RnsBase

F64 = jnp.float64
C128 = jnp.complex128
U64 = jnp.uint64


class EmbedTables(struct.PyTreeNode):
    """Constant tables for one polynomial degree n: the twist factors
    zeta^k (decode) and zeta^-k (encode), and the slot orbit."""

    untwist_re: jnp.ndarray    # (n,) f64 Re zeta^-k
    untwist_im: jnp.ndarray    # (n,) f64 Im zeta^-k
    twist: jnp.ndarray         # (n,) c128 zeta^k
    slot_index: jnp.ndarray    # (n/2,) i32: slot i <-> coeff index (3^i-1)/2
    spread: jnp.ndarray        # (n,) i32: V[j] = [v, conj(v)][spread[j]]
    n: int = struct.field(pytree_node=False)


@lru_cache(maxsize=None)
def make_embed_tables(n: int) -> EmbedTables:
    j = np.arange(n)
    slots = n // 2
    idx = np.zeros(slots, dtype=np.int32)
    pos = 1
    for i in range(slots):
        idx[i] = (pos - 1) >> 1
        pos = (pos * 3) % (2 * n)
    # the slot orbit and its mirror cover every evaluation index once
    spread = np.zeros(n, dtype=np.int32)
    spread[idx] = np.arange(slots)
    spread[n - 1 - idx] = slots + np.arange(slots)
    # the same numpy expressions as the host oracle's (ckks.CKKSEncoder)
    untwist = np.exp(-1j * np.pi * j / n)
    return EmbedTables(
        untwist_re=jnp.asarray(untwist.real, dtype=F64),
        untwist_im=jnp.asarray(untwist.imag, dtype=F64),
        twist=jnp.asarray(np.exp(1j * np.pi * j / n), dtype=C128),
        slot_index=jnp.asarray(idx),
        spread=jnp.asarray(spread),
        n=n,
    )


def embed_inverse(values: jnp.ndarray, t: EmbedTables) -> jnp.ndarray:
    """Encode direction: slot values (m <= n/2,) complex -> real
    polynomial coefficients Re(zeta^-k * FFT(V) / n), V the
    conjugate-symmetric evaluation vector (unused slots zero). V is
    built by one gather: a complex128 scatter runs serially on the GPU
    (~190 ms at n=16384, H100)."""
    n = t.n
    v = jnp.pad(values, (0, n // 2 - values.shape[0]))
    v = jnp.concatenate([v, jnp.conj(v)])[t.spread]
    w = jnp.fft.fft(v) / n
    return jnp.real(w) * t.untwist_re - jnp.imag(w) * t.untwist_im


def embed_forward(coeffs: jnp.ndarray, t: EmbedTables) -> jnp.ndarray:
    """Decode direction: real coefficients (n,) -> the full evaluation
    vector IFFT(coeffs * zeta^k) * n (complex, length n)."""
    return jnp.fft.ifft(coeffs * t.twist) * t.n


# ---------------------------------------------------------------------------
# exact f64 <-> RNS on device
# ---------------------------------------------------------------------------

class RnsRoundTables(struct.PyTreeNode):
    """Per-(n, level) constants for exact rounding/composition.

    chunks: radix-2^32 pieces of round(c) (exact on integral f64);
    pow32[i, j] = 2^(32 j) mod q_i with Shoup quotients for the folds.
    Composition: punct[i] = prod_{l != i} q_l as multiwords, invp[i] =
    punct[i]^-1 mod q_i, qwords/qhalf for the final reduce + centering."""

    pow32: jnp.ndarray         # (k, MAXW) u64
    pow32_shoup: jnp.ndarray   # (k, MAXW) u64
    invp: jnp.ndarray          # (k,) u64
    invp_shoup: jnp.ndarray    # (k,) u64
    q_values: Tuple[int, ...] = struct.field(pytree_node=False)
    punct_words: Tuple[Tuple[int, ...], ...] = struct.field(pytree_node=False)
    q_words: Tuple[int, ...] = struct.field(pytree_node=False)
    qhalf_words: Tuple[int, ...] = struct.field(pytree_node=False)
    maxw: int = struct.field(pytree_node=False)      # 32-bit chunk count
    words: int = struct.field(pytree_node=False)     # 64-bit word count


def _to_words(v: int, count: int) -> Tuple[int, ...]:
    return tuple((v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(count))


@lru_cache(maxsize=None)
def make_rns_round_tables(q_values: Tuple[int, ...]) -> RnsRoundTables:
    from ..modulus import Modulus
    base = RnsBase(tuple(Modulus(v) for v in q_values))
    k = len(q_values)
    Q = 1
    for q in q_values:
        Q *= q
    maxw = max(2, (Q.bit_length() + 2 + 31) // 32)
    words = (Q.bit_length() + 63) // 64 + 1
    pow32 = np.zeros((k, maxw), dtype=np.uint64)
    pow32_sh = np.zeros((k, maxw), dtype=np.uint64)
    for i, q in enumerate(q_values):
        for j in range(maxw):
            w = pow(2, 32 * j, q)
            pow32[i, j] = w
            pow32_sh[i, j] = (w << 64) // q
    invp = np.array([base.inv_punctured(i) for i in range(k)],
                    dtype=np.uint64)
    invp_sh = np.array([(int(invp[i]) << 64) // q_values[i]
                        for i in range(k)], dtype=np.uint64)
    return RnsRoundTables(
        pow32=jnp.asarray(pow32), pow32_shoup=jnp.asarray(pow32_sh),
        invp=jnp.asarray(invp), invp_shoup=jnp.asarray(invp_sh),
        q_values=tuple(q_values),
        punct_words=tuple(_to_words(base.punctured_prod(i), words)
                          for i in range(k)),
        q_words=_to_words(Q, words),
        qhalf_words=_to_words((Q + 1) // 2, words),
        maxw=maxw, words=words,
    )


def _peel_pieces(v: jnp.ndarray, maxw: int):
    """Peel an integral f64 value into signed radix-2^32 pieces, top
    down: r starts at the scale of the top piece, and each level does
    p = rint(r); r = (r - p) * 2^32. Every step is exact in IEEE f64
    (power-of-two scalings, an integral subtraction), so the pieces sum
    back to v exactly. Returns [(piece_f64, level)] top first.

    A finite f64 is below 2^1024, so no piece above level 31 is ever
    non-zero (the level-31 piece is at most 2^32, whose high part the
    fold carries into level 32). Starting at level <= 31 also keeps the
    first scaling 2^(-32 top) >= 2^-992 a normal f64: a larger ladder
    would scale by a subnormal or by 0.0 and lose every piece."""
    top = min(maxw - 1, 31)
    r = v * (2.0 ** (-32 * top))
    pieces = []
    for m in range(top, 0, -1):
        p = jnp.rint(r)
        pieces.append((p, m))
        r = (r - p) * (2.0 ** 32)
    pieces.append((jnp.rint(r), 0))
    return pieces


def _fold_pieces(pieces, rt: RnsRoundTables) -> jnp.ndarray:
    """Fold signed radix-2^32 pieces into per-prime residues: (k, ...)."""
    outs = []
    for i, q in enumerate(rt.q_values):
        acc = None
        for p, m in pieces:
            neg = p < 0.0
            ap = jnp.abs(p)
            hi = jnp.floor(ap * (2.0 ** -32))
            lo = ap - hi * (2.0 ** 32)
            hi = hi.astype(jnp.uint32).astype(U64)
            lo = lo.astype(jnp.uint32).astype(U64)
            term = u.mul_mod_shoup(lo, rt.pow32[i, m],
                                   rt.pow32_shoup[i, m], q)
            if m + 1 < rt.maxw:
                t_hi = u.mul_mod_shoup(hi, rt.pow32[i, m + 1],
                                       rt.pow32_shoup[i, m + 1], q)
                term = u.add_mod(term, t_hi, q)
            term = jnp.where(neg, u.neg_mod(term, q), term)
            acc = term if acc is None else u.add_mod(acc, term, q)
        outs.append(acc)
    return jnp.stack(outs)


def round_to_rns_device(coeffs: jnp.ndarray,
                        rt: RnsRoundTables) -> jnp.ndarray:
    """round-to-nearest-even of f64 coefficients, decomposed mod each q_i:
    (n,) f64 -> (k, n) u64. Exact at any magnitude; bit-identical to the
    host oracle's rounding (ckks._round_to_rns)."""
    return _fold_pieces(_peel_pieces(jnp.rint(coeffs), rt.maxw), rt)


def _mw_add_scaled(acc: List[jnp.ndarray], x: jnp.ndarray,
                   words: Tuple[int, ...]) -> List[jnp.ndarray]:
    """acc (list of u64 arrays) += x * words (multiword constant)."""
    carry = jnp.zeros_like(x)
    out = []
    for w, cw in enumerate(words):
        lo, hi = u.mul128(x, u.u64(cw))
        s1 = acc[w] + lo
        c1 = (s1 < lo).astype(U64)
        s2 = s1 + carry
        c2 = (s2 < carry).astype(U64)
        out.append(s2)
        carry = hi + c1 + c2
    return out


def _mw_cond_sub(acc: List[jnp.ndarray],
                 words: Tuple[int, ...]) -> List[jnp.ndarray]:
    """acc -= words where acc >= words (borrow-select, elementwise)."""
    borrow = jnp.zeros_like(acc[0])
    diff = []
    for w, cw in enumerate(words):
        cwv = u.u64(cw)
        d1 = acc[w] - cwv
        b1 = (acc[w] < cwv).astype(U64)
        d2 = d1 - borrow
        b2 = (d1 < borrow).astype(U64)
        diff.append(d2)
        borrow = b1 + b2        # in {0, 1}: b1 and b2 never both set
    keep = borrow != 0          # borrowed out => acc < words
    return [jnp.where(keep, a, d) for a, d in zip(acc, diff)]


def _mw_ge(acc: List[jnp.ndarray], words: Tuple[int, ...]) -> jnp.ndarray:
    borrow = jnp.zeros_like(acc[0])
    for w, cw in enumerate(words):
        cwv = u.u64(cw)
        d1 = acc[w] - cwv
        b1 = (acc[w] < cwv).astype(U64)
        b2 = (d1 < borrow).astype(U64)
        borrow = b1 + b2
    return borrow == 0


def compose_centered_device(residues: jnp.ndarray,
                            rt: RnsRoundTables) -> jnp.ndarray:
    """CRT compose (k, n) residues to the CENTERED value as f64 (n,):
    v = sum_i (r_i * invp_i mod q_i) * P_i, reduced mod Q, centered to
    (-Q/2, Q/2]. Multiword-exact until the final f64 conversion."""
    k = len(rt.q_values)
    W = rt.words
    n_shape = residues.shape[1:]
    acc = [jnp.zeros(n_shape, dtype=U64) for _ in range(W)]
    for i, q in enumerate(rt.q_values):
        x = u.mul_mod_shoup(residues[i], rt.invp[i], rt.invp_shoup[i], q)
        acc = _mw_add_scaled(acc, x, rt.punct_words[i])
    for _ in range(k - 1):
        acc = _mw_cond_sub(acc, rt.q_words)
    neg = _mw_ge(acc, rt.qhalf_words)
    # magnitude of the negative branch: Q - acc
    borrow = jnp.zeros(n_shape, dtype=U64)
    mag = []
    for w, cw in enumerate(rt.q_words):
        cwv = u.u64(cw)
        d1 = cwv - acc[w]
        b1 = (cwv < acc[w]).astype(U64)
        d2 = d1 - borrow
        b2 = (d1 < borrow).astype(U64)
        mag.append(d2)
        borrow = b1 + b2
    vals = [jnp.where(neg, m, a) for m, a in zip(mag, acc)]
    f = jnp.zeros(n_shape, dtype=F64)
    for w in reversed(range(W)):
        hi = (vals[w] >> u.u64(32)).astype(jnp.uint32).astype(F64)
        lo = (vals[w] & u.u64(0xFFFFFFFF)).astype(jnp.uint32).astype(F64)
        f = f * (2.0 ** 64) + hi * (2.0 ** 32) + lo
    return jnp.where(neg, -f, f)


# ---------------------------------------------------------------------------
# fused pipelines (jitted by the encoder)
# ---------------------------------------------------------------------------

@jax.jit
def encode_pipeline(values, scale, emb: EmbedTables, rt: RnsRoundTables,
                    ntt_tables):
    """Slot values (complex) -> NTT-form RNS plaintext words (k, n)."""
    coeffs = embed_inverse(values, emb) * scale
    return dntt.rns_ntt_forward(round_to_rns_device(coeffs, rt), ntt_tables)


@jax.jit
def encode_polynomial_pipeline(coeffs, scale, rt: RnsRoundTables,
                               ntt_tables):
    """Raw real coefficients -> NTT-form RNS words (no embedding;
    ckks_cuda.cu:455 encodePolynomial analogue)."""
    return dntt.rns_ntt_forward(round_to_rns_device(coeffs * scale, rt),
                                ntt_tables)


@jax.jit
def encode_stats_pipeline(values, scale, emb: EmbedTables,
                          rt: RnsRoundTables, ntt_tables):
    """encode_pipeline plus the device max-|coefficient| statistic
    (reference: src/ckks_cuda.cu:178-209 gMaxReal, used at :386-407 for
    the exact magnitude check). Returns (data, max |round(coeffs)|)."""
    coeffs = jnp.rint(embed_inverse(values, emb) * scale)
    data = dntt.rns_ntt_forward(round_to_rns_device(coeffs, rt), ntt_tables)
    return data, jnp.max(jnp.abs(coeffs))


@jax.jit
def decode_pipeline(data, inv_scale, emb: EmbedTables, rt: RnsRoundTables,
                    ntt_tables):
    """NTT-form RNS words (k, n) -> slot values ((n/2,) re, im)."""
    coeffs = compose_centered_device(
        dntt.rns_ntt_inverse(data, ntt_tables), rt) * inv_scale
    v = embed_forward(coeffs, emb)[emb.slot_index]
    return jnp.real(v), jnp.imag(v)


@jax.jit
def decode_stats_pipeline(data, inv_scale, emb: EmbedTables,
                          rt: RnsRoundTables, ntt_tables):
    """decode_pipeline plus a device max-error estimate.

    The plaintext polynomial has REAL coefficients, so the full embedding
    output satisfies V[n-1-j] = conj(V[j]) exactly in exact arithmetic;
    the numerical asymmetry residual
        max(|Re V[j] - Re V[n-1-j]|, |Im V[j] + Im V[n-1-j]|)
    is therefore a pure measure of the transform's rounding error in slot
    units (zero for an exact transform, independent of the input). This
    is the decode-side counterpart of the reference's device max-tracking
    kernel (src/ckks_cuda.cu:178-209 gMaxReal). Returns (re, im, max_err)
    with max_err a device f64 scalar."""
    coeffs = compose_centered_device(
        dntt.rns_ntt_inverse(data, ntt_tables), rt) * inv_scale
    v = embed_forward(coeffs, emb)
    idx = emb.slot_index
    slot, mirror = v[idx], v[emb.n - 1 - idx]
    err = jnp.maximum(jnp.max(jnp.abs(jnp.real(slot) - jnp.real(mirror))),
                      jnp.max(jnp.abs(jnp.imag(slot) + jnp.imag(mirror))))
    return jnp.real(slot), jnp.imag(slot), err


@jax.jit
def decode_polynomial_pipeline(data, inv_scale, rt: RnsRoundTables,
                               ntt_tables):
    return compose_centered_device(
        dntt.rns_ntt_inverse(data, ntt_tables), rt) * inv_scale
