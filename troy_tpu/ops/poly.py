"""Elementwise RNS polynomial arithmetic and plain-embedding ops on device.

The reference's poly kernels and scaling variant
(reference: src/kernelutils.cu:30-186 add/sub/negate/scalar-mul,
src/scalingvariant.cpp / scalingvariant_cuda.cu multiplyAddPlainWithScalingVariant).

Arrays are (..., k, n) uint64, limb-major; per-limb moduli broadcast from
(k,) arrays (carried by RnsNttTables) or specialize as static Python ints.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import u64ops as u
from .ntt import RnsNttTables

U64 = jnp.uint64


def _qcol(t: RnsNttTables, ndim: int) -> jnp.ndarray:
    """Broadcastable (1, ..., k, 1) modulus column for (..., k, n) data."""
    return t.q.reshape((1,) * (ndim - 2) + (t.k, 1))


def _const_col(values, ndim: int) -> jnp.ndarray:
    arr = np.array([int(v) & 0xFFFFFFFFFFFFFFFF for v in values],
                   dtype=np.uint64)
    return jnp.asarray(arr).reshape((1,) * (ndim - 2) + (len(arr), 1))


def rns_add(a: jnp.ndarray, b: jnp.ndarray, t: RnsNttTables) -> jnp.ndarray:
    q = _qcol(t, a.ndim)
    s = a + b
    return jnp.where(s >= q, s - q, s)


def rns_sub(a: jnp.ndarray, b: jnp.ndarray, t: RnsNttTables) -> jnp.ndarray:
    q = _qcol(t, a.ndim)
    d = a - b
    return jnp.where(a >= b, d, d + q)


def rns_neg(a: jnp.ndarray, t: RnsNttTables) -> jnp.ndarray:
    q = _qcol(t, a.ndim)
    return jnp.where(a == jnp.uint64(0), a, q - a)


def rns_scalar_mul(x: jnp.ndarray, scalars: Sequence[int],
                   t: RnsNttTables) -> jnp.ndarray:
    """x * s_i mod q_i per limb, static per-limb scalars (Shoup)."""
    vals = t.values
    w = _const_col([s % q for s, q in zip(scalars, vals)], x.ndim)
    wq = _const_col([((s % q) << 64) // q for s, q in zip(scalars, vals)],
                    x.ndim)
    q = _qcol(t, x.ndim)
    r = x * w - u.mulhi64(x, wq) * q
    return jnp.where(r >= q, r - q, r)


def rns_broadcast_scalar_mul(x: jnp.ndarray, scalar: int,
                             t: RnsNttTables) -> jnp.ndarray:
    """x * s mod q_i for one integer s (reduced per limb)."""
    return rns_scalar_mul(x, [scalar] * t.k, t)


def plain_lift(m: jnp.ndarray, t: RnsNttTables, plain_modulus: int,
               plain_upper_half_threshold: int,
               total_q: int) -> jnp.ndarray:
    """Lift a mod-t plaintext (..., n) to RNS residues (..., k, n) with the
    centered (upper-half) correction: coefficients >= (t+1)/2 represent
    negatives and map to (m - t) mod q_i.

    Covers both the reference's fast_plain_lift and composed paths in one
    RNS-parallel formula (context.cpp plain_upper_half_increment semantics):
    (m - t) mod q_i == (m mod q_i + (Q - t) mod q_i) mod q_i.
    """
    vals = t.values
    tt = plain_modulus
    outs = []
    for i, q in enumerate(vals):
        if tt <= q:
            mi = m
        else:
            ratio = (1 << 128) // q
            mi = u.barrett_reduce_64(m, q, ratio >> 64)
        inc = (total_q - tt) % q
        lifted = u.add_mod(mi, u.u64(inc), q)
        outs.append(jnp.where(m >= u.u64(plain_upper_half_threshold),
                              lifted, mi))
    return jnp.stack(outs, axis=-2)


def bfv_multiply_add_plain(m: jnp.ndarray, c0: jnp.ndarray,
                           plain_modulus: int, q_mod_t: int,
                           coeff_div_plain: Tuple[int, ...],
                           t: RnsNttTables, subtract: bool = False
                           ) -> jnp.ndarray:
    """BFV plain embedding: c0 +/- round(Q/t * m) per limb
    (scalingvariant.cpp multiplyAddPlainWithScalingVariant).

    round(Q*m/t) = m*floor(Q/t) + fix,  fix = floor((m*(Q mod t) + (t+1)/2)/t).
    The 128/64 exact division subtracts the Barrett remainder, shifts out
    the power-of-two part of t, then multiplies by the inverse of the odd
    part mod 2^64 — the quotient is < 2^64 so the wrap-around product is
    exact (no long division; handles even t like 2^41).
    """
    tt = plain_modulus
    half = (tt + 1) >> 1
    ratio = (1 << 128) // tt
    cr = (ratio & ((1 << 64) - 1), ratio >> 64, 0)

    lo, hi = u.mul128(m, u.u64(q_mod_t))
    lo2 = lo + u.u64(half)
    hi2 = hi + (lo2 < lo).astype(U64)
    r = u.barrett_reduce_128(lo2, hi2, tt, cr)
    # exact division of the 128-bit (lo2:hi2) - r by t = 2^s * odd
    s = (tt & -tt).bit_length() - 1
    odd = tt >> s
    borrow = (lo2 < r).astype(U64)
    lo3 = lo2 - r
    hi3 = hi2 - borrow
    if s:
        lo3 = (lo3 >> u.u64(s)) | (hi3 << u.u64(64 - s))
    inv_odd = pow(odd, -1, 1 << 64)
    fix = lo3 * u.u64(inv_odd)              # exact floor((m*qt + half)/t)

    vals = t.values
    outs = []
    for i, q in enumerate(vals):
        d = int(coeff_div_plain[i])
        scaled = u.mul_mod_shoup(m, u.u64(d), u.u64((d << 64) // q), q)
        ratio_q = (1 << 128) // q
        term = u.barrett_reduce_64(scaled + fix, q, ratio_q >> 64)
        if subtract:
            outs.append(u.sub_mod(c0[..., i, :], term, q))
        else:
            outs.append(u.add_mod(c0[..., i, :], term, q))
    return jnp.stack(outs, axis=-2)


def negacyclic_shift(x: jnp.ndarray, shift: int, t: RnsNttTables) -> jnp.ndarray:
    """Multiply by x^shift mod (x^n + 1): rotate coefficients with sign flips
    for the wrapped prefix (kernelutils.cu:537 gNegacyclicShiftPolyCoeffmod).
    x: (..., k, n)."""
    n = t.n
    shift %= 2 * n
    if shift == 0:
        return x
    q = _qcol(t, x.ndim)
    neg = jnp.where(x == jnp.uint64(0), x, q - x)
    s = shift % n
    rolled = jnp.roll(x, s, axis=-1)
    rolled_neg = jnp.roll(neg, s, axis=-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    wrapped = idx < s                       # these came from the top: negate
    flip = wrapped if shift < n else ~wrapped
    return jnp.where(flip, rolled_neg, rolled)
