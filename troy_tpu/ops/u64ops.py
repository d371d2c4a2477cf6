"""64-bit modular arithmetic primitives on JAX uint64 arrays.

The reference's scalar/SIMT modmul layer (reference:
src/utils/uintarithsmallmod.h:95-336, src/kernelutils.cuh:120-200) in
plain JAX:
  * every modulus and Barrett/Shoup constant is STATIC (a Python int baked
    into the jaxpr at trace time), so XLA constant-folds and specializes;
  * ``lax`` has no 64-bit high multiply, so mulhi64/mul128 are built from
    four 32x32->64 partial products (the GPU's native 64-bit high multiply,
    which the reference's dMultiplyUintMod uses, is not reachable from
    XLA's elementwise code);
  * Shoup precomputed-quotient multiplication runs on all hot paths where
    one operand is a known table constant (NTT roots, inverse factors).

All functions are shape-polymorphic and vmappable; they are the only place
in the framework that performs raw modular arithmetic on device.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

U64 = jnp.uint64
_M32 = np.uint64(0xFFFFFFFF)
_32 = np.uint64(32)


def u64(x) -> jnp.ndarray:
    """Make a uint64 scalar/array from a Python int or array."""
    if isinstance(x, int):
        return jnp.asarray(np.uint64(x & 0xFFFFFFFFFFFFFFFF))
    return jnp.asarray(x, dtype=U64)


def mulhi64(a, b):
    """High 64 bits of the 128-bit product a*b (both uint64)."""
    a_lo = a & _M32
    a_hi = a >> _32
    b_lo = b & _M32
    b_hi = b >> _32
    t = a_lo * b_lo
    u = a_hi * b_lo + (t >> _32)
    v = a_lo * b_hi + (u & _M32)
    return a_hi * b_hi + (u >> _32) + (v >> _32)


def mul128(a, b):
    """Full 128-bit product as (lo64, hi64)."""
    a_lo = a & _M32
    a_hi = a >> _32
    b_lo = b & _M32
    b_hi = b >> _32
    t = a_lo * b_lo
    u = a_hi * b_lo + (t >> _32)
    v = a_lo * b_hi + (u & _M32)
    lo = (v << _32) | (t & _M32)
    hi = a_hi * b_hi + (u >> _32) + (v >> _32)
    return lo, hi


def add_mod(a, b, q: int):
    """(a + b) mod q for a, b in [0, q). q < 2^63 so the sum never wraps."""
    qs = u64(q)
    s = a + b
    return jnp.where(s >= qs, s - qs, s)


def sub_mod(a, b, q: int):
    """(a - b) mod q for a, b in [0, q)."""
    qs = u64(q)
    d = a - b
    return jnp.where(a >= b, d, d + qs)


def neg_mod(a, q: int):
    """(-a) mod q for a in [0, q)."""
    qs = u64(q)
    return jnp.where(a == u64(0), a, qs - a)


def barrett_reduce_64(x, q: int, const_ratio_hi: int):
    """Reduce a full uint64 to [0, q) (uintarithsmallmod.h barrettReduce64):
    one mulhi with the high ratio word, then a single conditional subtract."""
    qs = u64(q)
    tmp = mulhi64(x, u64(const_ratio_hi))
    res = x - tmp * qs
    return jnp.where(res >= qs, res - qs, res)


def barrett_reduce_128(z_lo, z_hi, q: int, const_ratio: tuple):
    """Reduce a 128-bit value (z_hi:z_lo) to [0, q)
    (uintarithsmallmod.h:95-163 semantics).

    const_ratio = (cr0, cr1, _) with cr1:cr0 = floor(2^128 / q).
    """
    cr0 = u64(const_ratio[0])
    cr1 = u64(const_ratio[1])
    qs = u64(q)

    # Round 1
    carry = mulhi64(z_lo, cr0)
    tmp2_lo, tmp2_hi = mul128(z_lo, cr1)
    tmp1 = tmp2_lo + carry
    c = (tmp1 < tmp2_lo).astype(U64)        # carry out of the add
    tmp3 = tmp2_hi + c

    # Round 2
    tmp2_lo, tmp2_hi = mul128(z_hi, cr0)
    s = tmp1 + tmp2_lo
    c = (s < tmp1).astype(U64)
    tmp1 = s
    carry = tmp2_hi + c

    # This is all we care about
    tmp1 = z_hi * cr1 + tmp3 + carry

    # Barrett subtraction
    tmp3 = z_lo - tmp1 * qs
    return jnp.where(tmp3 >= qs, tmp3 - qs, tmp3)


def barrett_reduce_128_dyn(z_lo, z_hi, q, cr_lo, cr_hi):
    """Barrett 128-bit reduction with *array* modulus and ratio words
    (broadcast against z): the per-limb-vectorized form used by the
    RNS-stacked kernels. Same algorithm as barrett_reduce_128."""
    carry = mulhi64(z_lo, cr_lo)
    tmp2_lo, tmp2_hi = mul128(z_lo, cr_hi)
    tmp1 = tmp2_lo + carry
    c = (tmp1 < tmp2_lo).astype(U64)
    tmp3 = tmp2_hi + c
    tmp2_lo, tmp2_hi = mul128(z_hi, cr_lo)
    s = tmp1 + tmp2_lo
    c = (s < tmp1).astype(U64)
    carry = tmp2_hi + c
    tmp1 = z_hi * cr_hi + tmp3 + carry
    tmp3 = z_lo - tmp1 * q
    return jnp.where(tmp3 >= q, tmp3 - q, tmp3)


def mul_mod(a, b, q: int, const_ratio: tuple):
    """(a * b) mod q via full Barrett reduction of the 128-bit product."""
    lo, hi = mul128(a, b)
    return barrett_reduce_128(lo, hi, q, const_ratio)


def shoup_quotient(operand: int, q: int) -> int:
    """Host precompute: floor(operand * 2^64 / q) — the Shoup quotient word
    (MultiplyUIntModOperand, uintarithsmallmod.h:166-176)."""
    return (operand << 64) // q


def mul_mod_shoup_lazy(x, w, w_quot, q: int):
    """Shoup multiplication by a table constant, lazy result in [0, 2q).
    x may be any uint64; w < q; w_quot = floor(w * 2^64 / q).
    w and w_quot may be arrays (broadcast against x)."""
    qs = u64(q)
    hi = mulhi64(x, w_quot)
    return x * w - hi * qs


def mul_mod_shoup(x, w, w_quot, q: int):
    """Shoup multiplication fully reduced to [0, q)."""
    qs = u64(q)
    r = mul_mod_shoup_lazy(x, w, w_quot, q)
    return jnp.where(r >= qs, r - qs, r)


def reduce_2q(x, q: int):
    """Map a value in [0, 2q) down to [0, q)."""
    qs = u64(q)
    return jnp.where(x >= qs, x - qs, x)


def reduce_4q(x, q: int):
    """Map a value in [0, 4q) down to [0, q)."""
    qs = u64(q)
    q2 = u64(2 * q)
    x = jnp.where(x >= q2, x - q2, x)
    return jnp.where(x >= qs, x - qs, x)


def add_u128(lo_a, hi_a, lo_b, hi_b):
    """128-bit addition of two (lo, hi) pairs."""
    lo = lo_a + lo_b
    carry = (lo < lo_a).astype(U64)
    hi = hi_a + hi_b + carry
    return lo, hi
