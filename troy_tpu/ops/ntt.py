"""Negacyclic NTT on device — vectorized Harvey butterfly network.

The reference's design (reference: src/kernelutils.cu:330-476,
kNttNegacyclicHarvey: one launch per butterfly layer, Shoup multiplies on
native 64-bit words) as one traced function: log2(n) rounds of reshaped
elementwise u64 ops that XLA fuses; values ride the lazy Harvey bounds
([0, 4q) between rounds) exactly like the reference, with a single final
reduction pass. ``utils/host_ntt.py`` is its numpy twin.

Two table flavors:
  * ``NttTables`` — one modulus; transforms act on (..., n).
  * ``RnsNttTables`` — a stacked RNS base: per-limb root tables (k, n) and
    per-limb moduli broadcast as (k, 1) arrays, so one trace covers every
    limb of a ciphertext at once; transforms act on (..., k, n).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from ..utils import struct

from . import u64ops as u
from ..utils.ntt_tables import NttTablesHost, make_ntt_tables

U64 = jnp.uint64

@lru_cache(maxsize=256)
def _limb_root_tables_dev(n: int, q: int):
    """Device copies of one modulus's root-power tables, cached per (n, q):
    chain levels share primes, so each prime's tables upload exactly once
    (the reference re-uploads per ContextDataCuda — context_cuda.cu).
    Used by the single-modulus NttTables (plain-NTT, mod-t batching);
    the RNS bases use _stacked_tables_dev. Both caches are LRU-BOUNDED
    (ADVICE r4): each entry pins device memory, so long-lived processes
    cycling many parameter sets evict cold tables instead of growing
    without bound (a live context re-uploads on the next use)."""
    h = make_ntt_tables(n, q)
    return (jnp.asarray(h.root_powers), jnp.asarray(h.root_powers_shoup),
            jnp.asarray(h.inv_root_powers),
            jnp.asarray(h.inv_root_powers_shoup))


@lru_cache(maxsize=64)
def _stacked_tables_dev(n: int, moduli: Tuple[int, ...]):
    """Device copies of a whole RNS base's stacked tables, cached per
    (n, base). Stacking happens on the HOST (numpy) and each stacked array
    uploads as ONE transfer: a device-side jnp.stack would compile a tiny
    XLA executable per distinct (k, n) shape, whereas pure transfers need
    no compile at all. A rebuilt context (same params) is then a pure
    cache hit."""
    hosts = [make_ntt_tables(n, int(q)) for q in moduli]
    stack = lambda get: jnp.asarray(np.stack([get(h) for h in hosts]))
    vec = lambda get: jnp.asarray(np.array(
        [get(h) & 0xFFFFFFFFFFFFFFFF for h in hosts], dtype=np.uint64))
    return (
        stack(lambda h: h.root_powers),
        stack(lambda h: h.root_powers_shoup),
        stack(lambda h: h.inv_root_powers),
        stack(lambda h: h.inv_root_powers_shoup),
        vec(lambda h: h.modulus),
        vec(lambda h: h.const_ratio[1]),
        vec(lambda h: h.const_ratio[0]),
        vec(lambda h: h.inv_degree),
        vec(lambda h: h.inv_degree_shoup),
    )


class NttTables(struct.PyTreeNode):
    """Device twin of NttTablesHost. Arrays are leaves; scalars are static."""

    root_powers: jnp.ndarray
    root_powers_shoup: jnp.ndarray
    inv_root_powers: jnp.ndarray
    inv_root_powers_shoup: jnp.ndarray
    n: int = struct.field(pytree_node=False)
    log_n: int = struct.field(pytree_node=False)
    modulus: int = struct.field(pytree_node=False)
    const_ratio: Tuple[int, int, int] = struct.field(pytree_node=False)
    inv_degree: int = struct.field(pytree_node=False)
    inv_degree_shoup: int = struct.field(pytree_node=False)

    @classmethod
    def from_host(cls, h: NttTablesHost) -> "NttTables":
        rp, rps, irp, irps = _limb_root_tables_dev(h.n, h.modulus)
        return cls(
            root_powers=rp,
            root_powers_shoup=rps,
            inv_root_powers=irp,
            inv_root_powers_shoup=irps,
            n=h.n,
            log_n=h.log_n,
            modulus=h.modulus,
            const_ratio=h.const_ratio,
            inv_degree=h.inv_degree,
            inv_degree_shoup=h.inv_degree_shoup,
        )


class RnsNttTables(struct.PyTreeNode):
    """Stacked NTT tables for a whole RNS base (k limbs, one shared n).

    Every per-limb constant is a (k,) device array so a single traced
    transform serves all limbs; the raw modulus values stay available as a
    static tuple for ops that need per-limb Python ints.
    """

    root_powers: jnp.ndarray           # (k, n)
    root_powers_shoup: jnp.ndarray     # (k, n)
    inv_root_powers: jnp.ndarray       # (k, n)
    inv_root_powers_shoup: jnp.ndarray # (k, n)
    q: jnp.ndarray                     # (k,) moduli
    cr_hi: jnp.ndarray                 # (k,) Barrett ratio high word
    cr_lo: jnp.ndarray                 # (k,) Barrett ratio low word
    inv_degree: jnp.ndarray            # (k,)
    inv_degree_shoup: jnp.ndarray      # (k,)
    n: int = struct.field(pytree_node=False)
    log_n: int = struct.field(pytree_node=False)
    values: Tuple[int, ...] = struct.field(pytree_node=False)

    @classmethod
    def from_moduli(cls, n: int, moduli: Sequence[int]) -> "RnsNttTables":
        n = int(n)   # tolerate numpy integers from loaded configs
        values = tuple(int(q) for q in moduli)
        (rp, rps, irp, irps, qv, cr_hi, cr_lo,
         inv_deg, inv_deg_s) = _stacked_tables_dev(n, values)
        return cls(
            root_powers=rp,
            root_powers_shoup=rps,
            inv_root_powers=irp,
            inv_root_powers_shoup=irps,
            q=qv,
            cr_hi=cr_hi,
            cr_lo=cr_lo,
            inv_degree=inv_deg,
            inv_degree_shoup=inv_deg_s,
            n=n,
            log_n=n.bit_length() - 1,
            values=values,
        )

    @property
    def k(self) -> int:
        return len(self.values)

    def limb(self, i: int) -> NttTables:
        """Single-modulus view of limb i (static modulus)."""
        h = make_ntt_tables(self.n, self.values[i])
        return NttTables(
            root_powers=self.root_powers[i],
            root_powers_shoup=self.root_powers_shoup[i],
            inv_root_powers=self.inv_root_powers[i],
            inv_root_powers_shoup=self.inv_root_powers_shoup[i],
            n=self.n, log_n=self.log_n, modulus=h.modulus,
            const_ratio=h.const_ratio, inv_degree=h.inv_degree,
            inv_degree_shoup=h.inv_degree_shoup,
        )

    def select(self, indices: Sequence[int]) -> "RnsNttTables":
        """Sub-base view over an arbitrary (static) limb index set — e.g. the
        key-switch working base {q_0..q_{k-1}, p_special}."""
        idx = jnp.asarray(np.array(indices, dtype=np.int32))
        take = lambda a: jnp.take(a, idx, axis=0)
        return RnsNttTables(
            root_powers=take(self.root_powers),
            root_powers_shoup=take(self.root_powers_shoup),
            inv_root_powers=take(self.inv_root_powers),
            inv_root_powers_shoup=take(self.inv_root_powers_shoup),
            q=take(self.q),
            cr_hi=take(self.cr_hi),
            cr_lo=take(self.cr_lo),
            inv_degree=take(self.inv_degree),
            inv_degree_shoup=take(self.inv_degree_shoup),
            n=self.n, log_n=self.log_n,
            values=tuple(self.values[i] for i in indices),
        )

    def slice(self, start: int, stop: int) -> "RnsNttTables":
        """Sub-base view over limbs [start, stop)."""
        return RnsNttTables(
            root_powers=self.root_powers[start:stop],
            root_powers_shoup=self.root_powers_shoup[start:stop],
            inv_root_powers=self.inv_root_powers[start:stop],
            inv_root_powers_shoup=self.inv_root_powers_shoup[start:stop],
            q=self.q[start:stop],
            cr_hi=self.cr_hi[start:stop],
            cr_lo=self.cr_lo[start:stop],
            inv_degree=self.inv_degree[start:stop],
            inv_degree_shoup=self.inv_degree_shoup[start:stop],
            n=self.n, log_n=self.log_n,
            values=self.values[start:stop],
        )


# --------------------------------------------------------------------------
# Single-modulus transforms (static modulus).
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("lazy",))
def ntt_forward(x: jnp.ndarray, t: NttTables, lazy: bool = False) -> jnp.ndarray:
    """Forward negacyclic NTT over the last axis.

    Input: coefficients in [0, q), natural order.
    Output: NTT values in bit-reversed evaluation order, in [0, q)
    (or [0, 4q) if lazy=True).
    """
    n, q = t.n, t.modulus
    q2 = u.u64(2 * q)
    lead = x.shape[:-1]
    v = x
    for r in range(t.log_n):
        m = 1 << r            # blocks this round
        gap = n >> (r + 1)    # half-block length
        w = jax.lax.dynamic_slice_in_dim(t.root_powers, m, m)
        wq = jax.lax.dynamic_slice_in_dim(t.root_powers_shoup, m, m)
        w = w.reshape((1,) * len(lead) + (m, 1))
        wq = wq.reshape((1,) * len(lead) + (m, 1))
        v = v.reshape(lead + (m, 2, gap))
        a = v[..., 0, :]
        b = v[..., 1, :]
        a = jnp.where(a >= q2, a - q2, a)             # guard: [0,4q) -> [0,2q)
        bw = u.mul_mod_shoup_lazy(b, w, wq, q)        # [0, 2q)
        v = jnp.stack([a + bw, a - bw + q2], axis=-2)  # both [0, 4q)
        v = v.reshape(lead + (n,))
    if not lazy:
        v = u.reduce_4q(v, q)
    return v


@partial(jax.jit, static_argnames=("lazy",))
def ntt_inverse(x: jnp.ndarray, t: NttTables, lazy: bool = False) -> jnp.ndarray:
    """Inverse negacyclic NTT over the last axis (Gentleman–Sande), including
    the n^{-1} scaling. Input in [0, q) (accepts up to [0, 2q) lazily),
    output in [0, q) (or [0, 2q) if lazy=True)."""
    n, q = t.n, t.modulus
    q2 = u.u64(2 * q)
    lead = x.shape[:-1]
    v = x
    for r in range(t.log_n - 1, -1, -1):
        m = 1 << r
        gap = n >> (r + 1)
        w = jax.lax.dynamic_slice_in_dim(t.inv_root_powers, m, m)
        wq = jax.lax.dynamic_slice_in_dim(t.inv_root_powers_shoup, m, m)
        w = w.reshape((1,) * len(lead) + (m, 1))
        wq = wq.reshape((1,) * len(lead) + (m, 1))
        v = v.reshape(lead + (m, 2, gap))
        a = v[..., 0, :]
        b = v[..., 1, :]
        s = a + b                                      # [0, 4q)
        d = a - b + q2                                 # [0, 4q)
        s = jnp.where(s >= q2, s - q2, s)              # [0, 2q)
        bw = u.mul_mod_shoup_lazy(d, w, wq, q)         # [0, 2q)
        v = jnp.stack([s, bw], axis=-2)
        v = v.reshape(lead + (n,))
    # scale by n^{-1}
    v = u.mul_mod_shoup_lazy(v, u.u64(t.inv_degree), u.u64(t.inv_degree_shoup), q)
    if not lazy:
        v = u.reduce_2q(v, q)
    return v


@jax.jit
def dyadic_mul(a: jnp.ndarray, b: jnp.ndarray, t: NttTables) -> jnp.ndarray:
    """Pointwise product mod q of two NTT-domain arrays (kernelutils dyadic
    product equivalent)."""
    return u.mul_mod(a, b, t.modulus, t.const_ratio)


@jax.jit
def negacyclic_mul(a: jnp.ndarray, b: jnp.ndarray, t: NttTables) -> jnp.ndarray:
    """Full negacyclic polynomial product via NTT -> dyadic -> iNTT."""
    fa = ntt_forward(a, t)
    fb = ntt_forward(b, t)
    return ntt_inverse(dyadic_mul(fa, fb, t), t)


# --------------------------------------------------------------------------
# RNS-stacked transforms: x has shape (..., k, n); per-limb constants
# broadcast from (k,) arrays. One trace serves the whole base.
# --------------------------------------------------------------------------

def _bshape(t: RnsNttTables, lead_len: int, m: int) -> Tuple[int, ...]:
    return (1,) * lead_len + (t.k, m, 1)


@partial(jax.jit, static_argnames=("lazy",))
def rns_ntt_forward(x: jnp.ndarray, t: RnsNttTables,
                    lazy: bool = False) -> jnp.ndarray:
    """Forward NTT of every limb: (..., k, n) -> (..., k, n). Input limbs
    in [0, q), output in [0, q) (or [0, 4q) if lazy=True)."""
    n = t.n
    lead = x.shape[:-2]
    L = len(lead)
    q = t.q.reshape((1,) * L + (t.k, 1, 1))
    q2 = q * jnp.uint64(2)
    v = x
    for r in range(t.log_n):
        m = 1 << r
        gap = n >> (r + 1)
        w = jax.lax.dynamic_slice_in_dim(t.root_powers, m, m, axis=1)
        wq = jax.lax.dynamic_slice_in_dim(t.root_powers_shoup, m, m, axis=1)
        w = w.reshape(_bshape(t, L, m))
        wq = wq.reshape(_bshape(t, L, m))
        v = v.reshape(lead + (t.k, m, 2, gap))
        a = v[..., 0, :]
        b = v[..., 1, :]
        a = jnp.where(a >= q2, a - q2, a)
        bw = b * w - u.mulhi64(b, wq) * q              # Shoup lazy, [0, 2q)
        v = jnp.stack([a + bw, a - bw + q2], axis=-2)
        v = v.reshape(lead + (t.k, n))
    if not lazy:
        qn = t.q.reshape((1,) * L + (t.k, 1))
        v = jnp.where(v >= qn * jnp.uint64(2), v - qn * jnp.uint64(2), v)
        v = jnp.where(v >= qn, v - qn, v)
    return v


@partial(jax.jit, static_argnames=("lazy",))
def rns_ntt_inverse(x: jnp.ndarray, t: RnsNttTables,
                    lazy: bool = False) -> jnp.ndarray:
    """Inverse NTT of every limb: (..., k, n) -> (..., k, n), including the
    n^{-1} scaling."""
    n = t.n
    lead = x.shape[:-2]
    L = len(lead)
    q = t.q.reshape((1,) * L + (t.k, 1, 1))
    q2 = q * jnp.uint64(2)
    v = x
    for r in range(t.log_n - 1, -1, -1):
        m = 1 << r
        gap = n >> (r + 1)
        w = jax.lax.dynamic_slice_in_dim(t.inv_root_powers, m, m, axis=1)
        wq = jax.lax.dynamic_slice_in_dim(t.inv_root_powers_shoup, m, m, axis=1)
        w = w.reshape(_bshape(t, L, m))
        wq = wq.reshape(_bshape(t, L, m))
        v = v.reshape(lead + (t.k, m, 2, gap))
        a = v[..., 0, :]
        b = v[..., 1, :]
        s = a + b
        d = a - b + q2
        s = jnp.where(s >= q2, s - q2, s)
        bw = d * w - u.mulhi64(d, wq) * q
        v = jnp.stack([s, bw], axis=-2)
        v = v.reshape(lead + (t.k, n))
    qn = t.q.reshape((1,) * L + (t.k, 1))
    iv = t.inv_degree.reshape((1,) * L + (t.k, 1))
    ivs = t.inv_degree_shoup.reshape((1,) * L + (t.k, 1))
    v = v * iv - u.mulhi64(v, ivs) * qn                # [0, 2q)
    if not lazy:
        v = jnp.where(v >= qn, v - qn, v)
    return v


def ntt_forward_limb(x: jnp.ndarray, t: RnsNttTables, i: int,
                     lazy: bool = False) -> jnp.ndarray:
    """Forward NTT of one limb of an RNS base."""
    return ntt_forward(x, t.limb(i), lazy=lazy)


def ntt_inverse_limb(x: jnp.ndarray, t: RnsNttTables, i: int,
                     lazy: bool = False) -> jnp.ndarray:
    """Inverse NTT of one limb of an RNS base."""
    return ntt_inverse(x, t.limb(i), lazy=lazy)


@jax.jit
def rns_dyadic_mul(a: jnp.ndarray, b: jnp.ndarray,
                   t: RnsNttTables) -> jnp.ndarray:
    """Pointwise product mod per-limb q: inputs (..., k, n)."""
    qn = t.q.reshape((1,) * (a.ndim - 2) + (t.k, 1))
    crh = t.cr_hi.reshape(qn.shape)
    crl = t.cr_lo.reshape(qn.shape)
    lo, hi = u.mul128(a, b)
    return u.barrett_reduce_128_dyn(lo, hi, qn, crl, crh)
