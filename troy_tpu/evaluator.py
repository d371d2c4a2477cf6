"""Evaluator: the full homomorphic-operation surface.

Semantics-compatible with the reference's evaluator
(reference: src/evaluator.h:72 / src/evaluator_cuda.cuh:13-440,
src/evaluator_cuda.cu; BEHZ BFV multiply :283-382, CKKS :384-432,
BGV :435+, relinearize :703, mod-switch :749, switch-key :1163-1362,
Galois/rotations :2024-2150).

Every hot op is a module-level ``jax.jit`` function whose
arguments are uint64 pytrees plus the ContextData pytree — the static
metadata (moduli, RNS tool, scheme) specializes each compiled executable,
so there is zero dynamic control flow on device. The key-switch inner
product runs as a dense (decomp x key-limb) 128-bit multiply-accumulate —
the reference's triangular lazy-reduction loop restructured into one fused
tensor contraction.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .context import HeContext, ContextData
from .he_types import (Ciphertext, Plaintext, GaloisKeys, KSwitchKeys,
                       LWECiphertext, RelinKeys)
from .params import SchemeType
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import rns as drns
from .ops import u64ops as u
from .utils import galois as galois_util
from .utils import numth

U64 = jnp.uint64


# ==========================================================================
# jitted cores
# ==========================================================================

@jax.jit
def _negate(data: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return dpoly.rns_neg(data, cd.ntt)


@jax.jit
def _add(d1: jnp.ndarray, d2: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return dpoly.rns_add(d1, d2, cd.ntt)


@jax.jit
def _sub(d1: jnp.ndarray, d2: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return dpoly.rns_sub(d1, d2, cd.ntt)


def _dyadic_convolution(a: List[jnp.ndarray], b: List[jnp.ndarray],
                        tables: dntt.RnsNttTables) -> List[jnp.ndarray]:
    """Ciphertext-degree convolution of NTT-domain component lists
    (kernelutils.cu:89-115 gDyadicConvolutionCoeffmod equivalent)."""
    out: List[Optional[jnp.ndarray]] = [None] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            p = dntt.rns_dyadic_mul(ai, bj, tables)
            out[i + j] = p if out[i + j] is None else dpoly.rns_add(
                out[i + j], p, tables)
    return out  # type: ignore


@jax.jit
def _bfv_multiply(d1: jnp.ndarray, d2: jnp.ndarray,
                  cd: ContextData) -> jnp.ndarray:
    """BEHZ RNS multiplication (evaluator_cuda.cu:283-382):
    lift to q  and Bsk, dyadic-convolve in both bases, scale by t,
    fast-floor by Q, convert Bsk -> q."""
    tool = cd.rns_tool
    qt = cd.ntt
    bt = cd.bsk_ntt
    size1, size2 = d1.shape[0], d2.shape[0]

    def lift(data, size):
        q_ntt, bsk_ntt = [], []
        for i in range(size):
            poly = data[i]
            q_ntt.append(dntt.rns_ntt_forward(poly, qt, lazy=True))
            tmp = drns.fastbconv_m_tilde(poly, tool)
            tmp = drns.sm_mrq(tmp, tool)
            bsk_ntt.append(dntt.rns_ntt_forward(tmp, bt, lazy=True))
        return q_ntt, bsk_ntt

    a_q, a_b = lift(d1, size1)
    b_q, b_b = lift(d2, size2)

    prod_q = _dyadic_convolution(a_q, b_q, qt)
    prod_b = _dyadic_convolution(a_b, b_b, bt)

    t_plain = int(cd.plain_modulus)
    outs = []
    for i in range(size1 + size2 - 1):
        cq = dntt.rns_ntt_inverse(prod_q[i], qt)
        cb = dntt.rns_ntt_inverse(prod_b[i], bt)
        # multiply by t in both bases, then floor-divide by Q
        cq = dpoly.rns_broadcast_scalar_mul(cq, t_plain, qt)
        cb = dpoly.rns_broadcast_scalar_mul(cb, t_plain, bt)
        stacked = jnp.concatenate([cq, cb], axis=0)       # q union Bsk
        floored = drns.fast_floor(stacked, tool)          # -> Bsk
        outs.append(drns.fastbconv_sk(floored, tool))     # -> q
    return jnp.stack(outs)


@jax.jit
def _ntt_form_multiply(d1: jnp.ndarray, d2: jnp.ndarray,
                       cd: ContextData) -> jnp.ndarray:
    """CKKS/BGV multiply: plain dyadic convolution in the NTT domain
    (evaluator_cuda.cu:384-432, :435+)."""
    a = [d1[i] for i in range(d1.shape[0])]
    b = [d2[i] for i in range(d2.shape[0])]
    return jnp.stack(_dyadic_convolution(a, b, cd.ntt))


def _dyadic_square(a0: jnp.ndarray, a1: jnp.ndarray,
                   tables: dntt.RnsNttTables) -> List[jnp.ndarray]:
    """Size-2 NTT-domain square: 3 dyadic products instead of the
    convolution's 4 — the c0*c1 cross term is computed once and doubled
    (kernelutils.cu:166-186 gDyadicSquareCoeffmod). Bit-identical to
    _dyadic_convolution([a0,a1],[a0,a1]) since both fully reduce mod q."""
    s0 = dntt.rns_dyadic_mul(a0, a0, tables)
    cross = dntt.rns_dyadic_mul(a0, a1, tables)
    s1 = dpoly.rns_add(cross, cross, tables)
    s2 = dntt.rns_dyadic_mul(a1, a1, tables)
    return [s0, s1, s2]


@jax.jit
def _bfv_square(d: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    """Dedicated BEHZ square for size-2 ciphertexts
    (evaluator_cuda.cu:525-601 bfvSquare): ONE lift of the two components
    to q and Bsk (multiply lifts each *operand*, paying it twice when both
    arguments are the same ciphertext) and 3 dyadic products instead of 4,
    then the same t-scale / fast-floor / Bsk->q tail as multiply."""
    tool = cd.rns_tool
    qt = cd.ntt
    bt = cd.bsk_ntt

    q_ntt, bsk_ntt = [], []
    for i in range(2):
        poly = d[i]
        q_ntt.append(dntt.rns_ntt_forward(poly, qt, lazy=True))
        tmp = drns.fastbconv_m_tilde(poly, tool)
        tmp = drns.sm_mrq(tmp, tool)
        bsk_ntt.append(dntt.rns_ntt_forward(tmp, bt, lazy=True))

    prod_q = _dyadic_square(q_ntt[0], q_ntt[1], qt)
    prod_b = _dyadic_square(bsk_ntt[0], bsk_ntt[1], bt)

    t_plain = int(cd.plain_modulus)
    outs = []
    for i in range(3):
        cq = dntt.rns_ntt_inverse(prod_q[i], qt)
        cb = dntt.rns_ntt_inverse(prod_b[i], bt)
        cq = dpoly.rns_broadcast_scalar_mul(cq, t_plain, qt)
        cb = dpoly.rns_broadcast_scalar_mul(cb, t_plain, bt)
        stacked = jnp.concatenate([cq, cb], axis=0)
        floored = drns.fast_floor(stacked, tool)
        outs.append(drns.fastbconv_sk(floored, tool))
    return jnp.stack(outs)


@jax.jit
def _ntt_form_square(d: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    """CKKS/BGV dedicated square for size-2 ciphertexts
    (evaluator_cuda.cu:601-646 ckksSquare, :647-700 bgvSquare)."""
    return jnp.stack(_dyadic_square(d[0], d[1], cd.ntt))


def _switch_key_decompose(target: jnp.ndarray, cd: ContextData,
                          key_cd: ContextData,
                          target_ntt_form: bool) -> jnp.ndarray:
    """Stage 1 of the key switch: RNS-digit decomposition of the target
    polynomial, reduced mod every used key prime and NTT'd — the expensive
    part (k x (k+1) limb NTTs). Returns t_hat (k, used, n), fully reduced.

    Split out so hoisted multi-rotation can compute it ONCE and reuse it
    across automorphisms: digit decomposition commutes with the Galois
    automorphism, and in NTT domain the automorphism is a pure permutation
    of t_hat's last axis."""
    k = cd.limbs
    key_values = key_cd.coeff_values
    kf = len(key_values)
    used = list(range(k)) + [kf - 1]
    used_tables = key_cd.ntt.select(used)

    # ---- decompose: t_hat[j, i] = NTT_{p_i}(target_j mod p_i) ----
    diag_ok = all(key_values[j] == cd.coeff_values[j] for j in range(k))
    if target_ntt_form and diag_ok:
        # Diagonal shortcut (NTT-form targets — CKKS/BGV relin, rotation):
        # for i = j < k the entry NTT_{q_j}(INTT(target)_j mod q_j) is
        # identically the ORIGINAL NTT-form limb (both transforms are
        # exact bijections on Z_q^n), so it is reused verbatim and only
        # the off-diagonal lifts run NTTs — k x k instead of k x (k+1),
        # bit-exact by construction.
        target_coeff = dntt.rns_ntt_inverse(target, cd.ntt)
        out_rows: List[Optional[jnp.ndarray]] = [None] * k
        for j in range(k):
            qj = cd.coeff_values[j]
            others = [i for i in used if i != j]
            row = []
            for i in others:
                p = key_values[i]
                tj = target_coeff[j]
                if qj > p:
                    tj = u.barrett_reduce_64(tj, p, ((1 << 128) // p) >> 64)
                row.append(tj)
            res = dntt.rns_ntt_forward(jnp.stack(row),
                                       key_cd.ntt.select(others))
            pos = used.index(j)
            out_rows[j] = jnp.concatenate(
                [res[:pos], target[j][None], res[pos:]])
        return jnp.stack(out_rows)             # fully reduced
    if target_ntt_form:
        target_coeff = dntt.rns_ntt_inverse(target, cd.ntt)
    else:
        target_coeff = target
    cols = []
    for i in used:
        p = key_values[i]
        cr_hi = ((1 << 128) // p) >> 64
        rows = []
        for j in range(k):
            qj = cd.coeff_values[j]
            tj = target_coeff[j]
            if qj > p:
                tj = u.barrett_reduce_64(tj, p, cr_hi)
            rows.append(tj)
        cols.append(jnp.stack(rows))
    t_mat = jnp.stack(cols, axis=1)            # (k_j, used, n)
    return dntt.rns_ntt_forward(t_mat, used_tables)   # fully reduced


def _switch_key_inner_product(t_hat: jnp.ndarray, key: jnp.ndarray,
                              cd: ContextData,
                              key_cd: ContextData) -> List[jnp.ndarray]:
    """The 128-bit dense inner product over the decomposition axis —
    ELEMENTWISE in the evaluation index, so a lane permutation commutes
    with it (the hoisted-rotation pre-permuted-key schedule relies on
    this). Returns [prods_c0, prods_c1], each (used, n) fully reduced."""
    k = cd.limbs
    n = cd.n
    kf = len(key_cd.coeff_values)
    used = list(range(k)) + [kf - 1]
    used_tables = key_cd.ntt.select(used)
    key_used = key[:k][:, :, jnp.asarray(np.array(used, dtype=np.int32)), :]
    q_used = used_tables.q.reshape(len(used), 1)
    crl = used_tables.cr_lo.reshape(len(used), 1)
    crh = used_tables.cr_hi.reshape(len(used), 1)
    prods = []
    for c in range(2):
        acc_lo = jnp.zeros((len(used), n), dtype=U64)
        acc_hi = jnp.zeros((len(used), n), dtype=U64)
        for j in range(k):
            lo, hi = u.mul128(t_hat[j], key_used[j, c])
            acc_lo, acc_hi = u.add_u128(acc_lo, acc_hi, lo, hi)
        prods.append(u.barrett_reduce_128_dyn(acc_lo, acc_hi,
                                              q_used, crl, crh))
    return prods


def _switch_key_contract(t_hat: jnp.ndarray, key: jnp.ndarray,
                         cd: ContextData,
                         key_cd: ContextData) -> jnp.ndarray:
    """Stage 2 of the key switch: the dense 128-bit inner product against
    the switching key plus the divide-by-special-prime rounding. Takes the
    decomposed digits t_hat (k, used, n) from _switch_key_decompose."""
    k = cd.limbs
    key_values = key_cd.coeff_values
    kf = len(key_values)
    p_sp = key_values[-1]
    key_tables = key_cd.ntt
    scheme = cd.scheme
    is_ntt_scheme = scheme in (SchemeType.ckks, SchemeType.bgv)

    prods = _switch_key_inner_product(t_hat, key, cd, key_cd)

    # ---- divide by the special prime, per component ----
    # The per-limb corrections run as STACKED (k, n) kernels with the
    # per-limb constants broadcast from (k, 1) arrays — one fused pass
    # instead of a chain of per-limb scalar kernels (the reference's
    # UtilE/F/G launches, evaluator_cuda.cu:1299-1361).
    key_rns = key_cd.rns_tool
    qk = cd.ntt.q.reshape(k, 1)                     # (k, 1) data moduli
    crh_k = cd.ntt.cr_hi.reshape(k, 1)
    psp_mod = np.array([p_sp % qv for qv in cd.coeff_values],
                       dtype=np.uint64).reshape(k, 1)
    outs = []
    for c in range(2):
        x = prods[c]                           # (used, n) NTT
        last = dntt.ntt_inverse_limb(x[-1], key_tables, kf - 1)
        if scheme == SchemeType.bgv:
            t_plain = int(cd.plain_modulus)
            cr_t_hi = ((1 << 128) // t_plain) >> 64
            neg_k = u.neg_mod(u.barrett_reduce_64(last, t_plain, cr_t_hi),
                              t_plain)
            if key_rns.inv_q_last_mod_t != 1:
                neg_k = drns.smul(neg_k, key_rns.inv_q_last_mod_t, t_plain)
            # delta_i = ((-c_last mod t) * q_last^-1 mod t) * (P mod q_i),
            # then temp_i = delta_i + (c_last mod q_i), all limbs at once
            delta = u.barrett_reduce_64(neg_k[None, :], qk, crh_k)
            psp_shoup = np.array(
                [u.shoup_quotient(p_sp % qv, qv) for qv in cd.coeff_values],
                dtype=np.uint64).reshape(k, 1)
            delta = u.mul_mod_shoup(delta, jnp.asarray(psp_mod),
                                    jnp.asarray(psp_shoup), qk)
            c_last = u.barrett_reduce_64(last[None, :], qk, crh_k)
            temp = u.add_mod(delta, c_last, qk)
        else:
            half = p_sp >> 1
            last = u.add_mod(last, u.u64(half), p_sp)
            half_mod = np.array([half % qv for qv in cd.coeff_values],
                                dtype=np.uint64).reshape(k, 1)
            tmp = u.barrett_reduce_64(last[None, :], qk, crh_k)
            temp = u.sub_mod(tmp, jnp.asarray(half_mod), qk)
        body = x[:-1]                          # (k, n) NTT over q_0..q_{k-1}
        if is_ntt_scheme:
            temp = dntt.rns_ntt_forward(temp, cd.ntt)
        else:
            body = dntt.rns_ntt_inverse(body, cd.ntt)
        diff = dpoly.rns_sub(body, temp, cd.ntt)
        inv_p = [numth.invert_mod(p_sp % qv, qv) for qv in cd.coeff_values]
        outs.append(dpoly.rns_scalar_mul(diff, inv_p, cd.ntt))
    return jnp.stack(outs)


def _switch_key_core(target: jnp.ndarray, key: jnp.ndarray,
                     cd: ContextData, key_cd: ContextData,
                     target_ntt_form: bool) -> jnp.ndarray:
    """The key-switch pipeline (evaluator_cuda.cu:1163-1362) as a dense
    contraction. target: (k, n) in the ciphertext's domain; key:
    (decomp_full, 2, key_full, n) NTT form. Returns (2, k, n) in the
    ciphertext's domain, to be added onto (c0, c1)."""
    t_hat = _switch_key_decompose(target, cd, key_cd, target_ntt_form)
    return _switch_key_contract(t_hat, key, cd, key_cd)



@jax.jit
def _add_ct_core(da: jnp.ndarray, db: jnp.ndarray,
                 cd: ContextData) -> jnp.ndarray:
    """Whole-ciphertext add with static size mismatch handling, fused."""
    s = min(da.shape[0], db.shape[0])
    body = _add(da[:s], db[:s], cd)
    tail = da[s:] if da.shape[0] > s else db[s:]
    return jnp.concatenate([body, tail]) if tail.shape[0] else body


@jax.jit
def _sub_ct_core(da: jnp.ndarray, db: jnp.ndarray,
                 cd: ContextData) -> jnp.ndarray:
    s = min(da.shape[0], db.shape[0])
    body = _sub(da[:s], db[:s], cd)
    tail = da[s:] if da.shape[0] > s else _negate(db[s:], cd)
    return jnp.concatenate([body, tail]) if tail.shape[0] else body


_switch_key_core_jit = jax.jit(
    _switch_key_core, static_argnames=("target_ntt_form",))


@partial(jax.jit, static_argnames=("target_ntt_form",))
def _relinearize_core(data: jnp.ndarray, keys: Tuple[jnp.ndarray, ...],
                      cd: ContextData, key_cd: ContextData,
                      target_ntt_form: bool) -> jnp.ndarray:
    """Full relinearization (size s -> 2) as ONE fused executable: every
    c_p (p >= 2) key-switched and folded into (c0, c1)
    (evaluator_cuda.cu:703 relinearizeInternal)."""
    c0, c1 = data[0], data[1]
    for i, key in enumerate(keys):
        delta = _switch_key_core(data[2 + i], key, cd, key_cd,
                                 target_ntt_form)
        c0 = _add(c0[None], delta[0][None], cd)[0]
        c1 = _add(c1[None], delta[1][None], cd)[0]
    return jnp.stack([c0, c1])


@partial(jax.jit, static_argnames=("target_ntt_form",))
def _apply_keyswitch_core(data: jnp.ndarray, key: jnp.ndarray,
                          cd: ContextData, key_cd: ContextData,
                          target_ntt_form: bool) -> jnp.ndarray:
    """Generic external key switch on a size-2 ciphertext, fused."""
    delta = _switch_key_core(data[1], key, cd, key_cd, target_ntt_form)
    c0 = _add(data[0][None], delta[0][None], cd)[0]
    return jnp.stack([c0, delta[1]])


@jax.jit
def _apply_galois_ntt_core(data: jnp.ndarray, perm: jnp.ndarray,
                           key: jnp.ndarray, cd: ContextData,
                           key_cd: ContextData) -> jnp.ndarray:
    """NTT-domain Galois: permute + key-switch + fold, one executable
    (evaluator_cuda.cu:2024 applyGaloisInplace, NTT branch)."""
    c0 = _apply_permutation(data[0], perm)
    c1 = _apply_permutation(data[1], perm)
    delta = _switch_key_core(c1, key, cd, key_cd, True)
    c0 = _add(c0[None], delta[0][None], cd)[0]
    return jnp.stack([c0, delta[1]])


@jax.jit
def _apply_galois_coeff_core(data: jnp.ndarray, src: jnp.ndarray,
                             keep: jnp.ndarray, key: jnp.ndarray,
                             cd: ContextData,
                             key_cd: ContextData) -> jnp.ndarray:
    """Coefficient-domain Galois (signed permutation), fused."""
    c0 = _apply_permutation_signed(data[0], src, keep, cd)
    c1 = _apply_permutation_signed(data[1], src, keep, cd)
    delta = _switch_key_core(c1, key, cd, key_cd, False)
    c0 = _add(c0[None], delta[0][None], cd)[0]
    return jnp.stack([c0, delta[1]])


def _batched_galois_fold(data: jnp.ndarray, src: jnp.ndarray,
                         keep: jnp.ndarray, key: jnp.ndarray,
                         cd: ContextData, key_cd: ContextData,
                         ntt_domain: bool) -> jnp.ndarray:
    """Same Galois automorphism + key switch over a BATCH of size-2
    ciphertexts: data (m, 2, k, n) -> (m, 2, k, n). The reference applies
    these one ciphertext at a time (evaluator_cuda.cu:2024); here the m
    key-switch contractions run as one vmapped executable."""
    if ntt_domain:
        c0 = _apply_permutation(data[:, 0], src)
        c1 = _apply_permutation(data[:, 1], src)
    else:
        c0 = _apply_permutation_signed(data[:, 0], src, keep, cd)
        c1 = _apply_permutation_signed(data[:, 1], src, keep, cd)
    delta = jax.vmap(
        lambda t: _switch_key_core(t, key, cd, key_cd, ntt_domain))(c1)
    out0 = dpoly.rns_add(c0, delta[:, 0], cd.ntt)
    return jnp.stack([out0, delta[:, 1]], axis=1)


@partial(jax.jit, static_argnames=("ntt_domain",))
def _hoisted_galois_core(data: jnp.ndarray, perms: Sequence[jnp.ndarray],
                         srcs: Sequence[jnp.ndarray],
                         keeps: Sequence[jnp.ndarray],
                         keys_pp: Sequence[jnp.ndarray], cd: ContextData,
                         key_cd: ContextData,
                         ntt_domain: bool) -> Tuple[jnp.ndarray, ...]:
    """HOISTED multi-automorphism (an extension — the reference key-switches
    each rotation from scratch, evaluator_cuda.cu:2024): decompose+NTT the
    target digits ONCE, then share them across every automorphism's key
    switch. Valid because digit decomposition commutes with the
    automorphism and the NTT-domain automorphism is a pure permutation.
    Saves the k x (k+1) decompose NTTs on every rotation after the first
    (the dominant cost at small k).

    Schedule: the switching keys arrive PRE-PERMUTED by the inverse
    automorphism (keys_pp; computed once per (key, element) and cached by
    the Evaluator), the WHOLE key switch — inner product AND the
    divide-by-special-prime contract — runs on un-permuted data, c0 is
    folded in un-permuted, and ONE permutation of the finished (2, k, n)
    result lands the automorphism. Validity: the inner product is
    elementwise in the evaluation index, so
        inner(perm(t_hat), key) = perm(inner(t_hat, perm_inv(key)))
    holds word-for-word, and the contract stage commutes with the
    automorphism up to rounding representatives — its eval-domain ops
    are pointwise (commute with the lane permutation) and its
    iNTT -> pointwise-coefficient -> NTT round trip conjugates the lane
    permutation to the coefficient-domain signed automorphism, which
    commutes with pointwise coefficient ops except for +-1 rounding
    choices on sign-flipped coefficients (the add-half floor picks the
    other representative). Those +-1 units sit far below the key-switch
    noise; decryption agrees (decrypt-level tests pin this). Delaying the
    permutation gathers exactly 2k rows per element, the same traffic as
    the sequential path, while still saving the per-element decompose
    NTTs. The element axis is vmapped: one executable for any m.

    NOT bit-identical to the sequential path (either domain): digit
    images and divide roundings pick different (equally small)
    representatives of the same residue classes — see above; decryption
    agrees.

    data (2, k, n); perms: m (n,) NTT-domain tables; srcs/keeps: m (n,)
    coefficient-domain tables (used when not ntt_domain); keys_pp: m
    (decomp, 2, kf, n) pre-permuted keys. Returns m (2, k, n) results.
    The per-element operands are stacked, and the results split, inside
    the program: a call is one dispatch (eager stacking cost ~6 ms per
    call at m=4, n=16384 on an H100, more than the hoist saves)."""
    t_hat = _switch_key_decompose(data[1], cd, key_cd, ntt_domain)

    def one(perm, src, keep, key_pp):
        delta = _switch_key_contract(t_hat, key_pp, cd, key_cd)
        out0 = _add(data[0][None], delta[0][None], cd)[0]
        stacked = jnp.stack([out0, delta[1]])      # un-permuted result
        if ntt_domain:
            return _apply_permutation(stacked, perm)
        return _apply_permutation_signed(stacked, src, keep, cd)

    out = jax.vmap(one)(jnp.stack(perms), jnp.stack(srcs), jnp.stack(keeps),
                        jnp.stack(keys_pp))
    return tuple(out[i] for i in range(len(perms)))


# Compile-cost guard for the pack tree: a layer's folds run in
# bounded-width vmapped dispatches, because the compile time of a vmapped
# key-switch fold grows with the batch width. Not measured on the GPU
# yet; the value comes from an earlier target. Word-neutral: same
# arithmetic, different dispatch boundaries.
_MAX_GALOIS_FOLDS_PER_DISPATCH = 2


@partial(jax.jit, static_argnames=("shift", "ntt_domain"))
def _pack_fold_prepare(cur: jnp.ndarray, cd: ContextData,
                       shift: int, ntt_domain: bool):
    """Shift/fold half of a pack-tree layer: cur (2m, 2, k, n) ->
    (even (m, 2, k, n), folded (m, 2, k, n)); folded NTT'd for NTT-form
    schemes."""
    even, odd = cur[0::2], cur[1::2]
    temp = dpoly.negacyclic_shift(odd, shift, cd.ntt)
    folded = dpoly.rns_sub(even, temp, cd.ntt)
    even = dpoly.rns_add(even, temp, cd.ntt)
    if ntt_domain:
        folded = dntt.rns_ntt_forward(folded, cd.ntt)
    return even, folded


@partial(jax.jit, static_argnames=("ntt_domain",))
def _batched_galois_fold_jit(folded: jnp.ndarray, src: jnp.ndarray,
                             keep: jnp.ndarray, key: jnp.ndarray,
                             cd: ContextData, key_cd: ContextData,
                             ntt_domain: bool) -> jnp.ndarray:
    return _batched_galois_fold(folded, src, keep, key, cd, key_cd,
                                ntt_domain)


@partial(jax.jit, static_argnames=("ntt_domain",))
def _pack_fold_finish(even: jnp.ndarray, rotated: jnp.ndarray,
                      cd: ContextData, ntt_domain: bool) -> jnp.ndarray:
    if ntt_domain:
        rotated = dntt.rns_ntt_inverse(rotated, cd.ntt)
    return dpoly.rns_add(even, rotated, cd.ntt)


def _pack_tree_layer_core(cur: jnp.ndarray, src: jnp.ndarray,
                          keep: jnp.ndarray, key: jnp.ndarray,
                          cd: ContextData, key_cd: ContextData,
                          shift: int, ntt_domain: bool) -> jnp.ndarray:
    """One layer of the LWE packing tree (evaluator_cuda.cu:2278-2341),
    batched over every (even, odd) pair: cur (2m, 2, k, n) coefficient
    domain -> (m, 2, k, n). even + odd*x^shift + phi(even - odd*x^shift),
    the m Galois key-switches batched in bounded-width dispatches (see
    _MAX_GALOIS_FOLDS_PER_DISPATCH)."""
    even, folded = _pack_fold_prepare(cur, cd, shift, ntt_domain)
    m = folded.shape[0]
    step = max(1, _MAX_GALOIS_FOLDS_PER_DISPATCH)
    parts = [_batched_galois_fold_jit(folded[i:i + step], src, keep, key,
                                      cd, key_cd, ntt_domain)
             for i in range(0, m, step)]
    rotated = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return _pack_fold_finish(even, rotated, cd, ntt_domain)


@partial(jax.jit, static_argnames=("mul", "ntt_domain"))
def _field_trace_batch_core(data: jnp.ndarray,
                            srcs: Tuple[jnp.ndarray, ...],
                            keeps: Tuple[jnp.ndarray, ...],
                            keys: Tuple[jnp.ndarray, ...],
                            cd: ContextData, key_cd: ContextData,
                            mul: int, ntt_domain: bool) -> jnp.ndarray:
    """Field trace over a batch (evaluator_cuda.cu:2251-2261): the full
    sequence of fold-with-automorphism steps as ONE executable. data
    (m, 2, k, n); srcs/keeps/keys are the per-step permutation tables and
    Galois keys, outermost element first. `mul` scales by n^{-1}*mul
    beforehand (divideByPolyModulusDegreeInplace fused in; 0 = skip)."""
    if mul:
        scalars = [numth.invert_mod(cd.n, q) * mul % q
                   for q in cd.coeff_values]
        data = dpoly.rns_scalar_mul(data, scalars, cd.ntt)
    for src, keep, key in zip(srcs, keeps, keys):
        rotated = _batched_galois_fold(data, src, keep, key, cd, key_cd,
                                       ntt_domain)
        data = dpoly.rns_add(data, rotated, cd.ntt)
    return data


@jax.jit
def _extract_lwe_many_core(data: jnp.ndarray, terms: jnp.ndarray,
                           cd: ContextData):
    """Batched extractLWE with TRACED shift amounts: data (2, k, n),
    terms (m,) int32 -> (c1s (m, k, n), c0s (m, k)). Mirrors
    ops/poly.negacyclic_shift's semantics (shift = 2n - term) with the
    shift as a dynamic value so one executable serves every term."""
    n = cd.n
    q = cd.ntt.q.reshape(-1, 1)
    x = data[1]
    neg = jnp.where(x == jnp.uint64(0), x, q - x)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)

    def one(term):
        shift = jnp.where(term == 0, 0, 2 * n - term)
        s = shift % n
        rolled = jnp.roll(x, s, axis=-1)
        rolled_neg = jnp.roll(neg, s, axis=-1)
        wrapped = idx < s
        flip = jnp.where(shift < n, wrapped, ~wrapped)
        c1 = jnp.where(flip, rolled_neg, rolled)
        c0 = jax.lax.dynamic_slice_in_dim(data[0], term, 1, axis=1)[:, 0]
        return c1, c0

    return jax.vmap(one)(terms)


@jax.jit
def _pack_assemble_core(c1s: jnp.ndarray, c0s: jnp.ndarray,
                        cd: ContextData) -> jnp.ndarray:
    """Batched assembleLWE at term 0 + divide by n
    (evaluator_cuda.cu:2185-2207, :2266-2276): c1s (m, k, n), c0s (m, k)
    -> (m, 2, k, n) coefficient-domain ciphertexts."""
    m, k, n = c1s.shape
    d0 = jnp.zeros((m, k, n), dtype=U64).at[:, :, 0].set(c0s)
    data = jnp.stack([d0, c1s], axis=1)
    inv_n = [numth.invert_mod(n, q) for q in cd.coeff_values]
    return dpoly.rns_scalar_mul(data, inv_n, cd.ntt)


@jax.jit
def _bfv_mod_switch_scale(data: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    outs = [drns.divide_and_round_q_last(data[i], cd.rns_tool)
            for i in range(data.shape[0])]
    return jnp.stack(outs)


@jax.jit
def _ckks_rescale(data: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    outs = [drns.divide_and_round_q_last_ntt(data[i], cd.rns_tool, cd.ntt)
            for i in range(data.shape[0])]
    return jnp.stack(outs)


@jax.jit
def _bgv_mod_switch_scale(data: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    outs = [drns.mod_t_and_divide_q_last_ntt(data[i], cd.rns_tool, cd.ntt)
            for i in range(data.shape[0])]
    return jnp.stack(outs)


@jax.jit
def _plain_to_ntt(m: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    """Lift a mod-t plaintext to RNS with centered correction and NTT it
    (evaluator transformToNtt on plaintexts)."""
    lifted = dpoly.plain_lift(m, cd.ntt, int(cd.plain_modulus),
                              cd.plain_upper_half_threshold,
                              cd.total_coeff_modulus)
    return dntt.rns_ntt_forward(lifted, cd.ntt)


@jax.jit
def _multiply_plain_ntt(data: jnp.ndarray, plain_ntt: jnp.ndarray,
                        cd: ContextData) -> jnp.ndarray:
    outs = [dntt.rns_dyadic_mul(data[i], plain_ntt, cd.ntt)
            for i in range(data.shape[0])]
    return jnp.stack(outs)


@jax.jit
def _bfv_multiply_plain(data: jnp.ndarray, m: jnp.ndarray,
                        cd: ContextData) -> jnp.ndarray:
    """BFV coeff-domain ct x mod-t plain (multiplyPlainNormal path):
    lift+NTT the plaintext, NTT the ciphertext, dyadic, back."""
    plain_ntt = _plain_to_ntt(m, cd)
    outs = []
    for i in range(data.shape[0]):
        ci = dntt.rns_ntt_forward(data[i], cd.ntt, lazy=True)
        ci = dntt.rns_dyadic_mul(ci, plain_ntt, cd.ntt)
        outs.append(dntt.rns_ntt_inverse(ci, cd.ntt))
    return jnp.stack(outs)


def _bfv_add_plain(data: jnp.ndarray, m: jnp.ndarray, cd: ContextData,
                   subtract: bool = False) -> jnp.ndarray:
    c0 = dpoly.bfv_multiply_add_plain(
        m, data[0], int(cd.plain_modulus),
        cd.coeff_modulus_mod_plain_modulus,
        cd.coeff_div_plain_modulus, cd.ntt, subtract=subtract)
    return data.at[0].set(c0)


_bfv_add_plain_jit = jax.jit(_bfv_add_plain, static_argnames=("subtract",))


@partial(jax.jit, static_argnames=("subtract",))
def _add_plain_ntt_core(data: jnp.ndarray, m: jnp.ndarray, cd: ContextData,
                        subtract: bool = False) -> jnp.ndarray:
    """CKKS add/sub of an NTT-form plaintext onto c0, fused to one
    executable (evaluator_cuda.cuh addPlain for NTT-form cts)."""
    op = dpoly.rns_sub if subtract else dpoly.rns_add
    return data.at[0].set(op(data[0], m, cd.ntt))


@partial(jax.jit, static_argnames=("correction_factor", "subtract"))
def _bgv_add_plain_core(data: jnp.ndarray, m: jnp.ndarray, cd: ContextData,
                        correction_factor: int = 1,
                        subtract: bool = False) -> jnp.ndarray:
    """BGV add/sub of a mod-t plaintext: scale by the correction factor,
    centered-lift, NTT, add onto c0 — one fused executable."""
    t = int(cd.plain_modulus)
    if correction_factor != 1:
        m = drns.smul(m, correction_factor, t)
    m_ntt = _plain_to_ntt.__wrapped__(m, cd)
    op = dpoly.rns_sub if subtract else dpoly.rns_add
    return data.at[0].set(op(data[0], m_ntt, cd.ntt))


@jax.jit
def _transform_to_ntt(data: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return dntt.rns_ntt_forward(data, cd.ntt)


@jax.jit
def _transform_from_ntt(data: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    return dntt.rns_ntt_inverse(data, cd.ntt)


@jax.jit
def _apply_permutation_signed(data: jnp.ndarray, src: jnp.ndarray,
                              keep_sign: jnp.ndarray,
                              cd: ContextData) -> jnp.ndarray:
    """Coefficient-domain automorphism: gather + conditional negate."""
    gathered = jnp.take(data, src, axis=-1)
    q = cd.ntt.q.reshape((1,) * (data.ndim - 2) + (cd.limbs, 1))
    neg = jnp.where(gathered == jnp.uint64(0), gathered, q - gathered)
    return jnp.where(keep_sign, gathered, neg)


@jax.jit
def _apply_permutation(data: jnp.ndarray, perm: jnp.ndarray) -> jnp.ndarray:
    return jnp.take(data, perm, axis=-1)


# ==========================================================================
# host-side helpers
# ==========================================================================

def _balance_correction_factors(f1: int, f2: int, t: int
                                ) -> Tuple[int, int, int]:
    """BGV correction-factor balancing (evaluator_cuda.cu:53-70): find a
    small centered pair (e1, e2) with e1*f1 = e2*f2 mod t via the extended
    Euclid walk on (t, f2/f1); returns (new_factor, e1, e2)."""
    if f1 == f2:
        return f1, 1, 1
    ratio = f2 * numth.invert_mod(f1 % t, t) % t

    def cost(x):
        x %= t
        return min(x, t - x)

    best_e1, best_e2 = ratio, 1
    best = cost(ratio) + cost(1)
    prev_r, r = t, ratio
    prev_s, s = 0, 1
    while r != 0:
        q = prev_r // r
        prev_r, r = r, prev_r - q * r
        prev_s, s = s, prev_s - q * s
        if r == 0:
            break
        e1, e2 = r % t, s % t
        if numth.gcd(e2, t) == 1:
            c = cost(e1) + cost(e2)
            if c < best:
                best, best_e1, best_e2 = c, e1, e2
    f_new = best_e1 * f1 % t
    return f_new, best_e1, best_e2


# ==========================================================================
# the Evaluator
# ==========================================================================

class Evaluator:
    """(evaluator.h:72 / evaluator_cuda.cuh:13-361)"""

    def __init__(self, context: HeContext):
        self.context = context
        # hoisted-rotation pre-permuted switching keys: (id(key), elt) ->
        # (source key array, permuted copy); identity-checked on every
        # hit so a different GaloisKeys object never serves a stale
        # entry; LRU-bounded (PP_KEY_CACHE_MAX)
        from collections import OrderedDict
        self._pp_keys = OrderedDict()

    # ---- helpers ----
    def _cd(self, ct: Ciphertext) -> ContextData:
        return self.context.get_context_data(ct.level)

    def _check_same(self, a: Ciphertext, b: Ciphertext):
        if a.level != b.level:
            raise ValueError("ciphertexts are at different chain levels")
        if a.is_ntt_form != b.is_ntt_form:
            raise ValueError("NTT form mismatch")

    # ---- negate / add / sub (evaluator_cuda.cuh:18-47) ----
    def negate(self, ct: Ciphertext) -> Ciphertext:
        return ct.replace(data=_negate(ct.data, self._cd(ct)), seed=0)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        scheme = cd.scheme
        if scheme == SchemeType.ckks and not _scales_close(a.scale, b.scale):
            raise ValueError("CKKS scales mismatch in add")
        cf = 1
        da, db = a.data, b.data
        if scheme == SchemeType.bgv and a.correction_factor != b.correction_factor:
            t = int(cd.plain_modulus)
            cf, e1, e2 = _balance_correction_factors(
                a.correction_factor, b.correction_factor, t)
            da = dpoly.rns_broadcast_scalar_mul(da, e1, cd.ntt)
            db = dpoly.rns_broadcast_scalar_mul(db, e2, cd.ntt)
        elif scheme == SchemeType.bgv:
            cf = a.correction_factor
        data = _add_ct_core(da, db, cd)
        return a.replace(data=data, correction_factor=cf, seed=0)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        scheme = cd.scheme
        if scheme == SchemeType.ckks and not _scales_close(a.scale, b.scale):
            raise ValueError("CKKS scales mismatch in sub")
        cf = 1
        da, db = a.data, b.data
        if scheme == SchemeType.bgv and a.correction_factor != b.correction_factor:
            t = int(cd.plain_modulus)
            cf, e1, e2 = _balance_correction_factors(
                a.correction_factor, b.correction_factor, t)
            da = dpoly.rns_broadcast_scalar_mul(da, e1, cd.ntt)
            db = dpoly.rns_broadcast_scalar_mul(db, e2, cd.ntt)
        elif scheme == SchemeType.bgv:
            cf = a.correction_factor
        data = _sub_ct_core(da, db, cd)
        return a.replace(data=data, correction_factor=cf, seed=0)

    def add_many(self, cts: Sequence[Ciphertext]) -> Ciphertext:
        acc = cts[0]
        for c in cts[1:]:
            acc = self.add(acc, c)
        return acc

    # ---- multiply / square (evaluator_cuda.cu:262-432) ----
    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check_same(a, b)
        cd = self._cd(a)
        scheme = cd.scheme
        if scheme == SchemeType.bfv:
            if a.is_ntt_form:
                raise ValueError("BFV multiply expects coefficient form")
            data = _bfv_multiply(a.data, b.data, cd)
            return a.replace(data=data, seed=0)
        if scheme == SchemeType.ckks:
            data = _ntt_form_multiply(a.data, b.data, cd)
            return a.replace(data=data, scale=a.scale * b.scale, seed=0)
        if scheme == SchemeType.bgv:
            data = _ntt_form_multiply(a.data, b.data, cd)
            t = int(cd.plain_modulus)
            cf = a.correction_factor * b.correction_factor % t
            return a.replace(data=data, correction_factor=cf, seed=0)
        raise ValueError("unsupported scheme")

    def square(self, a: Ciphertext) -> Ciphertext:
        """Dedicated square pipeline for size-2 ciphertexts — one BEHZ
        lift and 3 dyadic products instead of multiply's two lifts and 4
        (evaluator_cuda.cu:503-700 squareInplace / bfv|ckks|bgvSquare).
        Larger sizes fall back to multiply, like the reference."""
        if a.size != 2:
            return self.multiply(a, a)
        cd = self._cd(a)
        scheme = cd.scheme
        if scheme == SchemeType.bfv:
            if a.is_ntt_form:
                raise ValueError("BFV square expects coefficient form")
            return a.replace(data=_bfv_square(a.data, cd), seed=0)
        if scheme == SchemeType.ckks:
            return a.replace(data=_ntt_form_square(a.data, cd),
                             scale=a.scale * a.scale, seed=0)
        if scheme == SchemeType.bgv:
            t = int(cd.plain_modulus)
            cf = a.correction_factor * a.correction_factor % t
            return a.replace(data=_ntt_form_square(a.data, cd),
                             correction_factor=cf, seed=0)
        raise ValueError("unsupported scheme")

    def multiply_many(self, cts: Sequence[Ciphertext],
                      relin_keys: RelinKeys) -> Ciphertext:
        """Balanced product tree (evaluator.h multiplyMany)."""
        layer = list(cts)
        while len(layer) > 1:
            nxt = []
            for i in range(0, len(layer) - 1, 2):
                prod = self.relinearize(self.multiply(layer[i], layer[i + 1]),
                                        relin_keys)
                nxt.append(prod)
            if len(layer) % 2:
                nxt.append(layer[-1])
            layer = nxt
        return layer[0]

    def exponentiate(self, ct: Ciphertext, power: int,
                     relin_keys: RelinKeys) -> Ciphertext:
        if power < 1:
            raise ValueError("power must be >= 1")
        return self.multiply_many([ct] * power, relin_keys)

    # ---- key switching (evaluator_cuda.cu:1163-1362) ----
    def apply_keyswitching(self, ct: Ciphertext,
                           kswitch_keys: KSwitchKeys) -> Ciphertext:
        """Generic external key switch: ct must have size 2; switches the
        c1 component under keys[1] (evaluator_cuda.cuh applyKeySwitching)."""
        if ct.size != 2:
            raise ValueError("key switching expects size-2 ciphertexts")
        cd = self._cd(ct)
        data = _apply_keyswitch_core(
            ct.data, kswitch_keys.keys[1], cd,
            self.context.key_context_data, ct.is_ntt_form)
        return ct.replace(data=data, seed=0)

    def relinearize(self, ct: Ciphertext, relin_keys: RelinKeys) -> Ciphertext:
        """Reduce ciphertext size back to 2 (evaluator_cuda.cu:703)."""
        if ct.size == 2:
            return ct
        cd = self._cd(ct)
        key_cd = self.context.key_context_data
        keys = tuple(relin_keys.keys[p] for p in range(2, ct.size))
        data = _relinearize_core(ct.data, keys, cd, key_cd, ct.is_ntt_form)
        return ct.replace(data=data, seed=0)

    # ---- modulus switching / rescaling (evaluator_cuda.cu:749+) ----
    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        cd = self._cd(ct)
        if ct.level >= self.context.last_level:
            raise ValueError("already at the last level")
        scheme = cd.scheme
        if scheme == SchemeType.bfv:
            data = _bfv_mod_switch_scale(ct.data, cd)
            return ct.replace(data=data, level=ct.level + 1, seed=0)
        if scheme == SchemeType.ckks:
            # drop the last limb without scaling
            data = ct.data[:, :-1, :]
            return ct.replace(data=data, level=ct.level + 1, seed=0)
        if scheme == SchemeType.bgv:
            data = _bgv_mod_switch_scale(ct.data, cd)
            t = int(cd.plain_modulus)
            cf = ct.correction_factor * cd.rns_tool.inv_q_last_mod_t % t
            return ct.replace(data=data, level=ct.level + 1,
                              correction_factor=cf, seed=0)
        raise ValueError("unsupported scheme")

    def mod_switch_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        if level < ct.level:
            raise ValueError("cannot switch to a higher level")
        while ct.level < level:
            ct = self.mod_switch_to_next(ct)
        return ct

    def mod_switch_plain_to_next(self, plain: Plaintext) -> Plaintext:
        if not plain.is_ntt_form or plain.level is None:
            raise ValueError("only NTT-form plaintexts carry levels")
        return plain.replace(data=plain.data[:-1, :], level=plain.level + 1)

    def mod_switch_plain_to(self, plain: Plaintext, level: int) -> Plaintext:
        while plain.level < level:
            plain = self.mod_switch_plain_to_next(plain)
        return plain

    def rescale_to_next(self, ct: Ciphertext) -> Ciphertext:
        cd = self._cd(ct)
        if cd.scheme != SchemeType.ckks:
            raise ValueError("rescale is CKKS-only")
        if ct.level >= self.context.last_level:
            raise ValueError("already at the last level")
        data = _ckks_rescale(ct.data, cd)
        new_scale = ct.scale / cd.coeff_values[-1]
        return ct.replace(data=data, level=ct.level + 1, scale=new_scale,
                          seed=0)

    def rescale_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        while ct.level < level:
            ct = self.rescale_to_next(ct)
        return ct

    # ---- plaintext ops (evaluator_cuda.cuh:160-260) ----
    def add_plain(self, ct: Ciphertext, plain: Plaintext,
                  subtract: bool = False) -> Ciphertext:
        cd = self._cd(ct)
        scheme = cd.scheme
        if scheme == SchemeType.bfv:
            if plain.is_ntt_form:
                raise ValueError("BFV add_plain expects mod-t plaintext")
            data = _bfv_add_plain_jit(ct.data, plain.data, cd,
                                      subtract=subtract)
            return ct.replace(data=data, seed=0)
        if scheme == SchemeType.ckks:
            if not plain.is_ntt_form or plain.level != ct.level:
                raise ValueError("CKKS plain must be NTT form at ct level")
            if not _scales_close(ct.scale, plain.scale):
                raise ValueError("CKKS scales mismatch in add_plain")
            data = _add_plain_ntt_core(ct.data, plain.data, cd,
                                       subtract=subtract)
            return ct.replace(data=data, seed=0)
        if scheme == SchemeType.bgv:
            if plain.is_ntt_form:
                raise ValueError("BGV add_plain expects mod-t plaintext")
            data = _bgv_add_plain_core(ct.data, plain.data, cd,
                                       correction_factor=ct.correction_factor,
                                       subtract=subtract)
            return ct.replace(data=data, seed=0)
        raise ValueError("unsupported scheme")

    def sub_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        return self.add_plain(ct, plain, subtract=True)

    def multiply_plain(self, ct: Ciphertext, plain: Plaintext) -> Ciphertext:
        cd = self._cd(ct)
        scheme = cd.scheme
        if scheme == SchemeType.bfv and not ct.is_ntt_form:
            if plain.is_ntt_form:
                # pre-transformed plaintext: NTT the ct transiently
                # (evaluator.cpp multiplyPlainNtt semantics on a coeff ct)
                ntt = _transform_to_ntt(ct.data, cd)
                data = _transform_from_ntt(
                    _multiply_plain_ntt(ntt, plain.data, cd), cd)
                return ct.replace(data=data, seed=0)
            data = _bfv_multiply_plain(ct.data, plain.data, cd)
            return ct.replace(data=data, seed=0)
        if scheme == SchemeType.ckks:
            if not plain.is_ntt_form or plain.level != ct.level:
                raise ValueError("CKKS plain must be NTT form at ct level")
            data = _multiply_plain_ntt(ct.data, plain.data, cd)
            return ct.replace(data=data, scale=ct.scale * plain.scale, seed=0)
        if scheme == SchemeType.bgv:
            if plain.is_ntt_form:
                # pre-lifted plaintext (multiplyPlainNtt)
                if plain.level != ct.level:
                    raise ValueError("NTT-form plaintext level mismatch")
                m_ntt = plain.data
            else:
                m_ntt = _plain_to_ntt(plain.data, cd)
            data = _multiply_plain_ntt(ct.data, m_ntt, cd)
            return ct.replace(data=data, seed=0)
        # BFV ct in NTT form with NTT plaintext
        if not plain.is_ntt_form or plain.level != ct.level:
            raise ValueError("need NTT-form plaintext at ct level")
        data = _multiply_plain_ntt(ct.data, plain.data, cd)
        return ct.replace(data=data, seed=0)

    # ---- NTT transforms (evaluator_cuda.cuh transformToNtt/FromNtt) ----
    def transform_to_ntt(self, ct: Ciphertext) -> Ciphertext:
        if ct.is_ntt_form:
            raise ValueError("already NTT form")
        cd = self._cd(ct)
        return ct.replace(data=_transform_to_ntt(ct.data, cd),
                          is_ntt_form=True, seed=0)

    def transform_from_ntt(self, ct: Ciphertext) -> Ciphertext:
        if not ct.is_ntt_form:
            raise ValueError("not in NTT form")
        cd = self._cd(ct)
        return ct.replace(data=_transform_from_ntt(ct.data, cd),
                          is_ntt_form=False, seed=0)

    def transform_plain_to_ntt(self, plain: Plaintext, level: int) -> Plaintext:
        """Lift + NTT a mod-t plaintext at a chain level (for repeated
        multiply_plain)."""
        if plain.is_ntt_form:
            raise ValueError("already NTT form")
        cd = self.context.get_context_data(level)
        return Plaintext(data=_plain_to_ntt(plain.data, cd), level=level,
                         is_ntt_form=True, scale=plain.scale)

    # ---- Galois / rotations (evaluator_cuda.cu:2024-2150) ----
    def apply_galois(self, ct: Ciphertext, elt: int,
                     galois_keys: GaloisKeys) -> Ciphertext:
        if ct.size != 2:
            raise ValueError("apply_galois expects size-2 ciphertexts "
                             "(relinearize first)")
        cd = self._cd(ct)
        n = cd.n
        if not galois_keys.has_key(elt):
            raise ValueError(f"Galois key for element {elt} not present")
        key = galois_keys.keys[elt]
        key_cd = self.context.key_context_data
        if ct.is_ntt_form:
            perm = galois_util.ntt_permutation_dev(n, elt)
            data = _apply_galois_ntt_core(ct.data, perm, key, cd, key_cd)
        else:
            src_j, keep_j = galois_util.coeff_permutation_dev(n, elt)
            data = _apply_galois_coeff_core(ct.data, src_j, keep_j, key,
                                            cd, key_cd)
        return ct.replace(data=data, seed=0)

    # Bound on cached pre-permuted switching keys: each entry pins the
    # source key AND its permuted copy in HBM (~11 MB each at n=16384,
    # kf=6), so the cache is LRU-bounded; raise it for wide BSGS
    # transforms on memory-rich chips.
    PP_KEY_CACHE_MAX = 32

    def _prepermuted_key(self, galois_keys: GaloisKeys, elt: int,
                         n: int) -> jnp.ndarray:
        """Switching key for `elt` permuted by the INVERSE automorphism
        along the evaluation axis, LRU-cached per (key object, elt) — the
        hoisted schedule's per-element setup (one lane gather of the key,
        done once; a cache entry costs one key's worth of HBM). The key
        object is identity-checked on every hit, so distinct GaloisKeys
        sharing an element each get their own entry and a regenerated
        key never serves a stale permutation."""
        src = galois_keys.keys[elt]
        cache_key = (id(src), elt)
        hit = self._pp_keys.get(cache_key)
        if hit is not None and hit[0] is src:
            self._pp_keys.move_to_end(cache_key)
            return hit[1]
        perm = np.asarray(galois_util.ntt_permutation_dev(n, elt))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=perm.dtype)
        pp = jnp.take(src, jnp.asarray(inv), axis=-1)
        self._pp_keys[cache_key] = (src, pp)
        while len(self._pp_keys) > self.PP_KEY_CACHE_MAX:
            self._pp_keys.popitem(last=False)
        return pp

    def apply_galois_many(self, ct: Ciphertext, elts: Sequence[int],
                          galois_keys: GaloisKeys) -> List[Ciphertext]:
        """Hoisted multi-automorphism: the digit decomposition + NTT of c1
        is computed once and shared by every element's key switch — an
        extension beyond the reference, which re-decomposes per rotation
        (evaluator_cuda.cu:2024). The keys arrive pre-permuted by the
        inverse automorphism (cached per (key, elt)); the whole key
        switch runs un-permuted and one output permutation lands the
        automorphism (validity in _hoisted_galois_core).

        One element runs the fused single-automorphism program; two or
        more run the hoisted vmap schedule (_hoisted_galois_core), one
        executable for any m. BFV n=16384, q={60,40,40,40,40,60},
        coefficient form, NVIDIA H100 80GB HBM3 at a 400 W limit, median
        ms per call of m automorphisms: m=1 fused 0.405 / vmap 0.493;
        m=2 0.574 / 0.438; m=4 1.416 / 0.423; m=16 5.293 / 1.037. A
        second schedule (decompose once, then one contract dispatch per
        element) lost at every m there (2.0-21.8 ms) and was removed."""
        if ct.size != 2:
            raise ValueError("apply_galois_many expects size-2 ciphertexts "
                             "(relinearize first)")
        if not elts:
            return []
        for elt in elts:
            if not galois_keys.has_key(elt):
                raise ValueError(f"Galois key for element {elt} not present")
        cd = self._cd(ct)
        n = cd.n
        key_cd = self.context.key_context_data
        if len(elts) == 1:
            # the hoist saves nothing for one element, and its pre-permuted
            # key would be built for nothing
            return [self.apply_galois(ct, elts[0], galois_keys)]
        keys_pp = [self._prepermuted_key(galois_keys, elt, n)
                   for elt in elts]
        perms = [galois_util.ntt_permutation_dev(n, elt) for elt in elts]
        if ct.is_ntt_form:
            srcs = keeps = perms   # unused in the NTT-domain branch
        else:
            pairs = [galois_util.coeff_permutation_dev(n, elt)
                     for elt in elts]
            srcs = [p[0] for p in pairs]
            keeps = [p[1] for p in pairs]
        outs = _hoisted_galois_core(ct.data, perms, srcs, keeps, keys_pp,
                                    cd, key_cd, ct.is_ntt_form)
        return [ct.replace(data=o, seed=0) for o in outs]

    def rotate_many(self, ct: Ciphertext, steps: Sequence[int],
                    galois_keys: GaloisKeys) -> List[Ciphertext]:
        """Hoisted multi-rotation of ONE ciphertext by several step counts
        (rows for BFV/BGV, vector for CKKS). Steps whose exact Galois key
        is present share one hoisted decomposition; the rest (and step 0)
        fall back to the sequential NAF path."""
        n = self.context.n
        direct = [(i, galois_util.get_elt_from_step(n, s))
                  for i, s in enumerate(steps)
                  if s != 0 and galois_keys.has_key(
                      galois_util.get_elt_from_step(n, s))]
        results: List[Optional[Ciphertext]] = [None] * len(steps)
        if direct:
            rotated = self.apply_galois_many(
                ct, [elt for _, elt in direct], galois_keys)
            for (i, _), r in zip(direct, rotated):
                results[i] = r
        for i, s in enumerate(steps):
            if results[i] is None:
                # step 0: a fresh object, not the caller's input, so every
                # output is independently mutable (ADVICE r4)
                results[i] = ct.replace() if s == 0 else \
                    self._rotate_internal(ct, s, galois_keys)
        return results

    def _rotate_internal(self, ct: Ciphertext, steps: int,
                         galois_keys: GaloisKeys) -> Ciphertext:
        if steps == 0:
            return ct
        n = self.context.n
        elt = galois_util.get_elt_from_step(n, steps)
        if galois_keys.has_key(elt):
            return self.apply_galois(ct, elt, galois_keys)
        # NAF-decompose into power-of-two hops (evaluator_cuda.cu:2150+)
        parts = [p for p in numth.naf(steps) if p != 0]
        if parts == [steps]:
            raise ValueError(f"Galois key for rotation step {steps} "
                             "not present")
        for part in parts:
            ct = self._rotate_internal(ct, part, galois_keys)
        return ct

    def rotate_rows(self, ct: Ciphertext, steps: int,
                    galois_keys: GaloisKeys) -> Ciphertext:
        if self.context.scheme not in (SchemeType.bfv, SchemeType.bgv):
            raise ValueError("rotate_rows is BFV/BGV-only")
        return self._rotate_internal(ct, steps, galois_keys)

    def rotate_columns(self, ct: Ciphertext,
                       galois_keys: GaloisKeys) -> Ciphertext:
        if self.context.scheme not in (SchemeType.bfv, SchemeType.bgv):
            raise ValueError("rotate_columns is BFV/BGV-only")
        return self.apply_galois(ct, 2 * self.context.n - 1, galois_keys)

    def rotate_vector(self, ct: Ciphertext, steps: int,
                      galois_keys: GaloisKeys) -> Ciphertext:
        if self.context.scheme != SchemeType.ckks:
            raise ValueError("rotate_vector is CKKS-only")
        return self._rotate_internal(ct, steps, galois_keys)

    def complex_conjugate(self, ct: Ciphertext,
                          galois_keys: GaloisKeys) -> Ciphertext:
        if self.context.scheme != SchemeType.ckks:
            raise ValueError("complex_conjugate is CKKS-only")
        return self.apply_galois(ct, 2 * self.context.n - 1, galois_keys)

    # ---- negacyclic shift (evaluator_cuda.cuh negacyclicShift) ----
    def negacyclic_shift(self, ct: Ciphertext, shift: int) -> Ciphertext:
        cd = self._cd(ct)
        if ct.is_ntt_form:
            raise ValueError("negacyclic shift expects coefficient form")
        data = dpoly.negacyclic_shift(ct.data, shift, cd.ntt)
        return ct.replace(data=data, seed=0)

    # ---- LWE extraction / packing (troy extensions,
    #      evaluator_cuda.cu:2185-2341) ----
    def extract_lwe(self, ct: Ciphertext, term: int) -> LWECiphertext:
        """Extract coefficient `term` as an LWE sample
        (evaluator_cuda.cu:2216-2249 extractLWE)."""
        if ct.size != 2:
            raise ValueError("extract_lwe expects size-2 ciphertexts")
        if ct.is_ntt_form:
            return self.extract_lwe(self.transform_from_ntt(ct), term)
        cd = self._cd(ct)
        n = cd.n
        shift = 0 if term == 0 else 2 * n - term
        c1 = dpoly.negacyclic_shift(ct.data[1], shift, cd.ntt)
        c0 = ct.data[0][:, term]
        return LWECiphertext(c1=c1, c0=c0, level=ct.level, scale=ct.scale,
                             correction_factor=ct.correction_factor)

    def extract_lwe_many(self, ct: Ciphertext,
                         terms: Sequence[int]) -> List[LWECiphertext]:
        """Batched extractLWE: all terms in ONE executable with the
        negacyclic shift amount as a traced value, so extracting m
        coefficients costs one dispatch (and one compile for any m of
        the same count) instead of m distinct static-shift programs —
        the shape the app layer's output packing consumes
        (evaluator_cuda.cu:2216-2249 extractLWE, looped by
        LinearHelper.cuh packOutputs:592-650)."""
        if ct.size != 2:
            raise ValueError("extract_lwe expects size-2 ciphertexts")
        if ct.is_ntt_form:
            return self.extract_lwe_many(self.transform_from_ntt(ct), terms)
        cd = self._cd(ct)
        bad = [t for t in terms if not 0 <= t < cd.n]
        if bad:
            raise ValueError(f"extract_lwe_many terms out of [0, {cd.n}): "
                             f"{bad[:4]}")
        t_arr = jnp.asarray(np.array(terms, dtype=np.int32))
        c1s, c0s = _extract_lwe_many_core(ct.data, t_arr, cd)
        return [LWECiphertext(c1=c1s[i], c0=c0s[i], level=ct.level,
                              scale=ct.scale,
                              correction_factor=ct.correction_factor)
                for i in range(len(terms))]

    def assemble_lwe(self, lwe: LWECiphertext, term: int = 0) -> Ciphertext:
        """Re-embed an LWE sample as an RLWE ciphertext whose coefficient
        `term` carries the value (evaluator_cuda.cu:2185-2207)."""
        cd = self.context.get_context_data(lwe.level)
        n = cd.n
        c1 = dpoly.negacyclic_shift(lwe.c1, term, cd.ntt)
        c0 = jnp.zeros((cd.limbs, n), dtype=jnp.uint64).at[:, term].set(lwe.c0)
        data = jnp.stack([c0, c1])
        return Ciphertext(data=data, level=lwe.level, is_ntt_form=False,
                          scale=lwe.scale,
                          correction_factor=lwe.correction_factor)

    def divide_by_poly_modulus_degree(self, ct: Ciphertext,
                                      mul: int = 1) -> Ciphertext:
        """Multiply every coefficient by n^{-1} (times mul)
        (evaluator_cuda.cu:2266-2276)."""
        cd = self._cd(ct)
        n = cd.n
        scalars = [numth.invert_mod(n, q) * mul % q for q in cd.coeff_values]
        return ct.replace(data=dpoly.rns_scalar_mul(ct.data, scalars, cd.ntt),
                          seed=0)

    def _field_trace_steps(self, automorphism_keys: GaloisKeys, logn: int,
                           ntt_domain: bool):
        """Per-step (src, keep, key) tables for the trace automorphisms
        x -> x^(m/2^i + 1), outermost first."""
        n = self.context.n
        srcs, keeps, keys = [], [], []
        poly_degree = n
        while poly_degree > (1 << logn):
            elt = poly_degree + 1
            if not automorphism_keys.has_key(elt):
                raise ValueError(f"Galois key for element {elt} not present")
            if ntt_domain:
                src = galois_util.ntt_permutation_dev(n, elt)
                keep = src
            else:
                src, keep = galois_util.coeff_permutation_dev(n, elt)
            srcs.append(src)
            keeps.append(keep)
            keys.append(automorphism_keys.keys[elt])
            poly_degree >>= 1
        return tuple(srcs), tuple(keeps), tuple(keys)

    def field_trace(self, ct: Ciphertext, automorphism_keys: GaloisKeys,
                    logn: int = 0) -> Ciphertext:
        """Trace down to the subfield of degree 2^logn: repeatedly fold with
        the automorphism x -> x^(m/2^i + 1) (evaluator_cuda.cu:2251-2261).
        Annihilates all coefficients except multiples of n/2^logn, scaling
        the survivors by n/2^logn. Fold steps run in bounded-length
        dispatches: XLA's compile time grows superlinearly in the number
        of chained key switches per program (a full n=16384 trace chains
        10 — unbounded it takes tens of minutes to compile), and the
        chunking is word-neutral."""
        if ct.size != 2:
            raise ValueError("field_trace expects size-2 ciphertexts")
        srcs, keeps, keys = self._field_trace_steps(
            automorphism_keys, logn, ct.is_ntt_form)
        if not srcs:
            return ct
        cd = self._cd(ct)
        key_cd = self.context.key_context_data
        data = ct.data[None]
        step = max(1, _MAX_GALOIS_FOLDS_PER_DISPATCH)
        for i in range(0, len(srcs), step):
            data = _field_trace_batch_core(
                data, srcs[i:i + step], keeps[i:i + step],
                keys[i:i + step], cd, key_cd, 0, ct.is_ntt_form)
        return ct.replace(data=data[0], seed=0)

    def pack_lwe_ciphertexts(self, lwes: Sequence[LWECiphertext],
                             automorphism_keys: GaloisKeys) -> Ciphertext:
        """Pack up to n LWE samples into one RLWE ciphertext via the
        automorphism tree + field trace (evaluator_cuda.cu:2278-2341)."""
        count = len(lwes)
        if count == 0:
            raise ValueError("no LWE ciphertexts to pack")
        n = self.context.n
        if count > n:
            raise ValueError("too many LWE ciphertexts")
        cd = self.context.get_context_data(lwes[0].level)
        key_cd = self.context.key_context_data
        is_ckks = cd.scheme == SchemeType.ckks
        l = 0
        while (1 << l) < count:
            l += 1

        # Batched assembly: pad to 2^l with zero samples, bit-reversed order.
        zero_c1 = jnp.zeros_like(lwes[0].c1)
        zero_c0 = jnp.zeros_like(lwes[0].c0)
        c1s, c0s = [], []
        for i in range(1 << l):
            index = numth.reverse_bits(i, l)
            src = lwes[index] if index < count else None
            c1s.append(src.c1 if src is not None else zero_c1)
            c0s.append(src.c0 if src is not None else zero_c0)
        cur = _pack_assemble_core(jnp.stack(c1s), jnp.stack(c0s), cd)

        # Tree fold: one batched dispatch per layer instead of one
        # key-switch per pair (evaluator_cuda.cu:2278-2341).
        for layer in range(l):
            elt = (1 << (layer + 1)) + 1
            if not automorphism_keys.has_key(elt):
                raise ValueError(f"Galois key for element {elt} not present")
            if is_ckks:
                src = galois_util.ntt_permutation_dev(n, elt)
                keep = src
            else:
                src, keep = galois_util.coeff_permutation_dev(n, elt)
            cur = _pack_tree_layer_core(cur, src, keep,
                                        automorphism_keys.keys[elt],
                                        cd, key_cd, n >> (layer + 1), is_ckks)

        template = lwes[0]
        ret = Ciphertext(data=cur[0], level=template.level,
                         is_ntt_form=False, scale=template.scale,
                         correction_factor=template.correction_factor)
        if is_ckks:
            ret = self.transform_to_ntt(ret)
        return self.field_trace(ret, automorphism_keys, l)


def _scales_close(a: float, b: float) -> bool:
    return abs(a - b) <= max(abs(a), abs(b)) * 1e-9
