"""RNS base conversion and BEHZ tool operations on device.

The reference's RNS kernels
(reference: src/utils/rns_cuda.cu:96-625). An RNS polynomial is a uint64
array of shape (k, n) — limb-major. Every modulus, base-change matrix entry
and scalar precompute comes in as a *static* Python int from
troy_tpu.utils.rns.RnsTool, so XLA sees fully specialized constant
arithmetic; the limb loops below unroll at trace time (k <= ~20).

128-bit dot-product accumulations (base conversion) keep (lo, hi) uint64
pairs, mirroring the reference's lazy multiply-accumulate bound
(defines.h SEAL_MULTIPLY_ACCUMULATE_USER_MOD_MAX: up to 64 terms fit).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from . import u64ops as u
from . import ntt as dntt
from ..utils.rns import RnsTool, BaseConverter

U64 = jnp.uint64


def _shoup(s: int, q: int) -> int:
    return (s << 64) // q


def smul(x, s: int, q: int):
    """x * s mod q for a static scalar s (Shoup). Accepts any u64 x."""
    s %= q
    return u.mul_mod_shoup(x, u.u64(s), u.u64(_shoup(s, q)), q)


def smul_lazy(x, s: int, q: int):
    s %= q
    return u.mul_mod_shoup_lazy(x, u.u64(s), u.u64(_shoup(s, q)), q)


def fast_convert(x: jnp.ndarray, conv: BaseConverter) -> jnp.ndarray:
    """Approximate CRT base conversion (rns.cpp fastConvertArray):
    x: (k_in, n) in ibase -> (k_out, n) in obase. May overshoot by a
    multiple of prod(ibase) (the BEHZ alpha), as in the reference."""
    ib, ob = conv.ibase, conv.obase
    temp = [
        u.mul_mod_shoup(x[i], u.u64(conv.inv_punctured[i]),
                        u.u64(conv.inv_punctured_shoup[i]), ib.values[i])
        for i in range(ib.size)
    ]
    outs = []
    for o in range(ob.size):
        po = ob.values[o]
        acc_lo = jnp.zeros_like(x[0])
        acc_hi = jnp.zeros_like(x[0])
        for i in range(ib.size):
            lo, hi = u.mul128(temp[i], u.u64(conv.matrix[o][i]))
            acc_lo, acc_hi = u.add_u128(acc_lo, acc_hi, lo, hi)
        outs.append(u.barrett_reduce_128(acc_lo, acc_hi, po,
                                         ob.moduli[o].const_ratio))
    return jnp.stack(outs)


def exact_convert(x: jnp.ndarray, conv: BaseConverter) -> jnp.ndarray:
    """Exact CRT conversion to a single-modulus base (rns.cpp
    exactConvertArray, CT-RSA 2019): subtracts alpha*Q where
    alpha = round(sum_i temp_i / q_i).

    The reference estimates alpha with f64 accumulation; we use Q.64
    fixed-point integer arithmetic (each term computed through the 128-bit
    Barrett ratio floor(2^128/q_i), truncated to 64 fractional bits) —
    deterministic on every backend and strictly more precise than
    doubles."""
    ib, ob = conv.ibase, conv.obase
    if ob.size != 1:
        raise ValueError("exact_convert requires a single output modulus")
    p = ob.values[0]
    cr_p = ob.moduli[0].const_ratio

    temp = [
        u.mul_mod_shoup(x[i], u.u64(conv.inv_punctured[i]),
                        u.u64(conv.inv_punctured_shoup[i]), ib.values[i])
        for i in range(ib.size)
    ]

    # alpha = round(sum_i temp_i / q_i) in Q.64 fixed point:
    # temp_i / q_i ~= temp_i * floor(2^128/q_i) / 2^128, truncated to Q.64.
    frac_lo = jnp.zeros_like(x[0])
    frac_hi = jnp.zeros_like(x[0])
    for i in range(ib.size):
        w_lo, w_hi = ib.moduli[i].const_ratio[0], ib.moduli[i].const_ratio[1]
        t_lo = u.mulhi64(temp[i], u.u64(w_lo))
        m_lo, m_hi = u.mul128(temp[i], u.u64(w_hi))
        term_lo, term_hi = u.add_u128(t_lo, jnp.zeros_like(t_lo), m_lo, m_hi)
        frac_lo, frac_hi = u.add_u128(frac_lo, frac_hi, term_lo, term_hi)
    alpha = frac_hi + (frac_lo >> jnp.uint64(63))     # round-half-up

    acc_lo = jnp.zeros_like(x[0])
    acc_hi = jnp.zeros_like(x[0])
    for i in range(ib.size):
        lo, hi = u.mul128(temp[i], u.u64(conv.matrix[0][i]))
        acc_lo, acc_hi = u.add_u128(acc_lo, acc_hi, lo, hi)
    sum_mod_p = u.barrett_reduce_128(acc_lo, acc_hi, p, cr_p)
    alpha_red = u.barrett_reduce_64(alpha, p, cr_p[1])
    alpha_q = smul(alpha_red, ib.base_prod % p, p)
    return u.sub_mod(sum_mod_p, alpha_q, p)[None, :]


def fastbconv_m_tilde(x: jnp.ndarray, tool: RnsTool) -> jnp.ndarray:
    """q -> Bsk ∪ {m̃} with the m̃ premultiplication for Montgomery
    reduction (rns.cpp:1012-1037). x: (k, n) -> (|Bsk|+1, n)."""
    qv = tool.base_q.values
    temp = jnp.stack([smul(x[i], tool.m_tilde % qv[i], qv[i])
                      for i in range(len(qv))])
    to_bsk = fast_convert(temp, tool.conv_q_to_Bsk)
    to_mt = fast_convert(temp, tool.conv_q_to_m_tilde)
    return jnp.concatenate([to_bsk, to_mt], axis=0)


def sm_mrq(x: jnp.ndarray, tool: RnsTool) -> jnp.ndarray:
    """Montgomery reduction mod m̃: Bsk ∪ {m̃} -> Bsk (rns.cpp:943-983)."""
    bsk = tool.base_Bsk.values
    r = smul(x[len(bsk)], tool.neg_inv_prod_q_mod_m_tilde, tool.m_tilde)
    half = u.u64(tool.m_tilde >> 1)
    outs = []
    for i, b in enumerate(bsk):
        # centered reduction of r mod m̃ (m̃ is a power of two, hence >=)
        temp = jnp.where(r >= half, r + u.u64(b - tool.m_tilde), r)
        d = u.add_mod(smul(temp, tool.prod_q_mod_Bsk[i], b), x[i], b)
        outs.append(smul(d, tool.inv_m_tilde_mod_Bsk[i], b))
    return jnp.stack(outs)


def fast_floor(x: jnp.ndarray, tool: RnsTool) -> jnp.ndarray:
    """floor(x / Q): q ∪ Bsk -> Bsk (rns.cpp:985-1010).
    x: (k + |Bsk|, n) -> (|Bsk|, n)."""
    k = tool.base_q.size
    bsk = tool.base_Bsk.values
    conv = fast_convert(x[:k], tool.conv_q_to_Bsk)
    outs = []
    for i, b in enumerate(bsk):
        diff = x[k + i] + (u.u64(b) - conv[i])          # < 2b, Shoup-safe
        outs.append(smul(diff, tool.inv_prod_q_mod_Bsk[i], b))
    return jnp.stack(outs)


def fastbconv_sk(x: jnp.ndarray, tool: RnsTool) -> jnp.ndarray:
    """Shenoy–Kumaresan conversion Bsk -> q (rns.cpp:879-941).
    x: (|Bsk|, n) -> (k, n)."""
    nb = tool.base_B.size
    dest = fast_convert(x[:nb], tool.conv_B_to_q)
    temp = fast_convert(x[:nb], tool.conv_B_to_m_sk)[0]
    m_sk = tool.m_sk
    alpha = smul(temp + (u.u64(m_sk) - x[nb]),
                 tool.inv_prod_B_mod_m_sk, m_sk)
    half = u.u64(m_sk >> 1)
    outs = []
    for i, qi in enumerate(tool.base_q.values):
        pb = tool.prod_B_mod_q[i]
        neg_corr = smul(u.u64(m_sk) - alpha, pb, qi)      # alpha was negative
        pos_corr = smul(alpha, (qi - pb) % qi, qi)        # -alpha*prod(B)
        corr = jnp.where(alpha > half, neg_corr, pos_corr)
        outs.append(u.add_mod(dest[i], corr, qi))
    return jnp.stack(outs)


def decrypt_scale_and_round(phase: jnp.ndarray, tool: RnsTool) -> jnp.ndarray:
    """BFV decrypt scaling: round(t/Q * phase) mod t via the gamma trick
    (rns.cpp:1039-1095). phase: (k, n) -> (n,) mod t."""
    t, gamma = tool.t, tool.gamma
    qv = tool.base_q.values
    temp = jnp.stack([smul(phase[i], tool.prod_t_gamma_mod_q[i], qv[i])
                      for i in range(len(qv))])
    tg = fast_convert(temp, tool.conv_q_to_t_gamma)
    vt = smul(tg[0], tool.neg_inv_q_mod_t_gamma[0], t)
    vg = smul(tg[1], tool.neg_inv_q_mod_t_gamma[1], gamma)
    gamma_div_2 = u.u64(gamma >> 1)
    cr_t = tool.base_t_gamma.moduli[0].const_ratio
    neg_red = u.barrett_reduce_64(u.u64(gamma) - vg, t, cr_t[1])
    pos_red = u.barrett_reduce_64(vg, t, cr_t[1])
    corrected = jnp.where(vg > gamma_div_2,
                          u.add_mod(vt, neg_red, t),
                          u.sub_mod(vt, pos_red, t))
    return smul(corrected, tool.inv_gamma_mod_t, t)


def decrypt_mod_t(phase: jnp.ndarray, tool: RnsTool) -> jnp.ndarray:
    """BGV decrypt: exact conversion q -> t (rns.cpp:1142-1146)."""
    return exact_convert(phase, tool.conv_q_to_t)[0]


def divide_and_round_q_last(x: jnp.ndarray, tool: RnsTool) -> jnp.ndarray:
    """Divide by the last prime with rounding, coefficient domain
    (rns.cpp:805-829). x: (k, n) -> (k-1, n)."""
    qv = tool.base_q.values
    k = len(qv)
    q_last = qv[-1]
    half = q_last >> 1
    last = u.add_mod(x[k - 1], u.u64(half), q_last)
    outs = []
    for i in range(k - 1):
        qi = qv[i]
        cr = tool.base_q.moduli[i].const_ratio
        temp = u.barrett_reduce_64(last, qi, cr[1])
        temp = u.sub_mod(temp, u.u64(half % qi), qi)
        diff = u.sub_mod(x[i], temp, qi)
        outs.append(smul(diff, tool.inv_q_last_mod_q[i], qi))
    return jnp.stack(outs)


def divide_and_round_q_last_ntt(
        x: jnp.ndarray, tool: RnsTool,
        tables: "dntt.RnsNttTables") -> jnp.ndarray:
    """NTT-domain variant (rns.cpp:831-877): iNTT the last limb, round,
    NTT the corrections back — batched over the remaining limbs in one
    stacked transform. x: (..., k, n) NTT form -> (..., k-1, n)."""
    qv = tool.base_q.values
    k = len(qv)
    q_last = qv[-1]
    half = q_last >> 1
    last = dntt.ntt_inverse_limb(x[..., k - 1, :], tables, k - 1)
    last = u.add_mod(last, u.u64(half), q_last)
    temps = []
    for i in range(k - 1):
        qi = qv[i]
        cr = tool.base_q.moduli[i].const_ratio
        if qi < q_last:
            temp = u.barrett_reduce_64(last, qi, cr[1])
        else:
            temp = last
        temp = temp + u.u64(qi - half % qi)               # lazy, < 2*qi
        temps.append(temp)
    temp = jnp.stack(temps, axis=-2)                       # (..., k-1, n)
    sub = tables.slice(0, k - 1)
    temp = dntt.rns_ntt_forward(temp, sub, lazy=True)      # < 4*qi
    outs = []
    for i in range(k - 1):
        qi = qv[i]
        diff = x[..., i, :] + (u.u64(4 * qi) - temp[..., i, :])  # < 5*qi
        outs.append(smul(diff, tool.inv_q_last_mod_q[i], qi))
    return jnp.stack(outs, axis=-2)


def mod_t_and_divide_q_last_ntt(
        x: jnp.ndarray, tool: RnsTool,
        tables: "dntt.RnsNttTables") -> jnp.ndarray:
    """BGV NTT-form mod-switch (rns.cpp modTAndDivideqLastNttInplace):
    subtract a t-multiple making the last limb divisible by q_last, then
    divide. x: (..., k, n) NTT form -> (..., k-1, n) NTT form."""
    t = tool.t
    qv = tool.base_q.values
    k = len(qv)
    q_last = qv[-1]
    cr_t_hi = ((1 << 128) // t) >> 64
    last = dntt.ntt_inverse_limb(x[..., k - 1, :], tables, k - 1)
    # neg_k = -(c_last mod t) * q_last^{-1} mod t
    neg_k = u.neg_mod(u.barrett_reduce_64(last, t, cr_t_hi), t)
    if tool.inv_q_last_mod_t != 1:
        neg_k = smul(neg_k, tool.inv_q_last_mod_t, t)
    temps = []
    for i in range(k - 1):
        qi = qv[i]
        cr = tool.base_q.moduli[i].const_ratio
        delta = u.barrett_reduce_64(neg_k, qi, cr[1])
        delta = smul(delta, q_last % qi, qi)              # k*q_last mod qi
        c_last_qi = u.barrett_reduce_64(last, qi, cr[1])
        temps.append(u.add_mod(delta, c_last_qi, qi))     # (c_last + k*q_last)
    temp = jnp.stack(temps, axis=-2)
    sub = tables.slice(0, k - 1)
    temp = dntt.rns_ntt_forward(temp, sub, lazy=True)     # < 4*qi
    outs = []
    for i in range(k - 1):
        qi = qv[i]
        diff = x[..., i, :] + (u.u64(4 * qi) - temp[..., i, :])  # < 5*qi
        outs.append(smul(diff, tool.inv_q_last_mod_q[i], qi))
    return jnp.stack(outs, axis=-2)


def mod_t_and_divide_q_last(x: jnp.ndarray, tool: RnsTool) -> jnp.ndarray:
    """BGV mod-switch: (x - [x]_t-correction)/q_last (rns.cpp:1097-1140).
    x: (k, n) coefficient domain -> (k-1, n)."""
    t = tool.t
    qv = tool.base_q.values
    k = len(qv)
    q_last = qv[-1]
    cr_t = (((1 << 128) // t) & ((1 << 64) - 1), ((1 << 128) // t) >> 64)
    neg_c_last_mod_t = u.neg_mod(
        u.barrett_reduce_64(x[k - 1], t, cr_t[1]), t)
    if tool.inv_q_last_mod_t != 1:
        neg_c_last_mod_t = smul(neg_c_last_mod_t, tool.inv_q_last_mod_t, t)
    outs = []
    for i in range(k - 1):
        qi = qv[i]
        cr = tool.base_q.moduli[i].const_ratio
        delta = u.barrett_reduce_64(neg_c_last_mod_t, qi, cr[1])
        delta = smul(delta, q_last % qi, qi)
        lazy = x[i] + (u.u64(2 * qi)
                       - u.barrett_reduce_64(x[k - 1], qi, cr[1])
                       - delta)                            # < 3*qi, Shoup-safe
        outs.append(smul(lazy, tool.inv_q_last_mod_q[i], qi))
    return jnp.stack(outs)
