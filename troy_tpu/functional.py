"""Functional evaluator facade — the jit-composable API.

The class-based ``Evaluator`` resolves its ``ContextData`` from ``self``
and must therefore stay OUTSIDE ``jax.jit`` (a closed-over device table
becomes an embedded constant: trace-time readback + a far slower
executable). This module is the jit-safe surface: every function takes its
ciphertexts AND its tables/keys as explicit pytree arguments, so whole HE
pipelines compile into one fused XLA program:

    import jax
    from troy_tpu import functional as F

    @jax.jit
    def step(ct1, ct2, cd, key_cd, rk2):
        return F.relinearize(F.multiply(ct1, ct2, cd), (rk2,), cd, key_cd)

    out = step(ct1, ct2, ctx.first_context_data,
               ctx.key_context_data, rlk.keys[2])

Ciphertexts are pytree dataclasses; their static metadata (level, NTT
flag, scale, correction factor) specializes the trace exactly like the
reference's per-level dispatch (reference: src/evaluator_cuda.cu scheme
splits at :262-432).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

from .context import ContextData
from .he_types import Ciphertext
from .params import SchemeType
from . import evaluator as _ev


def negate(ct: Ciphertext, cd: ContextData) -> Ciphertext:
    return ct.replace(data=_ev._negate(ct.data, cd), seed=0)


def add(a: Ciphertext, b: Ciphertext, cd: ContextData) -> Ciphertext:
    """Same-size, same-metadata add (the jit-hot path; the class API's
    BGV correction-factor balancing is host logic — pre-balance there)."""
    return a.replace(data=_ev._add(a.data, b.data, cd), seed=0)


def sub(a: Ciphertext, b: Ciphertext, cd: ContextData) -> Ciphertext:
    return a.replace(data=_ev._sub(a.data, b.data, cd), seed=0)


def multiply(a: Ciphertext, b: Ciphertext, cd: ContextData) -> Ciphertext:
    """BEHZ (BFV) or dyadic (CKKS/BGV) multiply; output size 3 for
    size-2 inputs."""
    scheme = cd.scheme
    if scheme == SchemeType.bfv:
        data = _ev._bfv_multiply(a.data, b.data, cd)
        return a.replace(data=data, seed=0)
    data = _ev._ntt_form_multiply(a.data, b.data, cd)
    if scheme == SchemeType.ckks:
        return a.replace(data=data, scale=a.scale * b.scale, seed=0)
    t = int(cd.plain_modulus)
    cf = a.correction_factor * b.correction_factor % t
    return a.replace(data=data, correction_factor=cf, seed=0)


def square(a: Ciphertext, cd: ContextData) -> Ciphertext:
    """Dedicated square for size-2 ciphertexts: one BEHZ lift + 3 dyadic
    products (evaluator_cuda.cu:503-700); falls back to multiply for
    larger sizes like the reference."""
    if a.size != 2:
        return multiply(a, a, cd)
    scheme = cd.scheme
    if scheme == SchemeType.bfv:
        return a.replace(data=_ev._bfv_square(a.data, cd), seed=0)
    data = _ev._ntt_form_square(a.data, cd)
    if scheme == SchemeType.ckks:
        return a.replace(data=data, scale=a.scale * a.scale, seed=0)
    t = int(cd.plain_modulus)
    cf = a.correction_factor * a.correction_factor % t
    return a.replace(data=data, correction_factor=cf, seed=0)


def switch_key(target: jnp.ndarray, key: jnp.ndarray, cd: ContextData,
               key_cd: ContextData, target_ntt_form: bool) -> jnp.ndarray:
    """The raw key-switch contraction: target (k, n) -> delta (2, k, n)
    (reference: evaluator_cuda.cu:1163-1362)."""
    return _ev._switch_key_core(target, key, cd, key_cd, target_ntt_form)


def relinearize(ct: Ciphertext, keys: Sequence[jnp.ndarray],
                cd: ContextData, key_cd: ContextData) -> Ciphertext:
    """Reduce size-(2+len(keys)) to 2. ``keys[i]`` is the dense kswitch
    array for power i+2 (``relin_keys.keys[i + 2]``)."""
    size = ct.size
    if size == 2:
        return ct
    if len(keys) != size - 2:
        raise ValueError(f"need {size - 2} relin key arrays, got {len(keys)}")
    c0, c1 = ct.data[0], ct.data[1]
    for i, key in enumerate(keys):
        delta = _ev._switch_key_core(ct.data[2 + i], key, cd, key_cd,
                                     ct.is_ntt_form)
        c0 = _ev._add(c0[None], delta[0][None], cd)[0]
        c1 = _ev._add(c1[None], delta[1][None], cd)[0]
    return ct.replace(data=jnp.stack([c0, c1]), seed=0)


def multiply_relinearize(a: Ciphertext, b: Ciphertext, rk2: jnp.ndarray,
                         cd: ContextData, key_cd: ContextData) -> Ciphertext:
    """The benchmark op: multiply then relinearize with keys[2]."""
    return relinearize(multiply(a, b, cd), (rk2,), cd, key_cd)


def mod_switch_to_next(ct: Ciphertext, cd: ContextData) -> Ciphertext:
    scheme = cd.scheme
    if scheme == SchemeType.bfv:
        return ct.replace(data=_ev._bfv_mod_switch_scale(ct.data, cd),
                          level=ct.level + 1, seed=0)
    if scheme == SchemeType.ckks:
        return ct.replace(data=ct.data[:, :-1, :], level=ct.level + 1,
                          seed=0)
    data = _ev._bgv_mod_switch_scale(ct.data, cd)
    t = int(cd.plain_modulus)
    cf = ct.correction_factor * cd.rns_tool.inv_q_last_mod_t % t
    return ct.replace(data=data, level=ct.level + 1, correction_factor=cf,
                      seed=0)


def rescale_to_next(ct: Ciphertext, cd: ContextData) -> Ciphertext:
    if cd.scheme != SchemeType.ckks:
        raise ValueError("rescale is CKKS-only")
    data = _ev._ckks_rescale(ct.data, cd)
    return ct.replace(data=data, level=ct.level + 1,
                      scale=ct.scale / cd.coeff_values[-1], seed=0)


def apply_galois(ct: Ciphertext, perm: jnp.ndarray, key: jnp.ndarray,
                 cd: ContextData, key_cd: ContextData) -> Ciphertext:
    """NTT-form Galois application with a precomputed permutation table
    (``troy_tpu.utils.galois.ntt_permutation``) and the element's dense
    Galois key array. Coefficient-form ciphertexts should use the class
    API (its signed permutation is host-prepared)."""
    if not ct.is_ntt_form:
        raise ValueError("functional apply_galois expects NTT form "
                         "(use apply_galois_coeff)")
    c0 = _ev._apply_permutation(ct.data[0], perm)
    c1 = _ev._apply_permutation(ct.data[1], perm)
    delta = _ev._switch_key_core(c1, key, cd, key_cd, True)
    c0 = _ev._add(c0[None], delta[0][None], cd)[0]
    return ct.replace(data=jnp.stack([c0, delta[1]]), seed=0)


def apply_galois_coeff(ct: Ciphertext, src: jnp.ndarray,
                       keep_sign: jnp.ndarray, key: jnp.ndarray,
                       cd: ContextData, key_cd: ContextData) -> Ciphertext:
    """Coefficient-form Galois application: signed permutation tables from
    ``troy_tpu.utils.galois.coeff_permutation_dev`` plus the element's
    dense Galois key."""
    if ct.is_ntt_form:
        raise ValueError("functional apply_galois_coeff expects "
                         "coefficient form (use apply_galois)")
    c0 = _ev._apply_permutation_signed(ct.data[0], src, keep_sign, cd)
    c1 = _ev._apply_permutation_signed(ct.data[1], src, keep_sign, cd)
    delta = _ev._switch_key_core(c1, key, cd, key_cd, False)
    c0 = _ev._add(c0[None], delta[0][None], cd)[0]
    return ct.replace(data=jnp.stack([c0, delta[1]]), seed=0)
