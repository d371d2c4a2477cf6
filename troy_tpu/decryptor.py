"""Decryptor: ⟨ct, (1, s, s², …)⟩ phase + per-scheme rounding.

Semantics-compatible with the reference's decryptor
(reference: src/decryptor.h:47, src/decryptor.cpp,
src/decryptor_cuda.cu:61-393): the phase accumulates in the NTT domain
with cached secret-key powers; BFV applies the t/q scale-and-round, BGV
reduces mod t with the correction factor, CKKS returns the mod-q NTT
phase unchanged. ``invariant_noise_budget`` is implemented host-side
(present even where the reference's CUDA path comments it out,
decryptor_cuda.cu:330-393).

The whole decrypt is ONE fused jit per (size, level, scheme) — eager
composition would re-upload precomputed tables per call.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .context import HeContext, ContextData
from .he_types import Ciphertext, Plaintext, SecretKey
from .params import SchemeType
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import rns as drns
from .utils import numth


@partial(jax.jit, static_argnames=("is_ntt_form",))
def _phase_ntt_core(data: jnp.ndarray, sk_powers: Tuple[jnp.ndarray, ...],
                    cd: ContextData, is_ntt_form: bool) -> jnp.ndarray:
    """c0 + c1 s + c2 s² + ... in the NTT domain: (k, n)
    (decryptor_cuda.cu:262-329 dotProductCtSkArray)."""
    t = cd.ntt
    k = cd.limbs
    size = data.shape[0]
    if is_ntt_form:
        comps = [data[i] for i in range(size)]
    else:
        comps = [dntt.rns_ntt_forward(data[i], t, lazy=False)
                 for i in range(size)]
    acc = comps[0]
    for i in range(1, size):
        ski = sk_powers[i - 1][:k]
        acc = dpoly.rns_add(acc, dntt.rns_dyadic_mul(comps[i], ski, t), t)
    return acc


@partial(jax.jit, static_argnames=("is_ntt_form", "inv_cf"))
def _decrypt_core(data: jnp.ndarray, sk_powers: Tuple[jnp.ndarray, ...],
                  cd: ContextData, is_ntt_form: bool,
                  inv_cf: int) -> jnp.ndarray:
    """Fused decrypt to plaintext data (BFV/BGV; CKKS uses the phase)."""
    phase = dntt.rns_ntt_inverse(
        _phase_ntt_core(data, sk_powers, cd, is_ntt_form), cd.ntt)
    if cd.scheme == SchemeType.bfv:
        return drns.decrypt_scale_and_round(phase, cd.rns_tool)
    m = drns.decrypt_mod_t(phase, cd.rns_tool)
    if inv_cf != 1:
        m = drns.smul(m, inv_cf, int(cd.plain_modulus))
    return m


@partial(jax.jit, static_argnames=("is_ntt_form",))
def _phase_ntt_many(data: jnp.ndarray, sk_powers: Tuple[jnp.ndarray, ...],
                    cd: ContextData, is_ntt_form: bool) -> jnp.ndarray:
    return jax.vmap(
        lambda d: _phase_ntt_core.__wrapped__(d, sk_powers, cd, is_ntt_form)
    )(data)


@partial(jax.jit, static_argnames=("is_ntt_form", "inv_cf"))
def _decrypt_many(data: jnp.ndarray, sk_powers: Tuple[jnp.ndarray, ...],
                  cd: ContextData, is_ntt_form: bool,
                  inv_cf: int) -> jnp.ndarray:
    return jax.vmap(
        lambda d: _decrypt_core.__wrapped__(d, sk_powers, cd, is_ntt_form,
                                            inv_cf)
    )(data)


class Decryptor:
    """(decryptor.h:47)"""

    def __init__(self, context: HeContext, secret_key: SecretKey):
        self.context = context
        self._sk = secret_key
        # sk powers in NTT form over the *key* base; sliced per level
        self._sk_powers: Dict[int, jnp.ndarray] = {1: secret_key.data}

    def _sk_power(self, p: int) -> jnp.ndarray:
        if p not in self._sk_powers:
            cd = self.context.key_context_data
            self._sk_powers[p] = dntt.rns_dyadic_mul(
                self._sk_power(p - 1), self._sk.data, cd.ntt)
        return self._sk_powers[p]

    def _powers_for(self, size: int) -> Tuple[jnp.ndarray, ...]:
        return tuple(self._sk_power(p) for p in range(1, size))

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        cd = self.context.get_context_data(ct.level)
        scheme = self.context.scheme
        powers = self._powers_for(ct.size)

        if scheme == SchemeType.ckks:
            phase = _phase_ntt_core(ct.data, powers, cd, ct.is_ntt_form)
            return Plaintext(data=phase, level=ct.level,
                             is_ntt_form=True, scale=ct.scale)

        inv_cf = 1
        if scheme == SchemeType.bgv and ct.correction_factor != 1:
            tt = int(cd.plain_modulus)
            inv_cf = numth.invert_mod(ct.correction_factor % tt, tt)
        m = _decrypt_core(ct.data, powers, cd, ct.is_ntt_form, inv_cf)
        return Plaintext(data=m)

    def decrypt_many(self, cts) -> list:
        """Batched decryption: ONE fused executable and ONE device->host
        transfer for a list of same-shape ciphertexts (the app layer's
        decrypt_outputs decrypts many tiles; per-ciphertext dispatches cost
        a device round trip each).

        All ciphertexts must share size/level/NTT-form (and, for BGV,
        correction factor). Returned plaintexts carry host numpy data."""
        cts = list(cts)
        if not cts:
            return []
        if len(cts) == 1:
            # reuse the single-ciphertext executable (already compiled by
            # normal use) instead of compiling a vmapped twin
            return [self.decrypt(cts[0])]
        first = cts[0]
        for c in cts[1:]:
            if (c.size != first.size or c.level != first.level
                    or c.is_ntt_form != first.is_ntt_form
                    or c.correction_factor != first.correction_factor):
                raise ValueError("decrypt_many needs uniform ciphertexts")
        cd = self.context.get_context_data(first.level)
        scheme = self.context.scheme
        powers = self._powers_for(first.size)
        stacked = jnp.stack([c.data for c in cts])

        if scheme == SchemeType.ckks:
            out = _phase_ntt_many(stacked, powers, cd, first.is_ntt_form)
            host = np.asarray(out)
            return [Plaintext(data=host[i], level=first.level,
                              is_ntt_form=True, scale=c.scale)
                    for i, c in enumerate(cts)]

        inv_cf = 1
        if scheme == SchemeType.bgv and first.correction_factor != 1:
            tt = int(cd.plain_modulus)
            inv_cf = numth.invert_mod(first.correction_factor % tt, tt)
        out = _decrypt_many(stacked, powers, cd, first.is_ntt_form, inv_cf)
        host = np.asarray(out)
        return [Plaintext(data=host[i]) for i in range(len(cts))]

    # ---- noise budget (decryptor.cpp invariantNoiseBudget; host-side) ----
    def invariant_noise_budget(self, ct: Ciphertext) -> int:
        """Bits of noise budget left: log2(Q/2) - log2(2*||t/Q*phase - m||).
        Host big-int computation — a diagnostic, not a hot path.

        This performs a device->host readback: keep it out of timed
        windows."""
        if self.context.scheme not in (SchemeType.bfv, SchemeType.bgv):
            raise ValueError("noise budget is defined for BFV/BGV only")
        cd = self.context.get_context_data(ct.level)
        powers = self._powers_for(ct.size)
        phase = np.asarray(dntt.rns_ntt_inverse(
            _phase_ntt_core(ct.data, powers, cd, ct.is_ntt_form), cd.ntt))
        Q = cd.total_coeff_modulus
        t = int(cd.plain_modulus)
        base = cd.rns_tool.base_q
        # compose each coefficient, times t, centered mod Q
        k, n = phase.shape
        acc = np.zeros(n, dtype=object)
        for i in range(k):
            qi = base.values[i]
            acc += phase[i].astype(object) * base.inv_punctured(i) % qi \
                * base.punctured_prod(i)
        v = acc * t % Q
        v = np.minimum(v, Q - v)
        norm = int(v.max())
        # bits(Q) - bits(norm) - 1; the -1 scales the invariant noise by 2
        # (decryptor.cpp:439-441 invariantNoiseBudget)
        budget = Q.bit_length() - norm.bit_length() - 1
        return max(budget, 0)
