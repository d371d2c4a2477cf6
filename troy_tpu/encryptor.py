"""Encryptor: public-key (asymmetric) and secret-key (symmetric) encryption.

Semantics-compatible with the reference's encryptor
(reference: src/encryptor.h:45, src/encryptor.cpp,
src/encryptor_cuda.cu:92-236):
  * BFV: zero encryption in coefficient form + Delta*m scaling-variant embed;
  * CKKS: zero encryption in NTT form + NTT-form plaintext added to c0;
  * BGV: zero encryption in NTT form + centered plain lift, NTT'd, added.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .context import HeContext, ContextData
from .he_types import Ciphertext, Plaintext, PublicKey, SecretKey
from .params import SchemeType
from . import prng as rnd
from . import rlwe
from .ops import ntt as dntt
from .ops import poly as dpoly


def _embed_plain_c0(m: jnp.ndarray, c0: jnp.ndarray,
                    cd: ContextData) -> jnp.ndarray:
    """Scheme-specific embed of a plaintext into c0 (traced)."""
    scheme = cd.scheme
    if scheme == SchemeType.bfv:
        # c0 += round(Q/t * m) (encryptor.cpp multiplyAddPlainWithScalingVariant)
        return dpoly.bfv_multiply_add_plain(
            m, c0, int(cd.plain_modulus), cd.coeff_modulus_mod_plain_modulus,
            cd.coeff_div_plain_modulus, cd.ntt)
    if scheme == SchemeType.ckks:
        return dpoly.rns_add(c0, m, cd.ntt)
    # bgv: add the RAW plaintext residues, no centered lift
    # (encryptor.cpp:237 addPlainWithoutScalingVariant — the t-multiple
    # difference vs a centered lift is absorbed by decryption mod t, but
    # the reference adds m directly and we match it bit-for-bit).
    # plain_lift with threshold = t never triggers the upper-half branch,
    # leaving exactly the per-limb Barrett reduction of m.
    t = int(cd.plain_modulus)
    lifted = dpoly.plain_lift(m, cd.ntt, t, t, cd.total_coeff_modulus)
    return dpoly.rns_add(c0, dntt.rns_ntt_forward(lifted, cd.ntt), cd.ntt)


@partial(jax.jit, static_argnames=("is_ntt_form",))
def _encrypt_sym_full(seeds: jnp.ndarray, m: jnp.ndarray,
                      sk_data: jnp.ndarray, cd: ContextData,
                      is_ntt_form: bool) -> jnp.ndarray:
    """One fused executable for a whole symmetric encryption: device threefry
    sampling + zero encryption + plain embed. seeds: (2,) uint64 [a, e] —
    the only host->device transfer besides the (device-resident) plaintext."""
    ct = rlwe._zero_sym_core.__wrapped__(seeds[0], seeds[1], sk_data, cd,
                                         is_ntt_form)
    return ct.at[0].set(_embed_plain_c0(m, ct[0], cd))


@jax.jit
def _embed_into_zero(zero_data: jnp.ndarray, m: jnp.ndarray,
                     cd: ContextData) -> jnp.ndarray:
    """Embed the plaintext into a pre-built zero encryption's c0."""
    return zero_data.at[0].set(_embed_plain_c0(m, zero_data[0], cd))


@partial(jax.jit, static_argnames=("is_ntt_form", "size"))
def _encrypt_asym_full(seeds: jnp.ndarray, m: jnp.ndarray,
                       pk_data: jnp.ndarray, cd: ContextData,
                       is_ntt_form: bool, size: int) -> jnp.ndarray:
    """Fused asymmetric encryption: seeds (1+size,) uint64 [u, e_0..]."""
    ct = rlwe._zero_asym_core.__wrapped__(seeds[0], seeds[1:], pk_data, cd,
                                          is_ntt_form, size)
    return ct.at[0].set(_embed_plain_c0(m, ct[0], cd))


class Encryptor:
    """(encryptor.h:45)"""

    def __init__(self, context: HeContext,
                 public_key: Optional[PublicKey] = None,
                 secret_key: Optional[SecretKey] = None,
                 seed: Optional[bytes] = None,
                 host_sampling: bool = False):
        # keyless construction allowed: the reference's Encryptor(context)
        # + setPublicKey/setSecretKey pattern (binder.cu:464-469); key
        # presence is checked at encryption time instead.
        # host_sampling=True makes symmetric encryption consume the PRNG
        # stream exactly like the reference host path, so seeded
        # ciphertexts are bit-identical to the reference's (slower: the
        # default path samples on device from threefry streams).
        self.context = context
        self._pk = public_key
        self._sk = secret_key
        self._host_sampling = host_sampling
        self._prng = rnd.RandomGeneratorFactory.default_factory().create(seed)

    # ---- public API (encryptor.h:123-394 analogues) ----
    def encrypt(self, plain: Plaintext) -> Ciphertext:
        return self._encrypt_internal(plain, asymmetric=True, save_seed=False)

    def encrypt_symmetric(self, plain: Plaintext,
                          save_seed: bool = False) -> Ciphertext:
        return self._encrypt_internal(plain, asymmetric=False,
                                      save_seed=save_seed)

    def encrypt_symmetric_many(self, plains, save_seed: bool = False):
        """Batched symmetric encryption: ONE host->device upload and one
        fused executable for the whole batch (the app layer encrypts many
        ciphertexts at once).
        All plaintexts must share a representation/level."""
        import jax
        import jax.numpy as jnp

        if self._host_sampling:
            # the reference-interop path has no batched equivalent (each
            # ciphertext replays the seed stream); encrypt one by one
            return [self._encrypt_internal(p, asymmetric=False,
                                           save_seed=save_seed)
                    for p in plains]
        plains = list(plains)
        if not plains:
            return []
        scheme = self.context.scheme
        if self._sk is None:
            raise ValueError("no secret key set")
        if scheme == SchemeType.ckks:
            cd = self.context.get_context_data(plains[0].level)
        else:
            cd = self.context.first_context_data
        is_ntt = scheme in (SchemeType.ckks, SchemeType.bgv)
        seeds, (a_arr, e_arr) = rlwe.sample_zero_sym_batch(
            cd, self._prng, len(plains))
        zeros = rlwe._zero_sym_batch_core(
            jnp.asarray(a_arr), jnp.asarray(e_arr),
            self._sk.data, cd, is_ntt)                      # (B, 2, k, n)

        m = jnp.stack([self._pad(p.data, cd.n) if not p.is_ntt_form
                       else p.data for p in plains])
        # shared embed (same code path as single encryption, so the BGV
        # raw-residue semantics cannot drift between the two APIs)
        c0 = jax.vmap(lambda c, mm: _embed_plain_c0(mm, c, cd))(
            zeros[:, 0], m)
        data = zeros.at[:, 0].set(c0)
        scale = plains[0].scale if scheme == SchemeType.ckks else 1.0
        return [Ciphertext(data=data[i], level=cd.chain_index,
                           is_ntt_form=is_ntt, scale=scale,
                           correction_factor=1,
                           seed=seeds[i] if save_seed else 0)
                for i in range(len(plains))]

    def encrypt_zero(self, level: Optional[int] = None,
                     asymmetric: bool = True,
                     save_seed: bool = False) -> Ciphertext:
        cd = self._level_cd(level)
        is_ntt = self.context.scheme in (SchemeType.ckks, SchemeType.bgv)
        return self._zero(cd, is_ntt, asymmetric, save_seed)

    # ---- internals ----
    def _level_cd(self, level: Optional[int]) -> ContextData:
        if level is None:
            return self.context.first_context_data
        return self.context.get_context_data(level)

    def _zero(self, cd: ContextData, is_ntt_form: bool, asymmetric: bool,
              save_seed: bool) -> Ciphertext:
        if asymmetric:
            if self._pk is None:
                raise ValueError("no public key set")
            return rlwe.encrypt_zero_asymmetric(
                cd, self._pk, self._prng, is_ntt_form)
        if self._sk is None:
            raise ValueError("no secret key set")
        return rlwe.encrypt_zero_symmetric(
            cd, self._sk, self._prng, is_ntt_form, save_seed)

    @staticmethod
    def _pad(data, n: int):
        """Zero-pad a coefficient-form plaintext to length n (the reference
        accepts any plain_coeff_count <= n, e.g. hex-poly literals)."""
        import jax.numpy as jnp
        c = data.shape[-1]
        if c == n:
            return data
        if c > n:
            raise ValueError(f"plaintext has {c} coefficients > n={n}")
        return jnp.pad(data, (0, n - c))

    def _encrypt_internal(self, plain: Plaintext, asymmetric: bool,
                          save_seed: bool) -> Ciphertext:
        scheme = self.context.scheme
        if scheme == SchemeType.ckks:
            if not plain.is_ntt_form or plain.level is None:
                raise ValueError("CKKS plaintext must be NTT form at a level")
            cd = self.context.get_context_data(plain.level)
            m = plain.data
            is_ntt = True
        else:
            if plain.is_ntt_form:
                raise ValueError(f"{scheme.name} plaintext must be in "
                                 "coefficient form")
            cd = self.context.first_context_data
            m = self._pad(plain.data, cd.n)
            is_ntt = scheme == SchemeType.bgv

        if asymmetric:
            if self._pk is None:
                raise ValueError("no public key set")
            size = self._pk.data.shape[0]
            seeds = np.asarray(
                [self._prng.next_uint64() for _ in range(1 + size)],
                dtype=np.uint64)
            data = _encrypt_asym_full(jnp.asarray(seeds), m, self._pk.data,
                                      cd, is_ntt, size)
            a_seed = 0
        elif self._host_sampling:
            if self._sk is None:
                raise ValueError("no secret key set")
            if save_seed:
                # the reference's host path hardcodes save_seed=false too
                # (rlwe.cpp:138); refusing beats silently writing the
                # full-size serialization the caller did not ask for
                raise ValueError("save_seed is not supported with "
                                 "host_sampling (c1 is not seed-expanded "
                                 "on this path)")
            zero = rlwe.encrypt_zero_symmetric_reference(
                cd, self._sk, self._prng, is_ntt)
            data = _embed_into_zero(zero.data, m, cd)
            a_seed = 0
        else:
            if self._sk is None:
                raise ValueError("no secret key set")
            a_seed = self._prng.next_uint64() | 1
            e_seed = self._prng.next_uint64()
            seeds = np.asarray([a_seed, e_seed], dtype=np.uint64)
            data = _encrypt_sym_full(jnp.asarray(seeds), m, self._sk.data,
                                     cd, is_ntt)
        return Ciphertext(
            data=data, level=cd.chain_index, is_ntt_form=is_ntt,
            scale=plain.scale if scheme == SchemeType.ckks else 1.0,
            correction_factor=1,
            seed=a_seed if (save_seed and not asymmetric) else 0)
