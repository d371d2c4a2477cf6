"""RLWE zero encryptions — the shared core of keygen and the encryptor.

Semantics-compatible with the reference's rlwe layer
(reference: src/utils/rlwe.h:95-110, src/utils/rlwe.cpp / rlwe_cuda.cu:193-333):
  * symmetric: c = (-(a*s + e), a), a expandable from a stored 64-bit seed;
  * asymmetric: c_j = pk_j * u + e_j with ternary u;
  * BGV noise is scaled by the plain modulus t.

Device sampling: every polynomial draw happens ON DEVICE from a
counter-based threefry stream (jax.random) keyed by a 64-bit seed, so one
encryption uploads exactly TWO u64 scalars — no host XOF expansion and no
megabyte buffer transfer (the reference's device path likewise samples on
device with curand, rlwe_cuda.cu:34-151, but is not reproducible against
its host path; threefry is deterministic on every backend, so our seed
expansion and symmetric-ciphertext compression stay bit-reproducible).
Uniform residues are the Barrett reduction of 128 random bits per
coefficient (statistical distance < 2^-67 from uniform); CBD noise is the
difference of two 21-bit popcounts (sigma ~= 3.24, globals.h:31-37
analogue); ternary is a 64-bit draw mod 3 (bias < 2^-62).

The host-XOF samplers in troy_tpu.prng remain the keygen path (secret keys
are sampled once, bit-reproducibly, from the blake2xb stream).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .context import ContextData
from .he_types import Ciphertext, SecretKey, PublicKey
from .params import SchemeType
from . import prng as rnd
from .ops import ntt as dntt
from .ops import poly as dpoly
from .ops import u64ops as u

U64 = jnp.uint64
_M64 = (1 << 64) - 1
_CBD_BITS = 21


# --------------------------------------------------------------------------
# device samplers (traced; key is a threefry key derived from a u64 seed)
# --------------------------------------------------------------------------

def _key_from_seed(seed: jnp.ndarray) -> jax.Array:
    """Threefry key from a (traced) uint64 seed scalar."""
    return jax.random.PRNGKey(seed.astype(jnp.uint64))


def sample_uniform_rns_dev(key: jax.Array, cd: ContextData) -> jnp.ndarray:
    """(k, n) uniform residues over this level's base: Barrett reduction of
    128 random bits per coefficient per limb (rlwe.cpp samplePolyUniform
    analogue; rejection-free, bias < q/2^128)."""
    k, n = cd.limbs, cd.n
    bits = jax.random.bits(key, (2, k, n), dtype=U64)
    outs = []
    for i, q in enumerate(cd.coeff_values):
        cr = (1 << 128) // q
        outs.append(u.barrett_reduce_128(
            bits[0, i], bits[1, i], q, (cr & _M64, (cr >> 64) & _M64, 0)))
    return jnp.stack(outs)


def sample_cbd_dev(key: jax.Array, n: int) -> jnp.ndarray:
    """Centered binomial noise, sigma ~= 3.2: difference of two 21-bit
    Hamming weights per coefficient (rlwe.cpp samplePolyCbd analogue).
    Returns (n,) int64 centered values."""
    bits = jax.random.bits(key, (n,), dtype=U64)
    mask = jnp.uint64((1 << _CBD_BITS) - 1)
    x = bits & mask
    y = (bits >> jnp.uint64(_CBD_BITS)) & mask
    return (lax.population_count(x).astype(jnp.int64)
            - lax.population_count(y).astype(jnp.int64))


def sample_ternary_dev(key: jax.Array, n: int) -> jnp.ndarray:
    """Uniform ternary {-1, 0, 1} polynomial (rlwe.cpp samplePolyTernary
    analogue). Returns (n,) int64."""
    bits = jax.random.bits(key, (n,), dtype=U64)
    return (bits % jnp.uint64(3)).astype(jnp.int64) - 1


def _lift_centered_i64(e: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    """Centered int64 noise -> (k, n) RNS residues."""
    outs = []
    for q in cd.coeff_values:
        r = e % jnp.int64(q)                     # Python-sign semantics
        r = jnp.where(r < 0, r + jnp.int64(q), r)
        outs.append(r.astype(U64))
    return jnp.stack(outs)


@jax.jit
def _lift_centered(e_u64: jnp.ndarray, cd: ContextData) -> jnp.ndarray:
    """Centered int64 noise (bit-cast to u64) -> (k, n) RNS residues."""
    return _lift_centered_i64(e_u64.astype(jnp.int64), cd)


# --------------------------------------------------------------------------
# symmetric zero encryption
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("is_ntt_form",))
def _zero_sym_core(a_seed: jnp.ndarray, e_seed: jnp.ndarray,
                   sk_data: jnp.ndarray, cd: ContextData,
                   is_ntt_form: bool) -> jnp.ndarray:
    """Fully fused symmetric zero-encryption: sample a (NTT order) and e on
    device, then c = (-(a*s + e), a). Only the two seed scalars cross the
    host->device boundary."""
    t = cd.ntt
    k = cd.limbs
    a = sample_uniform_rns_dev(_key_from_seed(a_seed), cd)   # NTT order
    e = _lift_centered_i64(sample_cbd_dev(_key_from_seed(e_seed), cd.n), cd)
    if cd.scheme == SchemeType.bgv:
        e = dpoly.rns_broadcast_scalar_mul(e, int(cd.plain_modulus), t)
    sk_level = sk_data[:k]
    as_ntt = dntt.rns_dyadic_mul(a, sk_level, t)
    if is_ntt_form:
        e_ntt = dntt.rns_ntt_forward(e, t)
        c0 = dpoly.rns_neg(dpoly.rns_add(as_ntt, e_ntt, t), t)
        c1 = a
    else:
        as_coeff = dntt.rns_ntt_inverse(as_ntt, t)
        c0 = dpoly.rns_neg(dpoly.rns_add(as_coeff, e, t), t)
        c1 = dntt.rns_ntt_inverse(a, t)
    return jnp.stack([c0, c1])


@partial(jax.jit, static_argnames=("is_ntt_form",))
def _zero_sym_reference_core(c1_ntt: jnp.ndarray, noise: jnp.ndarray,
                             sk_data: jnp.ndarray, cd: ContextData,
                             is_ntt_form: bool) -> jnp.ndarray:
    """Assemble (-(a*s + e), a) from host-sampled a (NTT domain) and
    centered-lifted noise, in the reference's exact operation order
    (rlwe.cpp:110-180 encryptZeroSymmetric)."""
    k = cd.limbs
    sk = sk_data[:k]
    c0 = dntt.rns_dyadic_mul(sk, c1_ntt, cd.ntt)
    t_plain = int(cd.plain_modulus) if cd.scheme == SchemeType.bgv else 1
    if is_ntt_form:
        nz = dntt.rns_ntt_forward(noise, cd.ntt)
        if t_plain != 1:
            nz = dpoly.rns_broadcast_scalar_mul(nz, t_plain, cd.ntt)
        c0 = dpoly.rns_neg(dpoly.rns_add(nz, c0, cd.ntt), cd.ntt)
        c1 = c1_ntt
    else:
        c0 = dntt.rns_ntt_inverse(c0, cd.ntt)
        nz = noise
        if t_plain != 1:
            nz = dpoly.rns_broadcast_scalar_mul(nz, t_plain, cd.ntt)
        c0 = dpoly.rns_neg(dpoly.rns_add(nz, c0, cd.ntt), cd.ntt)
        c1 = dntt.rns_ntt_inverse(c1_ntt, cd.ntt)
    return jnp.stack([c0, c1])


def encrypt_zero_symmetric_reference(
        cd: ContextData,
        sk: SecretKey,
        generator: rnd.UniformRandomGenerator,
        is_ntt_form: bool,
) -> Ciphertext:
    """Reference-interop symmetric zero encryption: consumes the PRNG
    stream exactly like the reference's host path (rlwe.cpp:110
    encryptZeroSymmetric: 64-byte public seed for the uniform-a PRNG,
    then CBD noise from the bootstrap stream), so the resulting
    ciphertext is bit-identical to the reference's for the same seed.
    (The default device-threefry path in ``encrypt_zero_symmetric`` is
    the device fast path; this one exists for cross-implementation
    reproducibility.)"""
    n = cd.n
    mods = list(cd.coeff_values)
    public_seed = generator.generate(rnd.PRNG_SEED_BYTES)
    ct_prng = rnd.UniformRandomGenerator(public_seed)
    c1_ntt = jnp.asarray(rnd.sample_poly_uniform(ct_prng, n, mods))
    noise = jnp.asarray(
        rnd.centered_to_rns(rnd.sample_poly_cbd(generator, n), mods))
    data = _zero_sym_reference_core(c1_ntt, noise, sk.data, cd, is_ntt_form)
    return Ciphertext(data=data, level=cd.chain_index,
                      is_ntt_form=is_ntt_form, scale=1.0,
                      correction_factor=1, seed=0)


def encrypt_zero_symmetric_host_np(
        cd: ContextData,
        sk_np: np.ndarray,
        generator: rnd.UniformRandomGenerator,
        is_ntt_form: bool,
) -> np.ndarray:
    """Fully host-side symmetric zero encryption (numpy in, numpy out) —
    the keygen fast path. Same PRNG draw order as
    encrypt_zero_symmetric_reference and the same canonical arithmetic as
    _zero_sym_reference_core (host_ntt twins the device transforms
    word-for-word), so the result is bit-identical to the device path for
    the same stream — but costs ZERO device executables: the reference's
    own architecture (keygen on host, upload the product,
    keygenerator_cuda.cuh:51-85)."""
    from .utils import host_ntt as hntt
    n = cd.n
    mods = list(cd.coeff_values)
    k = len(mods)
    public_seed = generator.generate(rnd.PRNG_SEED_BYTES)
    ct_prng = rnd.UniformRandomGenerator(public_seed)
    c1_ntt = rnd.sample_poly_uniform(ct_prng, n, mods)       # (k, n) NTT
    noise = rnd.centered_to_rns(rnd.sample_poly_cbd(generator, n), mods)
    sk_lvl = sk_np[:k]
    c0 = hntt.rns_dyadic_mul_np(sk_lvl, c1_ntt, n, mods)
    t_plain = int(cd.plain_modulus) if cd.scheme == SchemeType.bgv else 1
    if is_ntt_form:
        nz = hntt.rns_ntt_forward_np(noise, n, mods)
        c1 = c1_ntt
    else:
        c0 = hntt.rns_ntt_inverse_np(c0, n, mods)
        nz = noise
        c1 = hntt.rns_ntt_inverse_np(c1_ntt, n, mods)
    from .utils.ntt_tables import make_ntt_tables
    for i, q in enumerate(mods):
        if t_plain != 1:
            cr = make_ntt_tables(n, int(q)).const_ratio
            nz_i = hntt.mul_mod(nz[i], np.uint64(t_plain % q), int(q), cr)
        else:
            nz_i = nz[i]
        c0[i] = hntt.neg_mod(hntt.add_mod(nz_i, c0[i], int(q)), int(q))
    return np.stack([c0, c1])


def encrypt_zero_symmetric(
        cd: ContextData,
        sk: SecretKey,
        generator: rnd.UniformRandomGenerator,
        is_ntt_form: bool,
        save_seed: bool = False,
) -> Ciphertext:
    """Symmetric encryption of zero at level cd (rlwe.cpp:110 analogue).

    Returns (c0, c1) with c0 + c1*s = -e (respectively -t*e for BGV). When
    save_seed is set, the returned ciphertext's ``seed`` regenerates c1.
    """
    a_seed = generator.next_uint64() | 1     # nonzero marker
    e_seed = generator.next_uint64()
    data = _zero_sym_core(u.u64(a_seed), u.u64(e_seed), sk.data, cd,
                          is_ntt_form)
    return Ciphertext(
        data=data,
        level=cd.chain_index,
        is_ntt_form=is_ntt_form,
        scale=1.0,
        correction_factor=1,
        seed=a_seed if save_seed else 0,
    )


@partial(jax.jit, static_argnames=("is_ntt_form",))
def _zero_sym_batch_core(a_seeds: jnp.ndarray, e_seeds: jnp.ndarray,
                         sk_data: jnp.ndarray, cd: ContextData,
                         is_ntt_form: bool) -> jnp.ndarray:
    """Batched symmetric zero-encryption: (B,) seed pairs -> (B, 2, k, n).
    One dispatch for the whole batch (the app layer's encrypt_inputs
    encrypts many ciphertexts at once)."""
    return jax.vmap(
        lambda a, e: _zero_sym_core.__wrapped__(a, e, sk_data, cd,
                                                is_ntt_form)
    )(a_seeds, e_seeds)


def sample_zero_sym_batch(cd: ContextData,
                          generator: rnd.UniformRandomGenerator,
                          count: int):
    """Host side of a batched symmetric encryption: (seeds, (a, e) seed
    arrays) — sampling itself happens on device in the batch core."""
    a_seeds = [generator.next_uint64() | 1 for _ in range(count)]
    e_seeds = [generator.next_uint64() for _ in range(count)]
    return a_seeds, (np.asarray(a_seeds, dtype=np.uint64),
                     np.asarray(e_seeds, dtype=np.uint64))


@partial(jax.jit, static_argnames=("is_ntt_form",))
def _expand_seed_core(data: jnp.ndarray, a_seed: jnp.ndarray,
                      cd: ContextData, is_ntt_form: bool) -> jnp.ndarray:
    a = sample_uniform_rns_dev(_key_from_seed(a_seed), cd)
    if not is_ntt_form:
        a = dntt.rns_ntt_inverse(a, cd.ntt)
    return data.at[1].set(a)


def expand_seed(ct: Ciphertext, cd: ContextData) -> Ciphertext:
    """Regenerate c1 of a seed-compressed symmetric ciphertext
    (ciphertext_cuda.cu:27-41 seed expansion analogue). Reproduces the
    exact device threefry draw the original encryption made."""
    if ct.seed == 0:
        return ct
    data = _expand_seed_core(ct.data, u.u64(ct.seed), cd, ct.is_ntt_form)
    return ct.replace(data=data, seed=0)


# --------------------------------------------------------------------------
# asymmetric zero encryption
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("is_ntt_form", "size"))
def _zero_asym_core(u_seed: jnp.ndarray, e_seeds: jnp.ndarray,
                    pk_data: jnp.ndarray, cd: ContextData,
                    is_ntt_form: bool, size: int) -> jnp.ndarray:
    """Fused asymmetric zero-encryption: ternary u and per-component CBD
    noise sampled on device; c_j = pk_j * u + e_j."""
    t = cd.ntt
    k, n = cd.limbs, cd.n
    tt = int(cd.plain_modulus)
    uc = sample_ternary_dev(_key_from_seed(u_seed), n)
    u_ntt = dntt.rns_ntt_forward(_lift_centered_i64(uc, cd), t)
    comps = []
    for j in range(size):
        cj = dntt.rns_dyadic_mul(u_ntt, pk_data[j][:k], t)
        e = _lift_centered_i64(
            sample_cbd_dev(_key_from_seed(e_seeds[j]), n), cd)
        if cd.scheme == SchemeType.bgv:
            e = dpoly.rns_broadcast_scalar_mul(e, tt, t)
        if is_ntt_form:
            cj = dpoly.rns_add(cj, dntt.rns_ntt_forward(e, t), t)
        else:
            cj = dpoly.rns_add(dntt.rns_ntt_inverse(cj, t), e, t)
        comps.append(cj)
    return jnp.stack(comps)


def encrypt_zero_asymmetric(
        cd: ContextData,
        pk: PublicKey,
        generator: rnd.UniformRandomGenerator,
        is_ntt_form: bool,
) -> Ciphertext:
    """Asymmetric encryption of zero at level cd (rlwe.cpp:95,
    rlwe_cuda.cu:193-260): c_j = pk_j * u + e_j, u ternary."""
    size = pk.data.shape[0]
    u_seed = generator.next_uint64()
    e_seeds = np.asarray([generator.next_uint64() for _ in range(size)],
                         dtype=np.uint64)
    data = _zero_asym_core(u.u64(u_seed), jnp.asarray(e_seeds), pk.data, cd,
                           is_ntt_form, size)
    return Ciphertext(
        data=data,
        level=cd.chain_index,
        is_ntt_form=is_ntt_form,
        scale=1.0,
        correction_factor=1,
    )
