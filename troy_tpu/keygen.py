"""Key generation: secret/public keys, relinearization and Galois keys.

Semantics-compatible with the reference's key generator
(reference: src/keygenerator.h:27, src/keygenerator.cpp:122-368 and the
upload pattern of src/keygenerator_cuda.cuh:51-85; switching-key
decomposition at keygenerator.cpp:294-338).

Key-switching keys use a dense layout (decomp, 2, key_limbs, n): the
j-th decomposition ciphertext is a fresh symmetric zero encryption over the
full key base whose c0 gets P*w (P = the special prime) added on limb j
only — exactly the reference's per-prime decomposition, laid out for the
key-switch einsum.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .context import HeContext, ContextData
from .he_types import SecretKey, PublicKey, KSwitchKeys, RelinKeys, GaloisKeys
from . import prng as rnd
from . import rlwe
from .ops import ntt as dntt
from .ops import rns as drns
from .ops import u64ops as u
from .utils import galois as galois_util


@jax.jit
def _kswitch_key_core(a_seeds: jnp.ndarray, e_seeds: jnp.ndarray,
                      w_ntt: jnp.ndarray, sk_data: jnp.ndarray,
                      key_cd) -> jnp.ndarray:
    """Fused switching-key generation (keygenerator.cpp:294-338): decomp
    fresh symmetric zero encryptions over the full key base (vmapped over
    per-row seed pairs), with P*w added onto c0's limb j of row j."""
    key_values = key_cd.coeff_values
    decomp = len(key_values) - 1
    p_special = key_values[-1]
    zeros = jax.vmap(
        lambda a, e: rlwe._zero_sym_core.__wrapped__(a, e, sk_data, key_cd,
                                                     True)
    )(a_seeds, e_seeds)                          # (decomp, 2, key_limbs, n)
    rows = []
    for j in range(decomp):
        qj = key_values[j]
        term = drns.smul(w_ntt[j], p_special % qj, qj)
        rows.append(zeros[j, 0].at[j].set(
            u.add_mod(zeros[j, 0, j], term, qj)))
    c0 = jnp.stack(rows)
    return jnp.stack([c0, zeros[:, 1]], axis=1)  # (decomp, 2, key_limbs, n)


class KeyGenerator:
    """(keygenerator.h:27)

    Setup-cost architecture: like the reference (key generation ALWAYS on
    the host, results uploaded — keygenerator_cuda.cuh:51-85), all key
    material is computed in numpy (utils/host_ntt twins the device
    transforms word-for-word) and uploaded as ONE finished array per key.
    One-shot setup therefore compiles and loads ZERO device executables.
    The device-threefry sampling path remains
    for externally supplied secret keys (whose coefficients live only on
    device)."""

    def __init__(self, context: HeContext,
                 secret_key: Optional[SecretKey] = None,
                 seed: Optional[bytes] = None,
                 host_sampling: bool = False):
        # host_sampling=True makes every switching-key row a host-sampled
        # zero encryption consuming a FRESH replay of the seed stream —
        # exactly the reference's seeded-factory behavior
        # (randomgen.h:419-427 create() replays the default seed;
        # keygenerator.cpp:294-338 creates one PRNG per row) — so seeded
        # relin/Galois keys are bit-identical to the reference's. The
        # default draws sequentially from one stream (distinct rows).
        self.context = context
        if seed is None and host_sampling:
            import secrets as _secrets
            seed = _secrets.token_bytes(rnd.PRNG_SEED_BYTES)
        self._seed = seed
        self._host_sampling = host_sampling
        self._prng = rnd.RandomGeneratorFactory.default_factory().create(seed)
        self._sk_np: Optional[np.ndarray] = None
        if secret_key is not None:
            self._secret_key = secret_key
        else:
            self._secret_key = self._generate_sk()
        # cached NTT-domain powers of s over the key base: powers[p] = s^p
        self._sk_powers: Dict[int, jnp.ndarray] = {1: self._secret_key.data}
        self._sk_powers_np: Dict[int, np.ndarray] = (
            {1: self._sk_np} if self._sk_np is not None else {})

    def _fresh_gen(self) -> rnd.UniformRandomGenerator:
        """A replay of the seed stream (reference factory create())."""
        return rnd.UniformRandomGenerator(self._seed)

    # ---- secret key (keygenerator.cpp generateSk) ----
    def _generate_sk(self) -> SecretKey:
        from .utils import host_ntt as hntt
        cd = self.context.key_context_data
        s = rnd.sample_poly_ternary(self._prng, cd.n)
        s_rns = rnd.centered_to_rns(s, cd.coeff_values)
        self._sk_np = hntt.rns_ntt_forward_np(s_rns, cd.n, cd.coeff_values)
        return SecretKey(data=jnp.asarray(self._sk_np))

    @property
    def secret_key(self) -> SecretKey:
        return self._secret_key

    # ---- public key (keygenerator.cpp generatePk) ----
    def create_public_key(self, save_seed: bool = False) -> PublicKey:
        cd = self.context.key_context_data
        if self._host_sampling:
            ct = rlwe.encrypt_zero_symmetric_reference(
                cd, self._secret_key, self._fresh_gen(), is_ntt_form=True)
        elif self._sk_np is not None and not save_seed:
            data = rlwe.encrypt_zero_symmetric_host_np(
                cd, self._sk_np, self._prng, is_ntt_form=True)
            return PublicKey(data=jnp.asarray(data), seed=0)
        else:
            # save_seed needs the device-threefry expansion semantics
            ct = rlwe.encrypt_zero_symmetric(
                cd, self._secret_key, self._prng, is_ntt_form=True,
                save_seed=save_seed)
        return PublicKey(data=ct.data, seed=ct.seed)

    # ---- secret key powers (keygenerator.cpp computeSecretKeyArray:234) ----
    def _sk_power(self, p: int) -> jnp.ndarray:
        if p not in self._sk_powers:
            cd = self.context.key_context_data
            prev = self._sk_power(p - 1)
            self._sk_powers[p] = dntt.rns_dyadic_mul(
                prev, self._secret_key.data, cd.ntt)
        return self._sk_powers[p]

    def _sk_power_np(self, p: int) -> np.ndarray:
        from .utils import host_ntt as hntt
        if p not in self._sk_powers_np:
            cd = self.context.key_context_data
            prev = self._sk_power_np(p - 1)
            self._sk_powers_np[p] = hntt.rns_dyadic_mul_np(
                prev, self._sk_np, cd.n, cd.coeff_values)
        return self._sk_powers_np[p]

    # ---- generic switching key (keygenerator.cpp:294-338) ----
    def _kswitch_key_host(self, w_ntt_np: np.ndarray,
                          reference_replay: bool) -> jnp.ndarray:
        """Host-computed switching key: decomp zero encryptions + the
        P*w term on c0's limb j of row j, all numpy, uploaded once
        (keygenerator.cpp:294-338 generateOneKswitchKey; the host-then-
        upload architecture of keygenerator_cuda.cuh:51-85)."""
        from .utils import host_ntt as hntt
        from .utils.ntt_tables import make_ntt_tables
        key_cd = self.context.key_context_data
        key_values = key_cd.coeff_values
        n = key_cd.n
        decomp = len(key_values) - 1
        p_special = key_values[-1]
        rows = []
        for j in range(decomp):
            gen = self._fresh_gen() if reference_replay else self._prng
            zero = rlwe.encrypt_zero_symmetric_host_np(
                key_cd, self._sk_np, gen, is_ntt_form=True)
            qj = int(key_values[j])
            cr = make_ntt_tables(n, qj).const_ratio
            term = hntt.mul_mod(w_ntt_np[j], np.uint64(p_special % qj),
                                qj, cr)
            zero[0, j] = hntt.add_mod(zero[0, j], term, qj)
            rows.append(zero)
        return jnp.asarray(np.stack(rows))   # one upload per key

    def _generate_one_kswitch_key(self, w_ntt) -> jnp.ndarray:
        """w_ntt: (>=decomp, n) NTT-form target over the key base prefix
        (numpy for the host path, device array for external targets).
        Returns the dense key array (decomp, 2, key_limbs, n)."""
        ctx = self.context
        if not ctx.using_keyswitching:
            raise ValueError("parameters do not support keyswitching "
                             "(need >= 2 coefficient moduli)")
        key_cd = ctx.key_context_data
        decomp = len(key_cd.coeff_values) - 1
        if self._sk_np is not None and isinstance(w_ntt, np.ndarray):
            return self._kswitch_key_host(w_ntt, self._host_sampling)
        if self._host_sampling:
            # reference-exact per-row replay, device compute (external sk)
            key_values = key_cd.coeff_values
            p_special = key_values[-1]
            rows = []
            for j in range(decomp):
                zero = rlwe.encrypt_zero_symmetric_reference(
                    key_cd, self._secret_key, self._fresh_gen(),
                    is_ntt_form=True)
                qj = key_values[j]
                term = drns.smul(w_ntt[j], p_special % qj, qj)
                c0j = u.add_mod(zero.data[0, j], term, qj)
                rows.append(zero.data.at[0, j].set(c0j))
            return jnp.stack(rows)
        a_seeds = np.asarray([self._prng.next_uint64() | 1
                              for _ in range(decomp)], dtype=np.uint64)
        e_seeds = np.asarray([self._prng.next_uint64()
                              for _ in range(decomp)], dtype=np.uint64)
        return _kswitch_key_core(jnp.asarray(a_seeds), jnp.asarray(e_seeds),
                                 w_ntt, self._secret_key.data, key_cd)

    # ---- relinearization keys (keygenerator.cpp:122) ----
    def create_relin_keys(self, count: int = 1) -> RelinKeys:
        if count < 1 or count > 14:  # SEAL_CIPHERTEXT_SIZE_MAX - 2
            raise ValueError("invalid count")
        keys = {}
        host = self._sk_np is not None
        for p in range(2, count + 2):
            w = self._sk_power_np(p) if host else self._sk_power(p)
            keys[p] = self._generate_one_kswitch_key(w)
        return RelinKeys(keys=keys)

    # ---- Galois keys (keygenerator.cpp:162, createAutomorphismKeys) ----
    def create_galois_keys(self, steps: Optional[Sequence[int]] = None,
                           elts: Optional[Sequence[int]] = None) -> GaloisKeys:
        ctx = self.context
        n = ctx.n
        if elts is None:
            if steps is not None:
                elts = galois_util.get_elts_from_steps(n, steps)
            else:
                elts = galois_util.get_elts_all(n)
        keys = {}
        if self._sk_np is not None:
            for elt in elts:
                perm = galois_util.ntt_permutation(n, elt)
                rotated = np.take(self._sk_np, perm, axis=-1)
                keys[int(elt)] = self._generate_one_kswitch_key(rotated)
            return GaloisKeys(keys=keys)
        sk = self._secret_key.data                 # (key_limbs, n) NTT
        for elt in elts:
            perm = galois_util.ntt_permutation_dev(n, elt)
            rotated = jnp.take(sk, perm, axis=-1)  # s(x^elt) in NTT order
            keys[int(elt)] = self._generate_one_kswitch_key(rotated)
        return GaloisKeys(keys=keys)

    def create_automorphism_keys(self) -> GaloisKeys:
        """Galois keys for every power-of-two-plus-one element {2^i + 1},
        the set the LWE packing tree and field trace use
        (keygenerator_cuda.cuh:288 createAutomorphismKeys)."""
        n = self.context.n
        log_n = n.bit_length() - 1
        elts = [(1 << i) + 1 for i in range(1, log_n + 1)]
        return self.create_galois_keys(elts=elts)

    # ---- key-switching key for an external old secret key
    # (keygenerator.h createKeySwitchingKey; used by external ksk protocols)
    def create_keyswitch_key(self, old_sk: SecretKey) -> KSwitchKeys:
        return KSwitchKeys(keys={1: self._generate_one_kswitch_key(old_sk.data)})
