"""Host numpy NTT twin (utils/host_ntt.py) — must produce words IDENTICAL
to the device transforms (ops/ntt.py), since
the host keygen fast path uploads its output directly into the bit-exact
pipelines (reference architecture: keygen on host + upload,
keygenerator_cuda.cuh:51-85)."""

import numpy as np
import pytest

import troy_tpu as T
from troy_tpu import prng as rnd
from troy_tpu.ops import ntt as dntt
from troy_tpu.utils import host_ntt as hntt
from troy_tpu.utils.ntt_tables import make_ntt_tables


@pytest.mark.parametrize("n", [64, 2048])
def test_host_ntt_matches_device(n):
    qs = [int(q) for q in T.CoeffModulus.create(n, [40, 60])]
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, q, size=n, dtype=np.uint64) for q in qs])
    tables = dntt.RnsNttTables.from_moduli(n, qs)

    fwd_host = hntt.rns_ntt_forward_np(x, n, qs)
    fwd_dev = np.asarray(dntt.rns_ntt_forward(x, tables))
    np.testing.assert_array_equal(fwd_host, fwd_dev)

    inv_host = hntt.rns_ntt_inverse_np(fwd_host, n, qs)
    inv_dev = np.asarray(dntt.rns_ntt_inverse(fwd_dev, tables))
    np.testing.assert_array_equal(inv_host, inv_dev)
    np.testing.assert_array_equal(inv_host, x)

    prod_host = hntt.rns_dyadic_mul_np(fwd_host, fwd_host, n, qs)
    prod_dev = np.asarray(dntt.rns_dyadic_mul(fwd_dev, fwd_dev, tables))
    np.testing.assert_array_equal(prod_host, prod_dev)


def test_host_keygen_keys_decrypt_roundtrip():
    """Keys produced entirely on host must work in the full pipeline."""
    n = 64
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, [40, 40, 40])),
        plain_modulus=T.PlainModulus.batching(n, 17))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(77))
    assert kg._sk_np is not None          # host fast path active
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1])
    pk = kg.create_public_key()
    enc = T.Encryptor(ctx, public_key=pk)
    dec = T.Decryptor(ctx, kg.secret_key)
    ev = T.Evaluator(ctx)
    be = T.BatchEncoder(ctx)
    t = int(ctx.first_context_data.plain_modulus)
    vals = np.arange(n, dtype=np.uint64) % t
    ct = enc.encrypt(be.encode(vals))
    out = ev.rotate_rows(ev.relinearize(ev.multiply(ct, ct), rlk), 1, gk)
    got = be.decode(dec.decrypt(out))
    sq = vals.astype(object) ** 2 % t
    expect = np.concatenate([np.roll(sq[:n // 2], -1), np.roll(sq[n // 2:], -1)])
    np.testing.assert_array_equal(got, expect)


def test_host_keygen_matches_device_kswitch_math():
    """The host-built switching key must equal a device-built one given
    the SAME samples: rebuild one row both ways from a fixed stream."""
    n = 64
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, [40, 40, 40])),
        plain_modulus=T.PlainModulus.batching(n, 17))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    seed = rnd.seed_from_uint64(88)
    kg_host = T.KeyGenerator(ctx, seed=seed, host_sampling=True)
    # device replay of the same reference-order stream
    from troy_tpu import rlwe
    key_cd = ctx.key_context_data
    host_key = np.asarray(kg_host.create_relin_keys().keys[2])
    # device path: same per-row replayed generator, device compute
    import jax.numpy as jnp
    from troy_tpu.ops import rns as drns
    from troy_tpu.ops import u64ops as u
    w = kg_host._sk_power_np(2)
    key_values = key_cd.coeff_values
    p_special = key_values[-1]
    rows = []
    for j in range(len(key_values) - 1):
        zero = rlwe.encrypt_zero_symmetric_reference(
            key_cd, kg_host.secret_key, kg_host._fresh_gen(),
            is_ntt_form=True)
        qj = key_values[j]
        term = drns.smul(jnp.asarray(w[j]), p_special % qj, qj)
        c0j = u.add_mod(zero.data[0, j], term, qj)
        rows.append(np.asarray(zero.data.at[0, j].set(c0j)))
    np.testing.assert_array_equal(host_key, np.stack(rows))
