"""Multi-chip sharding regimes on the virtual 8-device CPU mesh
(conftest forces JAX_PLATFORMS=cpu with xla_force_host_platform_device_count).

The reference is single-GPU (reference: src/kernelprovider.cuh:30
cudaSetDevice(0)); these layouts are the capability it lacks. Each regime
must decrypt bit-exactly to the plain-integer result.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import pytest

import troy_tpu as T
from troy_tpu import prng as rnd
from troy_tpu.parallel import sharding as par

N = 64
Q_BITS = [30, 30, 30]


@pytest.fixture(scope="module")
def setup():
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=T.PlainModulus.batching(N, 16))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(11))
    return {
        "ctx": ctx, "rlk": kg.create_relin_keys(),
        "enc": T.Encryptor(ctx, secret_key=kg.secret_key),
        "dec": T.Decryptor(ctx, kg.secret_key),
        "be": T.BatchEncoder(ctx),
        "t": int(ctx.first_context_data.plain_modulus),
        "mesh": par.make_mesh(8),
    }


def test_dp_batch(setup):
    s = setup
    a = np.arange(N, dtype=np.uint64)
    cts1 = [s["enc"].encrypt_symmetric(s["be"].encode(a + i)).data
            for i in range(8)]
    cts2 = [s["enc"].encrypt_symmetric(s["be"].encode(a * 2 + i)).data
            for i in range(8)]
    d1 = par.shard_batch(s["mesh"], jnp.stack(cts1))
    d2 = par.shard_batch(s["mesh"], jnp.stack(cts2))
    out = par.batched_multiply_relin(s["ctx"], s["rlk"], s["mesh"])(d1, d2)
    for i in range(8):
        ct = T.Ciphertext(data=np.asarray(out[i]),
                          level=s["ctx"].first_level)
        got = s["be"].decode(s["dec"].decrypt(ct))
        assert np.array_equal(got, ((a + i) * (a * 2 + i)) % s["t"])


def test_coeff_sharded(setup):
    s = setup
    a = np.arange(N, dtype=np.uint64)
    ca = s["enc"].encrypt_symmetric(s["be"].encode(a))
    cb = s["enc"].encrypt_symmetric(s["be"].encode(a + 3))
    run = par.coeff_sharded_multiply_relin(s["ctx"], s["rlk"], s["mesh"])
    spec = NamedSharding(s["mesh"], P(None, None, "dp"))
    out = run(jax.device_put(ca.data, spec), jax.device_put(cb.data, spec))
    ct = T.Ciphertext(data=np.asarray(out), level=s["ctx"].first_level)
    got = s["be"].decode(s["dec"].decrypt(ct))
    assert np.array_equal(got, (a * (a + 3)) % s["t"])


def test_sharded_executables_contain_collectives(setup):
    """The annotation-derived programs must really communicate: the
    compiled HLO of the limb- and coefficient-sharded steps has to contain
    cross-device collective ops (psum lowers to all-reduce; the NTT's
    resharding lowers to all-to-all / collective-permute / all-gather).
    This pins the §2.2 claim that GSPMD inserts the collectives the
    reference would have needed NCCL for."""
    s = setup
    a = np.arange(N, dtype=np.uint64)
    ca = s["enc"].encrypt_symmetric(s["be"].encode(a)).data
    cb = s["enc"].encrypt_symmetric(s["be"].encode(a + 1)).data

    collective_re = (
        "all-reduce|all-to-all|collective-permute|all-gather|reduce-scatter")
    import re

    # limb sharding needs the limb axis to cover the mesh: a 5-prime chain
    # (4 data limbs) over a 4-device submesh — one limb per device. (With
    # fewer limbs than devices GSPMD just replicates: no communication,
    # no scaling — the degenerate case this test exists to catch.)
    parms5 = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, [30] * 5)),
        plain_modulus=T.PlainModulus.batching(N, 16))
    ctx5 = T.HeContext(parms5, sec_level=T.SecurityLevel.none)
    kg5 = T.KeyGenerator(ctx5, seed=rnd.seed_from_uint64(21))
    rlk5 = kg5.create_relin_keys()
    enc5 = T.Encryptor(ctx5, secret_key=kg5.secret_key)
    be5 = T.BatchEncoder(ctx5)
    mesh4 = par.make_mesh(4)
    e1 = enc5.encrypt_symmetric(be5.encode(a)).data
    e2 = enc5.encrypt_symmetric(be5.encode(a + 1)).data

    run_l = par.limb_sharded_multiply_relin(ctx5, rlk5, mesh4)
    lspec = NamedSharding(mesh4, P(None, "dp", None))
    hlo = run_l.jitted.lower(jax.device_put(e1, lspec),
                             jax.device_put(e2, lspec),
                             *run_l.args).compile().as_text()
    assert re.search(collective_re, hlo), "limb-sharded HLO has no collectives"

    # and it must still decrypt exactly
    out_l = run_l(jax.device_put(e1, lspec), jax.device_put(e2, lspec))
    dec5 = T.Decryptor(ctx5, kg5.secret_key)
    t5 = int(ctx5.first_context_data.plain_modulus)
    got = be5.decode(dec5.decrypt(T.Ciphertext(
        data=np.asarray(out_l), level=ctx5.first_level)))
    assert np.array_equal(got, (a * (a + 1)) % t5)

    run_c = par.coeff_sharded_multiply_relin(s["ctx"], s["rlk"], s["mesh"])
    cspec = NamedSharding(s["mesh"], P(None, None, "dp"))
    d1 = jax.device_put(ca, cspec)
    hlo = run_c.jitted.lower(d1, jax.device_put(cb, cspec),
                             *run_c.args).compile().as_text()
    assert re.search(collective_re, hlo), "coeff-sharded HLO has no collectives"

    # DP must be collective-FREE on the data path: batches are independent
    run_d = par.batched_multiply_relin(s["ctx"], s["rlk"], s["mesh"])
    bspec = NamedSharding(s["mesh"], P("dp"))
    b1 = jax.device_put(jnp.stack([ca] * 8), bspec)
    b2 = jax.device_put(jnp.stack([cb] * 8), bspec)
    hlo = run_d.jitted.lower(b1, b2, *run_d.args).compile().as_text()
    assert not re.search("all-to-all|reduce-scatter", hlo), \
        "DP should not reshard the batch"


def test_limb_sharded(setup):
    s = setup
    a = np.arange(N, dtype=np.uint64)
    ca = s["enc"].encrypt_symmetric(s["be"].encode(a + 5))
    cb = s["enc"].encrypt_symmetric(s["be"].encode(a + 9))
    # the limb axis (2 data limbs here) must cover the mesh: submesh of 2
    mesh = par.make_mesh(min(8, s["ctx"].first_context_data.limbs))
    run = par.limb_sharded_multiply_relin(s["ctx"], s["rlk"], mesh)
    spec = NamedSharding(mesh, P(None, "dp", None))
    out = run(jax.device_put(ca.data, spec), jax.device_put(cb.data, spec))
    ct = T.Ciphertext(data=np.asarray(out), level=s["ctx"].first_level)
    got = s["be"].decode(s["dec"].decrypt(ct))
    assert np.array_equal(got, ((a + 5) * (a + 9)) % s["t"])


def test_dp_limb_2d_mesh(setup):
    """Combined DP x limb regime on a (4, 2) mesh: batches over dp, each
    ciphertext's 2 data limbs over tp; must decrypt bit-exactly."""
    s = setup
    a = np.arange(N, dtype=np.uint64)
    mesh2d = par.make_mesh_2d(4, 2)
    cts1 = [s["enc"].encrypt_symmetric(s["be"].encode(a + i)).data
            for i in range(4)]
    cts2 = [s["enc"].encrypt_symmetric(s["be"].encode(a * 3 + i)).data
            for i in range(4)]
    spec = NamedSharding(mesh2d, P("dp", None, "tp", None))
    d1 = jax.device_put(jnp.stack(cts1), spec)
    d2 = jax.device_put(jnp.stack(cts2), spec)
    run = par.dp_limb_sharded_multiply_relin(s["ctx"], s["rlk"], mesh2d)
    out = run(d1, d2)
    for i in range(4):
        ct = T.Ciphertext(data=np.asarray(out[i]),
                          level=s["ctx"].first_level)
        got = s["be"].decode(s["dec"].decrypt(ct))
        assert np.array_equal(got, ((a + i) * (a * 3 + i)) % s["t"])
    # the tp reduction must communicate within a dp group
    import re
    hlo = run.jitted.lower(d1, d2, *run.args).compile().as_text()
    assert re.search("all-reduce|all-to-all|collective-permute|all-gather",
                     hlo)


def test_sharded_app_matmul(setup):
    """BASELINE config 5: the LinearHelper matmul pipeline with its
    batch-block tile axis sharded over the mesh; decrypts bit-exactly."""
    from troy_tpu.app.linear import MatmulHelper
    s = setup
    t = s["t"]
    B, I, O = 12, 4, 3
    rng = np.random.default_rng(23)
    x = rng.integers(0, t, size=(B, I), dtype=np.uint64)
    w = rng.integers(0, t, size=(I, O), dtype=np.uint64)
    helper = MatmulHelper(B, I, O, N, objective=0, pack_lwe=False)
    x_ct = helper.encode_inputs(s["be"].encode_polynomial, x) \
        .encrypt_symmetric(s["enc"])
    w_pt = helper.encode_weights(s["be"].encode_polynomial, w)
    blocks = len(x_ct.data)
    n_dev = max(d for d in range(1, 9) if blocks % d == 0)
    mesh = par.make_mesh(n_dev)
    ev = T.Evaluator(s["ctx"])
    y_ct = par.sharded_app_matmul(ev, mesh, x_ct, w_pt)
    y = helper.decrypt_outputs(s["be"].decode_polynomial, s["dec"], y_ct)
    np.testing.assert_array_equal(
        y.astype(object) % t,
        (x.astype(object) @ w.astype(object)) % t)


def _ctx5():
    parms5 = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, [30] * 5)),
        plain_modulus=T.PlainModulus.batching(N, 16))
    ctx5 = T.HeContext(parms5, sec_level=T.SecurityLevel.none)
    kg5 = T.KeyGenerator(ctx5, seed=rnd.seed_from_uint64(31))
    return ctx5, kg5


def test_limb_sharded_rotate(setup):
    """Rotation under the limb regime: permutation is limb-local, the key
    switch reduces across devices; must match the unsharded evaluator word for
    word AND really communicate (VERDICT.md next #7)."""
    import re
    a = np.arange(N, dtype=np.uint64)
    ctx5, kg5 = _ctx5()
    gk5 = kg5.create_galois_keys(steps=[1])
    enc5 = T.Encryptor(ctx5, secret_key=kg5.secret_key)
    be5 = T.BatchEncoder(ctx5)
    ct = enc5.encrypt_symmetric(be5.encode(a))
    mesh4 = par.make_mesh(4)
    run = par.limb_sharded_rotate(ctx5, gk5, 1, mesh4)
    spec = NamedSharding(mesh4, P(None, "dp", None))
    out = run(jax.device_put(ct.data, spec))
    ev5 = T.Evaluator(ctx5)
    want = ev5.rotate_rows(ct, 1, gk5)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want.data))
    hlo = run.jitted.lower(jax.device_put(ct.data, spec),
                           *run.args).compile().as_text()
    assert re.search(
        "all-reduce|all-to-all|collective-permute|all-gather", hlo), \
        "limb-sharded rotate HLO has no collectives"


def test_limb_sharded_mod_switch(setup):
    a = np.arange(N, dtype=np.uint64)
    ctx5, kg5 = _ctx5()
    enc5 = T.Encryptor(ctx5, secret_key=kg5.secret_key)
    be5 = T.BatchEncoder(ctx5)
    ct = enc5.encrypt_symmetric(be5.encode(a))
    mesh4 = par.make_mesh(4)
    run = par.limb_sharded_mod_switch(ctx5, mesh4)
    spec = NamedSharding(mesh4, P(None, "dp", None))
    out = run(jax.device_put(ct.data, spec))
    ev5 = T.Evaluator(ctx5)
    want = ev5.mod_switch_to_next(ct)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want.data))


def test_dp_limb_sharded_rotate_and_mod_switch(setup):
    """The 2-D regime chains rotate -> mod-switch on a (4, 2) mesh with no
    resharding between the ops; each batch element must match the
    unsharded evaluator bit-exactly."""
    s = setup
    a = np.arange(N, dtype=np.uint64)
    ctx, kg = s["ctx"], None
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(41))
    gk = kg.create_galois_keys(steps=[2])
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    cts = [enc.encrypt_symmetric(s["be"].encode(a + i)).data
           for i in range(4)]
    mesh2d = par.make_mesh_2d(4, 2)
    spec = NamedSharding(mesh2d, P("dp", None, "tp", None))
    batch = jax.device_put(jnp.stack(cts), spec)
    rot = par.dp_limb_sharded_rotate(ctx, gk, 2, mesh2d)(batch)
    ms = par.dp_limb_sharded_mod_switch(ctx, mesh2d)(rot)
    ev = T.Evaluator(ctx)
    for i in range(4):
        ct = T.Ciphertext(data=np.asarray(cts[i]), level=ctx.first_level)
        want = ev.mod_switch_to_next(ev.rotate_rows(ct, 2, gk))
        np.testing.assert_array_equal(np.asarray(ms[i]),
                                      np.asarray(want.data))
