"""Device CKKS encoder vs the host numpy oracle.

The device path (ops/embedding.py: complex128 FFT embedding, chunk-exact
RNS rounding, multiword CRT composition) must agree with the host path
(numpy FFT + exact-integer rounding) to the LAST ROUNDED BIT — two double
FFTs differ in the last bits at most, far inside the rounding margin.
(VERDICT.md next #1: no numpy FFT on the CKKS hot path.)
"""

import numpy as np
import pytest

import troy_tpu as T
from troy_tpu.ops import embedding as emb


def _ctx(n, bits):
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, bits)))
    return T.HeContext(parms, sec_level=T.SecurityLevel.none)


@pytest.mark.parametrize("n,bits,scale", [
    (64, [50, 30, 50], float(1 << 30)),
    (64, [50, 30, 50], float(1 << 40)),
    (256, [60, 40, 40, 60], float(1 << 40)),
    # Q of 1200 bits: a radix-2^32 ladder of 38 levels, beyond what one
    # f64 scaling can reach from the top
    (64, [60] * 20, float(1 << 40)),
])
def test_device_encode_matches_host_words(n, bits, scale):
    ctx = _ctx(n, bits)
    dev = T.CKKSEncoder(ctx)
    host = T.CKKSEncoder(ctx, host=True)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(n // 2) * 3 + 1j * rng.standard_normal(n // 2)
    pd = dev.encode(v, scale)
    ph = host.encode(v, scale)
    np.testing.assert_array_equal(np.asarray(pd.data), np.asarray(ph.data))


def test_device_encode_large_coefficients():
    """scale * value beyond 2^62: word equality with the host oracle is
    impossible by construction here (ANY two f64 transforms differ by
    ~2^-51 relative, i.e. >> 1 integer unit at scale 2^80 — the reference's
    own double FFT has the same property), so the contract is round-trip
    accuracy: decode(encode(v)) recovers v to f64-FFT precision on both
    paths."""
    n = 64
    ctx = _ctx(n, [60, 60, 60])
    dev = T.CKKSEncoder(ctx)
    host = T.CKKSEncoder(ctx, host=True)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(n // 2) * 100
    scale = 2.0 ** 80
    got_d = dev.decode(dev.encode(v, scale))
    got_h = host.decode(host.encode(v, scale))
    np.testing.assert_allclose(np.real(got_d), v, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_d, got_h, rtol=0, atol=1e-10)


def test_device_decode_matches_host():
    n = 256
    ctx = _ctx(n, [60, 40, 60])
    dev = T.CKKSEncoder(ctx)
    host = T.CKKSEncoder(ctx, host=True)
    rng = np.random.default_rng(9)
    v = rng.standard_normal(n // 2) * 10 + 1j * rng.standard_normal(n // 2)
    pt = dev.encode(v, float(1 << 40))
    got_d = dev.decode(pt)
    got_h = host.decode(pt)
    np.testing.assert_allclose(got_d, got_h, atol=1e-8)
    np.testing.assert_allclose(got_d, v, atol=1e-6)


def test_device_encode_polynomial_matches_host():
    n = 128
    ctx = _ctx(n, [50, 40, 50])
    dev = T.CKKSEncoder(ctx)
    host = T.CKKSEncoder(ctx, host=True)
    rng = np.random.default_rng(11)
    c = rng.standard_normal(n) * 5
    pd = dev.encode_polynomial(c, float(1 << 35))
    ph = host.encode_polynomial(c, float(1 << 35))
    np.testing.assert_array_equal(np.asarray(pd.data), np.asarray(ph.data))
    back = dev.decode_polynomial(pd)
    np.testing.assert_allclose(back, c, atol=1e-8)


def _check_round_to_rns(bits, mags, seed):
    """round_to_rns_device equals Python-int rounding mod each prime."""
    q = tuple(int(m) for m in T.CoeffModulus.create(64, bits))
    rt = emb.make_rns_round_tables(q)
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    for mag in mags:
        c = rng.standard_normal(64) * mag
        got = np.asarray(emb.round_to_rns_device(jnp.asarray(c), rt))
        want_int = [int(float(v)) for v in np.rint(c)]
        for i, qi in enumerate(q):
            want = np.array([w % qi for w in want_int], dtype=np.uint64)
            np.testing.assert_array_equal(got[i], want)
    return rt


def test_round_to_rns_device_exact():
    """Chunk-route rounding is exact at any magnitude, including negatives
    and values far beyond 2^62."""
    _check_round_to_rns([60, 40, 60], (1.0, 2.0**40, 2.0**75, 2.0**120), 13)


def test_round_to_rns_device_exact_long_chain():
    """A 1200-bit Q (20 primes of 60 bits) needs more radix-2^32 levels
    than an f64 can span; every finite magnitude up to near 2^1023 still
    rounds exactly."""
    rt = _check_round_to_rns([60] * 20, (1.0, 2.0**40, 2.0**500, 2.0**1000,
                                         2.0**1020), 19)
    assert rt.maxw > 32


def test_compose_centered_device_exact():
    q = tuple(int(m) for m in T.CoeffModulus.create(64, [60, 40, 60]))
    rt = emb.make_rns_round_tables(q)
    import jax.numpy as jnp
    Q = int(np.prod([int(x) for x in q], dtype=object))
    rng = np.random.default_rng(17)
    vals = [int(rng.integers(0, 1 << 62)) * int(rng.integers(1, 1 << 62))
            % Q for _ in range(64)]
    res = np.zeros((3, 64), dtype=np.uint64)
    for i, qi in enumerate(q):
        res[i] = np.array([v % qi for v in vals], dtype=np.uint64)
    got = np.asarray(emb.compose_centered_device(jnp.asarray(res), rt))
    want = np.array([float(v - Q) if v > Q // 2 else float(v)
                     for v in vals])
    # the multiword value is exact; only the final f64 conversion rounds
    # (top-down word sum: <= 2 ulp vs Python's correctly-rounded float())
    np.testing.assert_allclose(got, want, rtol=5e-16, atol=0)


def test_two_party_flow_uses_device_encoder():
    """End-to-end CKKS mult+relin+rescale through the DEVICE encoder."""
    n = 256
    ctx = _ctx(n, [50, 40, 40, 50])
    enc = T.CKKSEncoder(ctx)
    from troy_tpu import prng as rnd
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(3))
    rlk = kg.create_relin_keys()
    e = T.Encryptor(ctx, secret_key=kg.secret_key)
    d = T.Decryptor(ctx, kg.secret_key)
    ev = T.Evaluator(ctx)
    v1 = np.arange(1, n // 2 + 1) / 10.0
    v2 = np.linspace(0.5, 2.0, n // 2)
    scale = float(1 << 40)
    c1 = e.encrypt_symmetric(enc.encode(v1, scale))
    c2 = e.encrypt_symmetric(enc.encode(v2, scale))
    prod = ev.rescale_to_next(ev.relinearize(ev.multiply(c1, c2), rlk))
    got = enc.decode(d.decrypt(prod))
    np.testing.assert_allclose(np.real(got), v1 * v2, atol=1e-3)
