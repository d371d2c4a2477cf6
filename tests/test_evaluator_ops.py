"""Evaluator corner-op tests: many-operand helpers, shifts, plain-side ops,
targeted mod switching, and error paths.

Mirrors the reference's wide evaluator scenarios (reference:
test/evaluator.cpp, test/evaluator_cuda.cu — AddMany/MultiplyMany/
Exponentiate, NegacyclicShift, SubPlain, ModSwitchTo on ct and plain,
TransformToNTT roundtrips, argument validation).
"""

import numpy as np
import pytest

import troy_tpu as T
from troy_tpu import prng as rnd


N = 64
SEED = rnd.seed_from_uint64(777)


@pytest.fixture(scope="module")
def bfv():
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, [40, 40, 40])),
        plain_modulus=T.PlainModulus.batching(N, 17))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=SEED)
    return {
        "ctx": ctx,
        "enc": T.Encryptor(ctx, secret_key=kg.secret_key, seed=SEED),
        "dec": T.Decryptor(ctx, kg.secret_key),
        "ev": T.Evaluator(ctx),
        "be": T.BatchEncoder(ctx),
        "rlk": kg.create_relin_keys(),
        "t": int(parms.plain_modulus),
    }


def test_add_many(bfv):
    s = bfv
    vals = [np.full(N, i + 1, dtype=np.uint64) for i in range(5)]
    cts = [s["enc"].encrypt_symmetric(s["be"].encode(v)) for v in vals]
    got = s["be"].decode(s["dec"].decrypt(s["ev"].add_many(cts)))
    np.testing.assert_array_equal(got, sum(vals) % s["t"])


def test_multiply_many(bfv):
    s = bfv
    vals = [np.arange(N, dtype=np.uint64) % 5 + 1 + i for i in range(4)]
    cts = [s["enc"].encrypt_symmetric(s["be"].encode(v)) for v in vals]
    out = s["ev"].multiply_many(cts, s["rlk"])
    assert out.size == 2
    got = s["be"].decode(s["dec"].decrypt(out))
    expect = np.ones(N, dtype=object)
    for v in vals:
        expect = expect * v % s["t"]
    np.testing.assert_array_equal(got, expect.astype(np.uint64))


def test_exponentiate(bfv):
    s = bfv
    a = np.arange(N, dtype=np.uint64) % 9 + 1
    ct = s["enc"].encrypt_symmetric(s["be"].encode(a))
    got = s["be"].decode(s["dec"].decrypt(
        s["ev"].exponentiate(ct, 3, s["rlk"])))
    np.testing.assert_array_equal(
        got, (a.astype(object) ** 3 % s["t"]).astype(np.uint64))
    with pytest.raises(ValueError):
        s["ev"].exponentiate(ct, 0, s["rlk"])


def test_negacyclic_shift(bfv):
    """x^shift * p(x) mod (x^n + 1): rotated coefficients with sign flips
    on wraparound (evaluator_cuda.cuh negacyclicShift)."""
    s = bfv
    coeffs = np.arange(1, N + 1, dtype=np.uint64)
    pt = s["be"].encode_polynomial(coeffs)
    ct = s["enc"].encrypt_symmetric(pt)
    shift = 5
    out = s["ev"].negacyclic_shift(ct, shift)
    got = s["be"].decode_polynomial(s["dec"].decrypt(out))
    expect = np.zeros(N, dtype=np.uint64)
    for i, c in enumerate(coeffs):
        j = (i + shift) % N
        wrapped = (i + shift) // N % 2 == 1
        expect[j] = (s["t"] - c) % s["t"] if wrapped else c
    np.testing.assert_array_equal(got, expect)


def test_sub_plain(bfv):
    s = bfv
    a = np.full(N, 1000, dtype=np.uint64)
    b = np.arange(N, dtype=np.uint64)
    ct = s["enc"].encrypt_symmetric(s["be"].encode(a))
    got = s["be"].decode(s["dec"].decrypt(
        s["ev"].sub_plain(ct, s["be"].encode(b))))
    np.testing.assert_array_equal(got, (a - b) % s["t"])


def test_mod_switch_to_target_level(bfv):
    s = bfv
    a = np.arange(N, dtype=np.uint64)
    ct = s["enc"].encrypt_symmetric(s["be"].encode(a))
    last = s["ctx"].last_level
    down = s["ev"].mod_switch_to(ct, last)
    assert down.level == last
    got = s["be"].decode(s["dec"].decrypt(down))
    np.testing.assert_array_equal(got, a)
    with pytest.raises(Exception):
        s["ev"].mod_switch_to(down, s["ctx"].first_level)  # cannot go up


def test_mod_switch_plain_keeps_decoding(bfv):
    """CKKS-style plaintext mod switch on an NTT-form plaintext is the
    reference's modSwitchPlainToNext; for BFV the plaintext is mod-t and
    level-free, so the meaningful check is the ct/plain multiply after a
    ciphertext switch."""
    s = bfv
    a = np.arange(N, dtype=np.uint64)
    b = (a * 3 + 1) % s["t"]
    ct = s["ev"].mod_switch_to_next(
        s["enc"].encrypt_symmetric(s["be"].encode(a)))
    got = s["be"].decode(s["dec"].decrypt(
        s["ev"].multiply_plain(ct, s["be"].encode(b))))
    np.testing.assert_array_equal(got, a * b % s["t"])


def test_transform_ntt_roundtrip(bfv):
    s = bfv
    a = np.arange(N, dtype=np.uint64)
    ct = s["enc"].encrypt_symmetric(s["be"].encode(a))
    ntt_ct = s["ev"].transform_to_ntt(ct)
    assert ntt_ct.is_ntt_form
    back = s["ev"].transform_from_ntt(ntt_ct)
    assert not back.is_ntt_form
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(ct.data))
    with pytest.raises(ValueError):
        s["ev"].transform_to_ntt(ntt_ct)
    with pytest.raises(ValueError):
        s["ev"].transform_from_ntt(ct)


def test_level_mismatch_rejected(bfv):
    s = bfv
    a = np.arange(N, dtype=np.uint64)
    ct1 = s["enc"].encrypt_symmetric(s["be"].encode(a))
    ct2 = s["ev"].mod_switch_to_next(ct1)
    with pytest.raises(ValueError):
        s["ev"].add(ct1, ct2)


def test_ntt_form_mismatch_rejected(bfv):
    s = bfv
    a = np.arange(N, dtype=np.uint64)
    ct1 = s["enc"].encrypt_symmetric(s["be"].encode(a))
    ct2 = s["ev"].transform_to_ntt(ct1)
    with pytest.raises(ValueError):
        s["ev"].add(ct1, ct2)
    with pytest.raises(ValueError):
        s["ev"].multiply(ct2, ct2)  # BFV multiply needs coefficient form


def test_negate_roundtrip(bfv):
    s = bfv
    a = np.arange(N, dtype=np.uint64) + 1
    ct = s["enc"].encrypt_symmetric(s["be"].encode(a))
    got = s["be"].decode(s["dec"].decrypt(s["ev"].negate(ct)))
    np.testing.assert_array_equal(got, (s["t"] - a) % s["t"])


def test_apply_galois_many_matches_sequential():
    """Hoisted multi-rotation (decompose-once) must agree with the
    sequential apply_galois path at the decryption level in all three
    schemes. (Bit-exactness is NOT expected: the hoisted path applies the
    automorphism to the mod-p digit images, choosing the -v mod p_i
    representative where the sequential path reduces q_j - v — the same
    residue class mod q_j with equally small magnitude, so the ciphertexts
    differ in noise representative but decrypt identically.)"""
    for scheme in (T.SchemeType.bfv, T.SchemeType.bgv, T.SchemeType.ckks):
        kwargs = {}
        if scheme != T.SchemeType.ckks:
            kwargs["plain_modulus"] = T.PlainModulus.batching(64, 16)
        parms = T.EncryptionParameters(
            scheme=scheme, poly_modulus_degree=64,
            coeff_modulus=tuple(T.CoeffModulus.create(64, [40, 40, 40])),
            **kwargs)
        ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
        kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(77))
        glk = kg.create_galois_keys()
        enc = T.Encryptor(ctx, secret_key=kg.secret_key)
        dec = T.Decryptor(ctx, kg.secret_key)
        ev = T.Evaluator(ctx)
        n = ctx.n
        if scheme == T.SchemeType.ckks:
            ce = T.CKKSEncoder(ctx)
            vals = np.arange(n // 2) * (0.25 + 0.5j)
            ct = enc.encrypt_symmetric(ce.encode(vals, scale=2.0**40))
        else:
            be = T.BatchEncoder(ctx)
            vals = np.arange(n, dtype=np.uint64)
            ct = enc.encrypt_symmetric(be.encode(vals))

        elts = [T.utils.galois.get_elt_from_step(n, s) for s in (1, 2, -1)]
        elts.append(2 * n - 1)
        hoisted = ev.apply_galois_many(ct, elts, glk)
        for elt, h in zip(elts, hoisted):
            seq = ev.apply_galois(ct, elt, glk)
            if scheme == T.SchemeType.ckks:
                got = ce.decode(dec.decrypt(h))
                want = ce.decode(dec.decrypt(seq))
                np.testing.assert_allclose(got, want, atol=1e-4,
                                           err_msg=f"elt={elt}")
            else:
                np.testing.assert_array_equal(
                    be.decode(dec.decrypt(h)), be.decode(dec.decrypt(seq)),
                    err_msg=f"scheme={scheme} elt={elt}")


def test_rotate_many_mixed_keys():
    """rotate_many: direct-key steps ride the hoisted path, steps without
    an exact key fall back to NAF composition — results must match the
    one-at-a-time rotate API."""
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=64,
        coeff_modulus=tuple(T.CoeffModulus.create(64, [40, 40, 40])),
        plain_modulus=T.PlainModulus.batching(64, 16))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(78))
    glk = kg.create_galois_keys()   # default set: conjugation + powers of 2
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    be = T.BatchEncoder(ctx)
    ev = T.Evaluator(ctx)
    a = np.arange(64, dtype=np.uint64)
    ct = enc.encrypt_symmetric(be.encode(a))
    steps = [0, 1, 3, 2, -2]   # 3 has no direct key in the default set
    outs = ev.rotate_many(ct, steps, glk)
    for s, out in zip(steps, outs):
        ref = ct if s == 0 else ev.rotate_rows(ct, s, glk)
        np.testing.assert_array_equal(
            be.decode(dec.decrypt(out)), be.decode(dec.decrypt(ref)),
            err_msg=f"step={s}")


def test_apply_galois_many_gate():
    """One element runs the fused single-automorphism program and builds
    no pre-permuted key; two or more run the hoisted schedule. Both must
    decrypt-match the sequential path."""
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=64,
        coeff_modulus=tuple(T.CoeffModulus.create(64, [40, 40, 40])),
        plain_modulus=T.PlainModulus.batching(64, 16))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(83))
    glk = kg.create_galois_keys()
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    be = T.BatchEncoder(ctx)
    ev = T.Evaluator(ctx)
    n = ctx.n
    a = np.arange(n, dtype=np.uint64)
    ct = enc.encrypt_symmetric(be.encode(a))
    all_elts = [T.utils.galois.get_elt_from_step(n, s)
                for s in (1, 2, -1, -2)]
    for m in (1, 2, 4):
        elts = all_elts[:m]
        outs = ev.apply_galois_many(ct, elts, glk)
        assert (len(ev._pp_keys) > 0) == (m > 1)
        for elt, out in zip(elts, outs):
            seq = ev.apply_galois(ct, elt, glk)
            np.testing.assert_array_equal(
                be.decode(dec.decrypt(out)), be.decode(dec.decrypt(seq)),
                err_msg=f"m={m} elt={elt}")


def test_prepermuted_key_cache_coexists_across_key_sets():
    """Two GaloisKeys objects sharing an element must each keep their own
    pre-permuted cache entry (keyed by key object identity, not elt), and
    the cache stays LRU-bounded."""
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=64,
        coeff_modulus=tuple(T.CoeffModulus.create(64, [40, 40, 40])),
        plain_modulus=T.PlainModulus.batching(64, 16))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg1 = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(81))
    kg2 = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(82))
    gk1 = kg1.create_galois_keys(steps=[1])
    gk2 = kg2.create_galois_keys(steps=[1])
    ev = T.Evaluator(ctx)
    elt = T.utils.galois.get_elt_from_step(64, 1)
    pp1 = ev._prepermuted_key(gk1, elt, 64)
    pp2 = ev._prepermuted_key(gk2, elt, 64)
    assert len(ev._pp_keys) == 2            # both entries coexist
    assert ev._prepermuted_key(gk1, elt, 64) is pp1   # both still hit
    assert ev._prepermuted_key(gk2, elt, 64) is pp2
    # the bound evicts oldest entries on insert
    ev.PP_KEY_CACHE_MAX = 1
    kg3 = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(83))
    gk3 = kg3.create_galois_keys(steps=[1])
    ev._prepermuted_key(gk3, elt, 64)
    assert len(ev._pp_keys) == 1
    del ev.PP_KEY_CACHE_MAX                 # restore the class default


def test_context_accepts_numpy_degree():
    """poly_modulus_degree arriving as a numpy integer (e.g. from a
    loaded config) must build a context like a Python int."""
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=np.int64(64),
        coeff_modulus=tuple(T.CoeffModulus.create(64, [40, 40])),
        plain_modulus=T.PlainModulus.batching(64, 16))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    assert ctx.first_context_data.ntt.n == 64
