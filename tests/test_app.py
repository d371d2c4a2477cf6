"""App-layer protocol tests: HE matmul/conv2d with serialization across a
simulated client/server boundary (reference: test/app/linear.cu:213-292 —
random ints, byte-stream exchange, compare against plain integer results)."""

import numpy as np
import pytest

import troy_tpu as T
from troy_tpu import prng as rnd
from troy_tpu import serialization as ser
from troy_tpu.app.linear import MatmulHelper, Conv2dHelper, Cipher2d

SEED = rnd.seed_from_uint64(31337)
N = 64


@pytest.fixture(scope="module")
def bfv():
    t = T.PlainModulus.batching(N, 20)
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, [40, 40, 40])),
        plain_modulus=t)
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=SEED)
    enc = T.Encryptor(ctx, public_key=kg.create_public_key(),
                      secret_key=kg.secret_key, seed=SEED)
    dec = T.Decryptor(ctx, kg.secret_key)
    ev = T.Evaluator(ctx)
    be = T.BatchEncoder(ctx)
    auto_keys = kg.create_automorphism_keys()
    return ctx, enc, dec, ev, be, auto_keys


def test_matmul_plain_weights(bfv):
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    rng = np.random.default_rng(0)
    B, I, O = 4, 5, 6
    x = rng.integers(0, t, (B, I), dtype=np.uint64)
    w = rng.integers(0, t, (I, O), dtype=np.uint64)

    helper = MatmulHelper(B, I, O, N, objective=0, pack_lwe=False)
    w_enc = helper.encode_weights(be.encode_polynomial, w)
    x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
    y_ct = helper.matmul(ev, x_ct, w_enc)

    # through the wire with partial-term serialization
    blob = helper.serialize_outputs(ev, ctx, y_ct)
    y_ct2 = helper.deserialize_outputs(ev, ctx, blob)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct2)
    expect = (x.astype(object) @ w.astype(object)) % t
    np.testing.assert_array_equal(y.astype(object) % t, expect)


def test_matmul_pack_lwe(bfv):
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    rng = np.random.default_rng(1)
    B, I, O = 2, 4, 5
    x = rng.integers(0, t, (B, I), dtype=np.uint64)
    w = rng.integers(0, t, (I, O), dtype=np.uint64)

    helper = MatmulHelper(B, I, O, N, objective=0, pack_lwe=True)
    w_enc = helper.encode_weights(be.encode_polynomial, w)
    x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
    y_ct = helper.matmul(ev, x_ct, w_enc)
    packed = helper.pack_outputs(ev, auto_keys, y_ct)
    blob = helper.serialize_outputs(ev, ctx, packed)
    y_ct2 = helper.deserialize_outputs(ev, ctx, blob)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct2)
    expect = (x.astype(object) @ w.astype(object)) % t
    np.testing.assert_array_equal(y.astype(object) % t, expect)


def test_matmul_cipher_weights(bfv):
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    rng = np.random.default_rng(2)
    B, I, O = 2, 3, 4
    x = rng.integers(0, t, (B, I), dtype=np.uint64)
    w = rng.integers(0, t, (I, O), dtype=np.uint64)

    helper = MatmulHelper(B, I, O, N, objective=0, pack_lwe=False)
    w_ct = helper.encode_weights(be.encode_polynomial, w).encrypt(enc)
    x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
    y_ct = helper.matmul_cipher(ev, x_ct, w_ct)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct)
    expect = (x.astype(object) @ w.astype(object)) % t
    np.testing.assert_array_equal(y.astype(object) % t, expect)


def test_conv2d(bfv):
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    rng = np.random.default_rng(3)
    B, CI, CO, H, W, KH, KW = 1, 2, 2, 5, 5, 3, 3
    x = rng.integers(0, 50, (B, CI, H, W), dtype=np.uint64)
    w = rng.integers(0, 50, (CO, CI, KH, KW), dtype=np.uint64)

    helper = Conv2dHelper(B, H, W, KH, KW, CI, CO, N, objective=0)
    w_enc = helper.encode_weights(be.encode_polynomial, w)
    x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
    y_ct = helper.conv2d(ev, x_ct, w_enc)
    blob = helper.serialize_outputs(ev, ctx, y_ct)
    y_ct2 = helper.deserialize_outputs(ev, ctx, blob)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct2)

    # plain valid conv reference
    oh, ow = H - KH + 1, W - KW + 1
    expect = np.zeros((B, CO, oh, ow), dtype=object)
    for b in range(B):
        for co in range(CO):
            for i in range(oh):
                for j in range(ow):
                    acc = 0
                    for ci in range(CI):
                        acc += int((x[b, ci, i:i + KH, j:j + KW].astype(object)
                                    * w[co, ci].astype(object)).sum())
                    expect[b, co, i, j] = acc % t
    np.testing.assert_array_equal(y.astype(object) % t, expect)


def test_lwe_extract_pack_roundtrip(bfv):
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    coeffs = np.arange(N, dtype=np.uint64) % t
    ct = enc.encrypt(be.encode_polynomial(coeffs))
    # extract a few coefficients as LWEs, re-pack, decrypt
    terms = [0, 3, 7, 11]
    lwes = [ev.extract_lwe(ct, i) for i in terms]
    packed = ev.pack_lwe_ciphertexts(lwes, auto_keys)
    out = be.decode_polynomial(dec.decrypt(packed))
    # packed ciphertext holds lwe values at stride n/2^ceil(log2(count))
    l = 0
    while (1 << l) < len(lwes):
        l += 1
    stride = N // (1 << l)
    got = [int(out[i * stride]) for i in range(len(terms))]
    assert got == [int(coeffs[i]) for i in terms]


def test_ciphertext_serialization_roundtrip(bfv):
    ctx, enc, dec, ev, be, auto_keys = bfv
    vals = np.arange(N, dtype=np.uint64)
    ct = enc.encrypt(be.encode(vals))
    blob = ser.save_ciphertext(ct)
    ct2 = ser.load_ciphertext(blob, ctx)
    np.testing.assert_array_equal(be.decode(dec.decrypt(ct2)), vals)
    # seed-compressed symmetric: blob carries only c0
    cts = enc.encrypt_symmetric(be.encode(vals), save_seed=True)
    blob_s = ser.save_ciphertext(cts)
    assert len(blob_s) < len(blob)
    ct3 = ser.load_ciphertext(blob_s, ctx)
    np.testing.assert_array_equal(be.decode(dec.decrypt(ct3)), vals)


def test_key_serialization_roundtrip(bfv):
    ctx, enc, dec, ev, be, auto_keys = bfv
    blob = ser.save_galois_keys(auto_keys)
    keys2 = ser.load_galois_keys(blob)
    assert sorted(keys2.keys) == sorted(auto_keys.keys)
    vals = np.arange(N, dtype=np.uint64)
    ct = enc.encrypt(be.encode_polynomial(vals))
    lwes = [ev.extract_lwe(ct, 0)]
    packed = ev.pack_lwe_ciphertexts(lwes, keys2)
    out = be.decode_polynomial(dec.decrypt(packed))
    assert int(out[0]) == 0


def test_matmul_reverse_encrypted_weights(bfv):
    """objective=1: weights encrypted, inputs plain (LinearHelper.cuh:429
    matmul_reverse path)."""
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    B, I, O = 3, 5, 4
    rng = np.random.default_rng(11)
    x = rng.integers(0, t, size=(B, I), dtype=np.uint64)
    w = rng.integers(0, t, size=(I, O), dtype=np.uint64)
    helper = MatmulHelper(B, I, O, N, objective=1, pack_lwe=False)
    w_ct = helper.encode_weights(be.encode_polynomial, w) \
        .encrypt_symmetric(enc)
    x_pt = helper.encode_inputs(be.encode_polynomial, x)
    y_ct = helper.matmul_reverse(ev, x_pt, w_ct)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct)
    np.testing.assert_array_equal(
        y.astype(object) % t, (x.astype(object) @ w.astype(object)) % t)


def test_conv2d_cipher_weights(bfv):
    """ct x ct convolution (Conv2dHelper::conv2d cipher path)."""
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    B, H, W, KH, KW, CI, CO = 1, 4, 4, 2, 2, 2, 2
    rng = np.random.default_rng(13)
    x = rng.integers(0, 16, size=(B, CI, H, W), dtype=np.uint64)
    w = rng.integers(0, 16, size=(CO, CI, KH, KW), dtype=np.uint64)
    helper = Conv2dHelper(B, H, W, KH, KW, CI, CO, N, objective=0)
    w_ct = helper.encode_weights(be.encode_polynomial, w) \
        .encrypt_symmetric(enc)
    x_ct = helper.encode_inputs(be.encode_polynomial, x) \
        .encrypt_symmetric(enc)
    y_ct = helper.conv2d_cipher(ev, x_ct, w_ct)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct)
    oh, ow = H - KH + 1, W - KW + 1
    expect = np.zeros((B, CO, oh, ow), dtype=object)
    for b in range(B):
        for co in range(CO):
            for i in range(oh):
                for j in range(ow):
                    acc = 0
                    for ci in range(CI):
                        acc += int((x[b, ci, i:i + KH, j:j + KW].astype(object)
                                    * w[co, ci].astype(object)).sum())
                    expect[b, co, i, j] = acc % t
    np.testing.assert_array_equal(y.astype(object) % t, expect)


def test_conv2d_reverse_encrypted_weights(bfv):
    """Encrypted weights x plain inputs (the conv analogue of
    matmul_reverse; reference: app/LinearHelper.cuh:1020-1043
    conv2dReverse, bound as a conv2d overload at binder.cu:830-831).
    objective=1 biases the tiling toward few weight ciphertexts."""
    ctx, enc, dec, ev, be, auto_keys = bfv
    t = int(ctx.first_context_data.plain_modulus)
    B, H, W, KH, KW, CI, CO = 2, 4, 4, 2, 2, 2, 3
    rng = np.random.default_rng(17)
    x = rng.integers(0, t, size=(B, CI, H, W), dtype=np.uint64)
    w = rng.integers(0, t, size=(CO, CI, KH, KW), dtype=np.uint64)
    helper = Conv2dHelper(B, H, W, KH, KW, CI, CO, N, objective=1)
    w_ct = helper.encode_weights(be.encode_polynomial, w) \
        .encrypt_symmetric(enc)
    x_pt = helper.encode_inputs(be.encode_polynomial, x)
    y_ct = helper.conv2d_reverse(ev, x_pt, w_ct)
    # through the wire with partial-term serialization, like the
    # reference's reverse protocols
    blob = helper.serialize_outputs(ev, ctx, y_ct)
    y_ct2 = helper.deserialize_outputs(ev, ctx, blob)
    y = helper.decrypt_outputs(be.decode_polynomial, dec, y_ct2)
    oh, ow = H - KH + 1, W - KW + 1
    expect = np.zeros((B, CO, oh, ow), dtype=object)
    for b in range(B):
        for co in range(CO):
            for i in range(oh):
                for j in range(ow):
                    acc = 0
                    for ci in range(CI):
                        acc += int((x[b, ci, i:i + KH, j:j + KW].astype(object)
                                    * w[co, ci].astype(object)).sum())
                    expect[b, co, i, j] = acc % t
    np.testing.assert_array_equal(y.astype(object) % t, expect)


def test_matmul_block_search_matches_reference():
    """Tiling choices pinned against a verbatim transcription of the
    reference's determineBlock (app/LinearHelper.cuh:242-307), including
    its pow(slotCount, 0.33) cube-root approximation — so ciphertext
    counts (the protocol's bandwidth) match the reference exactly."""
    cases = {
        (64, 128, 256, 16384, 0, True): (64, 16, 16),
        (64, 128, 256, 16384, 1, True): (4, 16, 256),
        (64, 128, 256, 16384, 2, True): (16, 16, 64),
        (64, 128, 256, 16384, 0, False): (64, 8, 32),
        (4, 5, 6, 64, 0, False): (4, 5, 3),
        (2, 4, 5, 64, 0, True): (2, 2, 5),
        (128, 500, 1001, 16384, 1, False): (2, 8, 1001),
        (1, 2048, 1001, 8192, 0, True): (1, 16, 512),
    }
    for (bs, ind, outd, slots, obj, pl), expect in cases.items():
        h = MatmulHelper(bs, ind, outd, slots, objective=obj, pack_lwe=pl)
        assert (h.batch_block, h.input_block, h.output_block) == expect, \
            (bs, ind, outd, slots, obj, pl)


def test_conv2d_block_search_matches_reference():
    """Conv tiling pinned against a verbatim transcription of the
    reference's 5-dim search (app/LinearHelper.cuh:786-845), including
    the commented conv benchmark config 1x64x256x56x56 k3."""
    cases = {
        (1, 56, 56, 3, 3, 64, 256, 16384, 0): (1, 56, 56, 1, 5),
        (1, 56, 56, 3, 3, 64, 256, 16384, 1): (1, 8, 8, 1, 256),
        (4, 16, 16, 5, 5, 3, 8, 4096, 0): (4, 16, 16, 1, 4),
        (1, 4, 4, 3, 3, 2, 2, 64, 0): (1, 4, 4, 2, 2),
        (2, 8, 8, 2, 2, 4, 4, 256, 2): (1, 8, 8, 2, 2),
    }
    for (bs, H, W, kh, kw, ci, co, slots, obj), expect in cases.items():
        h = Conv2dHelper(bs, H, W, kh, kw, ci, co, slots, objective=obj)
        got = (h.block_batch, h.block_height, h.block_width,
               h.block_in_channels, h.block_out_channels)
        assert got == expect, (bs, H, W, kh, kw, ci, co, slots, obj)


def test_tile_contraction_chunked_matches_unchunked(monkeypatch):
    """The live-set chunking of the ct x pt tile contraction must be
    bit-identical to the single-dispatch path (it bounds the memory of the
    reference conv2d config 1x64x256 56x56 k3)."""
    import numpy as np
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu.app import linear as lin
    from troy_tpu.app.linear import MatmulHelper

    n = 64
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, [40, 40])),
        plain_modulus=T.Modulus(1 << 10))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(5))
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    ev = T.Evaluator(ctx)
    be = T.BatchEncoder(ctx)
    t = int(parms.plain_modulus)

    rng = np.random.default_rng(3)
    B, I, O = 16, 12, 10
    x = rng.integers(0, t, size=(B, I), dtype=np.uint64)
    w = rng.integers(0, t, size=(I, O), dtype=np.uint64)
    helper = MatmulHelper(B, I, O, n, objective=0, pack_lwe=False)
    x_ct = helper.encode_inputs(be.encode_polynomial, x) \
        .encrypt_symmetric(enc)
    w_pt = helper.encode_weights(be.encode_polynomial, w)

    y_full = helper.matmul(ev, x_ct, w_pt)
    monkeypatch.setattr(lin, "_MAX_PLAIN_MULS_PER_DISPATCH", 2)
    y_chunked = helper.matmul(ev, x_ct, w_pt)
    for r_full, r_chunk in zip(y_full.data, y_chunked.data):
        for cf, cc in zip(r_full, r_chunk):
            np.testing.assert_array_equal(np.asarray(cf.data),
                                          np.asarray(cc.data))
    got = helper.decrypt_outputs(be.decode_polynomial, dec, y_chunked)
    np.testing.assert_array_equal(
        got.astype(object) % t, (x.astype(object) @ w.astype(object)) % t)
