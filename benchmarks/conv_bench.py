"""HE conv2d end-to-end benchmark — the reference's conv app benchmark.

Mirrors test/app/linear.cu:581-583 (reference, commented config
1x64x256x56x56 k3): ct x pt 2-D convolution with coefficient packing,
timing each protocol phase. Default dimensions are scaled down so a single
run stays in minutes; pass the reference's full config explicitly to
reproduce it.

Usage: python benchmarks/conv_bench.py [batch] [ci] [co] [H] [W] [kh] [kw]
"""

import os
import sys
import time

import numpy as np


def main():
    import jax
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu.app.linear import Conv2dHelper
    from troy_tpu.utils import jax_cache
    jax_cache.enable()

    args = [int(a) for a in sys.argv[1:]]
    bs, ci, co, H, W, kh, kw = (args + [1, 16, 32, 28, 28, 3, 3][len(args):])
    n = 16384

    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, [60, 60, 60])),
        plain_modulus=T.Modulus(1 << 41))
    ctx = T.HeContext(parms)
    t0 = time.time()
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(0xC0DE))
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    ev = T.Evaluator(ctx)
    be = T.BatchEncoder(ctx)
    print(f"[setup {time.time()-t0:.1f}s] conv2d {bs}x{ci}x{co} "
          f"{H}x{W} k{kh}x{kw} n={n}", flush=True)

    t_mod = int(parms.plain_modulus)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 6, (bs, ci, H, W), dtype=np.uint64)
    w = rng.integers(0, 1 << 6, (co, ci, kh, kw), dtype=np.uint64)

    helper = Conv2dHelper(bs, H, W, kh, kw, ci, co, n, objective=0)
    print(f"  block: b={helper.block_batch} h={helper.block_height} "
          f"w={helper.block_width} ci={helper.block_in_channels} "
          f"co={helper.block_out_channels}", flush=True)

    def phase(name, fn):
        t0 = time.time()
        out = fn()
        jax.tree.map(lambda a: a.block_until_ready()
                     if hasattr(a, "block_until_ready") else a, out)
        print(f"  {name:24s} {(time.time()-t0)*1e3:10.1f} ms", flush=True)
        return out

    w_enc = phase("encode weights",
                  lambda: helper.encode_weights(be.encode_polynomial, w))
    x_ct = phase("encode+encrypt inputs",
                 lambda: helper.encrypt_inputs(enc, be.encode_polynomial, x))
    y_ct = phase("conv2d", lambda: helper.conv2d(ev, x_ct, w_enc))
    y_ct = phase("conv2d (warm)", lambda: helper.conv2d(ev, x_ct, w_enc))
    blob = phase("serialize outputs",
                 lambda: helper.serialize_outputs(ev, ctx, y_ct))
    print(f"  {'output bytes':24s} {len(blob):10d}", flush=True)
    back = phase("deserialize",
                 lambda: helper.deserialize_outputs(ev, ctx, blob))
    got = phase("decrypt+decode outputs",
                lambda: helper.decrypt_outputs(be.decode_polynomial, dec,
                                               back))
    # plain integer conv2d oracle
    oh, ow = H - kh + 1, W - kw + 1
    expect = np.zeros((bs, co, oh, ow), dtype=object)
    for b in range(bs):
        for oc in range(co):
            acc = np.zeros((oh, ow), dtype=object)
            for icc in range(ci):
                for di in range(kh):
                    for dj in range(kw):
                        acc += (x[b, icc, di:di + oh, dj:dj + ow].astype(object)
                                * int(w[oc, icc, di, dj]))
            expect[b, oc] = acc % t_mod
    ok = np.array_equal(got.astype(object) % t_mod, expect)
    print(f"  correctness: {'OK' if ok else 'FAIL'}", flush=True)


if __name__ == "__main__":
    main()
