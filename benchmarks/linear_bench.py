"""HE matmul end-to-end benchmark — the reference's app benchmark rebuilt.

Mirrors test/app/linear.cu:575-584 (reference): ct x pt matmul
batch=64, in=128, out=256 with LWE output packing, BFV n=16384
q={60,60,60} t=2^41, timing each protocol phase (encode, encrypt, matmul,
pack, serialize, decrypt+decode) like the reference's Timer blocks
(linear.cu:8-49).

Phases run in protocol order; device-compute phases (matmul, pack) execute
before the first device->host readback (serialize), so they are measured
in the harness's undegraded mode.

Usage: python benchmarks/linear_bench.py [batch] [in] [out] [pack]
  pack: 1 (default) = LWE output packing + ct x ct variant, the reference
  main's testMatmulCipherInts(64, 128, 256, true) config;
  0 = plain-weight matmul with saveTerms output serialization, the
  reference main's commented testMatmulInts(128, 500, 1001, false) config
  (test/app/linear.cu:581).
"""

import os
import sys
import time

import numpy as np


def main():
    import jax
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu.app.linear import MatmulHelper
    from troy_tpu.utils import jax_cache
    jax_cache.enable()

    bs = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    ind = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    outd = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    pack = bool(int(sys.argv[4])) if len(sys.argv) > 4 else True
    n = 16384

    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, [60, 60, 60])),
        plain_modulus=T.Modulus(1 << 41))
    ctx = T.HeContext(parms)
    t0 = time.time()
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(0xABCD))
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    ev = T.Evaluator(ctx)
    be = T.BatchEncoder(ctx)
    auto_keys = kg.create_automorphism_keys() if pack else None
    print(f"[setup {time.time()-t0:.1f}s] matmul {bs}x{ind}x{outd} "
          f"n={n} {'packLwe' if pack else 'saveTerms (no packing)'}",
          flush=True)

    t_mod = int(parms.plain_modulus)
    rng = np.random.default_rng(12)
    x = rng.integers(0, 1 << 8, (bs, ind), dtype=np.uint64)
    w = rng.integers(0, 1 << 8, (ind, outd), dtype=np.uint64)

    helper = MatmulHelper(bs, ind, outd, n, objective=0, pack_lwe=pack)

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
    y_ct = phase("matmul", lambda: helper.matmul(ev, x_ct, w_enc))
    # warm compile separated from steady-state timing
    y_ct2 = phase("matmul (warm)", lambda: helper.matmul(ev, x_ct, w_enc))
    if pack:
        packed = phase("pack outputs (LWE tree)",
                       lambda: helper.pack_outputs(ev, auto_keys, y_ct))
        packed = phase("pack outputs (warm)",
                       lambda: helper.pack_outputs(ev, auto_keys, y_ct2))
        # ct x ct variant (the reference main's testMatmulCipherInts config,
        # test/app/linear.cu:575-584)
        w_ct = phase("encrypt weights (ct x ct)",
                     lambda: helper.encode_weights(be.encode_polynomial, w)
                     .encrypt_symmetric(enc))
        yc = phase("matmul ct x ct",
                   lambda: helper.matmul_cipher(ev, x_ct, w_ct))
        yc = phase("matmul ct x ct (warm)",
                   lambda: helper.matmul_cipher(ev, x_ct, w_ct))
    else:
        packed = y_ct2

    blob = phase("serialize outputs",
                 lambda: helper.serialize_outputs(ev, ctx, packed))
    print(f"  {'output bytes':24s} {len(blob):10d}", flush=True)
    back = phase("deserialize",
                 lambda: helper.deserialize_outputs(ev, ctx, blob))
    got = phase("decrypt+decode outputs",
                lambda: helper.decrypt_outputs(be.decode_polynomial, dec,
                                               back))
    expect = (x @ w) % t_mod
    ok = np.array_equal(got, expect)
    print(f"  correctness: {'OK' if ok else 'FAIL'}", flush=True)


if __name__ == "__main__":
    main()
