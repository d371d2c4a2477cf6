"""N-ceiling proof: n = 262144 — 2x the reference's hard maximum — runs
end to end under coefficient sharding.

The reference caps the polynomial degree at N <= 131072
(reference: src/utils/defines.h:30 SEAL_POLY_MOD_DEGREE_MAX) because its
scaling unit is one GPU. Our coefficient-sharded regime splits the
polynomial axis over a device mesh (parallel/sharding.py
coeff_sharded_multiply_relin): GSPMD partitions the coefficient axis and
inserts the collectives the NTT needs across shards, so the degree
ceiling becomes a cluster-size question, not a one-device one.

This script executes encrypt -> coefficient-sharded multiply+relinearize
-> decrypt at n=262144 on the virtual 8-device CPU mesh, asserts the
result is WORD-FOR-WORD identical to a single-device replay, decrypts to
the exact expected product, and records the run in
results/nceiling.json.

Usage: python benchmarks/nceiling.py [n]   (default 262144)
"""

import json
import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax                                    # noqa: E402
jax.config.update("jax_platforms", "cpu")
from troy_tpu.utils import jax_cache          # noqa: E402
jax_cache.enable()
import numpy as np                            # noqa: E402

import troy_tpu as T                          # noqa: E402
from troy_tpu import prng as rnd              # noqa: E402
from troy_tpu.parallel import sharding as sh  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 262144
    q_bits = [55, 55, 60]
    t0 = time.time()
    devs = jax.devices()
    assert len(devs) == 8, f"expected the 8-device virtual mesh, got {devs}"

    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, q_bits)),
        plain_modulus=T.PlainModulus.batching(n, 30))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(262144))
    rlk = kg.create_relin_keys()
    enc = T.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(262144))
    dec = T.Decryptor(ctx, kg.secret_key)
    be = T.BatchEncoder(ctx)
    ev = T.Evaluator(ctx)
    t_plain = int(parms.plain_modulus)
    print(f"setup: {time.time()-t0:.1f}s "
          f"(n={n}, k={ctx.first_context_data.limbs} data limbs)", flush=True)

    rng = np.random.default_rng(1)
    v1 = rng.integers(0, t_plain, size=n, dtype=np.uint64)
    v2 = rng.integers(0, t_plain, size=n, dtype=np.uint64)
    ct1 = enc.encrypt_symmetric(be.encode(v1))
    ct2 = enc.encrypt_symmetric(be.encode(v2))
    print(f"encrypted: {time.time()-t0:.1f}s", flush=True)

    # single-device replay (the truth the sharded run must match)
    ref = ev.relinearize(ev.multiply(ct1, ct2), rlk)
    ref_np = np.asarray(ref.data)
    print(f"single-device replay: {time.time()-t0:.1f}s", flush=True)

    mesh = sh.make_mesh(8, axis_name="coeff")
    run = sh.coeff_sharded_multiply_relin(ctx, rlk, mesh, axis_name="coeff")
    out = run(ct1.data, ct2.data)
    out_np = np.asarray(out)
    assert np.array_equal(out_np, ref_np), \
        "coefficient-sharded result differs from the single-device replay"
    print(f"coeff-sharded mult+relin: {time.time()-t0:.1f}s, "
          "word-for-word equal to the single-device replay", flush=True)

    got = be.decode(dec.decrypt(ref.replace(data=out)))
    expect = (v1.astype(object) * v2.astype(object)) % t_plain
    assert np.array_equal(got, expect), "decrypt mismatch"
    elapsed = time.time() - t0
    print(f"decrypt bit-exact: {elapsed:.1f}s total", flush=True)

    # memory footprint: per-device slice sizes under coefficient sharding
    # over 8 devices
    k = ctx.first_context_data.limbs
    ct_bytes = 2 * k * n * 8
    key_bytes = (len(ctx.key_context_data.coeff_values) - 1) * 2 * \
        len(ctx.key_context_data.coeff_values) * n * 8
    record = {
        "ok": True,
        "n": n,
        "reference_ceiling": 131072,
        "q_bits": q_bits,
        "devices": 8,
        "elapsed_s": round(elapsed, 1),
        "ciphertext_mb": round(ct_bytes / 2**20, 2),
        "relin_key_mb": round(key_bytes / 2**20, 2),
        "per_device_ct_slice_mb": round(ct_bytes / 8 / 2**20, 2),
        "note": ("encrypt -> coefficient-sharded multiply+relinearize -> "
                 "decrypt at 2x the reference's SEAL_POLY_MOD_DEGREE_MAX "
                 "(defines.h:30), bit-exact vs a single-device replay on "
                 "the virtual 8-device mesh"),
    }
    out = os.path.join(REPO, "results", "nceiling.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
