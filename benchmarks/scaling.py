"""Weak-scaling harness: data-parallel ciphertext batches over a mesh.

The reference is single-GPU by construction (cudaSetDevice(0),
src/kernelprovider.cuh:30); this measures what it cannot express —
mult+relin throughput as the batch and the mesh grow together
(BASELINE.md: >=80% weak-scaling efficiency target).

The default run uses the virtual CPU mesh (JAX_PLATFORMS=cpu,
xla_force_host_platform_device_count): the sharding/collective layout is
the one a multi-GPU mesh gets; only the per-device speed differs.
TROY_SCALING_BACKEND=default runs on the default platform's devices.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/scaling.py [n] [reps]
"""

import os
import sys
import time

import numpy as np


def main():
    import jax
    if os.environ.get("TROY_SCALING_BACKEND", "cpu") == "cpu":
        # an explicit config update lands on the virtual CPU mesh even
        # when JAX was imported with another platform configured
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu.parallel import sharding as par
    from troy_tpu.utils import jax_cache
    jax_cache.enable()

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}", flush=True)

    # realistic 6-prime chain (5 data limbs) — the shape the round-1
    # verdict asked the scaling evidence to be recorded at
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, [40] * 6)),
        plain_modulus=T.PlainModulus.batching(n, 20))
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(777))
    rlk = kg.create_relin_keys()
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    be = T.BatchEncoder(ctx)

    a = np.arange(n, dtype=np.uint64) % int(parms.plain_modulus)
    base_ct1 = enc.encrypt_symmetric(be.encode(a)).data
    base_ct2 = enc.encrypt_symmetric(be.encode(a[::-1].copy())).data

    results = {}
    d = 1
    while d <= n_dev:
        per_dev_batch = 4
        B = d * per_dev_batch
        mesh = par.make_mesh(d)
        d1 = par.shard_batch(mesh, jnp.stack([base_ct1] * B))
        d2 = par.shard_batch(mesh, jnp.stack([base_ct2] * B))
        run = par.batched_multiply_relin(ctx, rlk, mesh)
        out = run(d1, d2)
        out.block_until_ready()
        t0 = time.time()
        for _ in range(reps):
            out = run(d1, d2)
        out.block_until_ready()
        dt = (time.time() - t0) / reps
        ops = B / dt
        results[d] = ops
        eff = ops / (results[1] * d) * 100 if 1 in results else 100.0
        print(f"  {d} dev x batch {per_dev_batch}: {ops:9.1f} ops/s "
              f"(weak-scaling eff {eff:5.1f}%)", flush=True)
        d *= 2
    # ---- limb-sharded STRONG scaling of one mult+relin ----
    # one ciphertext's RNS limbs spread over the mesh: the BEHZ base
    # conversions and the key-switch inner product reduce over the mesh
    # (psum) — this measures the collective overhead GSPMD inserts.
    from jax.sharding import NamedSharding, PartitionSpec as P
    limbs = ctx.first_context_data.limbs
    print(f"limb-sharded strong scaling (k={limbs} data limbs):",
          flush=True)
    t1 = None
    for d in (1, limbs):
        if d > n_dev:
            break
        mesh = par.make_mesh(d)
        spec = NamedSharding(mesh, P(None, "dp", None))
        run = par.limb_sharded_multiply_relin(ctx, rlk, mesh)
        e1 = jax.device_put(base_ct1, spec)
        e2 = jax.device_put(base_ct2, spec)
        out = run(e1, e2)
        out.block_until_ready()
        t0 = time.time()
        for _ in range(reps):
            out = run(e1, e2)
        out.block_until_ready()
        dt = (time.time() - t0) / reps
        if t1 is None:
            t1 = dt
        speedup = t1 / dt
        eff = speedup / d * 100
        print(f"  {d} dev: {dt*1e3:9.2f} ms/op  speedup {speedup:5.2f}x "
              f"(strong-scaling eff {eff:5.1f}%)", flush=True)
        # hardware-independent collective cost: bytes moved by the
        # collectives GSPMD inserted, read off the compiled HLO
        import re as _re
        hlo = run.jitted.lower(e1, e2, *run.args).compile().as_text()
        vol = 0
        n_coll = 0
        for mt in _re.finditer(
                r"(all-reduce|all-gather|all-to-all|collective-permute|"
                r"reduce-scatter)[^\n]*?\bu(?:64|32)\[([0-9,]*)\]", hlo):
            dims = [int(x) for x in mt.group(2).split(",") if x]
            elems = 1
            for x in dims:
                elems *= x
            vol += elems * 8
            n_coll += 1
        if d > 1:
            print(f"         collectives in HLO: {n_coll} ops, "
                  f"{vol/1e6:.2f} MB moved per mult+relin", flush=True)

    if jax.devices()[0].platform == "cpu":
        print("  NOTE: virtual CPU devices share this host's physical "
              "cores — efficiency here validates the sharding layout, "
              "not real per-device scaling (that needs several GPUs).",
              flush=True)


if __name__ == "__main__":
    main()
