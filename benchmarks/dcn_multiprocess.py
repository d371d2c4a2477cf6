"""Multi-process collective execution of the sharded regimes.

The reference is strictly single-process (cudaSetDevice(0) hard-coded,
reference: src/kernelprovider.cuh:30; no NCCL/MPI anywhere). This script
executes our sharded mult+relin regimes ACROSS A REAL PROCESS BOUNDARY
via ``jax.distributed``: two OS processes, each owning 4 virtual CPU
devices, form one 8-device global mesh; GSPMD's collectives then run on
the cross-process code path — the same code path that carries
traffic between hosts (BASELINE.md's "N hosts" axis).

Regimes (all decrypt bit-exactly against a single-device replay):
  dp8   : batch of 8 mult+relin, batch axis over all 8 devices
          (4 per process) — cross-process placement, zero collectives.
  tp2x  : ONE ciphertext, RNS-limb axis split 3+3 across a 2-device mesh
          with one device FROM EACH PROCESS — the key-switch inner
          product and BEHZ base conversions reduce across the process
          boundary (the analogue of a cross-host psum).
  dp4tp2x: 2-D (4, 2) mesh whose tp PAIRS each span both processes —
          every limb collective crosses the boundary, batches stay local.
  app2x : the APP-LAYER MatmulHelper tile contraction (BASELINE config 5,
          "app pipeline sharded across multi-host pod"): the output-tile
          axis of the coefficient-packed matmul is split across a
          2-device mesh with one device FROM EACH PROCESS — each process
          computes its slice of the server-side multiplyPlain+add fan-out
          (LinearHelper.cuh:403-427), results gathered over the process
          boundary and decrypted through the helper's own output path.

Usage:
  python benchmarks/dcn_multiprocess.py            # launcher: spawns both
  python benchmarks/dcn_multiprocess.py --proc N   # worker (internal)

The launcher writes results/multiprocess.json under the repo root.
"""

import json
import os
import subprocess
import sys
import time

N = int(os.environ.get("TROY_DCN_N", "8192"))
# 6 data limbs by default: a limb axis divisible by the 2-device tp
# meshes; any config with an even data-limb count works (the test suite
# runs a small n=256 / 2-limb variant of all three regimes)
Q_BITS = [int(b) for b in os.environ.get(
    "TROY_DCN_QBITS", "60,40,40,40,40,40,60").split(",")]
T_BITS = int(os.environ.get("TROY_DCN_TBITS", "20"))
PORT = int(os.environ.get("TROY_DCN_PORT", "12923"))
OUT_JSON = os.environ.get("TROY_DCN_OUT",
                          os.path.join("results", "multiprocess.json"))
# app-layer matmul dims (batch, input_dims, output_dims); defaults sized
# so the output-tile axis splits evenly over the 2-device cross mesh
MM_DIMS = tuple(int(x) for x in os.environ.get(
    "TROY_DCN_MM", "8,1024,64").split(","))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
LOCAL_DEVICES = 4


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------

def worker(pid: int) -> None:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from troy_tpu.utils import jax_cache
    jax_cache.enable()
    jax.distributed.initialize(coordinator_address=f"localhost:{PORT}",
                               num_processes=NPROC, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu.parallel import sharding as sh

    assert jax.process_count() == NPROC
    devs = jax.devices()
    assert len(devs) == NPROC * LOCAL_DEVICES, devs
    local = [d for d in devs if d.process_index == pid]
    assert len(local) == LOCAL_DEVICES

    def log(msg):
        print(f"[proc {pid}] {msg}", flush=True)

    def to_np(tree):
        """Process-local device arrays -> host numpy so the pytree can be
        passed into a GLOBAL (multi-process) computation as replicated
        inputs (identical on both processes by construction: same seed,
        same deterministic integer programs)."""
        return jax.tree.map(
            lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)

    # Both processes derive identical keys/tables from the same seed.
    seed = rnd.seed_from_uint64(31337)
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=T.PlainModulus.batching(N, T_BITS))
    # 6 data limbs at n=8192 exceeds the 128-bit table bound; this run
    # certifies the cross-process code path, not a security level
    ctx = T.HeContext(parms, sec_level=T.SecurityLevel.none)
    kg = T.KeyGenerator(ctx, seed=seed)
    rlk = kg.create_relin_keys()
    enc = T.Encryptor(ctx, secret_key=kg.secret_key, seed=seed)
    dec = T.Decryptor(ctx, kg.secret_key)
    be = T.BatchEncoder(ctx)
    t_plain = int(parms.plain_modulus)
    log(f"context+keys ready (k={ctx.first_context_data.limbs} data limbs)")

    B = NPROC * LOCAL_DEVICES
    rng = np.random.default_rng(7)
    vals1 = rng.integers(0, t_plain, size=(B, N), dtype=np.uint64)
    vals2 = rng.integers(0, t_plain, size=(B, N), dtype=np.uint64)
    cts1 = [enc.encrypt_symmetric(be.encode(vals1[i])) for i in range(B)]
    cts2 = [enc.encrypt_symmetric(be.encode(vals2[i])) for i in range(B)]
    d1 = np.stack([np.asarray(c.data) for c in cts1])    # (B, 2, k, n)
    d2 = np.stack([np.asarray(c.data) for c in cts2])

    cd_np = to_np(ctx.first_context_data)
    key_cd_np = to_np(ctx.key_context_data)
    key_np = np.asarray(rlk.keys[2])

    # single-device truth (computed independently per process)
    step = sh._mult_relin_step(ctx.scheme)
    local_step = jax.jit(step)
    expect0 = np.asarray(local_step(d1[0], d2[0], cd_np, key_np, key_cd_np))

    def check_decrypt(out_np, i):
        ct = T.Ciphertext(data=jnp.asarray(out_np), level=ctx.first_level,
                          is_ntt_form=False)
        got = be.decode(dec.decrypt(ct))
        want = (vals1[i].astype(object) * vals2[i].astype(object)) % t_plain
        assert np.array_equal(got, want), f"decrypt mismatch at batch {i}"

    results = {}

    def make_global(arr, sharding):
        """Global sharded array from identical per-process numpy WITHOUT
        device_put's hidden cross-process assert_equal collective (which
        races gloo group formation against compile skew)."""
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])

    def barrier(name):
        """Coordination-service barrier (no gloo): absorbs compile-time
        skew between the processes so gloo group formation at the next
        collective does not hit its 30 s connect timeout."""
        from jax._src import distributed
        distributed.global_state.client.wait_at_barrier(name, 600_000)

    # ---- regime 1: DP over all 8 devices (crosses processes) ----
    mesh = Mesh(np.array(devs), ("dp",))
    spec = NamedSharding(mesh, P("dp"))
    batched = jax.jit(jax.vmap(step, in_axes=(0, 0, None, None, None)),
                      in_shardings=(spec, spec, None, None, None),
                      out_shardings=spec)
    g1 = make_global(d1, spec)
    g2 = make_global(d2, spec)
    batched_c = batched.lower(g1, g2, cd_np, key_np, key_cd_np).compile()
    log("dp8 compiled")
    barrier("dp8-compiled")
    out = batched_c(g1, g2, cd_np, key_np, key_cd_np)
    out_np = multihost_utils.process_allgather(out, tiled=True)
    assert np.array_equal(out_np[0], expect0), "dp8 not bit-exact"
    for i in range(B):
        check_decrypt(out_np[i], i)
    log("dp8: bit-exact across 2 processes (8 ciphertexts)")
    results["dp8"] = True

    # ---- regime 2: limb TP across the process boundary ----
    # one device from EACH process: every limb-axis reduction (key-switch
    # inner product, BEHZ base conversion) crosses the process boundary.
    mesh_x = Mesh(np.array([devs[0], devs[LOCAL_DEVICES]]), ("tp",))
    spec_x = NamedSharding(mesh_x, P(None, "tp", None))
    key_spec_x = NamedSharding(mesh_x, P("tp", None, None, None))
    tp_step = jax.jit(step,
                      in_shardings=(spec_x, spec_x, None, key_spec_x, None),
                      out_shardings=spec_x)
    s1 = make_global(d1[0], spec_x)
    s2 = make_global(d2[0], spec_x)
    key_x = make_global(key_np, key_spec_x)
    tp_c = tp_step.lower(s1, s2, cd_np, key_x, key_cd_np).compile()
    log("tp2x compiled")
    barrier("tp2x-compiled")
    out = tp_c(s1, s2, cd_np, key_x, key_cd_np)
    out_np = multihost_utils.process_allgather(out, tiled=True)
    assert np.array_equal(out_np, expect0), "tp2x not bit-exact"
    check_decrypt(out_np, 0)
    log("tp2x: limb-sharded mult+relin bit-exact ACROSS the process "
        "boundary (cross-process psum on the key-switch contraction)")
    results["tp2x"] = True

    # ---- regime 3: 2-D, tp pairs spanning both processes ----
    order = []
    for i in range(LOCAL_DEVICES):
        order.append(devs[i])                   # process 0
        order.append(devs[LOCAL_DEVICES + i])   # process 1
    mesh2 = Mesh(np.array(order).reshape(LOCAL_DEVICES, 2), ("dp", "tp"))
    spec2 = NamedSharding(mesh2, P("dp", None, "tp", None))
    key_spec2 = NamedSharding(mesh2, P("tp", None, None, None))
    batched2 = jax.jit(jax.vmap(step, in_axes=(0, 0, None, None, None)),
                       in_shardings=(spec2, spec2, None, key_spec2, None),
                       out_shardings=spec2)
    g1 = make_global(d1[:LOCAL_DEVICES], spec2)
    g2 = make_global(d2[:LOCAL_DEVICES], spec2)
    key_2 = make_global(key_np, key_spec2)
    b2_c = batched2.lower(g1, g2, cd_np, key_2, key_cd_np).compile()
    log("dp4tp2x compiled")
    barrier("dp4tp2x-compiled")
    out = b2_c(g1, g2, cd_np, key_2, key_cd_np)
    out_np = multihost_utils.process_allgather(out, tiled=True)
    assert np.array_equal(out_np[0], expect0), "dp4tp2x not bit-exact"
    for i in range(LOCAL_DEVICES):
        check_decrypt(out_np[i], i)
    log("dp4tp2x: 2-D regime bit-exact with every tp pair spanning "
        "both processes")
    results["dp4tp2x"] = True

    # ---- regime 4: app-layer matmul, output tiles across processes ----
    from troy_tpu.app import linear as lin
    Bm, Im, Om = MM_DIMS
    helper = lin.MatmulHelper(Bm, Im, Om, N, objective=0, pack_lwe=False)
    rng_mm = np.random.default_rng(11)
    x_mm = rng_mm.integers(0, t_plain, size=(Bm, Im), dtype=np.uint64)
    w_mm = rng_mm.integers(0, t_plain, size=(Im, Om), dtype=np.uint64)
    x_ct2d = helper.encode_inputs(be.encode_polynomial, x_mm) \
        .encrypt_symmetric(enc)           # identical on both procs (seeded)
    w_pt2d = helper.encode_weights(be.encode_polynomial, w_mm)
    ct_tiles = np.stack([np.stack([np.asarray(c.data) for c in row])
                         for row in x_ct2d.data])       # (X, I, 2, k, n)
    pt_tiles = np.stack([np.stack([np.asarray(p.data) for p in row])
                         for row in w_pt2d.data])       # (I, Y, n)
    Y = pt_tiles.shape[1]
    assert Y % 2 == 0, f"output-tile axis {Y} must split over the 2 procs"

    def app_step(ct_t, pt_t, cdl):
        return lin._matmul_tiles_core.__wrapped__(ct_t, pt_t, cdl,
                                                  True, True)

    ct_spec = NamedSharding(mesh_x, P(None, None, None, None, None))
    pt_spec = NamedSharding(mesh_x, P(None, "tp", None))
    out_spec = NamedSharding(mesh_x, P(None, "tp", None, None, None))
    app_jit = jax.jit(app_step,
                      in_shardings=(ct_spec, pt_spec, None),
                      out_shardings=out_spec)
    g_ct = make_global(ct_tiles, ct_spec)
    g_pt = make_global(pt_tiles, pt_spec)
    app_c = app_jit.lower(g_ct, g_pt, cd_np).compile()
    log("app2x compiled")
    barrier("app2x-compiled")
    out = app_c(g_ct, g_pt, cd_np)
    out_np = multihost_utils.process_allgather(out, tiled=True)
    # single-device replay
    expect_tiles = np.asarray(jax.jit(app_step)(ct_tiles, pt_tiles, cd_np))
    assert np.array_equal(out_np, expect_tiles), "app2x not bit-exact"
    template = x_ct2d.data[0][0]
    y2d = lin.Cipher2d([[template.replace(data=jnp.asarray(out_np[xi, yi]),
                                          seed=0)
                         for yi in range(out_np.shape[1])]
                        for xi in range(out_np.shape[0])])
    y_dec = helper.decrypt_outputs(be.decode_polynomial, dec, y2d)
    want_mm = (x_mm.astype(object) @ w_mm.astype(object)) % t_plain
    assert np.array_equal(y_dec.astype(object) % t_plain, want_mm), \
        "app2x decrypt mismatch"
    log(f"app2x: MatmulHelper {Bm}x{Im}x{Om} tile contraction bit-exact "
        "with the output-tile axis split ACROSS the process boundary")
    results["app2x"] = True

    multihost_utils.sync_global_devices("done")
    if pid == 0:
        print("RESULTS " + json.dumps(results), flush=True)
    jax.distributed.shutdown()


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def launch() -> int:
    env = dict(os.environ)
    # the workers import troy_tpu from this checkout
    env["PYTHONPATH"] = REPO
    env.pop("PYTHONSTARTUP", None)
    procs = []
    t0 = time.time()
    for pid in range(NPROC):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--proc", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    for i, o in enumerate(outs):
        print(f"----- proc {i} (exit {codes[i]}) -----")
        print(o)
    ok = all(c == 0 for c in codes)
    results = {}
    for line in outs[0].splitlines():
        if line.startswith("RESULTS "):
            results = json.loads(line[len("RESULTS "):])
    record = {
        "ok": ok and bool(results) and all(results.values()),
        "processes": NPROC,
        "devices_per_process": LOCAL_DEVICES,
        "n": N, "q_bits": Q_BITS,
        "regimes": results,
        "elapsed_s": round(time.time() - t0, 1),
        "note": ("cross-process GSPMD collectives executed via "
                 "jax.distributed; every regime decrypted bit-exactly and "
                 "matched a single-device replay word-for-word"),
    }
    out = os.path.join(REPO, OUT_JSON)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    if "--proc" in sys.argv:
        worker(int(sys.argv[sys.argv.index("--proc") + 1]))
    else:
        sys.exit(launch())
