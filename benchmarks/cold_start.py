"""Cold-start-to-first-result for the app matmul protocol (VERDICT r4 #7).

Measures the FULL cold path a fresh client/server process pays before its
first decrypted matmul result at the reference benchmark config
(batch=64, in=128, out=256, BFV n=16384 q={60,60,60} t=2^41 with LWE
output packing — reference: test/app/linear.cu:575-584, whose Timer
blocks time phases but never the cold boot): process start -> imports ->
context + keygen -> encode/encrypt -> matmul -> pack -> serialize ->
decrypt+decode, wall-clock.

Two sessions, one process each (XLA's compile cache is process+dir
keyed):
  * cold  — a FRESH empty JAX_COMPILATION_CACHE_DIR: every executable
    compiles from scratch (the real first-boot cost);
  * cached — the standing persistent cache (troy_tpu.utils.jax_cache):
    compiles are disk hits, the residual is executable load and transfer
    time.

Writes results/cold_start.json under the repo root, one session per
device kind; a failed session never replaces a good one.

Usage: python benchmarks/cold_start.py            (parent; runs both)
       python benchmarks/cold_start.py child      (one measured session)
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = time.perf_counter()             # process start (child mode)


def child():
    phases = []
    last = T0

    def mark(name):
        nonlocal last
        now = time.perf_counter()
        phases.append((name, now - last))
        print(f"  {name:28s} {now - last:8.2f} s", file=sys.stderr,
              flush=True)
        last = now

    import numpy as np
    import jax
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu.app.linear import MatmulHelper
    mark("imports (jax + troy_tpu)")

    n, bs, ind, outd = 16384, 64, 128, 256
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, [60, 60, 60])),
        plain_modulus=T.Modulus(1 << 41))
    ctx = T.HeContext(parms)
    for cd in ctx.chain:
        jax.block_until_ready(jax.tree_util.tree_leaves(cd))
    mark("context build")
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(0xABCD))
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    ev = T.Evaluator(ctx)
    be = T.BatchEncoder(ctx)
    auto_keys = kg.create_automorphism_keys()
    jax.block_until_ready(jax.tree_util.tree_leaves(auto_keys))
    mark("keygen (incl. automorphism keys)")

    t_mod = int(parms.plain_modulus)
    rng = np.random.default_rng(12)
    x = rng.integers(0, 1 << 8, (bs, ind), dtype=np.uint64)
    w = rng.integers(0, 1 << 8, (ind, outd), dtype=np.uint64)
    helper = MatmulHelper(bs, ind, outd, n, objective=0, pack_lwe=True)
    def block2d(c2d):
        jax.block_until_ready([c.data for row in c2d.data for c in row])

    w_enc = helper.encode_weights(be.encode_polynomial, w)
    x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
    block2d(x_ct)
    mark("encode weights + encrypt inputs")
    y_ct = helper.matmul(ev, x_ct, w_enc)
    block2d(y_ct)
    mark("matmul (incl. compiles)")
    packed = helper.pack_outputs(ev, auto_keys, y_ct)
    block2d(packed)
    mark("pack outputs (incl. compiles)")
    blob = helper.serialize_outputs(ev, ctx, packed)
    mark("serialize outputs")
    back = helper.deserialize_outputs(ev, ctx, blob)
    got = helper.decrypt_outputs(be.decode_polynomial, dec, back)
    mark("deserialize + decrypt + decode")
    ok = bool(np.array_equal(got, (x @ w) % t_mod))
    total = time.perf_counter() - T0
    print(json.dumps(dict(ok=ok, total_s=round(total, 2),
                          device_kind=jax.devices()[0].device_kind,
                          phases=[(nm, round(dt, 2)) for nm, dt in phases])))


def main():
    from troy_tpu.utils import jax_cache
    env_common = dict(os.environ,
                      JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1",
                      JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    sessions = {}
    with tempfile.TemporaryDirectory(prefix="troy_cold_cache_") as fresh:
        for name, cache in (("cold", fresh),
                            ("cached", jax_cache.cache_dir())):
            print(f"== {name} session (cache dir: {cache}) ==", flush=True)
            env = dict(env_common, JAX_COMPILATION_CACHE_DIR=cache)
            t0 = time.time()
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "child"],
                env=env, capture_output=True, text=True, timeout=7200)
            sys.stderr.write(p.stderr[-4000:])
            try:
                rec = json.loads(p.stdout.strip().splitlines()[-1])
            except (ValueError, IndexError):
                rec = None
            if p.returncode != 0 or rec is None:
                print(f"{name} session FAILED rc={p.returncode}")
                print(p.stdout[-2000:])
                sessions[name] = dict(ok=False, rc=p.returncode)
                continue
            rec["wall_s"] = round(time.time() - t0, 2)
            sessions[name] = rec
            print(f"{name}: total {rec['total_s']} s "
                  f"(ok={rec['ok']})", flush=True)
    # Key each session by device kind and MERGE into the artifact, so
    # several devices sit side by side; a failed session is printed but
    # never replaces a recorded good one.
    out = os.path.join(REPO, "results", "cold_start.json")
    merged = dict(config="matmul 64x128x256 packLwe, BFV n=16384 "
                         "q={60,60,60} t=2^41", sessions={})
    if os.path.exists(out):
        with open(out) as f:
            merged["sessions"].update(json.load(f).get("sessions", {}))
    kind = next((r["device_kind"] for r in sessions.values()
                 if "device_kind" in r), "unknown device")
    for name, rec in sessions.items():
        key = f"{name}_{kind}"
        if rec.get("ok") or not merged["sessions"].get(key, {}).get("ok"):
            merged["sessions"][key] = rec
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "child":
        child()
    else:
        main()
