"""Benchmarks for the two beyond-reference batching claims.

1. HOISTED multi-rotation (`Evaluator.rotate_many` /
   `apply_galois_many`): the digit decomposition + k x (k+1) NTTs of c1
   are computed once and shared by every rotation of the same ciphertext
   (evaluator.py _hoisted_galois_core), where the reference re-decomposes
   per rotation (evaluator_cuda.cu:2024 applyGaloisInplace ->
   switchKeyInplace from scratch each call). Measures the curve vs
   rotation count m: m sequential rotate_rows vs one rotate_many, in
   round-robin windows (median window reported).

2. BATCHED LWE pack tree (`Evaluator.pack_lwe_ciphertexts`): every
   (even, odd) fold of a tree layer runs as one vmapped dispatch
   (evaluator.py _pack_tree_layer_core), where the reference folds pair
   by pair with one key-switch launch each (evaluator_cuda.cu:2278-2341).
   The per-pair baseline here is a faithful transcription of the
   reference's loop built from this framework's PUBLIC ops (shift, sub,
   add, apply_galois, field_trace), so both sides decrypt to identical
   slot values.

Usage: python benchmarks/hoist_bench.py [reps_per_window]

Artifact: set TROY_HOIST_OUT=<path.json> to record every row (ms,
speedups, correctness verdict) under a per-device key (device_kind and
n) — merged into the existing file so one JSON carries several devices
side by side (VERDICT r4 #3).
"""

import json
import os
import statistics
import sys
import time

import numpy as np

N = int(os.environ.get("TROY_HOIST_N", "16384"))
Q_BITS = [60, 40, 40, 40, 40, 60] if N >= 8192 else [40, 40, 40]
ROT_COUNTS = (1, 2, 4, 8, 16)
# LWE counts packed by the tree; TROY_HOIST_PACK (comma list) overrides
PACK_COUNTS = tuple(int(x) for x in os.environ.get(
    "TROY_HOIST_PACK", "16,64").split(",") if x)


def main():
    import jax
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu.utils import jax_cache
    jax_cache.enable()
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    dev = jax.devices()[0]
    print(f"devices: {jax.devices()}", flush=True)
    record = {"device": dict(platform=dev.platform, kind=dev.device_kind,
                             count=len(jax.devices())),
              "n": N, "q_bits": Q_BITS, "reps": reps,
              "rotation_rows": [], "pack_rows": []}

    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=T.PlainModulus.batching(N, 20))
    sec = T.SecurityLevel.tc128 if N >= 16384 else T.SecurityLevel.none
    ctx = T.HeContext(parms, sec_level=sec)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(0xFACE))
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    be = T.BatchEncoder(ctx)
    ev = T.Evaluator(ctx)
    t_mod = int(parms.plain_modulus)
    steps_all = list(range(1, max(ROT_COUNTS) + 1))
    gk = kg.create_galois_keys(steps=steps_all)
    auto_keys = kg.create_automorphism_keys()
    a = np.arange(N, dtype=np.uint64) % t_mod
    ct = enc.encrypt_symmetric(be.encode(a))

    # ---------------- 1. hoisted rotation ----------------
    # TROY_HOIST_SKIP_ROT=1 skips straight to the pack comparison
    skip_rot = os.environ.get("TROY_HOIST_SKIP_ROT") == "1"
    cases = {}
    if not skip_rot:
        print(f"\n-- hoisted multi-rotation (BFV n={N}, coeff domain) --",
              flush=True)
        for m in ROT_COUNTS:
            steps = steps_all[:m]
            outs_h = ev.rotate_many(ct, steps, gk)
            outs_s = [ev.rotate_rows(ct, s, gk) for s in steps]
            jax.block_until_ready([o.data for o in outs_h + outs_s])
            cases[m] = dict(steps=steps, out_h=outs_h, out_s=outs_s,
                            win_h=[], win_s=[])

        for w in range(3):
            for m, c in cases.items():
                t0 = time.time()
                for _ in range(reps):
                    outs = ev.rotate_many(ct, c["steps"], gk)
                jax.block_until_ready(outs[-1].data)
                c["win_h"].append((time.time() - t0) / reps * 1e3)
                t0 = time.time()
                for _ in range(reps):
                    outs = [ev.rotate_rows(ct, s, gk) for s in c["steps"]]
                jax.block_until_ready(outs[-1].data)
                c["win_s"].append((time.time() - t0) / reps * 1e3)

        print(flush=True)
        for m, c in cases.items():
            ms_h = statistics.median(c["win_h"])
            ms_s = statistics.median(c["win_s"])
            print(f"m={m:3d}: rotate_many {ms_h:8.4f} ms vs sequential "
                  f"{ms_s:8.4f} ms -> {ms_s/ms_h:5.2f}x", flush=True)
            record["rotation_rows"].append(dict(
                m=m, hoisted_ms=ms_h, sequential_ms=ms_s,
                hoisted_windows_ms=c["win_h"],
                sequential_windows_ms=c["win_s"], speedup=ms_s / ms_h))

    # ---------------- 2. batched LWE pack ----------------
    print(f"\n-- LWE pack tree (BFV n={N}) --", flush=True)

    def naive_pack(lwes):
        """Reference-style per-pair fold (evaluator_cuda.cu:2278-2341),
        built from public ops. Matches pack_lwe_ciphertexts' tree shape:
        bit-reversed assembly, divide by n, per-layer per-pair fold,
        final field trace."""
        count = len(lwes)
        l = 0
        while (1 << l) < count:
            l += 1
        import troy_tpu.utils.numth as numth
        cts = []
        for i in range(1 << l):
            index = numth.reverse_bits(i, l)
            if index < count:
                c = ev.assemble_lwe(lwes[index], 0)
            else:
                c = ev.assemble_lwe(lwes[0], 0)
                c = ev.sub(c, c)
            cts.append(ev.divide_by_poly_modulus_degree(c))
        for layer in range(l):
            elt = (1 << (layer + 1)) + 1
            shift = N >> (layer + 1)
            nxt = []
            for p in range(0, len(cts), 2):
                even, odd = cts[p], cts[p + 1]
                temp = ev.negacyclic_shift(odd, shift)
                folded = ev.sub(even, temp)
                even = ev.add(even, temp)
                rotated = ev.apply_galois(folded, elt, auto_keys)
                nxt.append(ev.add(even, rotated))
            cts = nxt
        return ev.field_trace(cts[0], auto_keys, l)

    # coefficient-encoded source: extract_lwe reads polynomial
    # coefficients, so the expectation below is directly a[i].
    # extract_lwe_many: one dynamic-shift executable for all terms (the
    # per-term static path would compile one program per shift value).
    ct_poly = enc.encrypt_symmetric(be.encode_polynomial(a))
    pcases = {}
    for m in PACK_COUNTS:
        t0 = time.time()
        lwes = ev.extract_lwe_many(ct_poly, list(range(m)))
        jax.block_until_ready([l.c1 for l in lwes])
        print(f"m={m}: extracted ({time.time()-t0:.0f}s)", flush=True)
        t0 = time.time()
        batched = ev.pack_lwe_ciphertexts(lwes, auto_keys)
        jax.block_until_ready(batched.data)
        print(f"m={m}: batched pack warm "
              f"(compile {time.time()-t0:.0f}s)", flush=True)
        t0 = time.time()
        naive = naive_pack(lwes)
        jax.block_until_ready(naive.data)
        print(f"m={m}: per-pair pack warm "
              f"(compile {time.time()-t0:.0f}s)", flush=True)
        pcases[m] = dict(lwes=lwes, batched=batched, naive=naive,
                         best_b=float("inf"), best_n=float("inf"))

    preps = max(1, reps // 4)
    for w in range(3):
        for m, c in pcases.items():
            t0 = time.time()
            for _ in range(preps):
                out = ev.pack_lwe_ciphertexts(c["lwes"], auto_keys)
            jax.block_until_ready(out.data)
            c["best_b"] = min(c["best_b"], (time.time() - t0) / preps * 1e3)
            t0 = time.time()
            for _ in range(preps):
                out = naive_pack(c["lwes"])
            jax.block_until_ready(out.data)
            c["best_n"] = min(c["best_n"], (time.time() - t0) / preps * 1e3)

    for m, c in pcases.items():
        print(f"m={m:3d}: batched tree {c['best_b']:8.3f} ms vs per-pair "
              f"{c['best_n']:8.3f} ms -> {c['best_n']/c['best_b']:5.2f}x",
              flush=True)
        record["pack_rows"].append(dict(
            m=m, batched_ms=round(c["best_b"], 3),
            naive_ms=round(c["best_n"], 3),
            speedup=round(c["best_n"] / c["best_b"], 3)))

    # ---------------- correctness gates (readbacks last) ----------------
    dec = T.Decryptor(ctx, kg.secret_key)
    ok_all = True
    for m, c in cases.items():
        for s, o_h, o_s in zip(c["steps"], c["out_h"], c["out_s"]):
            got_h = be.decode(dec.decrypt(o_h))
            got_s = be.decode(dec.decrypt(o_s))
            half = N // 2
            expect = np.concatenate([np.roll(a[:half], -s),
                                     np.roll(a[half:], -s)])
            ok = (np.array_equal(got_h, expect)
                  and np.array_equal(got_s, expect))
            ok_all &= ok
            if not ok:
                print(f"rotation m={m} step={s}: FAIL", flush=True)
    for m, c in pcases.items():
        got_b = be.decode_polynomial(dec.decrypt(c["batched"]))
        got_n = be.decode_polynomial(dec.decrypt(c["naive"]))
        pad = 1
        while pad < m:
            pad *= 2
        stride = N // pad
        expect = np.zeros(N, dtype=np.uint64)
        expect[::stride][:m] = a[:m]
        ok = (np.array_equal(got_b, expect)
              and np.array_equal(got_n, expect))
        ok_all &= ok
        if not ok:
            print(f"pack m={m}: FAIL (batched eq {np.array_equal(got_b, expect)}, "
                  f"naive eq {np.array_equal(got_n, expect)})", flush=True)
    print(f"correctness {'OK' if ok_all else 'FAIL'}", flush=True)
    record["correctness"] = "OK" if ok_all else "FAIL"

    out_path = os.environ.get("TROY_HOIST_OUT")
    if out_path:
        # merge under a per-device/per-n key so one artifact carries
        # several devices side by side
        doc = {}
        if os.path.exists(out_path):
            try:
                with open(out_path) as f:
                    doc = json.load(f)
            except (ValueError, OSError):
                print(f"WARNING: {out_path} unreadable, starting fresh",
                      flush=True)
        doc[f"{dev.device_kind}_n{N}"] = record
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
