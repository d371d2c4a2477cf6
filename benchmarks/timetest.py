"""Full-op benchmark suite — the reference timetest harness rebuilt.

Mirrors the reference's op list and configurations
(reference: test/timetest.cu:321-331,452-481 — Encode/Decode, Encrypt/
Decrypt, Add, AddPlain, MultiplyPlain, Square, Multiply, Relinearize,
ModSwitch (BFV/BGV) or Rescale (CKKS), RotateRows/RotateVector) at
n=16384, q={60,40,40,40,40,60}; one scheme per process.

Discipline:
  * every device op is the SAME jitted core program the Evaluator object
    API dispatches, AOT-compiled up front (compile time printed);
  * all ops are timed in ROUND-ROBIN windows (op A's window w runs next
    to op B's window w); each row reports the median window and the
    spread (max - min over the median);
  * every device row is decrypt-gated after the timing;
  * host-boundary rows (Encrypt/Decrypt/Encode/Decode) are timed in a
    second phase (they include the host and PRNG work).

Writes results/optable_<scheme>.json under the repo root, with the device.

Usage:
    python benchmarks/timetest.py [bfv|ckks|bgv] [n] [reps]
"""

import json
import os
import statistics
import sys
import time
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def block(x):
    import jax
    jax.tree.map(lambda a: a.block_until_ready()
                 if hasattr(a, "block_until_ready") else a, x)
    return x


def main():
    import jax
    import jax.numpy as jnp
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu import evaluator as em
    from troy_tpu.utils import galois as galois_util
    from troy_tpu.utils import jax_cache
    jax_cache.enable()
    scheme_name = sys.argv[1] if len(sys.argv) > 1 else "bfv"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 16384
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 100
    scheme = {"bfv": T.SchemeType.bfv, "ckks": T.SchemeType.ckks,
              "bgv": T.SchemeType.bgv}[scheme_name]
    q_bits = [60, 40, 40, 40, 40, 60]
    is_ckks = scheme == T.SchemeType.ckks
    is_bfv = scheme == T.SchemeType.bfv
    ntt_form = not is_bfv

    if is_ckks:
        parms = T.EncryptionParameters(
            scheme=scheme, poly_modulus_degree=n,
            coeff_modulus=tuple(T.CoeffModulus.create(n, q_bits)))
    else:
        t_bits = 59 if is_bfv else 20
        parms = T.EncryptionParameters(
            scheme=scheme, poly_modulus_degree=n,
            coeff_modulus=tuple(T.CoeffModulus.create(n, q_bits)),
            plain_modulus=T.PlainModulus.batching(n, t_bits))
    sec = T.SecurityLevel.tc128 if n >= 16384 else T.SecurityLevel.none
    ctx = T.HeContext(parms, sec_level=sec)
    print(f"== timetest {scheme_name} n={n} q={q_bits} "
          f"(devices {jax.devices()}) ==", flush=True)

    t0 = time.time()
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(0xC0FFEE))
    rlk = kg.create_relin_keys()
    gk = kg.create_galois_keys(steps=[1])
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    dec = T.Decryptor(ctx, kg.secret_key)
    ev = T.Evaluator(ctx)
    print(f"  [keygen+setup: {time.time()-t0:.1f}s]", flush=True)

    scale = 2.0 ** 40
    if is_ckks:
        encd = T.CKKSEncoder(ctx)
        vals = ((np.arange(encd.slot_count) % 255) / 255.0 + 0.5)
        vals2 = vals[::-1].copy()
        pt = encd.encode(vals, scale=scale)
        pt2 = encd.encode(vals2, scale=scale)
    else:
        encd = T.BatchEncoder(ctx)
        tmod = int(parms.plain_modulus)
        vals = np.arange(n, dtype=np.uint64) % tmod
        vals2 = vals[::-1].copy()
        pt = encd.encode(vals)
        pt2 = encd.encode(vals2)
    ct1 = enc.encrypt_symmetric(pt)
    ct2 = enc.encrypt_symmetric(pt2)
    pt_ntt = pt2 if is_ckks else ev.transform_plain_to_ntt(pt2, ct1.level)
    prod3 = ev.multiply(ct1, ct2)
    block(prod3.data)

    cd = ctx.first_context_data
    key_cd = ctx.key_context_data
    key = rlk.keys[2]
    d1, d2 = ct1.data, ct2.data
    elt1 = galois_util.get_elt_from_step(n, 1)
    gkey = gk.keys[elt1]

    # ---- the device op set: (label, program + args, timed call) ----
    # program = the SAME jitted core the Evaluator dispatches (plus the
    # fused step), AOT-compiled before the windows.
    @partial(jax.jit, static_argnames=("nf",))
    def fused_step(a, b, cdl, k, kcd, nf):
        prod = em._ntt_form_multiply.__wrapped__(a, b, cdl) if nf \
            else em._bfv_multiply.__wrapped__(a, b, cdl)
        delta = em._switch_key_core(prod[2], k, cdl, kcd, nf)
        c0 = em._add.__wrapped__(prod[0][None], delta[0][None], cdl)[0]
        c1 = em._add.__wrapped__(prod[1][None], delta[1][None], cdl)[0]
        return jnp.stack([c0, c1])

    @jax.jit
    def mult_plain_coeff_via_ntt(d, p, cdl):
        # the object API's 3-dispatch path for a coeff ct x NTT pt
        ntt = em._transform_to_ntt.__wrapped__(d, cdl)
        prod = em._multiply_plain_ntt.__wrapped__(ntt, p, cdl)
        return em._transform_from_ntt.__wrapped__(prod, cdl)

    @jax.jit
    def bgv_mult_plain_modt(d, p, cdl):
        return em._multiply_plain_ntt.__wrapped__(
            d, em._plain_to_ntt.__wrapped__(p, cdl), cdl)

    mult_core = em._ntt_form_multiply if ntt_form else em._bfv_multiply
    sq_core = em._ntt_form_square if ntt_form else em._bfv_square

    ops = {}

    def add_op(label, lower_fn, lower_args, call, lower_kw=None):
        ops[label] = dict(lower=(lower_fn, lower_args, lower_kw or {}),
                          call=call, windows=[])

    add_op("Add", em._add_ct_core, (d1, d2, cd),
           lambda: ev.add(ct1, ct2).data)
    # Encrypt's DEVICE CORE as its own row (VERDICT r4 #5): the
    # same fused executable the Encryptor dispatches (threefry sampling +
    # zero-enc NTTs + plain embed), called with pre-staged operands so
    # the row isolates the device program from the per-call host work
    # (PRNG scalar draws + a 16-byte seed upload). The
    # "Encrypt (symmetric)" host row below times the full object API;
    # the difference between the two rows IS the host-boundary cost.
    from troy_tpu import encryptor as enc_mod
    enc_seeds = jnp.asarray(np.array([0x51D | 1, 0xE0E], dtype=np.uint64))
    sk_data = kg.secret_key.data
    add_op("Encrypt (sym, device core)", enc_mod._encrypt_sym_full,
           (enc_seeds, pt.data, sk_data, cd),
           lambda: enc_mod._encrypt_sym_full(enc_seeds, pt.data, sk_data,
                                             cd, is_ntt_form=ntt_form),
           dict(is_ntt_form=ntt_form))
    if is_bfv:
        add_op("AddPlain", em._bfv_add_plain_jit, (d1, pt2.data, cd),
               lambda: ev.add_plain(ct1, pt2).data,
               dict(subtract=False))
        add_op("MultiplyPlain", em._bfv_multiply_plain, (d1, pt2.data, cd),
               lambda: ev.multiply_plain(ct1, pt2).data)
        add_op("MultiplyPlain (NTT pt)", mult_plain_coeff_via_ntt,
               (d1, pt_ntt.data, cd),
               lambda: ev.multiply_plain(ct1, pt_ntt).data)
    elif is_ckks:
        add_op("AddPlain", em._add_plain_ntt_core, (d1, pt2.data, cd),
               lambda: ev.add_plain(ct1, pt2).data, dict(subtract=False))
        add_op("MultiplyPlain", em._multiply_plain_ntt,
               (d1, pt_ntt.data, cd),
               lambda: ev.multiply_plain(ct1, pt_ntt).data)
    else:
        add_op("AddPlain", em._bgv_add_plain_core, (d1, pt2.data, cd),
               lambda: ev.add_plain(ct1, pt2).data,
               dict(correction_factor=ct1.correction_factor,
                    subtract=False))
        add_op("MultiplyPlain", bgv_mult_plain_modt, (d1, pt2.data, cd),
               lambda: ev.multiply_plain(ct1, pt2).data)
        add_op("MultiplyPlain (NTT pt)", em._multiply_plain_ntt,
               (d1, pt_ntt.data, cd),
               lambda: ev.multiply_plain(ct1, pt_ntt).data)
    add_op("Multiply", mult_core, (d1, d2, cd),
           lambda: ev.multiply(ct1, ct2).data)
    add_op("Square", sq_core, (d1, cd), lambda: ev.square(ct1).data)
    add_op("Relinearize", em._relinearize_core,
           (prod3.data, (key,), cd, key_cd),
           lambda: ev.relinearize(prod3, rlk).data,
           dict(target_ntt_form=ntt_form))
    add_op("Multiply+Relinearize (fused)", fused_step,
           (d1, d2, cd, key, key_cd),
           lambda: fused_step(d1, d2, cd, key, key_cd, nf=ntt_form),
           dict(nf=ntt_form))
    if is_bfv:
        # the narrow-internal-base mode: same q/t/keys/ciphertexts —
        # only the BEHZ auxiliary base narrows. The 48-bit context reuses
        # the same key arrays (keys never touch Bsk).
        ctx48 = T.HeContext(parms, sec_level=sec, internal_prime_bits=48)
        cd48 = ctx48.first_context_data
        key_cd48 = ctx48.key_context_data
        add_op("Multiply+Relinearize (fused, 48-bit base)", fused_step,
               (d1, d2, cd48, key, key_cd48),
               lambda: fused_step(d1, d2, cd48, key, key_cd48,
                                  nf=ntt_form),
               dict(nf=ntt_form))
    add_op("Multiply+Relinearize (2 disp)", None, None,
           lambda: ev.relinearize(ev.multiply(ct1, ct2), rlk).data)
    if is_ckks:
        # rescale a PRODUCT (scale 2^80 -> 2^40), as in real usage — a
        # fresh scale-2^40 ct would rescale to scale ~1, which decodes
        # to noise and cannot be gated
        relin2 = ev.relinearize(prod3, rlk)
        block(relin2.data)
        add_op("Rescale", em._ckks_rescale, (relin2.data, cd),
               lambda: ev.rescale_to_next(relin2).data)
        add_op("RotateVector(1)", em._apply_galois_ntt_core,
               (d1, galois_util.ntt_permutation_dev(n, elt1), gkey, cd,
                key_cd),
               lambda: ev.rotate_vector(ct1, 1, gk).data)
    else:
        ms_core = em._bfv_mod_switch_scale if is_bfv \
            else em._bgv_mod_switch_scale
        add_op("ModSwitchToNext", ms_core, (d1, cd),
               lambda: ev.mod_switch_to_next(ct1).data)
        if is_bfv:
            src1, keep1 = galois_util.coeff_permutation_dev(n, elt1)
            add_op("RotateRows(1)", em._apply_galois_coeff_core,
                   (d1, src1, keep1, gkey, cd, key_cd),
                   lambda: ev.rotate_rows(ct1, 1, gk).data)
        else:
            add_op("RotateRows(1)", em._apply_galois_ntt_core,
                   (d1, galois_util.ntt_permutation_dev(n, elt1), gkey,
                    cd, key_cd),
                   lambda: ev.rotate_rows(ct1, 1, gk).data)

    # ---- AOT-compile every program ----
    for label, op in ops.items():
        if op["lower"][0] is None:
            continue
        fn, args, kw = op["lower"]
        t0 = time.time()
        fn.lower(*args, **kw).compile()
        print(f"  [{label}: compile {time.time()-t0:.0f}s]", flush=True)

    # ---- warm every timed path (compile/load outside the windows) ----
    for label, op in ops.items():
        op["out"] = op["call"]()
        block(op["out"])

    # ---- round-robin windows ----
    for w in range(5):
        for label, op in ops.items():
            t0 = time.time()
            out = None
            for _ in range(reps):
                out = op["call"]()
            block(out)
            op["windows"].append((time.time() - t0) / reps * 1e3)
            op["out"] = out

    print(f"\n  {'op':42s} {'median ms':>10s} {'spread':>7s}", flush=True)
    rows = []
    for label, op in ops.items():
        med = statistics.median(op["windows"])
        spread = (max(op["windows"]) - min(op["windows"])) / med
        print(f"  {label:42s} {med:10.4f} {spread:7.1%}", flush=True)
        rows.append(dict(op=label, median_ms=med, spread=spread,
                         windows_ms=op["windows"]))

    # ---- phase 2: host-boundary rows ----
    print(flush=True)
    host_rows = []

    def host_time(label, fn, hreps=10):
        out = fn()
        block(out)
        t0 = time.time()
        for _ in range(hreps):
            out = fn()
        block(out)
        dt = (time.time() - t0) / hreps * 1e3
        print(f"  {label:34s} {dt:9.3f} ms  (host-boundary)", flush=True)
        host_rows.append(dict(op=label, ms=dt))
        return out

    host_time("Encrypt (symmetric)", lambda: enc.encrypt_symmetric(pt).data)
    pt_dec = dec.decrypt(ct1)
    host_time("Decrypt", lambda: dec.decrypt(ct1).data)
    if is_ckks:
        v_re = jnp.asarray(vals.astype(np.float64))
        v_im = jnp.zeros_like(v_re)
        mx = float(np.max(np.abs(vals)))
        block((v_re, v_im))
        host_time("Encode (device-resident)",
                  lambda: encd.encode_device(v_re, v_im, scale, mx).data)
        host_time("Decode (device-resident)",
                  lambda: encd.decode_device(pt_dec))
        host_time("Encode", lambda: encd.encode(vals, scale=scale).data)
        host_time("Decode", lambda: encd.decode(pt_dec))
    else:
        host_time("Encode", lambda: encd.encode(vals).data)
        host_time("Decode", lambda: encd.decode(pt_dec))

    # ---- correctness gates: decrypt every device-row output ----
    print(flush=True)
    ok_all = True

    def gate(label, ct_like, want, approx=False, **meta):
        nonlocal ok_all
        c = ct1.replace(data=ct_like, seed=0, **meta)
        got = encd.decode(dec.decrypt(c))
        if is_ckks:
            ok = bool(np.allclose(np.real(got), want, rtol=1e-3,
                                  atol=1e-3))
        else:
            ok = bool(np.array_equal(got, want))
        ok_all &= ok
        if not ok:
            print(f"  GATE FAIL: {label}", flush=True)
        return ok

    vo = vals.astype(object) if not is_ckks else vals
    vo2 = vals2.astype(object) if not is_ckks else vals2
    mod = (lambda x: x % tmod) if not is_ckks else (lambda x: x)
    sc2 = dict(scale=scale * scale) if is_ckks else {}
    cf2 = {} if not scheme == T.SchemeType.bgv else \
        dict(correction_factor=ct1.correction_factor ** 2 % tmod)
    gate("Add", ops["Add"]["out"], mod(vo + vo2))
    gate("Encrypt (sym, device core)",
         ops["Encrypt (sym, device core)"]["out"], mod(vo))
    gate("AddPlain", ops["AddPlain"]["out"], mod(vo + vo2))
    gate("MultiplyPlain", ops["MultiplyPlain"]["out"], mod(vo * vo2),
         **sc2)
    if "MultiplyPlain (NTT pt)" in ops:
        gate("MultiplyPlain (NTT pt)", ops["MultiplyPlain (NTT pt)"]["out"],
             mod(vo * vo2))
    # squares/multiplies are size-3: decrypt via a size-3 container
    for label, want, meta in [
            ("Multiply", mod(vo * vo2), dict(**sc2, **cf2)),
            ("Square", mod(vo * vo), dict(
                **({"scale": scale * scale} if is_ckks else {}),
                **cf2))]:
        c3 = T.Ciphertext(data=ops[label]["out"], level=ct1.level,
                          is_ntt_form=ct1.is_ntt_form,
                          scale=meta.get("scale", ct1.scale),
                          correction_factor=meta.get(
                              "correction_factor", 1))
        got = encd.decode(dec.decrypt(c3))
        if is_ckks:
            ok = bool(np.allclose(np.real(got), want, rtol=1e-3, atol=1e-3))
        else:
            ok = bool(np.array_equal(got, want))
        ok_all &= ok
        if not ok:
            print(f"  GATE FAIL: {label}", flush=True)
    gate("Relinearize", ops["Relinearize"]["out"], mod(vo * vo2),
         **sc2, **cf2)
    gate("Multiply+Relinearize (fused)",
         ops["Multiply+Relinearize (fused)"]["out"], mod(vo * vo2),
         **sc2, **cf2)
    gate("Multiply+Relinearize (2 disp)",
         ops["Multiply+Relinearize (2 disp)"]["out"], mod(vo * vo2),
         **sc2, **cf2)
    if "Multiply+Relinearize (fused, 48-bit base)" in ops:
        gate("Multiply+Relinearize (fused, 48-bit base)",
             ops["Multiply+Relinearize (fused, 48-bit base)"]["out"],
             mod(vo * vo2), **sc2, **cf2)
    if is_ckks:
        c = ct1.replace(data=ops["Rescale"]["out"], level=ct1.level + 1,
                        scale=relin2.scale / cd.coeff_values[-1], seed=0)
        got = encd.decode(dec.decrypt(c))
        ok = bool(np.allclose(np.real(got), vals * vals2, rtol=1e-3,
                              atol=1e-3))
        ok_all &= ok
        if not ok:
            print("  GATE FAIL: Rescale", flush=True)
        rot = encd.decode(dec.decrypt(ct1.replace(
            data=ops["RotateVector(1)"]["out"], seed=0)))
        ok = bool(np.allclose(np.real(rot), np.roll(vals, -1), rtol=1e-3,
                              atol=1e-3))
        ok_all &= ok
        if not ok:
            print("  GATE FAIL: RotateVector(1)", flush=True)
    else:
        ms_cf = {} if is_bfv else dict(
            correction_factor=ct1.correction_factor
            * cd.rns_tool.inv_q_last_mod_t % tmod)
        c = ct1.replace(data=ops["ModSwitchToNext"]["out"],
                        level=ct1.level + 1, seed=0, **ms_cf)
        ok = bool(np.array_equal(encd.decode(dec.decrypt(c)), vals))
        ok_all &= ok
        if not ok:
            print("  GATE FAIL: ModSwitchToNext", flush=True)
        half = n // 2
        want_rot = np.concatenate([np.roll(vals[:half], -1),
                                   np.roll(vals[half:], -1)])
        rot = encd.decode(dec.decrypt(ct1.replace(
            data=ops["RotateRows(1)"]["out"], seed=0)))
        ok = bool(np.array_equal(rot, want_rot))
        ok_all &= ok
        if not ok:
            print("  GATE FAIL: RotateRows(1)", flush=True)

    print(f"  correctness {'OK' if ok_all else 'FAIL'}", flush=True)

    d = jax.devices()[0]
    record = dict(scheme=scheme_name, n=n, q_bits=q_bits, reps=reps,
                  windows=5, ok=ok_all, device_rows=rows,
                  host_rows=host_rows,
                  device=dict(platform=d.platform, kind=d.device_kind,
                              count=len(jax.devices())))
    out_path = os.path.join(REPO, "results", f"optable_{scheme_name}.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"  wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
