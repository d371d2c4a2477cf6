"""CKKS precision-vs-depth table (VERDICT r4 #6).

Measures decode max-error and bits of precision along a real multiply ->
relinearize -> rescale chain at the headline configuration (n=16384,
q={60,40,40,40,40,60}, scale 2^40): fresh encode/decode, after each
multiply+relin (scale 2^80), and after each rescale — the chain analogue
of the reference's device max-error tracking
(reference: src/ckks_cuda.cu:178-209 encode error clamp; precision checks
in test/ckks.cpp nearEqual tolerances).

Error model: inputs are uniform in [-1, 1], the plaintext model tracks the
exact slot products in float64, and max_err = max |decoded - model| over
all slots and trials. precision_bits = -log2(max_err / max|model|)
(relative precision of the worst slot).

Writes results/ckks_precision.json under the repo root when run as a
script, one session per device kind; ``run()`` is importable so the test
suite asserts the same bounds at the same configuration on the CPU.
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(n=16384, q_bits=(60, 40, 40, 40, 40, 60), scale=2.0 ** 40,
        trials=2, seed=2025):
    """Returns (rows, meta): one row per chain stage with max_err and
    precision bits, worst case over `trials` random input pairs."""
    import troy_tpu as T
    from troy_tpu import prng as rnd

    parms = T.EncryptionParameters(
        scheme=T.SchemeType.ckks, poly_modulus_degree=n,
        coeff_modulus=tuple(T.CoeffModulus.create(n, list(q_bits))))
    sec = T.SecurityLevel.tc128 if n >= 16384 else T.SecurityLevel.none
    ctx = T.HeContext(parms, sec_level=sec)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(seed))
    rlk = kg.create_relin_keys()
    enc = T.Encryptor(ctx, secret_key=kg.secret_key,
                      seed=rnd.seed_from_uint64(seed + 1))
    dec = T.Decryptor(ctx, kg.secret_key)
    ce = T.CKKSEncoder(ctx)
    ev = T.Evaluator(ctx)

    # stages: fresh, then per depth d: after mult+relin and after rescale.
    # depth capacity: data levels are 1..len(q)-1; each multiply+rescale
    # consumes one level, and the last level must still hold scale 2^40.
    depth = len(q_bits) - 3          # 3 multiplies at the headline config
    stats = {}

    def note(stage, got, model, level, sc):
        err = float(np.max(np.abs(got - model)))
        prev = stats.get(stage)
        if prev is None or err > prev["max_err"]:
            stats[stage] = dict(stage=stage, level=level, scale=sc,
                                max_err=err,
                                max_value=float(np.max(np.abs(model))))

    rng = np.random.default_rng(seed)
    for _ in range(trials):
        a = rng.uniform(-1.0, 1.0, n // 2)
        b = rng.uniform(-1.0, 1.0, n // 2)
        pt_a = ce.encode(a, scale=scale)
        note("encode/decode (fresh)", np.real(ce.decode(pt_a)), a,
             ctx.first_level, scale)
        ct = enc.encrypt_symmetric(pt_a)
        note("encrypt/decrypt (fresh)", np.real(ce.decode(dec.decrypt(ct))),
             a, ct.level, scale)
        model = a
        for d in range(1, depth + 1):
            ct_b = enc.encrypt_symmetric(ce.encode(b, scale=ct.scale,
                                                   level=ct.level))
            ct = ev.relinearize(ev.multiply(ct, ct_b), rlk)
            model = model * b
            note(f"depth {d}: multiply+relin",
                 np.real(ce.decode(dec.decrypt(ct))), model, ct.level,
                 ct.scale)
            ct = ev.rescale_to_next(ct)
            note(f"depth {d}: rescale",
                 np.real(ce.decode(dec.decrypt(ct))), model, ct.level,
                 ct.scale)

    rows = []
    for stage in stats:
        r = stats[stage]
        rel = r["max_err"] / max(r["max_value"], 1e-300)
        r["precision_bits"] = round(-np.log2(max(rel, 1e-300)), 1)
        r["max_err"] = float(f"{r['max_err']:.3e}")
        r["scale"] = float(r["scale"])
        rows.append(r)
    meta = dict(n=n, q_bits=list(q_bits), scale=float(scale),
                trials=trials, depth=depth)
    return rows, meta


def main():
    import jax
    from troy_tpu.utils import jax_cache
    jax_cache.enable()
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    rows, meta = run(trials=trials)
    dev = jax.devices()[0]
    meta["device"] = dict(platform=dev.platform, kind=dev.device_kind,
                          count=len(jax.devices()))
    print(f"\nCKKS precision vs depth (n={meta['n']}, "
          f"q={meta['q_bits']}, scale 2^40, {trials} trials, "
          f"{dev.device_kind}):")
    print(f"  {'stage':28s} {'level':>5s} {'scale':>10s} "
          f"{'max err':>10s} {'prec bits':>9s}")
    for r in rows:
        print(f"  {r['stage']:28s} {r['level']:5d} "
              f"2^{np.log2(r['scale']):.1f}  {r['max_err']:10.3e} "
              f"{r['precision_bits']:9.1f}")
    # one session per device kind, merged into the artifact (the
    # arithmetic is exact integer math, so devices should agree;
    # recording each proves it rather than asserting it)
    out = os.path.join(REPO, "results", "ckks_precision.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    merged = {"sessions": {}}
    if os.path.exists(out):
        with open(out) as f:
            merged["sessions"].update(json.load(f).get("sessions", {}))
    merged["sessions"][dev.device_kind] = dict(meta=meta, rows=rows)
    with open(out, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
