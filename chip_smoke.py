"""Bring-up check of troy_tpu on an NVIDIA GPU.

Drives the main path once through the public API at the reference's
headline widths (n=16384, q={60,40,40,40,40,60}; test/timetest.cu:468-481)
and checks every result exactly, or within its stated CKKS bound:

  1. device: the GPU, its name and power limit, the native host library;
  2. BFV multiply+relinearize at t=20 and t=59 bits;
  3. BGV multiply+relinearize at t=20 bits;
  4. CKKS multiply+relinearize+rescale at scale 2^40;
  5. hoisted rotation: rotate_many with m=4 against rotate_rows;
  6. the 64x128x256 private matmul protocol (test/app/linear.cu:575-584);
  7. the device kernels of that path against their plain references;
  8. the tests marked ``gpu``.

Usage:
    python chip_smoke.py          # phases 1-8 on one GPU
    python chip_smoke.py --four   # only the four-GPU sharding regimes

Exits non-zero, and prints no result, when JAX finds no GPU or any phase
fails. Otherwise its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from troy_tpu.utils.profiling import gpu_name_and_power, require_gpu, time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 16384
Q_BITS = [60, 40, 40, 40, 40, 60]
SCALE = 2.0 ** 40


def log(msg: str) -> None:
    print(msg, flush=True)


def result_line(devices) -> str:
    """The last line of a successful run."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rows_rotated(x: np.ndarray, s: int) -> np.ndarray:
    half = len(x) // 2
    return np.concatenate([np.roll(x[:half], -s), np.roll(x[half:], -s)])


def precision_bits(got, want) -> float:
    err = float(np.max(np.abs(np.real(got) - want)))
    return float(-np.log2(max(err / float(np.max(np.abs(want))), 1e-300)))


class Smoke:
    def __init__(self, gpu: str):
        import troy_tpu as T
        from troy_tpu import prng as rnd
        self.T, self.rnd, self.gpu = T, rnd, gpu
        self.rng = np.random.default_rng(2024)

    def context(self, scheme, q_bits=Q_BITS, t=None):
        T = self.T
        plain = {} if t is None else {"plain_modulus": t}
        parms = T.EncryptionParameters(
            scheme=scheme, poly_modulus_degree=N,
            coeff_modulus=tuple(T.CoeffModulus.create(N, list(q_bits))),
            **plain)
        return T.HeContext(parms)

    def report(self, label: str, timing) -> None:
        med, lo, hi = timing
        log(f"  {label}: {med:.3f} ms/op (min {lo:.3f}, max {hi:.3f}) "
            f"on {self.gpu}")

    # ---- 2, 3: BFV and BGV multiply+relinearize ----
    def integer_mult_relin(self, scheme, t_bits: int):
        T = self.T
        ctx = self.context(scheme, t=T.PlainModulus.batching(N, t_bits))
        t = int(ctx.first_context_data.plain_modulus)
        kg = T.KeyGenerator(ctx, seed=self.rnd.seed_from_uint64(t_bits))
        rlk = kg.create_relin_keys()
        enc = T.Encryptor(ctx, public_key=kg.create_public_key())
        dec = T.Decryptor(ctx, kg.secret_key)
        be = T.BatchEncoder(ctx)
        ev = T.Evaluator(ctx)
        x = self.rng.integers(0, t, N, dtype=np.uint64)
        y = self.rng.integers(0, t, N, dtype=np.uint64)
        ca, cb = enc.encrypt(be.encode(x)), enc.encrypt(be.encode(y))
        out = ev.relinearize(ev.multiply(ca, cb), rlk)
        got = be.decode(dec.decrypt(out))
        want = (x.astype(object) * y.astype(object)) % t
        check(np.array_equal(got.astype(object), want),
              f"{scheme.name} t={t_bits} bits: decryption != x*y mod t")
        self.report(f"{scheme.name.upper()} t={t_bits} bits mult+relin",
                    time_ms(lambda: ev.relinearize(ev.multiply(ca, cb),
                                                   rlk)))
        return dict(ctx=ctx, kg=kg, enc=enc, dec=dec, be=be, ev=ev, x=x,
                    ct=ca)

    # ---- 4: CKKS multiply+relinearize+rescale ----
    def ckks_mult_relin_rescale(self):
        T = self.T
        ctx = self.context(T.SchemeType.ckks)
        kg = T.KeyGenerator(ctx, seed=self.rnd.seed_from_uint64(40))
        rlk = kg.create_relin_keys()
        enc = T.Encryptor(ctx, secret_key=kg.secret_key)
        dec = T.Decryptor(ctx, kg.secret_key)
        ce = T.CKKSEncoder(ctx)
        ev = T.Evaluator(ctx)
        a = self.rng.uniform(-1.0, 1.0, N // 2)
        b = self.rng.uniform(-1.0, 1.0, N // 2)
        ca = enc.encrypt_symmetric(ce.encode(a, SCALE))
        cb = enc.encrypt_symmetric(ce.encode(b, SCALE))
        prod = ev.relinearize(ev.multiply(ca, cb), rlk)
        before = precision_bits(ce.decode(dec.decrypt(prod)), a * b)
        after = precision_bits(
            ce.decode(dec.decrypt(ev.rescale_to_next(prod))), a * b)
        log(f"  CKKS precision: {before:.1f} bits after multiply+relin, "
            f"{after:.1f} bits after rescale")
        check(before >= 23.0, f"CKKS precision {before:.1f} < 23 bits")
        check(after >= 22.0, f"CKKS precision {after:.1f} < 22 bits")
        self.report("CKKS mult+relin+rescale", time_ms(
            lambda: ev.rescale_to_next(ev.relinearize(ev.multiply(ca, cb),
                                                      rlk))))
        return dict(ctx=ctx, ce=ce, a=a)

    # ---- 5: hoisted rotation ----
    def rotate_many(self, bfv):
        steps = [1, 2, 3, 4]
        gk = bfv["kg"].create_galois_keys(steps=steps)
        ev, ct = bfv["ev"], bfv["ct"]
        hoisted = ev.rotate_many(ct, steps, gk)
        for s, h in zip(steps, hoisted):
            seq = ev.rotate_rows(ct, s, gk)
            got_h = bfv["be"].decode(bfv["dec"].decrypt(h))
            got_s = bfv["be"].decode(bfv["dec"].decrypt(seq))
            check(np.array_equal(got_h, got_s),
                  f"rotate_many step {s} != rotate_rows")
            check(np.array_equal(got_h, rows_rotated(bfv["x"], s)),
                  f"rotate_many step {s} != the rotated rows")
        self.report("BFV rotate_many m=4",
                    time_ms(lambda: ev.rotate_many(ct, steps, gk)))

    # ---- 6: private matmul protocol ----
    def matmul_protocol(self):
        T = self.T
        from troy_tpu.app.linear import MatmulHelper
        bs, ind, outd = 64, 128, 256
        ctx = self.context(T.SchemeType.bfv, q_bits=[60, 60, 60],
                           t=T.Modulus(1 << 41))
        t = int(ctx.first_context_data.plain_modulus)
        kg = T.KeyGenerator(ctx, seed=self.rnd.seed_from_uint64(0xABCD))
        enc = T.Encryptor(ctx, secret_key=kg.secret_key)
        dec = T.Decryptor(ctx, kg.secret_key)
        ev = T.Evaluator(ctx)
        be = T.BatchEncoder(ctx)
        auto_keys = kg.create_automorphism_keys()
        helper = MatmulHelper(bs, ind, outd, N, objective=0, pack_lwe=True)
        x = self.rng.integers(0, 1 << 8, (bs, ind), dtype=np.uint64)
        w = self.rng.integers(0, 1 << 8, (ind, outd), dtype=np.uint64)

        def server(x_ct, w_enc):
            return helper.pack_outputs(ev, auto_keys,
                                       helper.matmul(ev, x_ct, w_enc))

        # client: encrypt inputs; server: matmul + pack, serialize;
        # client: deserialize, decrypt, decode
        x_ct = helper.encrypt_inputs(enc, be.encode_polynomial, x)
        w_enc = helper.encode_weights(be.encode_polynomial, w)
        blob = helper.serialize_outputs(ev, ctx, server(x_ct, w_enc))
        got = helper.decrypt_outputs(
            be.decode_polynomial, dec,
            helper.deserialize_outputs(ev, ctx, blob))
        check(np.array_equal(got, (x @ w) % t),
              "matmul protocol != integer matmul")
        log(f"  matmul 64x128x256: {len(blob)} output bytes, bit-exact")
        self.report("matmul 64x128x256 server (matmul+pack)",
                    time_ms(lambda: server(x_ct, w_enc), reps=2))

    # ---- 7: kernels against their plain references ----
    def kernels(self, bfv, ckks):
        import jax.numpy as jnp
        from troy_tpu.ops import ntt as dntt
        from troy_tpu.ops import u64ops as u
        from troy_tpu.utils import host_ntt
        from troy_tpu.utils.ntt_tables import make_ntt_tables
        T = self.T
        ctx = bfv["ctx"]
        for name, tables in (("chain", ctx.key_context_data.ntt),
                             ("Bsk", ctx.first_context_data.bsk_ntt)):
            q = tables.values
            x = np.stack([self.rng.integers(0, qi, N, dtype=np.uint64)
                          for qi in q])
            fwd = np.asarray(dntt.rns_ntt_forward(jnp.asarray(x), tables))
            check(np.array_equal(fwd, host_ntt.rns_ntt_forward_np(x, N, q)),
                  f"forward NTT != host twin ({name} primes {q})")
            inv = np.asarray(dntt.rns_ntt_inverse(jnp.asarray(fwd), tables))
            check(np.array_equal(inv, host_ntt.rns_ntt_inverse_np(fwd, N, q)),
                  f"inverse NTT != host twin ({name} primes {q})")
            check(np.array_equal(inv, x), f"NTT round trip ({name})")
            log(f"  NTT n={N} fwd/inv word-equal to the host twin for the "
                f"{len(q)} {name} primes")

        count = 1 << 20
        q = ctx.key_context_data.coeff_values[0]
        a = self.rng.integers(0, q, count, dtype=np.uint64)
        b = self.rng.integers(0, q, count, dtype=np.uint64)
        z = self.rng.integers(0, 1 << 63, count, dtype=np.uint64) * 2 + 1
        want = (a.astype(object) * b.astype(object)) % q
        cr = make_ntt_tables(N, q).const_ratio
        got = np.asarray(u.mul_mod(jnp.asarray(a), jnp.asarray(b), q, cr))
        check(np.array_equal(got.astype(object), want), "u64 mul_mod")
        lo, hi = host_ntt.mul128(a, b)
        got = np.asarray(u.barrett_reduce_128_dyn(
            jnp.asarray(lo), jnp.asarray(hi), jnp.uint64(q),
            jnp.uint64(cr[0]), jnp.uint64(cr[1])))
        check(np.array_equal(got.astype(object), want),
              "u64 barrett_reduce_128_dyn")
        w = int(b[0])
        got = np.asarray(u.mul_mod_shoup(jnp.asarray(z), jnp.uint64(w),
                                         jnp.uint64(u.shoup_quotient(w, q)),
                                         q))
        check(np.array_equal(got.astype(object), (z.astype(object) * w) % q),
              "u64 mul_mod_shoup")
        log(f"  u64 mul_mod, barrett_reduce_128_dyn, mul_mod_shoup equal "
            f"Python ints on {count} words")

        ce, cctx = ckks["ce"], ckks["ctx"]
        host = T.CKKSEncoder(cctx, host=True)
        v = self.rng.uniform(-1, 1, N // 2) + 1j * self.rng.uniform(-1, 1,
                                                                   N // 2)
        pd = ce.encode(v, SCALE)
        check(np.array_equal(np.asarray(pd.data),
                             np.asarray(host.encode(v, SCALE).data)),
              "CKKS device encode != host encode")
        err = float(np.max(np.abs(ce.decode(pd) - host.decode(pd))))
        check(err <= 1e-8, f"CKKS device decode off host by {err:.3g}")
        log(f"  CKKS encode word-equal to the host oracle; decode within "
            f"{err:.3g} of it")

    # ---- 8: tests marked gpu ----
    @staticmethod
    def gpu_tests():
        import pytest
        rc = pytest.main(["-m", "gpu", "-q", "-p", "no:cacheprovider",
                          os.path.join(ROOT, "tests")])
        check(rc == 0, f"pytest -m gpu exited {rc}")


def phase(label: str, fn, *args):
    """Run one phase, logging its wall time (compilation included)."""
    log(label)
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return out


def run_one_gpu(gpu: str) -> None:
    import troy_tpu as T
    from troy_tpu import native
    check(native.available(), "native host library did not build")
    s = Smoke(gpu)
    bfv = phase("2. BFV mult+relin, t=20 bits", s.integer_mult_relin,
                T.SchemeType.bfv, 20)
    phase("2. BFV mult+relin, t=59 bits", s.integer_mult_relin,
          T.SchemeType.bfv, 59)
    phase("3. BGV mult+relin", s.integer_mult_relin, T.SchemeType.bgv, 20)
    ckks = phase("4. CKKS mult+relin+rescale", s.ckks_mult_relin_rescale)
    phase("5. rotate_many m=4", s.rotate_many, bfv)
    phase("6. matmul protocol", s.matmul_protocol)
    phase("7. kernels vs plain references", s.kernels, bfv, ckks)
    phase("8. pytest -m gpu", s.gpu_tests)


def run_four_gpus(gpu: str) -> None:
    """The sharding regimes of troy_tpu.parallel on four GPUs, BFV
    multiply+relinearize at the headline chain, each compared word for
    word with the same step on one GPU (the Evaluator on device 0).

    The limb and 2-D regimes run one level down the chain, where the
    ciphertext has four data limbs (q={60,40,40,40}) that split evenly
    over the limb axis; the DP and coefficient regimes run at the first
    level (five data limbs)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu.parallel import sharding as par

    s = Smoke(gpu)
    ctx = s.context(T.SchemeType.bfv, t=T.PlainModulus.batching(N, 20))
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(4))
    rlk = kg.create_relin_keys()
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    ev = T.Evaluator(ctx)
    be = T.BatchEncoder(ctx)
    dec = T.Decryptor(ctx, kg.secret_key)
    t = int(ctx.first_context_data.plain_modulus)
    low = ctx.first_level + 1

    def pairs(count, level):
        out = []
        for _ in range(count):
            x = s.rng.integers(0, t, N, dtype=np.uint64)
            y = s.rng.integers(0, t, N, dtype=np.uint64)
            ca, cb = (enc.encrypt_symmetric(be.encode(v)) for v in (x, y))
            if level != ca.level:
                ca, cb = ev.mod_switch_to(ca, level), ev.mod_switch_to(cb, level)
            out.append((ca, cb, x * y % t))
        return out

    def one_gpu(ca, cb):
        return np.asarray(ev.relinearize(ev.multiply(ca, cb), rlk).data)

    mesh1 = par.make_mesh(4)
    mesh2 = par.make_mesh_2d(2, 2)
    regimes = [
        ("DP batch", par.batched_multiply_relin(ctx, rlk, mesh1), 4,
         ctx.first_level, NamedSharding(mesh1, P("dp"))),
        ("limb", par.limb_sharded_multiply_relin(ctx, rlk, mesh1,
                                                 level=low), 0, low,
         NamedSharding(mesh1, P(None, "dp", None))),
        ("2-D dp x limb", par.dp_limb_sharded_multiply_relin(
            ctx, rlk, mesh2, level=low), 2, low,
         NamedSharding(mesh2, P("dp", None, "tp", None))),
        ("coefficient", par.coeff_sharded_multiply_relin(ctx, rlk, mesh1),
         0, ctx.first_level, NamedSharding(mesh1, P(None, None, "dp"))),
    ]
    for name, run, batch, level, spec in regimes:
        for leaf in jax.tree_util.tree_leaves(run.args):
            check(len(leaf.sharding.device_set) == 4,
                  f"{name}: a table or key lives on "
                  f"{len(leaf.sharding.device_set)} device(s), not 4")
        cases = pairs(max(batch, 1), level)
        if batch:
            d1 = jnp.stack([c[0].data for c in cases])
            d2 = jnp.stack([c[1].data for c in cases])
        else:
            d1, d2 = cases[0][0].data, cases[0][1].data
        d1, d2 = jax.device_put(d1, spec), jax.device_put(d2, spec)
        out = np.asarray(run(d1, d2))
        outs = out if batch else out[None]
        for i, (ca, cb, want) in enumerate(cases):
            check(np.array_equal(outs[i], one_gpu(ca, cb)),
                  f"{name}: ciphertext {i} differs from one GPU")
            got = be.decode(dec.decrypt(T.Ciphertext(data=outs[i],
                                                     level=level)))
            check(np.array_equal(got, want), f"{name}: decryption {i}")
        med, lo, hi = time_ms(lambda: run(d1, d2))
        ref = time_ms(lambda: ev.relinearize(ev.multiply(ca, cb), rlk))
        log(f"  {name}: {len(cases)} ciphertext(s) word-equal to one GPU; "
            f"{med:.3f} ms/step (min {lo:.3f}, max {hi:.3f}) on 4 GPUs vs "
            f"{ref[0]:.3f} ms/op on one; {gpu}")
    used = [(d.memory_stats() or {}).get("bytes_in_use") for d in jax.devices()]
    log(f"  bytes in use per device: {used}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharding regimes")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    require_gpu(devices, 4 if args.four else 1)
    from troy_tpu.utils import jax_cache
    jax_cache.enable()
    gpu = gpu_name_and_power()
    log(f"1. device: {devices[0].device_kind} x{len(devices)}; "
        f"nvidia-smi: {gpu}")
    if args.four:
        run_four_gpus(gpu)
    else:
        run_one_gpu(gpu)
    log(f"nvidia-smi: {gpu}")
    print(result_line(devices), flush=True)


if __name__ == "__main__":
    main()
