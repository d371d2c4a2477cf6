"""Setup-time bench: context construction + key generation at n=16384.

Counterpart of the reference's setup phase (context ctor
src/context_cuda.cuh:139-156 + KeyGenerator, keygenerator_cuda.cuh:51-85).
Reports a stage breakdown for the COLD build (first context in the
process: host table precompute + device uploads; on a cold XLA
persistent cache this is also where any mini-executable compiles would
show up — the round-4 fix removed them by stacking tables on the host
and uploading pure transfers, ops/ntt.py _stacked_tables_dev) and for a
WARM rebuild (same params: pure lru_cache hits).

Run: PYTHONPATH=. python benchmarks/setup_bench.py
"""
import time

import jax

import troy_tpu as T

N = 16384


def build(parms):
    t0 = time.perf_counter()
    ctx = T.HeContext(parms)
    for cd in ctx.chain:
        jax.block_until_ready(jax.tree_util.tree_leaves(cd))
    return ctx, time.perf_counter() - t0


def main():
    print("devices:", jax.devices())
    tmod = T.PlainModulus.batching(N, 59)
    q = tuple(T.CoeffModulus.create(N, [60, 40, 40, 40, 40, 60]))
    parms = T.EncryptionParameters(scheme=T.SchemeType.bfv,
                                   poly_modulus_degree=N,
                                   coeff_modulus=q, plain_modulus=tmod)

    ctx, cold = build(parms)
    print(f"context build (cold, tables materialized): {cold:.2f} s")
    _, warm = build(parms)
    print(f"context rebuild (warm, same params):       {warm:.3f} s")

    t0 = time.perf_counter()
    kg = T.KeyGenerator(ctx)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    rlk = kg.create_relin_keys()
    jax.block_until_ready(jax.tree_util.tree_leaves(rlk))
    t_relin = time.perf_counter() - t0
    t0 = time.perf_counter()
    gk = kg.create_galois_keys([1])
    jax.block_until_ready(jax.tree_util.tree_leaves(gk))
    t_gal = time.perf_counter() - t0
    print(f"keygen init {t_init:.2f} s, relin keys {t_relin:.2f} s, "
          f"galois key(1 step) {t_gal:.2f} s")
    total = cold + t_init + t_relin + t_gal
    print(f"total cold setup: {total:.2f} s")


if __name__ == "__main__":
    main()
