"""Benchmark: BFV multiply+relinearize at n=16384, q={60,40,40,40,40,60},
t=20 bits (the reference's headline op, test/timetest.cu:321-331) on one
NVIDIA GPU.

The fused op runs in plain windows (utils.profiling.time_ms): each window makes
REPS calls and ends in block_until_ready. The result is the median over
WINDOWS windows, with their spread ((max - min) / median), the device and
the card's name and power limit. It is decrypt-gated: the timed program's
output must decrypt to the plaintext product. One process; any platform
but the GPU is refused.

Prints one JSON line:
{"metric", "value" (ops/s), "unit", "ms_per_op", "spread", "device", "gpu"}.
"""

import json
import sys
import time

import numpy as np

N = 16384
Q_BITS = [60, 40, 40, 40, 40, 60]
T_BITS = 20
REPS = 50
WINDOWS = 5


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    import troy_tpu as T
    from troy_tpu import prng as rnd
    from troy_tpu import evaluator as ev_mod
    from troy_tpu.utils import jax_cache
    from troy_tpu.utils.profiling import (gpu_name_and_power, require_gpu,
                                          time_ms)

    devices = jax.devices()
    require_gpu(devices)
    jax_cache.enable()
    gpu = gpu_name_and_power()
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.bfv, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, Q_BITS)),
        plain_modulus=T.PlainModulus.batching(N, T_BITS))
    ctx = T.HeContext(parms)
    kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(2024))
    rlk = kg.create_relin_keys()
    enc = T.Encryptor(ctx, secret_key=kg.secret_key)
    be = T.BatchEncoder(ctx)
    t = int(parms.plain_modulus)
    a = np.arange(N, dtype=np.uint64) % t
    b = a[::-1].copy()
    ct1 = enc.encrypt_symmetric(be.encode(a))
    ct2 = enc.encrypt_symmetric(be.encode(b))

    # cd/key/key_cd are jit ARGUMENTS: a closed-over device array would be
    # embedded as a constant in the executable
    @jax.jit
    def step(d1, d2, cd, key, key_cd):
        prod = ev_mod._bfv_multiply(d1, d2, cd)
        delta = ev_mod._switch_key_core(prod[2], key, cd, key_cd, False)
        c0 = ev_mod._add(prod[0][None], delta[0][None], cd)[0]
        c1 = ev_mod._add(prod[1][None], delta[1][None], cd)[0]
        return jnp.stack([c0, c1])

    args = (ct1.data, ct2.data, ctx.first_context_data, rlk.keys[2],
            ctx.key_context_data)
    t0 = time.perf_counter()
    jax.block_until_ready(step(*args))
    log(f"compile + first run: {time.perf_counter() - t0:.1f} s")
    med, lo, hi = time_ms(lambda: step(*args), reps=REPS, windows=WINDOWS)

    dec = T.Decryptor(ctx, kg.secret_key)
    got = be.decode(dec.decrypt(T.Ciphertext(data=step(*args),
                                             level=ctx.first_level)))
    if not np.array_equal(got, a * b % t):
        raise SystemExit("bench: the timed output does not decrypt to the "
                         "plaintext product")
    d = devices[0]
    print(json.dumps({
        "metric": "bfv_mult_relin_n16384", "unit": "ops/s",
        "value": 1e3 / med, "ms_per_op": med, "spread": (hi - lo) / med,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
        "gpu": gpu}))


if __name__ == "__main__":
    main()
