"""The byte-plane (int8 tensor-core) NTT against the u64 butterfly NTT,
end to end in BFV multiply+relinearize at n=16384,
q={60,40,40,40,40,60}, t=20 bits, on one NVIDIA GPU.

The byte-plane NTT (troy_tpu/ops/ntt_mxu.py) is no longer in the tree.
A commit that still has it also has both forms behind one switch,
TROY_TPU_MXU_MIN_N (the byte-plane form from that n up), so this script
runs that tree's own code twice, differing in the NTT alone:

    mkdir -p build/ntt_parent
    git archive <commit with troy_tpu/ops/ntt_mxu.py> | tar -x -C build/ntt_parent
    python benchmarks/ntt_compare.py build/ntt_parent

Each measurement is its own process, one after another, in turns
(byte-plane, butterfly, butterfly, byte-plane), so only one process holds
the card at a time. The script runs a copy of that tree's troy_tpu
(build/ntt_compare/tree), whose pytree dataclasses come from a
third-party package the GPU machine lacks: the copy imports them from
this repo's troy_tpu/utils/struct.py instead. Its native library and
compile cache stay inside the checkout (build/ntt_compare/ and the
cache of troy_tpu.utils.jax_cache).

Each process times ``relinearize(multiply(a, b))`` through the public
Evaluator in windows (median, min, max of 5 windows of 20 calls after a
warm-up) and checks that the result decrypts to the plaintext product.
Prints one line per process and, last, one JSON object with every row
and the card's name and power limit.
"""

import glob
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FORMS = {"byte-plane": "2048", "butterfly": str(1 << 30)}
ORDER = ("byte-plane", "butterfly", "butterfly", "byte-plane")

CHILD = r"""
import json, statistics, time
import numpy as np
import jax
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
import troy_tpu as T
from troy_tpu import prng as rnd

N, REPS, WINDOWS = 16384, 20, 5
assert jax.devices()[0].platform == "gpu", jax.devices()
parms = T.EncryptionParameters(
    scheme=T.SchemeType.bfv, poly_modulus_degree=N,
    coeff_modulus=tuple(T.CoeffModulus.create(N, [60, 40, 40, 40, 40, 60])),
    plain_modulus=T.PlainModulus.batching(N, 20))
ctx = T.HeContext(parms)
kg = T.KeyGenerator(ctx, seed=rnd.seed_from_uint64(2024))
rlk = kg.create_relin_keys()
enc = T.Encryptor(ctx, secret_key=kg.secret_key)
be = T.BatchEncoder(ctx)
ev = T.Evaluator(ctx)
t = int(parms.plain_modulus)
a = np.arange(N, dtype=np.uint64) % t
b = a[::-1].copy()
ca, cb = enc.encrypt_symmetric(be.encode(a)), enc.encrypt_symmetric(be.encode(b))
step = lambda: ev.relinearize(ev.multiply(ca, cb), rlk)
t0 = time.perf_counter()
out = step()
jax.block_until_ready(out.data)
first_s = time.perf_counter() - t0
windows = []
for _ in range(WINDOWS):
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = step()
    jax.block_until_ready(out.data)
    windows.append((time.perf_counter() - t0) / REPS * 1e3)
got = be.decode(T.Decryptor(ctx, kg.secret_key).decrypt(out))
print(json.dumps({
    "byte_plane_tables": ctx.first_context_data.ntt.mxu is not None,
    "decrypt_exact": bool(np.array_equal(got, a * b % t)),
    "first_call_s": first_s, "median_ms": statistics.median(windows),
    "min_ms": min(windows), "max_ms": max(windows), "windows_ms": windows}))
"""


def run_form(tree: str, form: str, work: str) -> dict:
    from troy_tpu.utils import jax_cache
    env = dict(os.environ,
               PYTHONPATH=tree,
               TROY_TPU_MXU_MIN_N=FORMS[form],
               TROY_NATIVE_CACHE=os.path.join(work, "native"),
               JAX_COMPILATION_CACHE_DIR=jax_cache.cache_dir())
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        sys.stderr.write(res.stderr[-4000:])
        raise SystemExit(f"{form}: the process exited {res.returncode}")
    row = json.loads(res.stdout.strip().splitlines()[-1])
    if row["byte_plane_tables"] != (form == "byte-plane"):
        raise SystemExit(f"{form}: the tree ran the other NTT")
    if not row["decrypt_exact"]:
        raise SystemExit(f"{form}: the result does not decrypt to a*b")
    return dict(form=form, **row)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        raise SystemExit(__doc__)
    tree = os.path.abspath(args[0])
    if not os.path.exists(os.path.join(tree, "troy_tpu/ops/ntt_mxu.py")):
        raise SystemExit(f"{tree} has no troy_tpu/ops/ntt_mxu.py")
    from troy_tpu.utils.profiling import gpu_name_and_power
    gpu = gpu_name_and_power()
    work = os.path.join(ROOT, "build", "ntt_compare")
    copy = os.path.join(work, "tree")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "troy_tpu"),
                    os.path.join(copy, "troy_tpu"))
    shutil.copy(os.path.join(ROOT, "troy_tpu", "utils", "struct.py"),
                os.path.join(copy, "troy_tpu", "utils", "struct.py"))
    for path in glob.glob(os.path.join(copy, "troy_tpu", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            src = f.read()
        new = re.sub(r"^from [a-z]\w* import struct$",
                     "from troy_tpu.utils import struct", src, flags=re.M)
        if new != src:
            with open(path, "w") as f:
                f.write(new)
    rows = []
    for form in ORDER:
        row = run_form(copy, form, work)
        print(f"{form}: {row['median_ms']:.3f} ms/op (min {row['min_ms']:.3f},"
              f" max {row['max_ms']:.3f}; first call {row['first_call_s']:.1f}"
              f" s) on {gpu}", flush=True)
        rows.append(row)
    print(json.dumps({"gpu": gpu, "op": "BFV multiply+relinearize n=16384 "
                      "q={60,40,40,40,40,60} t=20 bits", "rows": rows}))


if __name__ == "__main__":
    main()
