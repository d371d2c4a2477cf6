"""Native runtime must agree bit-for-bit with the pure-Python host paths."""

import numpy as np
import pytest

from troy_tpu import native
from troy_tpu import prng as rnd
from troy_tpu.utils.rns import RnsBase
from troy_tpu.modulus import Modulus
from troy_tpu.utils import numth


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no native toolchain")


def test_xof_stream_matches_python():
    seed = rnd.seed_from_uint64(1, 2, 3)
    # pure python stream
    gen = rnd.UniformRandomGenerator(seed)
    py = b"".join(gen._refill_block(c) for c in range(3))
    nat = native.xof_fill(seed, 0, 3 * 4096)
    assert nat == py


def test_generator_bulk_path_matches_blockwise():
    seed = rnd.seed_from_uint64(9)
    g1 = rnd.UniformRandomGenerator(seed)
    g2 = rnd.UniformRandomGenerator(seed)
    a = g1.generate(5)
    b = g1.generate(9000)        # crosses blocks; may hit the native path
    c = g1.generate(4096 * 2)    # aligned bulk
    ref = g2._refill_block(0) + g2._refill_block(1) + g2._refill_block(2) \
        + g2._refill_block(3) + g2._refill_block(4)
    whole = a + b + c
    assert whole == ref[:len(whole)]


def test_crt_compose_matches_object_math():
    n = 64
    qs = [numth.get_prime(2 * n, b) for b in (40, 41, 42, 43)]
    base = RnsBase(tuple(Modulus(q) for q in qs))
    rng = np.random.default_rng(3)
    residues = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in qs])
    Q = base.base_prod
    k = len(qs)
    w = (Q.bit_length() + 63) // 64
    words = lambda v: [(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(w)]
    invp = [base.inv_punctured(i) for i in range(k)]
    got = native.crt_compose_centered_double(
        residues, qs, invp, [(x << 64) // q for x, q in zip(invp, qs)],
        np.array([words(base.punctured_prod(i)) for i in range(k)],
                 dtype=np.uint64),
        np.array(words(Q), dtype=np.uint64), 1.0)
    # object-math reference
    acc = np.zeros(n, dtype=object)
    for i in range(k):
        acc += residues[i].astype(object) * invp[i] % qs[i] \
            * base.punctured_prod(i)
    acc %= Q
    acc = np.where(acc > Q // 2, acc - Q, acc)
    np.testing.assert_allclose(got, acc.astype(np.float64), rtol=1e-12)


def test_ntt_tables_fill_matches_python_loop():
    # oracle: the pure-Python loop from utils/ntt_tables.py
    for n, bits in ((256, 60), (64, 30)):
        q = numth.get_prime(2 * n, bits)
        root = numth.minimal_primitive_root(2 * n, q)
        inv_root = numth.invert_mod(root, q)
        log_n = numth.get_power_of_two(n)
        powers = [0] * n
        inv_powers = [0] * n
        acc = inv_acc = 1
        for k in range(n):
            b = numth.reverse_bits(k, log_n)
            powers[b] = acc
            inv_powers[b] = inv_acc
            acc = (acc * root) % q
            inv_acc = (inv_acc * inv_root) % q
        shoup = lambda w: (w << 64) // q
        p_np, ps_np, ip_np, ips_np = native.ntt_tables_fill(
            n, q, root, inv_root)
        to64 = lambda vals: np.array(
            [v & 0xFFFFFFFFFFFFFFFF for v in vals], dtype=np.uint64)
        np.testing.assert_array_equal(p_np, to64(powers))
        np.testing.assert_array_equal(ps_np, to64([shoup(p) for p in powers]))
        np.testing.assert_array_equal(ip_np, to64(inv_powers))
        np.testing.assert_array_equal(
            ips_np, to64([shoup(p) for p in inv_powers]))


def test_library_builds_into_the_checkout():
    """The shared object is compiled from the committed source into the
    checkout's build/ directory (listed in .gitignore), nowhere else."""
    import os
    lib = native.get_lib()
    assert lib is not None
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.BUILD_DIR == os.path.join(repo, "build", "troy_native")
    assert os.path.dirname(lib._name) == native.BUILD_DIR


def test_jax_cache_follows_the_environment(monkeypatch, tmp_path):
    from troy_tpu.utils import jax_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_cache.cache_dir() == str(tmp_path)


def test_jax_cache_defaults_to_the_checkout(monkeypatch):
    import os
    from troy_tpu.utils import jax_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jax_cache.cache_dir() == os.path.join(repo, ".jax_cache")
