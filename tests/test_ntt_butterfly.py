"""The device butterfly NTT (ops/ntt.py) at every width the system uses,
word for word against its numpy twin (utils/host_ntt.py) and, where
O(n^2) is affordable, against the naive transform (utils/ntt_tables.py)."""

import numpy as np
import pytest

import troy_tpu  # noqa: F401
import jax.numpy as jnp
from troy_tpu.ops import ntt as dntt
from troy_tpu.utils import host_ntt, numth
from troy_tpu.utils import ntt_tables as nt

NAIVE_MAX_N = 1024


def _setup(n, bits, rows=2):
    q = numth.get_prime(2 * n, bits)
    t = nt.make_ntt_tables(n, q)
    x = np.random.default_rng(n + bits).integers(0, q, (rows, n),
                                                  dtype=np.uint64)
    return q, t, dntt.NttTables.from_host(t), x


@pytest.mark.parametrize("bits", [30, 40, 50, 60])
@pytest.mark.parametrize("n", [64, 256, 1024, 4096, 16384])
def test_forward_inverse_word_equal(n, bits):
    q, t, dt, x = _setup(n, bits)
    fwd = np.asarray(dntt.ntt_forward(jnp.asarray(x), dt))
    np.testing.assert_array_equal(fwd, host_ntt.ntt_forward_np(x, t))
    if n <= NAIVE_MAX_N:
        np.testing.assert_array_equal(fwd[0], nt.naive_negacyclic_ntt(x[0], t))
    inv = np.asarray(dntt.ntt_inverse(jnp.asarray(fwd), dt))
    np.testing.assert_array_equal(inv, host_ntt.ntt_inverse_np(fwd, t))
    np.testing.assert_array_equal(inv, x)


@pytest.mark.parametrize("n", [1024, 16384])
def test_lazy_forward_round_trip(n):
    """Lazy forward output stays in [0, 4q), is congruent to the reduced
    transform, and the inverse accepts it once folded below 2q."""
    q, t, dt, x = _setup(n, 59)
    lazy = np.asarray(dntt.ntt_forward(jnp.asarray(x), dt, lazy=True))
    assert (lazy < 4 * q).all()
    full = np.asarray(dntt.ntt_forward(jnp.asarray(x), dt))
    np.testing.assert_array_equal(lazy % q, full)
    folded = np.where(lazy >= 2 * q, lazy - 2 * q, lazy)
    back = np.asarray(dntt.ntt_inverse(jnp.asarray(folded), dt))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("n", [1024, 16384])
def test_lazy_inverse_round_trip(n):
    """Lazy inverse output stays in [0, 2q) and reduces to the input."""
    q, t, dt, x = _setup(n, 60)
    fwd = dntt.ntt_forward(jnp.asarray(x), dt)
    lazy = np.asarray(dntt.ntt_inverse(fwd, dt, lazy=True))
    assert (lazy < 2 * q).all()
    np.testing.assert_array_equal(lazy % q, x)
