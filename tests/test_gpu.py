"""Properties of the GPU backend that the CPU tests cannot show.

Marked ``gpu``: on any other platform a fixture skips them.
``python -m pytest -m gpu`` runs them on the card (chip_smoke.py does).
"""

import numpy as np
import pytest

import troy_tpu as T
from troy_tpu.ops import ntt as dntt
from troy_tpu.ops import u64ops as u
from troy_tpu.utils import host_ntt

pytestmark = pytest.mark.gpu

N = 16384


@pytest.fixture
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


def test_f64_is_ieee(gpu):
    """The CKKS embedding and its exact rounding rely on IEEE binary64:
    a 53-bit mantissa, gradual underflow and exact power-of-two steps."""
    import jax.numpy as jnp
    x = jnp.asarray([1.0 + 2.0 ** -52, 2.0 ** -1074, 2.0 ** 200 + 2.0 ** 148])
    got = np.asarray((x - jnp.asarray([1.0, 0.0, 2.0 ** 200])) * 2.0)
    np.testing.assert_array_equal(
        got, [2.0 ** -51, 2.0 ** -1073, 2.0 ** 149])


def test_mulhi64_equals_python_ints(gpu):
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 63, 1 << 16, dtype=np.uint64) * 2 + 1
    b = rng.integers(0, 1 << 63, 1 << 16, dtype=np.uint64) * 2
    got = np.asarray(u.mulhi64(jnp.asarray(a), jnp.asarray(b)))
    want = (a.astype(object) * b.astype(object)) >> 64
    np.testing.assert_array_equal(got.astype(object), want)


@pytest.mark.parametrize("bits", [60, 40])
def test_ntt_word_equal_to_host_twin(gpu, bits):
    import jax.numpy as jnp
    q = tuple(int(m) for m in T.CoeffModulus.create(N, [bits]))
    tables = dntt.RnsNttTables.from_moduli(N, q)
    x = np.random.default_rng(bits).integers(0, q[0], (1, N),
                                             dtype=np.uint64)
    fwd = np.asarray(dntt.rns_ntt_forward(jnp.asarray(x), tables))
    np.testing.assert_array_equal(fwd, host_ntt.rns_ntt_forward_np(x, N, q))
    inv = np.asarray(dntt.rns_ntt_inverse(jnp.asarray(fwd), tables))
    np.testing.assert_array_equal(inv, x)


def test_ckks_encode_word_equal_to_host(gpu):
    """cuFFT's complex128 transform rounds to the same words as numpy's
    at the headline width and scale."""
    parms = T.EncryptionParameters(
        scheme=T.SchemeType.ckks, poly_modulus_degree=N,
        coeff_modulus=tuple(T.CoeffModulus.create(N, [60, 40, 40, 60])))
    ctx = T.HeContext(parms)
    rng = np.random.default_rng(3)
    v = rng.uniform(-1, 1, N // 2) + 1j * rng.uniform(-1, 1, N // 2)
    dev = T.CKKSEncoder(ctx).encode(v, 2.0 ** 40)
    host = T.CKKSEncoder(ctx, host=True).encode(v, 2.0 ** 40)
    np.testing.assert_array_equal(np.asarray(dev.data), np.asarray(host.data))
