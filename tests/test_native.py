"""Native C++ components vs the JAX implementations (cross-oracles)."""
import numpy as np
import pytest

from jstsp19.utils import native_available, native_fwht, native_sparse_conj_mult

pytestmark = pytest.mark.skipif(
    not native_available(), reason="g++ build unavailable"
)


def test_native_fwht_matches_jax():
    from jstsp19.ops.fourier import fwht
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64))
    out = native_fwht(x)
    ref = np.asarray(fwht(jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # natural order too
    np.testing.assert_allclose(
        native_fwht(x, "natural"),
        np.asarray(fwht(jnp.asarray(x, jnp.float32), ordering="natural")),
        atol=1e-4,
    )


def test_native_fwht_self_inverse():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(128)
    y = native_fwht(native_fwht(x, "natural"), "natural")
    np.testing.assert_allclose(y, x, atol=1e-10)


def test_native_sparse_conj_mult():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((20, 8)) + 1j * rng.standard_normal((20, 8))
    X = rng.standard_normal((20, 6)) + 1j * rng.standard_normal((20, 6))
    Z = A.conj().T @ X
    rows = np.array([0, 3, 7, 7, 2])
    cols = np.array([1, 5, 0, 5, 2])
    out = native_sparse_conj_mult(A, X, rows, cols)
    np.testing.assert_allclose(out, Z[rows, cols], atol=1e-10)
