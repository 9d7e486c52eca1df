import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.ops.jacobi import jacobi_eigh, svt_jacobi
from jstsp19.solvers.lowrank import svt


def _rand_herm(seed, batch, n):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    return jnp.asarray((B + np.conj(np.transpose(B, (0, 2, 1)))) / 2, jnp.complex64)


def test_jacobi_matches_lapack():
    A = _rand_herm(0, 4, 32)
    w, V = jacobi_eigh(A, sweeps=10)
    w_ref = np.linalg.eigvalsh(np.asarray(A, np.complex128))
    np.testing.assert_allclose(np.asarray(w), w_ref, atol=2e-4 * np.abs(w_ref).max())
    # reconstruction + orthonormality
    Vn = np.asarray(V)
    R = (Vn * np.asarray(w)[..., None, :]) @ np.conj(np.transpose(Vn, (0, 2, 1)))
    np.testing.assert_allclose(R, np.asarray(A), atol=1e-4 * np.abs(np.asarray(A)).max())
    I = np.conj(np.transpose(Vn, (0, 2, 1))) @ Vn
    np.testing.assert_allclose(I, np.broadcast_to(np.eye(32), I.shape), atol=1e-4)


def test_jacobi_psd_gram():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2, 16, 40)) + 1j * rng.standard_normal((2, 16, 40))
    G = jnp.asarray(X @ np.conj(np.transpose(X, (0, 2, 1))), jnp.complex64)
    w, V = jacobi_eigh(G, sweeps=10)
    assert np.all(np.asarray(w) > -1e-3)


def test_svt_jacobi_matches_eigh_svt():
    rng = np.random.default_rng(2)
    Y = jnp.asarray(
        rng.standard_normal((3, 32, 140)) + 1j * rng.standard_normal((3, 32, 140)),
        jnp.complex64,
    )
    tau = 5.0
    out_j = svt_jacobi(Y, tau, sweeps=10)
    out_e = svt(Y, tau)
    scale = float(jnp.abs(out_e).max())
    np.testing.assert_allclose(
        np.asarray(out_j), np.asarray(out_e), atol=2e-3 * scale
    )
