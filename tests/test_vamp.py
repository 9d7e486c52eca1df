import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.ops import KronDictOp
from jstsp19.solvers import (
    CAwgnPrior,
    SparsePrior,
    CAwgnLikelihood,
    vamp_glm,
    vamp_mmwave,
)


def crandn(key, shape, var=1.0):
    k1, k2 = jax.random.split(key)
    return (
        (jax.random.normal(k1, shape) + 1j * jax.random.normal(k2, shape))
        * np.sqrt(var / 2)
    ).astype(jnp.complex64)


def test_cawgn_prior_posterior_moments(key):
    # Closed-form posterior of CN(0,v0) from r = x + CN(0,rvar)
    prior = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(2.0))
    r = crandn(key, (100,))
    xhat, xvar = prior.estim(r, jnp.asarray(0.5))
    gain = 2.0 / 2.5
    np.testing.assert_allclose(np.asarray(xhat), np.asarray(r) * gain, atol=1e-5)
    np.testing.assert_allclose(float(xvar), gain * 0.5, atol=1e-6)


def test_sparse_prior_limits(key):
    base = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    # Large observation => almost surely active => posterior ~ base posterior
    prior = SparsePrior(base, jnp.asarray(0.5))
    r_big = jnp.asarray([10.0 + 0j])
    xhat, _ = prior.estim(r_big, jnp.asarray(0.01))
    xb, _ = base.estim(r_big, jnp.asarray(0.01))
    np.testing.assert_allclose(np.asarray(xhat), np.asarray(xb), rtol=1e-3)
    # Tiny observation with sparse prior => shrunk toward 0
    prior_sparse = SparsePrior(base, jnp.asarray(0.01))
    xhat2, _ = prior_sparse.estim(jnp.asarray([0.05 + 0j]), jnp.asarray(0.1))
    assert abs(np.asarray(xhat2)[0]) < 0.05


def test_cawgn_likelihood_moments(key):
    y = crandn(key, (50,))
    lik = CAwgnLikelihood(y, jnp.asarray(0.1))
    phat = jnp.zeros((50,), jnp.complex64)
    zhat, zvar = lik.estim(phat, jnp.asarray(1.0))
    gain = 1.0 / 1.1
    np.testing.assert_allclose(np.asarray(zhat), np.asarray(y) * gain, atol=1e-5)
    np.testing.assert_allclose(float(zvar), 0.1 * gain, atol=1e-6)


def _sparse_matrix_problem(key, N=32, Gr=32, K=16, M=16, k_active=12, snr_db=30.0):
    kA, kB, kx, kn, ki = jax.random.split(key, 5)
    A = crandn(kA, (N, Gr)) / np.sqrt(N)
    B = crandn(kB, (K, M)) / np.sqrt(K)
    flat_idx = jax.random.choice(ki, Gr * K, (k_active,), replace=False)
    X = jnp.zeros((Gr * K,), jnp.complex64).at[flat_idx].set(
        crandn(kx, (k_active,)) * 2.0
    ).reshape(Gr, K)
    op = KronDictOp(A, B)
    Y_clean = op.mv(X)
    nv = float(jnp.mean(jnp.abs(Y_clean) ** 2) * 10 ** (-snr_db / 10))
    Y = Y_clean + crandn(kn, Y_clean.shape, nv)
    return op, X, Y, nv


def test_vamp_glm_recovers_sparse_matrix(key):
    op, X, Y, nv = _sparse_matrix_problem(key)
    beta = jnp.asarray(12 / (32 * 16), jnp.float32)
    prior = SparsePrior(CAwgnPrior(jnp.asarray(0.0 + 0j), 4.0 / beta), beta)
    lik = CAwgnLikelihood(Y, jnp.asarray(nv, jnp.float32))
    res = vamp_glm(prior, lik, op, nit=50)
    nmse = np.sum(np.abs(np.asarray(res.x - X)) ** 2) / np.sum(
        np.abs(np.asarray(X)) ** 2
    )
    assert nmse < 0.05, nmse


def test_vamp_glm_is_finite_and_stable(key):
    op, X, Y, nv = _sparse_matrix_problem(key, snr_db=0.0)
    beta = jnp.asarray(0.05, jnp.float32)
    prior = SparsePrior(CAwgnPrior(jnp.asarray(0.0 + 0j), 1.0 / beta), beta)
    lik = CAwgnLikelihood(Y, jnp.asarray(nv, jnp.float32))
    res = vamp_glm(prior, lik, op, nit=100)
    assert np.all(np.isfinite(np.asarray(res.x).real))


def test_vamp_equals_lmmse_oracle_gaussian_prior(key):
    """With a pure Gaussian prior, converged VAMP must equal the closed-form
    LMMSE solution (the genie-LMMSE oracle pattern of the reference's
    estimTest.m) — both eigenbasis branches."""
    for shapes in [((12, 8), (6, 20)), ((8, 12), (10, 6))]:  # M>N and M<N
        (N_, Gr), (K, M_) = shapes
        kA, kB, kx, kn = jax.random.split(jax.random.fold_in(key, N_), 4)
        A = crandn(kA, (N_, Gr))
        B = crandn(kB, (K, M_))
        X = crandn(kx, (Gr, K))
        op = KronDictOp(A, B)
        nv = 0.1
        Y = op.mv(X) + crandn(kn, (N_, M_), nv)
        prior = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
        lik = CAwgnLikelihood(Y, jnp.asarray(nv, jnp.float32))
        res = vamp_glm(prior, lik, op, nit=200, damp=0.9)
        K2 = np.kron(np.asarray(B).T, np.asarray(A))
        yv = np.asarray(Y).flatten(order="F")
        xl = np.linalg.solve(
            K2.conj().T @ K2 + nv * np.eye(Gr * K), K2.conj().T @ yv
        ).reshape(Gr, K, order="F")
        rel = np.linalg.norm(np.asarray(res.x) - xl) / np.linalg.norm(xl)
        assert rel < 1e-3, (shapes, rel)


def test_vamp_mmwave_pipeline_runs(key):
    # Smoke test on the actual driver-shaped problem.
    from jstsp19.channel import wideband_mmwave_channel
    from jstsp19.frontend import create_beamformer, qam4_training_frames, awgn, hbf

    Nt, Nr, L, T = 4, 16, 2, 10
    ch = wideband_mmwave_channel(key, L, Nr, Nt, 2, 3, Nr, Nt)
    T_hbf = T * Nt
    Psi = qam4_training_frames(jax.random.fold_in(key, 1), Nt, T_hbf, L)
    N = awgn(jax.random.fold_in(key, 2), Nr, T_hbf, 0.01)
    W = create_beamformer(Nr, "ZC")
    Y, W_c = hbf(ch.H, N, Psi, Nr, W)
    A = W_c.conj().T @ ch.Dr
    B = jnp.concatenate([ch.Dt.conj().T @ Psi[l] for l in range(L)], axis=0)
    Xh = vamp_mmwave(Y, A, B, 1.0, num_nonzero=20, nit=50)
    assert Xh.shape == ch.Zbar.shape
    nmse = np.sum(np.abs(np.asarray(Xh - ch.Zbar)) ** 2) / np.sum(
        np.abs(np.asarray(ch.Zbar)) ** 2
    )
    assert np.isfinite(nmse)
    assert nmse < 1.0  # meaningfully better than the zero estimate


def test_vamp_glm_quantized_channel():
    """VAMP-GLM with the y-less interval likelihood (few-bit ADC): dtype
    inference must fall back to the likelihood's leaves (real scalar
    model), and the truncated-moment pvar guard must keep the GAM_MIN
    precision init finite — round 5; previously this path crashed on
    likelihood.y and, once unblocked, returned zeros (f32 cancellation
    at pvar=1e11).  Recovery must track the quantization-noise floor."""
    from jstsp19.ops import KronDictOp
    from jstsp19.solvers import vamp_glm
    from jstsp19.solvers.estim import AwgnPrior, QuantizedLikelihood

    rng = np.random.default_rng(0)
    n, m, step = 32, 64, 0.25
    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(m), jnp.float32)
    x = rng.standard_normal(n).astype(np.float32)
    z = np.asarray(A) @ x
    lo = np.floor(z / step) * step
    op = KronDictOp(A, jnp.eye(1, dtype=jnp.float32))
    res = vamp_glm(
        AwgnPrior(mean0=0.0, var0=1.0),
        QuantizedLikelihood(
            lo=jnp.asarray(lo[:, None]), hi=jnp.asarray(lo[:, None] + step)
        ),
        op,
        nit=50,
    )
    nmse = float(np.sum((np.asarray(res.x)[:, 0] - x) ** 2) / np.sum(x**2))
    assert nmse < 3e-2, nmse  # ~1.1e-2; cell floor ~7e-3
