import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.core import prng
from jstsp19.ops import KronDictOp
from jstsp19.solvers.estim import (
    CAwgnPrior,
    CGMPrior,
    SparsePrior,
    ProbitLikelihood,
    QuantizedLikelihood,
)
from jstsp19.solvers.vamp_slm import vamp_slm, vamp_slm_se


def crandn(key, shape, var=1.0):
    return prng.complex_normal(key, shape, var=var)


def test_vamp_slm_gaussian_prior_equals_lmmse(key):
    kA, kB, kx, kn = jax.random.split(key, 4)
    A = crandn(kA, (12, 8))
    B = crandn(kB, (6, 20))
    op = KronDictOp(A, B)
    X = crandn(kx, (8, 6))
    nv = 0.1
    Y = op.mv(X) + crandn(kn, (12, 20), nv)
    prior = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    res = vamp_slm(prior, Y, op, gamw=1.0 / nv, nit=100)
    K2 = np.kron(np.asarray(B).T, np.asarray(A))
    yv = np.asarray(Y).flatten(order="F")
    xl = np.linalg.solve(
        K2.conj().T @ K2 + nv * np.eye(48), K2.conj().T @ yv
    ).reshape(8, 6, order="F")
    rel = np.linalg.norm(np.asarray(res.x) - xl) / np.linalg.norm(xl)
    assert rel < 1e-3, rel


def test_vamp_slm_sparse_recovery_and_se_agreement(key):
    # empirical VAMP-SLM MSE should approach the SE prediction
    kA, kB, kx, ki, kn = jax.random.split(key, 5)
    Gr, K, N, M = 24, 12, 32, 40
    A = crandn(kA, (N, Gr)) / np.sqrt(N)
    B = crandn(kB, (K, M)) / np.sqrt(K)
    op = KronDictOp(A, B)
    beta = 0.1
    mask = jax.random.uniform(ki, (Gr, K)) < beta
    X = jnp.where(mask, crandn(kx, (Gr, K), var=1 / beta), 0.0)
    nv = 0.01
    Y = op.mv(X) + crandn(kn, (N, M), nv)
    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    res = vamp_slm(prior, Y, op, gamw=1.0 / nv, nit=40)
    emp_mse = float(jnp.mean(jnp.abs(res.x - X) ** 2))
    assert emp_mse < 0.1 * (1.0)  # meaningful recovery (signal power = 1)

    _, _, d = op.gram_in_eig()

    def sampler(k, n):
        m = jax.random.uniform(k, (n,)) < beta
        return jnp.where(m, crandn(jax.random.fold_in(k, 1), (n,), var=1 / beta), 0.0)

    se = vamp_slm_se(sampler, prior, d.reshape(-1), gamw=1.0 / nv, nit=40)
    # SE prediction and empirical trajectory agree at convergence within 3x
    assert float(se[-1]) < 0.1
    assert emp_mse < float(se[-1]) * 3 + 0.01


def test_cgm_prior_moments(key):
    # single-component GM == CAwgn
    gm = CGMPrior(
        weights=jnp.asarray([1.0]),
        means=jnp.asarray([0.0 + 0j]),
        variances=jnp.asarray([2.0]),
    )
    ca = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(2.0))
    r = crandn(key, (50,))
    x1, v1 = gm.estim(r, jnp.full((50,), 0.5))
    x2, v2 = ca.estim(r, jnp.asarray(0.5))
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-5)


def test_probit_likelihood_pushes_toward_sign(key):
    y = jnp.asarray([1.0, 0.0])
    lik = ProbitLikelihood(y, jnp.asarray(1e-3))
    phat = jnp.asarray([0.0, 0.0])
    zhat, zvar = lik.estim(phat, jnp.asarray(1.0))
    assert float(zhat[0]) > 0.3 and float(zhat[1]) < -0.3
    assert np.all(np.asarray(zvar) < 1.0)


def test_quantized_likelihood_truncated_moments(key):
    lo = jnp.asarray([0.0])
    hi = jnp.asarray([1.0])
    lik = QuantizedLikelihood(lo, hi)
    zhat, zvar = lik.estim(jnp.asarray([0.0]), jnp.asarray(4.0))
    # posterior mean inside the cell, variance shrunk
    assert 0.0 < float(zhat[0]) < 1.0
    assert float(zvar[0]) < 4.0
