"""Rank-one matrix factorization: fit + SE overlay (matrixFactor family).

Mirrors the reference's ``rankOneTest.m`` golden methodology: Gaussian u,
sparse-exponential v (the exact ``rankOneSE.m:53-58`` discrete grid),
A = u0·v0ᵀ + sqrt(m·wvar)·W at fixed SNR, then check the empirical squared
correlations of the MMSE fit against the scalar SE prediction
(``rankOneSE.m:96-109``) — the ``data/rankOneTest_*.mat`` pattern.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.solvers import (
    AwgnPrior,
    DiscretePrior,
    mc_prior_mse,
    prior_moments,
    rank_one_fit,
    rank_one_se,
)

M, N = 1000, 500
BETA = N / M


def _v_prior():
    # exponential distribution on a discrete grid, sparsified at rate 0.1
    # (rankOneSE.m:53-66)
    nx = 100
    x = np.linspace(1 / nx, 2, nx)
    px = np.exp(-x)
    px = 0.1 * px / px.sum()
    atoms = np.concatenate([[0.0], x]).astype(np.float32)
    weights = np.concatenate([[0.9], px]).astype(np.float32)
    return DiscretePrior(jnp.asarray(atoms), jnp.asarray(weights))


def _sample_discrete(key, n, prior):
    w = prior.weights / jnp.sum(prior.weights)
    idx = jax.random.choice(key, prior.atoms.shape[0], (n,), p=w)
    return prior.atoms[idx]


@pytest.fixture(scope="module")
def problem():
    key = jax.random.key(3)
    ku, kv, kw = jax.random.split(key, 3)
    estimu = AwgnPrior(jnp.asarray(0.0), jnp.asarray(1.0))
    estimv = _v_prior()
    u0 = jax.random.normal(ku, (M,))
    v0 = _sample_discrete(kv, N, estimv)
    umean0, uvar0 = prior_moments(estimu)
    vmean0, vvar0 = prior_moments(estimv)
    usq0 = float(umean0**2 + uvar0)
    vsq0 = float(vmean0**2 + vvar0)
    snr_db = 5.0
    wvar = usq0 * vsq0 * 10 ** (-0.1 * snr_db)  # rankOneSE.m:101
    # the reference's model: A = u0 v0' + sqrt(m*wvar)*randn(m,n) — the 1/m
    # in the iteration absorbs the scale (rankOneFit.m:5-8)
    A = jnp.outer(u0, v0) + jnp.sqrt(M * wvar) * jax.random.normal(kw, (M, N))
    return A, u0, v0, estimu, estimv, wvar, (umean0, uvar0, vmean0, vvar0)


def _corr(a, b):
    num = jnp.abs(jnp.vdot(a, b)) ** 2
    den = jnp.vdot(a, a).real * jnp.vdot(b, b).real
    return float(num / den)


def test_mmse_fit_recovers_and_matches_se(problem):
    A, u0, v0, estimu, estimv, wvar, (um, uv, vm, vv) = problem
    res = rank_one_fit(A, estimu, estimv, jnp.asarray(wvar), nit=10)
    emp_corru = _corr(res.u, u0)
    emp_corrv = _corr(res.v, v0)
    mse_u = mc_prior_mse(
        lambda k, n: jax.random.normal(k, (n,)), estimu, seed=11
    )
    mse_v = mc_prior_mse(
        lambda k, n: _sample_discrete(k, n, estimv), estimv, seed=12
    )
    corru_se, corrv_se = rank_one_se(
        mse_u, mse_v, BETA, um, uv, vm, vv, jnp.asarray(wvar), nit=10
    )
    # SE predicts the empirical squared correlations (finite-size MC error)
    assert emp_corru > 0.5  # actually recovers u
    assert abs(emp_corru - float(corru_se[-1])) < 0.1
    assert abs(emp_corrv - float(corrv_se[-1])) < 0.1
    # SE trajectory is monotone nondecreasing to its fixed point
    se = np.asarray(corrv_se)
    assert (np.diff(se) > -1e-6).all()


def test_linear_branch_runs_and_underperforms_mmse(problem):
    A, u0, v0, estimu, estimv, wvar, _ = problem
    lin = rank_one_fit(A, estimu, estimv, jnp.asarray(wvar), nit=10, lin_est=True)
    mmse = rank_one_fit(A, estimu, estimv, jnp.asarray(wvar), nit=10)
    cl = _corr(lin.v, v0)
    cm = _corr(mmse.v, v0)
    assert np.isfinite(cl) and 0.0 <= cl <= 1.0
    # the prior-aware MMSE estimator beats (or matches) plain power iteration
    assert cm >= cl - 0.02


def test_prior_moments_discrete_and_sparse():
    estimv = _v_prior()
    m0, v0 = prior_moments(estimv)
    # direct numpy computation of the same grid moments
    nx = 100
    x = np.linspace(1 / nx, 2, nx)
    px = np.exp(-x)
    px = 0.1 * px / px.sum()
    w = np.concatenate([[0.9], px])
    a = np.concatenate([[0.0], x])
    m_ref = (w * a).sum()
    v_ref = (w * (a - m_ref) ** 2).sum()
    np.testing.assert_allclose(float(m0), m_ref, rtol=1e-5)
    np.testing.assert_allclose(float(v0), v_ref, rtol=1e-5)
