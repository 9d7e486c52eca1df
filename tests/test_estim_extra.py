"""Posterior-moment tests for the second wave of EstimIn/EstimOut analogs
(Dirac/Null/ElasticNet/NNSoftThresh/Mix/Concat priors; Dirac/Masked/
GaussMix/CMultAwgn/Hinge/Concat likelihoods), same quadrature-oracle
strategy as ``test_estim.py`` (reference: ``test/testLaplaceEstimOut.m``
family)."""
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.solvers.estim import (
    AwgnPrior,
    CAwgnLikelihood,
    CAwgnPrior,
    CMultAwgnLikelihood,
    ConcatLikelihood,
    ConcatPrior,
    DiracLikelihood,
    DiracPrior,
    ElasticNetPrior,
    GaussMixLikelihood,
    HingeLikelihood,
    MaskedLikelihood,
    MixPrior,
    NNSoftThreshPrior,
    NullPrior,
    OutlierLikelihood,
)


def _numeric_posterior(log_prior_fn, rhat, rvar, lo=-30.0, hi=30.0, n=400001):
    x = np.linspace(lo, hi, n)
    logp = log_prior_fn(x) - 0.5 * (x - rhat) ** 2 / rvar
    logp -= logp.max()
    w = np.exp(logp)
    Z = np.trapezoid(w, x)
    mean = np.trapezoid(w * x, x) / Z
    ex2 = np.trapezoid(w * x**2, x) / Z
    return mean, ex2 - mean**2


def test_dirac_prior_point_mass():
    prior = DiracPrior(x0=1.5)
    xhat, xvar = prior.estim(jnp.asarray([0.2, 3.0]), jnp.asarray([0.5, 0.1]))
    assert np.allclose(np.asarray(xhat), 1.5)
    assert np.allclose(np.asarray(xvar), 0.0)


def test_null_prior_passthrough():
    xhat, xvar = NullPrior().estim(jnp.asarray(0.7), jnp.asarray(0.3))
    assert float(xhat) == pytest.approx(0.7)
    assert float(xvar) == pytest.approx(0.3)


@pytest.mark.parametrize("rhat,rvar", [(0.9, 0.4), (-2.5, 0.2), (0.05, 1.0)])
def test_elastic_net_prox(rhat, rvar):
    lam1, lam2 = 0.8, 0.5
    xhat, _ = ElasticNetPrior(lam1=lam1, lam2=lam2).estim(
        jnp.asarray(rhat), jnp.asarray(rvar)
    )
    # argmin lam1|x| + lam2/2 x^2 + (x-r)^2/(2 rvar), dense grid oracle
    x = np.linspace(-10, 10, 2000001)
    cost = lam1 * np.abs(x) + 0.5 * lam2 * x**2 + 0.5 * (x - rhat) ** 2 / rvar
    assert abs(float(xhat) - x[np.argmin(cost)]) < 2e-5


@pytest.mark.parametrize("rhat,rvar,lam", [(0.5, 0.3, 1.0), (-1.0, 0.2, 2.0), (3.0, 1.5, 0.3)])
def test_nn_softthresh_matches_quadrature(rhat, rvar, lam):
    xhat, xvar = NNSoftThreshPrior(lam=lam).estim(
        jnp.asarray(rhat), jnp.asarray(rvar)
    )
    m, v = _numeric_posterior(
        lambda x: np.where(x >= 0, -lam * x, -np.inf), rhat, rvar, lo=0.0, hi=40.0
    )
    assert abs(float(xhat) - m) < 1e-4
    assert abs(float(xvar) - v) < 1e-4


@pytest.mark.parametrize("rhat,rvar", [(0.4, 0.5), (-1.2, 0.1)])
def test_mix_prior_matches_quadrature(rhat, rvar):
    # mixture of two real Gaussians with distinct means
    pa, pb, w = AwgnPrior(mean0=-1.0, var0=0.5), AwgnPrior(mean0=2.0, var0=0.2), 0.3
    xhat, xvar = MixPrior(pa, pb, w=w).estim(jnp.asarray(rhat), jnp.asarray(rvar))

    def logp(x):
        la = -0.5 * (x + 1.0) ** 2 / 0.5 - 0.5 * np.log(0.5)
        lb = -0.5 * (x - 2.0) ** 2 / 0.2 - 0.5 * np.log(0.2)
        return np.logaddexp(np.log(w) + la, np.log(1 - w) + lb)

    m, v = _numeric_posterior(logp, rhat, rvar)
    assert abs(float(xhat) - m) < 1e-4
    assert abs(float(xvar) - v) < 1e-4


def test_concat_prior_blocks():
    prior = ConcatPrior(
        priors=(DiracPrior(x0=2.0), NullPrior()), sizes=(2, 3)
    )
    rhat = jnp.arange(5.0)
    rvar = jnp.full((5,), 0.4)
    xhat, xvar = prior.estim(rhat, rvar)
    assert np.allclose(np.asarray(xhat[:2]), 2.0)
    assert np.allclose(np.asarray(xhat[2:]), np.arange(2.0, 5.0))
    assert np.allclose(np.asarray(xvar[2:]), 0.4)


def test_dirac_likelihood():
    zhat, zvar = DiracLikelihood(y=jnp.asarray(1.0)).estim(
        jnp.asarray(0.3), jnp.asarray(0.5)
    )
    assert float(zhat) == pytest.approx(1.0)
    assert float(zvar) == pytest.approx(0.0)


def test_masked_likelihood_passthrough_on_unobserved():
    y = jnp.asarray([1.0 + 0j, -1.0 + 0j])
    base = CAwgnLikelihood(y=y, wvar=jnp.asarray(0.1))
    like = MaskedLikelihood(base=base, mask=jnp.asarray([1.0, 0.0]))
    phat = jnp.asarray([0.2 + 0j, 0.4 + 0j])
    pvar = jnp.asarray([0.5, 0.5])
    zhat, zvar = like.estim(phat, pvar)
    zb, vb = base.estim(phat, pvar)
    assert np.allclose(np.asarray(zhat[0]), np.asarray(zb[0]))
    assert float(jnp.real(zhat[1])) == pytest.approx(0.4)
    assert float(zvar[1]) == pytest.approx(0.5)


def test_gaussmix_likelihood_reduces_to_outlier():
    key_vals = np.array([0.8 + 0.1j, -0.3 - 0.5j])
    y = jnp.asarray(key_vals)
    phat = jnp.asarray([0.5 + 0j, -0.2 - 0.3j])
    pvar = jnp.asarray([0.3, 0.7])
    lam, wv, wv_out = 0.1, 0.05, 5.0
    gm = GaussMixLikelihood(
        y=y,
        weights=jnp.asarray([1 - lam, lam]),
        variances=jnp.asarray([wv, wv_out]),
    )
    ol = OutlierLikelihood(y=y, wvar=wv, wvar_out=wv_out, lam=lam)
    z1, v1 = gm.estim(phat, pvar)
    z2, v2 = ol.estim(phat, pvar)
    assert np.allclose(np.asarray(z1), np.asarray(z2), atol=1e-6)
    assert np.allclose(np.asarray(v1), np.asarray(v2), atol=1e-6)


@pytest.mark.parametrize("y,phat,pvar", [(0.9, 0.5, 0.3), (-0.4, -0.1, 1.2)])
def test_gaussmix_likelihood_real_matches_quadrature(y, phat, pvar):
    w = np.array([0.6, 0.4])
    vs = np.array([0.2, 2.0])
    like = GaussMixLikelihood(
        y=jnp.asarray(y), weights=jnp.asarray(w), variances=jnp.asarray(vs)
    )
    zhat, zvar = like.estim(jnp.asarray(phat), jnp.asarray(pvar))

    def loglike(z):
        comps = [
            np.log(wk) - 0.5 * (y - z) ** 2 / vk - 0.5 * np.log(vk)
            for wk, vk in zip(w, vs)
        ]
        return np.logaddexp(*comps)

    m, v = _numeric_posterior(loglike, phat, pvar)
    assert abs(float(zhat) - m) < 1e-4
    assert abs(float(zvar) - v) < 1e-4


def test_cmult_awgn_posterior():
    # y = c z + w; with pvar→∞ posterior mean → y/c
    c = jnp.asarray(2.0 - 1.0j)
    y = jnp.asarray(1.0 + 1.0j)
    zhat, zvar = CMultAwgnLikelihood(y=y, c=c, wvar=jnp.asarray(1e-6)).estim(
        jnp.asarray(0.0 + 0j), jnp.asarray(1e6)
    )
    assert np.allclose(np.asarray(zhat), np.asarray(y / c), atol=1e-4)
    # Gaussian×Gaussian precision algebra at finite values
    phat, pvar, wvar = jnp.asarray(0.3 + 0.2j), jnp.asarray(0.5), jnp.asarray(0.1)
    zhat, zvar = CMultAwgnLikelihood(y=y, c=c, wvar=wvar).estim(phat, pvar)
    prec = 1 / 0.5 + abs(2.0 - 1.0j) ** 2 / 0.1
    want = (phat / pvar + jnp.conj(c) * y / wvar) / prec
    assert np.allclose(np.asarray(zhat), np.asarray(want), atol=1e-6)
    assert float(zvar) == pytest.approx(1 / prec, rel=1e-5)


@pytest.mark.parametrize("y,phat,pvar", [(1.0, 0.2, 0.5), (0.0, 0.8, 0.2)])
def test_hinge_likelihood_matches_quadrature(y, phat, pvar):
    zhat, zvar = HingeLikelihood(y=jnp.asarray(y), scale=2.0).estim(
        jnp.asarray(phat), jnp.asarray(pvar)
    )
    s = 2.0 * y - 1.0
    m, v = _numeric_posterior(
        lambda z: -2.0 * np.maximum(0.0, 1.0 - s * z), phat, pvar
    )
    assert abs(float(zhat) - m) < 1e-4
    assert abs(float(zvar) - v) < 1e-4


def test_concat_likelihood_blocks():
    like = ConcatLikelihood(
        likes=(DiracLikelihood(y=jnp.asarray([2.0])),
               CAwgnLikelihood(y=jnp.asarray([0.0 + 0j, 0.0 + 0j]), wvar=1e12)),
        sizes=(1, 2),
    )
    phat = jnp.asarray([0.1 + 0j, 0.5 + 0j, -0.5 + 0j])
    pvar = jnp.asarray([0.2, 0.3, 0.3])
    zhat, zvar = like.estim(phat, pvar)
    assert float(jnp.real(zhat[0])) == pytest.approx(2.0)
    # near-infinite noise → posterior ≈ prior message
    assert np.allclose(np.asarray(jnp.real(zhat[1:])), [0.5, -0.5], atol=1e-6)
    assert np.allclose(np.asarray(zvar[1:]), 0.3, atol=1e-6)
