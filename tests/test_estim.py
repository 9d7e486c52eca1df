"""Posterior-moment unit tests for the estimator tree.

Oracle: dense 1-D (or 2-D for complex) numerical integration of the exact
posterior  p(x|r) ∝ prior(x)·N(r; x, rvar)  (resp.  p(z|y) ∝ N(z; p, pvar)·
p(y|z)) — the same strategy as the reference's ``test/testLaplaceEstimOut.m``
/ ``testUnifEstimIn.m`` family.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.solvers.estim import (
    DiscretePrior,
    EllpPrior,
    GroupSparsePrior,
    CAwgnPrior,
    LaplaceLikelihood,
    LaplacePrior,
    LogitLikelihood,
    MagnitudeLikelihood,
    NNGMPrior,
    QuantizedLikelihood,
    SNIPEPrior,
    SparsePrior,
    UnifPrior,
)


def _numeric_posterior(log_prior_fn, rhat, rvar, lo=-30.0, hi=30.0, n=400001):
    """Quadrature moments of p(x) ∝ exp(log_prior(x))·N(rhat; x, rvar)."""
    x = np.linspace(lo, hi, n)
    logp = log_prior_fn(x) - 0.5 * (x - rhat) ** 2 / rvar
    logp -= logp.max()
    w = np.exp(logp)
    Z = np.trapezoid(w, x)
    mean = np.trapezoid(w * x, x) / Z
    ex2 = np.trapezoid(w * x**2, x) / Z
    return mean, ex2 - mean**2


@pytest.mark.parametrize("rhat,rvar,lam", [(0.3, 0.5, 1.0), (-2.0, 0.1, 3.0), (5.0, 2.0, 0.5)])
def test_laplace_prior_matches_quadrature(rhat, rvar, lam):
    prior = LaplacePrior(lam=lam)
    xhat, xvar = prior.estim(jnp.asarray(rhat), jnp.asarray(rvar))
    m, v = _numeric_posterior(lambda x: -lam * np.abs(x), rhat, rvar)
    assert abs(float(xhat) - m) < 1e-4
    assert abs(float(xvar) - v) < 1e-4


@pytest.mark.parametrize("rhat,rvar", [(0.2, 0.3), (-1.5, 0.05), (2.0, 4.0)])
def test_unif_prior_matches_quadrature(rhat, rvar):
    prior = UnifPrior(lo=-1.0, hi=1.0)
    xhat, xvar = prior.estim(jnp.asarray(rhat), jnp.asarray(rvar))
    m, v = _numeric_posterior(
        lambda x: np.where(np.abs(x) <= 1.0, 0.0, -np.inf), rhat, rvar,
        lo=-1.0, hi=1.0,
    )
    assert abs(float(xhat) - m) < 1e-4
    assert abs(float(xvar) - v) < 1e-4


def test_unif_prior_extreme_truncation_finite():
    xhat, xvar = UnifPrior(0.0, 1.0).estim(jnp.asarray(50.0), jnp.asarray(0.01))
    assert np.isfinite(float(xhat)) and np.isfinite(float(xvar))
    assert 0.0 <= float(xhat) <= 1.0


@pytest.mark.parametrize("rhat,rvar", [(0.5, 0.2), (-0.5, 0.5), (3.0, 1.0)])
def test_nngm_prior_matches_quadrature(rhat, rvar):
    w = np.array([0.6, 0.4])
    mu = np.array([0.5, 2.0])
    var = np.array([0.25, 1.0])
    prior = NNGMPrior(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))

    def log_prior(x):
        comp = (
            w
            / np.sqrt(2 * np.pi * var)
            * np.exp(-0.5 * (x[:, None] - mu) ** 2 / var)
        )
        # renormalize each component to x >= 0 (truncated-Gaussian mixture)
        from scipy.stats import norm

        mass = norm.cdf(mu / np.sqrt(var))
        dens = (comp / mass).sum(axis=1)
        return np.where(x >= 0, np.log(np.maximum(dens, 1e-300)), -np.inf)

    xhat, xvar = prior.estim(jnp.asarray(rhat), jnp.asarray(rvar))
    m, v = _numeric_posterior(log_prior, rhat, rvar, lo=0.0, hi=40.0)
    assert abs(float(xhat) - m) < 2e-4
    assert abs(float(xvar) - v) < 2e-4


def test_nngm_spike_slab_activity():
    prior = NNGMPrior(
        jnp.asarray([1.0]), jnp.asarray([1.0]), jnp.asarray([1.0]), p1=0.1
    )
    # strong evidence near zero → posterior mean ≈ 0
    xhat0, _ = prior.estim(jnp.asarray(0.0), jnp.asarray(0.01))
    # strong positive evidence → posterior follows the slab
    xhat1, _ = prior.estim(jnp.asarray(3.0), jnp.asarray(0.01))
    assert float(xhat0) < 0.05
    assert abs(float(xhat1) - 3.0) < 0.2


def test_snipe_prior_limits():
    p = SNIPEPrior(omega=2.0)
    xhat_small, _ = p.estim(jnp.asarray(0.01), jnp.asarray(1.0))
    xhat_big, _ = p.estim(jnp.asarray(20.0), jnp.asarray(1.0))
    assert abs(float(xhat_small)) < 0.01  # shrunk to ~0
    assert abs(float(xhat_big) - 20.0) < 1e-3  # passed through
    # complex input uses circular convention
    zh, zv = p.estim(jnp.asarray(3.0 + 4.0j), jnp.asarray(1.0))
    assert abs(complex(zh) - (3 + 4j)) < 1e-3
    assert float(zv) >= 0


def test_ellp_prior_p1_is_soft_threshold():
    p = EllpPrior(lam=2.0, p=1.0)
    xhat, _ = p.estim(jnp.asarray(3.0), jnp.asarray(0.5))
    assert abs(float(xhat) - (3.0 - 2.0 * 0.5)) < 1e-6
    xhat0, _ = p.estim(jnp.asarray(0.5), jnp.asarray(0.5))
    assert float(xhat0) == 0.0
    # p<1 shrinks large entries less than p=1 does
    xp = EllpPrior(lam=2.0, p=0.5)
    xh_half, _ = xp.estim(jnp.asarray(3.0), jnp.asarray(0.5))
    assert float(xh_half) > float(xhat)


def test_discrete_prior_qpsk():
    atoms = jnp.asarray([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2)
    prior = DiscretePrior(atoms, jnp.full((4,), 0.25))
    # low noise → snaps to nearest atom with tiny variance
    xhat, xvar = prior.estim(jnp.asarray(0.6 + 0.8j), jnp.asarray(0.01))
    assert abs(complex(xhat) - complex(atoms[0])) < 1e-3
    assert float(xvar) < 1e-3
    # symmetric input → zero-mean posterior, variance ≈ prior variance
    xhat0, xvar0 = prior.estim(jnp.asarray(0.0 + 0.0j), jnp.asarray(10.0))
    assert abs(complex(xhat0)) < 1e-6
    assert abs(float(xvar0) - 1.0) < 1e-3


def test_group_sparse_prior_pools_evidence():
    base = CAwgnPrior(0.0 + 0j, 1.0)
    gp = GroupSparsePrior(base, p1=0.2)
    sp = SparsePrior(base, p1=0.2)
    rvar = jnp.full((4,), 0.05)
    # one strong element in the group activates the WHOLE group
    r = jnp.asarray([2.0 + 0j, 0.05, 0.05, 0.05])
    xg, _ = gp.estim(r, rvar)
    xs, _ = sp.estim(r, rvar)
    # element-wise prior suppresses the weak entries; group prior keeps them
    assert float(jnp.abs(xg[1])) > 5 * float(jnp.abs(xs[1]))


def test_logit_likelihood_moves_toward_label():
    lik = LogitLikelihood(y=jnp.asarray([1.0, 0.0]), scale=2.0)
    zhat, zvar = lik.estim(jnp.zeros(2), jnp.ones(2))
    assert float(zhat[0]) > 0.1 and float(zhat[1]) < -0.1
    assert float(zhat[0]) == pytest.approx(-float(zhat[1]), abs=1e-5)
    assert (zvar < 1.0).all()  # observation reduces uncertainty


def test_logit_likelihood_matches_quadrature():
    lik = LogitLikelihood(y=jnp.asarray(1.0), scale=1.0)
    phat, pvar = 0.5, 2.0
    zhat, zvar = lik.estim(jnp.asarray(phat), jnp.asarray(pvar))
    m, v = _numeric_posterior(
        lambda z: -np.logaddexp(0.0, -z), phat, pvar
    )
    assert abs(float(zhat) - m) < 1e-3
    assert abs(float(zvar) - v) < 1e-3


@pytest.mark.parametrize("y,phat,pvar,lam", [(0.5, 0.0, 1.0, 1.0), (-2.0, 1.0, 0.3, 2.0)])
def test_laplace_likelihood_matches_quadrature(y, phat, pvar, lam):
    lik = LaplaceLikelihood(y=jnp.asarray(y), lam=lam)
    zhat, zvar = lik.estim(jnp.asarray(phat), jnp.asarray(pvar))
    m, v = _numeric_posterior(lambda z: -lam * np.abs(y - z), phat, pvar)
    assert abs(float(zhat) - m) < 1e-4
    assert abs(float(zvar) - v) < 1e-4


def test_magnitude_likelihood_matches_2d_quadrature():
    # z ~ CN(p, pvar), y = |z + w|, w ~ CN(0, wvar): integrate over the plane
    p, pvar, wvar, y = 1.0 + 0.5j, 0.8, 0.2, 1.5
    lik = MagnitudeLikelihood(y=jnp.asarray(y), wvar=wvar)
    zhat, zvar = lik.estim(jnp.asarray(p), jnp.asarray(pvar))

    g = np.linspace(-6, 6, 601)
    zr, zi = np.meshgrid(g + p.real, g + p.imag, indexing="ij")
    z = zr + 1j * zi
    # Rician density of y given |z|
    from scipy.special import ive

    s2 = wvar / 2.0  # per-component noise variance
    rice = (
        y
        / s2
        * np.exp(-((y - np.abs(z)) ** 2) / (2 * s2))
        * ive(0, y * np.abs(z) / s2)
    )
    prior = np.exp(-np.abs(z - p) ** 2 / pvar)
    post = rice * prior
    Z = post.sum()
    m = (post * z).sum() / Z
    ez2 = (post * np.abs(z) ** 2).sum() / Z
    v = ez2 - abs(m) ** 2
    assert abs(complex(zhat) - m) < 0.02
    assert abs(float(zvar) - v) < 0.02


def test_magnitude_likelihood_zero_phat_safe():
    lik = MagnitudeLikelihood(y=jnp.asarray(2.0), wvar=0.1)
    zhat, zvar = lik.estim(jnp.asarray(0.0 + 0.0j), jnp.asarray(1.0))
    assert np.isfinite(complex(zhat).real) and np.isfinite(float(zvar))
    assert abs(complex(zhat)) < 1e-6  # symmetric posterior


def test_quantized_likelihood_refactor_still_correct():
    lik = QuantizedLikelihood(lo=jnp.asarray(-0.5), hi=jnp.asarray(0.5))
    zhat, zvar = lik.estim(jnp.asarray(0.3), jnp.asarray(1.0))
    m, v = _numeric_posterior(
        lambda z: np.where(np.abs(z) <= 0.5, 0.0, -np.inf), 0.3, 1.0,
        lo=-0.5, hi=0.5,
    )
    assert abs(float(zhat) - m) < 1e-4
    assert abs(float(zvar) - v) < 1e-4
