"""Round-4 estimator additions: the AWBGN delta-spike + Gaussian noise
likelihood (``main/AwbgnEstimOut.m``) — closed-form posterior moments
checked against mixed analytic/numeric quadrature (the delta component is
integrated analytically; the Gaussian component on a dense grid)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.solvers.estim import AwbgnLikelihood, CAwgnLikelihood


def _awbgn_moments_oracle(y, wvar, lam, phat, pvar):
    """Posterior moments of z ~ N(phat, pvar) through
    p(y|z) = (1−λ)δ(z−y) + λN(z; y, wvar), by mixture quadrature."""
    # clean component: point mass at z=y, evidence (1−λ)·N(y; phat, pvar)
    ev0 = (1 - lam) * np.exp(-0.5 * (y - phat) ** 2 / pvar) / np.sqrt(
        2 * np.pi * pvar
    )
    # noisy component: numeric quadrature over z
    sd = np.sqrt(pvar + wvar)
    z = np.linspace(
        min(phat, y) - 12 * sd, max(phat, y) + 12 * sd, 400_001
    )
    w = (
        lam
        * np.exp(-0.5 * (z - phat) ** 2 / pvar)
        / np.sqrt(2 * np.pi * pvar)
        * np.exp(-0.5 * (z - y) ** 2 / wvar)
        / np.sqrt(2 * np.pi * wvar)
    )
    dz = z[1] - z[0]
    ev1 = np.trapezoid(w, dx=dz)
    m1 = ev0 * y + np.trapezoid(w * z, dx=dz)
    m2 = ev0 * y**2 + np.trapezoid(w * z**2, dx=dz)
    Z = ev0 + ev1
    zhat = m1 / Z
    return zhat, m2 / Z - zhat**2


@pytest.mark.parametrize(
    "y,wvar,lam,phat,pvar",
    [
        (1.0, 0.5, 0.2, 0.9, 0.1),
        (2.0, 0.5, 0.2, 3.0, 0.1),
        (-1.5, 2.0, 0.05, 0.0, 1.0),
        (0.3, 0.01, 0.9, 0.35, 0.4),
        (5.0, 1.0, 0.5, -1.0, 0.2),
    ],
)
def test_awbgn_moments_match_quadrature(y, wvar, lam, phat, pvar):
    lk = AwbgnLikelihood(
        y=jnp.asarray(y), wvar=jnp.asarray(wvar), lam=jnp.asarray(lam)
    )
    zhat, zvar = lk.estim(jnp.asarray(phat), jnp.asarray(pvar))
    zr, vr = _awbgn_moments_oracle(y, wvar, lam, phat, pvar)
    assert abs(float(zhat) - zr) < 1e-5 * max(1.0, abs(zr))
    assert abs(float(zvar) - vr) < 1e-5 * max(1.0, vr)


def test_awbgn_lam_to_one_reduces_to_awgn():
    """λ→1: every measurement is noisy — the posterior must equal the plain
    AWGN channel's (the reference's stated default, AwbgnEstimOut.m:13-14)."""
    y = jnp.asarray([0.7, -1.2, 3.0])
    phat = jnp.asarray([0.5, -1.0, 2.0])
    pvar = jnp.asarray([0.2, 0.4, 0.1])
    wvar = jnp.asarray(0.5)
    lk = AwbgnLikelihood(y=y, wvar=wvar, lam=jnp.asarray(1 - 1e-12))
    awgn = CAwgnLikelihood(y=y, wvar=wvar)
    z0, v0 = lk.estim(phat, pvar)
    z1, v1 = awgn.estim(phat, pvar)
    np.testing.assert_allclose(np.asarray(z0), np.asarray(z1), atol=1e-5)
    np.testing.assert_allclose(np.asarray(v0), np.asarray(v1), atol=1e-5)


def test_awbgn_clean_measurement_sticks():
    """A measurement exactly consistent with the prior and small λ: the
    posterior should sit (almost) exactly on y with near-zero variance."""
    lk = AwbgnLikelihood(
        y=jnp.asarray(1.0), wvar=jnp.asarray(1.0), lam=jnp.asarray(0.01)
    )
    zhat, zvar = lk.estim(jnp.asarray(1.0), jnp.asarray(0.05))
    assert abs(float(zhat) - 1.0) < 5e-3
    assert float(zvar) < 5e-3


def test_awbgn_gamp_impulsive_recovery():
    """End-to-end: sparse-signal recovery through an impulsive (AWBGN)
    channel — the delta-spike-aware likelihood must beat the naive AWGN
    likelihood mismatched to the impulse variance."""
    from jstsp19.ops import MatrixOp
    from jstsp19.solvers.estim import AwgnPrior, SparsePrior
    from jstsp19.solvers.gamp_full import GampOptions, gamp_est

    rng = np.random.default_rng(0)
    n, m, k = 200, 120, 12
    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(m), jnp.float32)
    x_np = np.zeros(n)
    x_np[rng.choice(n, k, False)] = rng.standard_normal(k)
    x = jnp.asarray(x_np, jnp.float32)
    lam, wvar = 0.1, 4.0
    mask = rng.uniform(size=m) < lam
    y = A @ x + jnp.asarray(
        mask * (np.sqrt(wvar) * rng.standard_normal(m)), jnp.float32
    )

    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=k / n)
    # near-deterministic channel (90% of measurements noiseless): the
    # posterior variance collapses toward 0, which makes f32 GAMP dynamics
    # knife-edge without a precision floor — pvar_min (the reference's
    # GampOpt pvarMin) restores robust convergence.
    # adapt_step off: AwbgnEstimOut.m's own warning — its lower-bound cost
    # "may return incorrect cost when using adaptive step size" — became
    # operative once round 5 made the acceptance window live from
    # iteration 2 (reference-faithful); the inexact cost then rejects
    # every step and the run stalls at the init, in MATLAB as here.
    opts = GampOptions(nit=80, pvar_min=1e-6, adapt_step=False)
    fin_awbgn, _, _ = gamp_est(
        prior,
        AwbgnLikelihood(y=y, wvar=jnp.asarray(wvar), lam=jnp.asarray(lam)),
        MatrixOp(A), opts,
    )
    fin_awgn, _, _ = gamp_est(
        prior, CAwgnLikelihood(y=y, wvar=jnp.asarray(lam * wvar)),
        MatrixOp(A), opts,
    )
    err_awbgn = float(jnp.sum(jnp.abs(fin_awbgn.xhat - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    err_awgn = float(jnp.sum(jnp.abs(fin_awgn.xhat - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert err_awbgn < 0.05
    assert err_awbgn < 0.5 * err_awgn


# ---------------------------------------------------------------------------
# round 5: _tn_moments f32 stability cluster (shared primitive fixes)
# ---------------------------------------------------------------------------

def test_tn_moments_flat_prior_limit_is_uniform():
    """Finite-interval moments at pvar >> width^2 (e.g. VAMP-GLM's
    GAM_MIN=1e-11 init): the shared pvar cap must return the uniform-cell
    moments instead of cancelling to zhat=0 / zvar garbage."""
    from jstsp19.solvers.estim import QuantizedLikelihood

    lo, hi = 0.0, 0.01
    like = QuantizedLikelihood(lo=jnp.asarray(lo), hi=jnp.asarray(hi))
    zhat, zvar = like.estim(jnp.asarray(0.005), jnp.asarray(1e11))
    np.testing.assert_allclose(float(zhat), 0.005, atol=1e-5)
    np.testing.assert_allclose(float(zvar), (hi - lo) ** 2 / 12, rtol=0.05)


def test_unif_prior_large_rvar_finite():
    """UnifPrior at huge rvar previously returned (nan, nan) — both
    normalized edges collapsed to the same f32 logcdf value."""
    from jstsp19.solvers.estim import UnifPrior

    p = UnifPrior(0.0, 0.01)
    for rvar in (1e11, 1e16):
        xhat, xvar = p.estim(jnp.asarray(0.5), jnp.asarray(rvar))
        assert np.isfinite(float(xhat)) and np.isfinite(float(xvar)), rvar
        # rhat sits 50 cell-widths outside: the capped-pvar posterior is
        # slightly edge-skewed (~8% of the cell) — the guard trades that
        # bias for finiteness; the estimate must stay inside the cell
        np.testing.assert_allclose(float(xhat), 0.005, atol=1e-3)


def test_log_ndiff_degenerate_interval_finite():
    """log1mexp branch: exp(d) rounds to 1.0 below f32 eps, so the old
    min(d, -1e-20) clamp produced -inf and downstream NaNs."""
    from jstsp19.solvers.estim import _log_ndiff

    v = float(_log_ndiff(jnp.asarray(0.1), jnp.asarray(0.1)))
    assert np.isfinite(v) and v < -20.0  # tiny mass, finite log


def test_ellp_dmm_p_below_one_zero_entries_finite():
    """p < 1 made mag**(p-2) overflow at the 1e-30 clamp; inf * inactive
    gave NaN xvar on the standard all-zero init."""
    from jstsp19.solvers.estim import EllpDMMPrior

    xhat, xvar = EllpDMMPrior(alpha=1.5, p=0.5).estim(
        jnp.asarray([0.0, 1.0]), jnp.asarray([0.01, 0.01])
    )
    assert bool(jnp.all(jnp.isfinite(xhat)))
    assert bool(jnp.all(jnp.isfinite(xvar)))


def test_svt_nan_resets_whole_matrix():
    """svt.m's `if(~isnan(softThres))` is a MATRIX condition: any
    non-finite input entry maps the whole (batch element's) matrix to
    zeros — not just the offending entry."""
    from jstsp19.ops.jacobi import svt_jacobi
    from jstsp19.solvers.lowrank import svt

    rng = np.random.default_rng(0)
    Y = jnp.asarray(
        rng.standard_normal((6, 8)) + 1j * rng.standard_normal((6, 8)),
        jnp.complex64,
    )
    Y_bad = Y.at[2, 3].set(jnp.nan)
    for fn in (svt, svt_jacobi):
        out = fn(Y_bad, 0.1)
        np.testing.assert_array_equal(np.asarray(out), 0.0)
        assert float(jnp.linalg.norm(fn(Y, 0.1))) > 0  # clean input unaffected
