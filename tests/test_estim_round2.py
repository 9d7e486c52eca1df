"""Round-2 estimator additions: BGZeroMean fast path, DMM thresholders,
black-box (D-AMP) denoiser prior, MultiSNIPE, the L1 output prox, the
general-nonlinear quadrature channel, CAwgn noise autotuning, and max-sum
(``estim_map``) branches — quadrature-oracle strategy as in test_estim.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.solvers.estim import (
    AwgnPrior,
    BGZeroMeanPrior,
    CAwgnLikelihood,
    CAwgnPrior,
    EllpDMMPrior,
    FxnhandlePrior,
    L1Likelihood,
    LaplacePrior,
    MultiSNIPEPrior,
    NLLikelihood,
    SoftThreshDMMPrior,
    SoftThreshPrior,
    SparsePrior,
    UnifPrior,
)


# --- BGZeroMeanPrior: must equal the generic SparsePrior(AwgnPrior) ---

@pytest.mark.parametrize("rhat,rvar", [(0.3, 0.5), (-2.0, 0.1), (4.0, 2.0)])
def test_bg_zero_mean_matches_generic_spike_slab(rhat, rvar):
    var0, p1 = 0.8, 0.15
    fast = BGZeroMeanPrior(var0=var0, p1=p1)
    generic = SparsePrior(base=AwgnPrior(mean0=0.0, var0=var0), p1=p1)
    xf, vf = fast.estim(jnp.asarray(rhat), jnp.asarray(rvar))
    xg, vg = generic.estim(jnp.asarray(rhat), jnp.asarray(rvar))
    assert abs(float(xf) - float(xg)) < 1e-5
    assert abs(float(vf) - float(vg)) < 1e-5
    # KL values agree too (BGZeroMeanEstimIn.m:70-84 vs SparseScaEstim.m)
    kf = fast.val_neg_kl(jnp.asarray(rhat), jnp.asarray(rvar), xf, vf)
    kg = generic.val_neg_kl(jnp.asarray(rhat), jnp.asarray(rvar), xg, vg)
    assert abs(float(kf) - float(kg)) < 1e-4


# --- DMM thresholders ---

def test_softthresh_dmm_thresholds_at_alpha_sqrt_mean_rvar():
    r = jnp.asarray([0.1, -0.5, 2.0, -3.0], jnp.float32)
    rv = jnp.full((4,), 0.25, jnp.float32)
    p = SoftThreshDMMPrior(alpha=2.0)  # thresh = 2*sqrt(0.25) = 1
    xhat, xvar = p.estim(r, rv)
    np.testing.assert_allclose(np.asarray(xhat), [0.0, 0.0, 1.0, -2.0], atol=1e-6)
    # variance = rvar * mean(active) = 0.25 * 0.5
    np.testing.assert_allclose(np.asarray(xvar), 0.125, rtol=1e-5)


def test_ellp_dmm_p1_reduces_to_soft_threshold():
    r = jnp.asarray([0.1, -0.5, 2.0, -3.0], jnp.float32)
    rv = jnp.full((4,), 0.25, jnp.float32)
    x1, _ = EllpDMMPrior(alpha=2.0, p=1.0).estim(r, rv)
    np.testing.assert_allclose(np.asarray(x1), [0.0, 0.0, 1.0, -2.0], atol=1e-5)
    # p<1 shrinks large entries less than p=1 does
    xp, _ = EllpDMMPrior(alpha=2.0, p=0.5).estim(r, rv)
    assert abs(float(xp[3])) > abs(float(x1[3]))


# --- FxnhandlePrior (D-AMP wrapper) ---

def test_fxnhandle_prior_divergence_matches_linear_denoiser():
    """For a linear denoiser x = g*r the MC divergence is exactly g, so
    xvar = g*rvar (FxnhandleEstimIn.m:49-80)."""
    g = 0.37
    prior = FxnhandlePrior(
        key=jax.random.PRNGKey(0), denoise=lambda r, rv: g * r, n_avg=2
    )
    r = jax.random.normal(jax.random.PRNGKey(1), (64,))
    xhat, xvar = prior.estim(r, jnp.full((64,), 0.5))
    np.testing.assert_allclose(np.asarray(xhat), g * np.asarray(r), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(xvar), g * 0.5, rtol=1e-3)


def test_fxnhandle_prior_clips_divergence():
    prior = FxnhandlePrior(
        key=jax.random.PRNGKey(0), denoise=lambda r, rv: 5.0 * r
    )  # div=5 -> clipped to div_max
    _, xvar = prior.estim(jnp.ones((8,)), jnp.ones((8,)))
    assert float(xvar[0]) <= 1.0


# --- MultiSNIPE ---

def test_multisnipe_single_zero_theta_shrinks_small_entries():
    """theta={0} MultiSNIPE behaves like SNIPE: small |r| pulled to 0,
    large |r| passed through."""
    p = MultiSNIPEPrior(thetas=jnp.asarray([0.0]), omegas=jnp.asarray([4.0]))
    r = jnp.asarray([0.05, 8.0], jnp.float32)
    xhat, _ = p.estim(r, jnp.full((2,), 0.5))
    assert abs(float(xhat[0])) < 0.02
    assert abs(float(xhat[1]) - 8.0) < 0.2


def test_multisnipe_pulls_toward_nonzero_atoms():
    p = MultiSNIPEPrior(
        thetas=jnp.asarray([-1.0, 1.0]), omegas=jnp.asarray([5.0, 5.0])
    )
    xhat, _ = p.estim(jnp.asarray([0.9, -1.1]), jnp.full((2,), 0.3))
    assert abs(float(xhat[0]) - 1.0) < 0.1
    assert abs(float(xhat[1]) + 1.0) < 0.1


def test_multisnipe_xvar_big_gain():
    p_inf = MultiSNIPEPrior(thetas=jnp.asarray([0.0]), omegas=jnp.asarray([2.0]))
    p_fin = MultiSNIPEPrior(
        thetas=jnp.asarray([0.0]), omegas=jnp.asarray([2.0]), xvar_big=1.0
    )
    r = jnp.asarray([3.0])
    rv = jnp.asarray([1.0])
    x_inf, _ = p_inf.estim(r, rv)
    x_fin, _ = p_fin.estim(r, rv)
    np.testing.assert_allclose(float(x_fin[0]), float(x_inf[0]) * 0.5, rtol=1e-5)


# --- L1 output ---

def test_l1_likelihood_prox():
    like = L1Likelihood(scale=2.0)
    zhat, zvar = like.estim(jnp.asarray([0.5, 3.0, -4.0]), jnp.asarray([1.0, 1.0, 1.0]))
    np.testing.assert_allclose(np.asarray(zhat), [0.0, 1.0, -2.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(zvar), [0.0, 1.0, 1.0], atol=1e-6)


def test_l1_likelihood_autoscale_runs():
    like = L1Likelihood(scale=1.0, auto_scale=True)
    z = jax.random.normal(jax.random.PRNGKey(2), (32,)) * 3.0
    zhat, _ = like.estim(z, jnp.ones((32,)))
    assert np.isfinite(np.asarray(zhat)).all()


# --- NLLikelihood: reduces to the linear AWGN posterior for f(z)=z ---

@pytest.mark.parametrize("y,phat,pvar,wvar", [(0.7, 0.2, 0.5, 0.1), (-1.0, 0.5, 1.0, 0.5)])
def test_nl_likelihood_linear_matches_awgn(y, phat, pvar, wvar):
    like = NLLikelihood(
        y=jnp.asarray([y]), wvar=wvar, out_fn=lambda z: z, n_z=4001
    )
    zhat, zvar = like.estim(jnp.asarray([phat]), jnp.asarray([pvar]))
    gain = pvar / (pvar + wvar)
    z_ref = phat + gain * (y - phat)
    v_ref = pvar * wvar / (pvar + wvar)
    assert abs(float(zhat[0]) - z_ref) < 2e-3
    assert abs(float(zvar[0]) - v_ref) < 2e-3


def test_nl_likelihood_cubic_posterior_sane():
    """A monotone nonlinearity: posterior mean moves toward f^{-1}(y)."""
    like = NLLikelihood(
        y=jnp.asarray([8.0]), wvar=1e-2, out_fn=lambda z: z**3, n_z=2001
    )
    zhat, zvar = like.estim(jnp.asarray([1.5]), jnp.asarray([1.0]))
    assert abs(float(zhat[0]) - 2.0) < 0.1  # cbrt(8) = 2
    assert float(zvar[0]) < 0.1


# --- CAwgn tuning branches ---

def test_cawgn_tune_methods_recover_wvar():
    rng = np.random.default_rng(0)
    m = 4096
    wvar_true = 0.05
    z = (rng.standard_normal(m) + 1j * rng.standard_normal(m)) / np.sqrt(2)
    y = z + np.sqrt(wvar_true / 2) * (
        rng.standard_normal(m) + 1j * rng.standard_normal(m)
    )
    like = CAwgnLikelihood(y=jnp.asarray(y, jnp.complex64), wvar=1.0)
    # ML method from (phat≈z, pvar≈0)
    w_ml = float(like.tune_wvar_ml(jnp.asarray(z, jnp.complex64), jnp.zeros(m)))
    assert 0.7 * wvar_true < w_ml < 1.4 * wvar_true
    # EM method from posterior moments (zhat≈z, zvar≈0)
    w_em = float(like.tune_wvar_em(jnp.asarray(z, jnp.complex64), jnp.zeros(m)))
    assert 0.7 * wvar_true < w_em < 1.4 * wvar_true


# --- max-sum branches used standalone ---

@pytest.mark.parametrize("rhat,rvar", [(0.3, 0.5), (-2.0, 0.1)])
def test_gaussian_map_equals_mmse(rhat, rvar):
    p = CAwgnPrior(mean0=0.1 + 0.2j, var0=0.7)
    r = jnp.asarray(rhat + 0.3j)
    x_mmse, v_mmse = p.estim(r, jnp.asarray(rvar))
    x_map, v_map = p.estim_map(r, jnp.asarray(rvar))
    assert abs(complex(x_mmse) - complex(x_map)) < 1e-7
    assert abs(float(v_mmse) - float(v_map)) < 1e-7


def test_laplace_map_is_soft_threshold():
    p = LaplacePrior(lam=2.0)
    x, v = p.estim_map(jnp.asarray([0.3, 1.5]), jnp.asarray([0.5, 0.5]))
    np.testing.assert_allclose(np.asarray(x), [0.0, 0.5], atol=1e-6)
    np.testing.assert_allclose(np.asarray(v), [0.0, 0.5], atol=1e-6)


def test_unif_map_clips():
    p = UnifPrior(lo=-1.0, hi=1.0)
    x, v = p.estim_map(jnp.asarray([-3.0, 0.2, 4.0]), jnp.asarray([0.5, 0.5, 0.5]))
    np.testing.assert_allclose(np.asarray(x), [-1.0, 0.2, 1.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(v), [0.0, 0.5, 0.0], atol=1e-6)


def test_softthresh_val_map():
    p = SoftThreshPrior(lam=3.0)
    assert float(p.val_map(jnp.asarray(2.0))) == pytest.approx(-6.0)
