"""Tests for the full-capability GAMP core (``gamp_full.gamp_est``) and its
operator wrappers — the ``gampEst.m`` options matrix, warm-start exactness
(the ``test/warmStart`` contract), mean removal (``LinTransDemeanRC.m``),
uniform variance (``UnifVarLinTrans.m``), and function-handle operators
(``FxnhandleLinTrans.m``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.ops.base import MatrixOp
from jstsp19.ops.structured import UnifVarOp, demean_rc, fxnhandle_op
from jstsp19.solvers.estim import (
    AwgnPrior,
    CAwgnLikelihood,
    CAwgnPrior,
    SoftThreshPrior,
    SparsePrior,
)
from jstsp19.solvers.gamp_full import GampOptions, gamp_est


def _bg_problem(seed=0, n=128, m=64, k=8, wvar=1e-3, cplx=True, mean=0.0):
    rng = np.random.default_rng(seed)
    if cplx:
        A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(
            2 * m
        )
        x = np.zeros(n, complex)
        idx = rng.choice(n, k, False)
        x[idx] = (rng.standard_normal(k) + 1j * rng.standard_normal(k)) / np.sqrt(2)
        w = np.sqrt(wvar / 2) * (rng.standard_normal(m) + 1j * rng.standard_normal(m))
        dt = jnp.complex64
    else:
        A = rng.standard_normal((m, n)) / np.sqrt(m)
        x = np.zeros(n)
        idx = rng.choice(n, k, False)
        x[idx] = rng.standard_normal(k)
        w = np.sqrt(wvar) * rng.standard_normal(m)
        dt = jnp.float32
    A = A + mean
    y = A @ x + w
    op = MatrixOp(jnp.asarray(A, dt))
    base = CAwgnPrior(mean0=0.0, var0=1.0) if cplx else AwgnPrior(mean0=0.0, var0=1.0)
    prior = SparsePrior(base=base, p1=k / n)
    like = CAwgnLikelihood(y=jnp.asarray(y, dt), wvar=wvar)
    return prior, like, op, x


def _nmse(xhat, x):
    return float(np.sum(np.abs(np.asarray(xhat) - x) ** 2) / np.sum(np.abs(x) ** 2))


OPTIONS_MATRIX = [
    ("plain", GampOptions(nit=80, adapt_step=False, step=0.9)),
    ("adapt", GampOptions(nit=80)),
    ("adapt_bethe", GampOptions(nit=80, adapt_step_bethe=True)),
    ("remove_mean", GampOptions(nit=80, remove_mean=True)),
    ("uniform_variance", GampOptions(nit=80, uniform_variance=True)),
    ("dm_uv", GampOptions(nit=80, remove_mean=True, uniform_variance=True)),
    ("var_norm", GampOptions(nit=80, adapt_step=False, step=1.0, var_norm=True)),
    ("tune_wvar", GampOptions(nit=80, tune_wvar=True)),
    ("rvar_step", GampOptions(nit=80, rvar_step=True)),
    ("bb_step", GampOptions(nit=80, bb_step=True)),
]


@pytest.mark.parametrize("label,opts", OPTIONS_MATRIX, ids=[t[0] for t in OPTIONS_MATRIX])
def test_options_matrix_converges(label, opts):
    """Every gampEst.m option combination must solve the BG-CS testbed to
    near-genie NMSE (the estimTest.m-style harness)."""
    prior, like, op, x = _bg_problem()
    fin, st, _ = gamp_est(prior, like, op, opts)
    nmse_db = 10 * np.log10(_nmse(fin.xhat, x))
    assert nmse_db < -20.0, f"{label}: {nmse_db:.2f} dB"


def test_max_sum_lasso():
    """Max-sum (MAP) mode with a SoftThresh prior solves LASSO
    (``gampEst.m`` maxSum / ``SoftThreshEstimIn.m``)."""
    rng = np.random.default_rng(1)
    n, m, k = 256, 128, 16
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x = np.zeros(n)
    x[rng.choice(n, k, False)] = rng.standard_normal(k)
    y = A @ x + 0.01 * rng.standard_normal(m)
    op = MatrixOp(jnp.asarray(A, jnp.float32))
    like = CAwgnLikelihood(y=jnp.asarray(y, jnp.float32), wvar=1e-4)
    fin, _, _ = gamp_est(
        SoftThreshPrior(lam=2.0), like, op, GampOptions(nit=200, max_sum=True, step=0.5)
    )
    assert 10 * np.log10(_nmse(fin.xhat, x)) < -18.0


def test_warm_start_exact():
    """nit=15 then nit=25 resumed from state equals nit=40 straight,
    bit-exactly (the ``test/warmStart`` contract; ``estFin.*Next``)."""
    prior, like, op, _ = _bg_problem(seed=2)
    kw = dict(tol=-1.0, step_tol=-1.0)
    fin40, st40, _ = gamp_est(prior, like, op, GampOptions(nit=40, **kw))
    _, st15, _ = gamp_est(prior, like, op, GampOptions(nit=15, **kw))
    fin_res, st_res, _ = gamp_est(
        prior, like, op, GampOptions(nit=25, **kw), state_in=st15
    )
    np.testing.assert_array_equal(np.asarray(fin40.xhat), np.asarray(fin_res.xhat))
    np.testing.assert_array_equal(np.asarray(st40.shat), np.asarray(st_res.shat))
    np.testing.assert_array_equal(np.asarray(st40.step), np.asarray(st_res.step))


def test_mean_removal_rescues_mean_heavy_operator():
    """A +1 common offset on A breaks i.i.d.-style GAMP; removeMean fixes it
    (the purpose of ``LinTransDemeanRC.m``)."""
    prior, like, op, x = _bg_problem(seed=3, cplx=False, mean=1.0)
    fin_plain, _, _ = gamp_est(prior, like, op, GampOptions(nit=100))
    fin_dm, _, _ = gamp_est(prior, like, op, GampOptions(nit=100, remove_mean=True))
    # round 5: the reference-faithful acceptance window (live from
    # iteration 2) stabilizes even the plain run to a stall instead of a
    # divergence — the rescue claim is the >=20 dB gap, not a blowup
    nmse_plain = _nmse(fin_plain.xhat, x)
    nmse_dm = _nmse(fin_dm.xhat, x)
    assert nmse_plain > 100 * nmse_dm, (nmse_plain, nmse_dm)
    assert 10 * np.log10(nmse_dm) < -25.0


def test_tune_wvar_recovers_noise_level():
    """ML autotuning (``CAwgnEstimOut.m:117-131``) recovers the true noise
    variance from a 10x-wrong initialization."""
    prior, like, op, x = _bg_problem(seed=4, wvar=1e-2)
    like_wrong = CAwgnLikelihood(y=like.y, wvar=1e-1)
    fin, st, _ = gamp_est(
        prior, like_wrong, op, GampOptions(nit=100, tune_wvar=True)
    )
    wvar_hat = float(st.likelihood.wvar)
    assert 10 * np.log10(_nmse(fin.xhat, x)) < -15.0
    assert 0.3e-2 < wvar_hat < 3e-2, wvar_hat


def test_history_monotone_val_and_shapes():
    prior, like, op, _ = _bg_problem(seed=5)
    opts = GampOptions(nit=30, save_hist=True, tol=-1.0)
    _, _, hist = gamp_est(prior, like, op, opts)
    assert hist["xhat"].shape == (30, 128)
    assert hist["zhat"].shape == (30, 64)
    assert hist["val"].shape == (30,)
    # utilities of passed iterations should trend upward overall
    vals = np.asarray(hist["val"])[np.asarray(hist["passed"])]
    assert vals[-1] > vals[1]


# ---------------------------------------------------------------------------
# operator wrappers
# ---------------------------------------------------------------------------


def _explicit_demean_matrix(op):
    """Materialize the augmented (m+2)x(n+2) matrix from the wrapper's own
    mv on basis vectors (ground truth for the identity checks)."""
    d = demean_rc(op)
    n_aug = d.in_shape[0]
    cols = [np.asarray(d.mv(jnp.zeros((n_aug,)).at[j].set(1.0))) for j in range(n_aug)]
    return d, np.stack(cols, axis=1)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_demean_rc_identities(cplx):
    """DemeanRCOp mv/rmv/sq_mv/sq_rmv match the explicit augmented matrix
    (``LinTransDemeanRC.m:100-216``) and the demeaned core has zero
    row/column sums."""
    rng = np.random.default_rng(6)
    m, n = 12, 20
    A = rng.standard_normal((m, n)) + 3.0
    if cplx:
        A = A + 1j * rng.standard_normal((m, n))
    dt = jnp.complex64 if cplx else jnp.float32
    d, Ad = _explicit_demean_matrix(MatrixOp(jnp.asarray(A, dt)))
    ref = MatrixOp(jnp.asarray(Ad, dt))
    xd = jnp.asarray(
        rng.standard_normal(n + 2) + (1j * rng.standard_normal(n + 2) if cplx else 0),
        dt,
    )
    sd = jnp.asarray(
        rng.standard_normal(m + 2) + (1j * rng.standard_normal(m + 2) if cplx else 0),
        dt,
    )
    xv = jnp.asarray(rng.random(n + 2), jnp.float32)
    sv = jnp.asarray(rng.random(m + 2), jnp.float32)
    np.testing.assert_allclose(d.rmv(sd), ref.rmv(sd), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(d.sq_mv(xv), ref.sq_mv(xv), rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(d.sq_rmv(sv), ref.sq_rmv(sv), rtol=2e-3, atol=1e-3)
    # demeaned core: zero row/column sums (LinTransDemeanRC's purpose)
    core = Ad[:m, :n]
    np.testing.assert_allclose(core.sum(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(core.sum(1), 0.0, atol=1e-4)
    # the constraint identity Ad @ expand(x) = [A x; 0; 0]
    x = xd[:n]
    zd = d.mv(d.expand_xhat(x))
    np.testing.assert_allclose(
        np.asarray(zd[:m]), A @ np.asarray(x), rtol=2e-4, atol=1e-4
    )
    np.testing.assert_allclose(np.asarray(zd[m:]), 0.0, atol=1e-3)


def test_unifvar_op_averages_variances():
    rng = np.random.default_rng(7)
    A = jnp.asarray(rng.standard_normal((10, 16)), jnp.float32)
    op = UnifVarOp(MatrixOp(A))
    xv = jnp.asarray(rng.random(16), jnp.float32)
    out = op.sq_mv(xv)
    expect = jnp.full((10,), jnp.mean((jnp.abs(A) ** 2) @ jnp.full((16,), jnp.mean(xv))))
    np.testing.assert_allclose(out, expect, rtol=1e-5)
    # mv/rmv untouched
    x = jnp.asarray(rng.standard_normal(16), jnp.float32)
    np.testing.assert_allclose(op.mv(x), A @ x, rtol=1e-5)
    # partial averaging leaves the tail entries alone
    op2 = UnifVarOp(MatrixOp(A), in_avg=14, out_avg=8)
    out2 = op2.sq_mv(xv)
    assert not np.allclose(out2[8], out2[0])


def test_fxnhandle_op_probe_and_adjoint():
    rng = np.random.default_rng(8)
    A = rng.standard_normal((24, 40)) + 1j * rng.standard_normal((24, 40))
    Aj = jnp.asarray(A, jnp.complex64)
    op = fxnhandle_op(
        lambda v: Aj @ v,
        lambda u: Aj.conj().T @ u,
        (40,),
        (24,),
        key=jax.random.PRNGKey(3),
        n_probe=64,
    )
    x = jnp.asarray(rng.standard_normal(40), jnp.complex64)
    u = jnp.asarray(rng.standard_normal(24), jnp.complex64)
    # adjointness through the callables
    lhs = jnp.vdot(u, op.mv(x))
    rhs = jnp.vdot(op.rmv(u), x)
    np.testing.assert_allclose(complex(lhs), complex(rhs), rtol=1e-4)
    # probed Frobenius estimate within MC error of the truth
    fro2 = float(np.sum(np.abs(A) ** 2))
    assert 0.6 * fro2 < float(op.fro2) < 1.5 * fro2
    # rank-1 variance approximation integrates to fro2 * mean
    xv = jnp.ones((40,), jnp.float32)
    np.testing.assert_allclose(
        float(jnp.sum(op.sq_mv(xv))), float(op.fro2) * 40.0 / 40.0, rtol=1e-4
    )


def test_hist_intvl_decimates_histories():
    """``histIntvl`` (GampOpt.m:134-136): save every k-th iteration."""
    prior, like, op, x = _bg_problem()
    _, _, hist_full = gamp_est(prior, like, op, GampOptions(nit=40, save_hist=True))
    _, _, hist_dec = gamp_est(
        prior, like, op, GampOptions(nit=40, save_hist=True, hist_intvl=10)
    )
    assert hist_full["xhat"].shape[0] == 40
    assert hist_dec["xhat"].shape[0] == 4
    # decimated entries are iterations 10, 20, 30, 40 of the full history
    np.testing.assert_allclose(
        np.asarray(hist_dec["xhat"]), np.asarray(hist_full["xhat"][9::10]),
        atol=1e-6,
    )


def test_xvar0auto_from_good_point_estimate():
    """``xvar0auto`` (gampEst.m:292-330): with xhat0 = x0 the derived
    xvar0 is far below the prior variance, and GAMP still converges."""
    from jstsp19.solvers.gamp_full import _xvar0_auto

    prior, like, op, x = _bg_problem()
    opts = GampOptions(nit=50, xvar0auto=True)
    xvar0 = _xvar0_auto(prior, like, op, jnp.asarray(x, jnp.complex64), opts)
    prior_var = float(jnp.mean(jnp.abs(jnp.asarray(x)) ** 2))  # ~ k/n scale
    assert float(jnp.mean(xvar0)) < prior_var  # tighter than the energy scale
    assert float(jnp.mean(xvar0)) > 0.0
    estfin, _, _ = gamp_est(
        prior, like, op, opts, x_init=jnp.asarray(x, jnp.complex64)
    )
    assert _nmse(estfin.xhat, x) < 1e-2


def test_stop_fn_custom_criterion():
    """GampOpt.stopFcn/stopFcn2 analog: a jittable state -> bool callable
    freezes the iteration exactly like tol/stepTol.  Stopping at it >= 10
    must reproduce the nit=10 run's estimate bit-for-bit, and the
    reported nit must stay at 10 even though the scan length is 80."""
    prior, like, op, x = _bg_problem(seed=3)
    stop = lambda st: st.it >= 10  # noqa: E731
    fin_stop, _, _ = gamp_est(
        prior, like, op, GampOptions(nit=80, tol=-1.0, stop_fn=stop)
    )
    fin_10, _, _ = gamp_est(prior, like, op, GampOptions(nit=10, tol=-1.0))
    assert int(fin_stop.nit) == 10
    np.testing.assert_array_equal(
        np.asarray(fin_stop.xhat), np.asarray(fin_10.xhat)
    )


def test_remove_mean_with_vector_init_and_autotune():
    """Round-5 crash fixes: remove_mean with (n,)-shaped x_init/xvar_init
    (the augmented state is (n+2,)), remove_mean + tune_wvar (the ML
    noise autotune now reaches through the Concat augmentation to the
    original likelihood block), and xvar0auto with a scalar x_init."""
    prior, like, op, x = _bg_problem(seed=5, mean=0.3)
    x0 = jnp.zeros(op.in_shape, jnp.complex64)
    fin, _, _ = gamp_est(
        prior, like, op,
        GampOptions(nit=40, remove_mean=True),
        x_init=x0, xvar_init=jnp.full(op.in_shape, 0.5, jnp.float32),
    )
    assert fin.xhat.shape == op.in_shape
    assert _nmse(fin.xhat, x) < 0.1
    fin2, _, _ = gamp_est(
        prior, like, op,
        GampOptions(nit=40, remove_mean=True, tune_wvar=True),
    )
    assert _nmse(fin2.xhat, x) < 0.1
    # scalar x_init must broadcast through _xvar0_auto (crash fix); a
    # zero "point estimate" is degenerate, so only assert finiteness
    fin3, _, _ = gamp_est(
        prior, like, op,
        GampOptions(nit=10, xvar0auto=True),
        x_init=jnp.zeros((), jnp.complex64),
    )
    assert bool(jnp.all(jnp.isfinite(fin3.xhat.real)))
    # the mode's actual use: a good point estimate -> auto xvar keeps it
    fin4, _, _ = gamp_est(
        prior, like, op,
        GampOptions(nit=40, xvar0auto=True),
        x_init=jnp.asarray(x, jnp.complex64),
    )
    assert _nmse(fin4.xhat, x) < 1e-2
