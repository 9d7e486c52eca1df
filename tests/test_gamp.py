import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.ops import MatrixOp
from jstsp19.solvers.estim import CAwgnPrior, SparsePrior, CAwgnLikelihood
from jstsp19.solvers.gamp import gamp, fista


def crandn(key, shape, var=1.0):
    k1, k2 = jax.random.split(key)
    return (
        (jax.random.normal(k1, shape) + 1j * jax.random.normal(k2, shape))
        * np.sqrt(var / 2)
    ).astype(jnp.complex64)


def _sparse_problem(key, m=128, n=256, k=10, snr_db=25.0):
    kA, kx, ki, kn = jax.random.split(key, 4)
    A = crandn(kA, (m, n)) / np.sqrt(m)
    idx = jax.random.choice(ki, n, (k,), replace=False)
    beta = k / n
    x = jnp.zeros((n,), jnp.complex64).at[idx].set(crandn(kx, (k,), var=1 / beta))
    y_clean = A @ x
    nv = float(jnp.mean(jnp.abs(y_clean) ** 2)) * 10 ** (-snr_db / 10)
    y = y_clean + crandn(kn, (m,), nv)
    return A, x, y, nv, beta


def test_gamp_recovers_sparse_vector(key):
    A, x, y, nv, beta = _sparse_problem(key)
    op = MatrixOp(A)
    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    lik = CAwgnLikelihood(y, jnp.asarray(nv, jnp.float32))
    res = gamp(prior, lik, op, nit=80)
    nmse = float(jnp.sum(jnp.abs(res.x - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert nmse < 0.05, nmse


def test_gamp_gaussian_prior_near_lmmse(key):
    # Gaussian prior: GAMP fixed point == LMMSE
    kA, kx, kn = jax.random.split(key, 3)
    A = crandn(kA, (64, 32)) / 8.0
    x = crandn(kx, (32,))
    nv = 0.05
    y = A @ x + crandn(kn, (64,), nv)
    op = MatrixOp(A)
    prior = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    lik = CAwgnLikelihood(y, jnp.asarray(nv, jnp.float32))
    res = gamp(prior, lik, op, nit=100)
    An = np.asarray(A, np.complex128)
    xl = np.linalg.solve(
        An.conj().T @ An + nv * np.eye(32), An.conj().T @ np.asarray(y)
    )
    rel = np.linalg.norm(np.asarray(res.x) - xl) / np.linalg.norm(xl)
    assert rel < 0.05, rel


def test_fista_recovers_sparse_vector(key):
    A, x, y, nv, beta = _sparse_problem(key, snr_db=35.0)
    op = MatrixOp(A)
    xh = fista(y, op, lam=0.002, nit=300)
    nmse = float(jnp.sum(jnp.abs(xh - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert nmse < 0.05, nmse


def test_amp_recovers_sparse_vector(key):
    from jstsp19.solvers.gamp import amp

    A, x, y, nv, beta = _sparse_problem(key, m=200, n=400, k=15, snr_db=30.0)
    op = MatrixOp(A)
    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    xh = amp(y, op, prior, nit=60)
    nmse = float(jnp.sum(jnp.abs(xh - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert nmse < 0.05, nmse


def test_amp_matches_state_evolution(key):
    """Empirical AMP MSE should track the gampSE-style state-evolution
    prediction (the reference's strongest analytic oracle)."""
    from jstsp19.solvers.gamp import amp
    from jstsp19.solvers.vamp_slm import amp_se
    from jstsp19.core import prng as _prng

    m, n, k, snr_db = 256, 512, 25, 25.0
    A, x, y, nv, beta = _sparse_problem(key, m=m, n=n, k=k, snr_db=snr_db)
    op = MatrixOp(A)
    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    xh = amp(y, op, prior, nit=40)
    emp = float(jnp.sum(jnp.abs(xh - x) ** 2) / n)

    def sampler(kk, ns):
        mask = jax.random.uniform(kk, (ns,)) < beta
        return jnp.where(
            mask,
            _prng.complex_normal(jax.random.fold_in(kk, 1), (ns,), var=1 / beta),
            0.0,
        )

    se = amp_se(sampler, prior, delta=m / n, wvar=jnp.asarray(nv), nit=40)
    pred = float(se[-1])
    # same order of magnitude at convergence (both ≈ the oracle MSE floor)
    assert emp < 10 * pred + 1e-4, (emp, pred)
    assert pred < 0.05


def test_sure_amp_recovers_sparse_vector(key):
    """SURE-tuned AMP needs no prior parameters at all (SURE_BAMP parity)."""
    from jstsp19.solvers.gamp import sure_amp

    A, x, y, nv, beta = _sparse_problem(key, m=256, n=512, k=20, snr_db=30.0)
    op = MatrixOp(A)
    xh = sure_amp(y, op, nit=60)
    nmse = float(jnp.sum(jnp.abs(xh - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert nmse < 0.05, nmse


def test_gamp_real_nonneg_prior_keeps_real_state(key):
    """A fully-real problem (non-negative spike-slab prior, real matrix and
    observation) must run GAMP with a float32 state and recover the signal."""
    from jstsp19.solvers.estim import NNGMPrior

    m, n, k = 128, 256, 12
    kA, kx, ki, kn = jax.random.split(key, 4)
    A = (jax.random.normal(kA, (m, n)) / np.sqrt(m)).astype(jnp.float32)
    idx = jax.random.choice(ki, n, (k,), replace=False)
    amp_pos = jnp.abs(jax.random.normal(kx, (k,))) + 0.5
    x = jnp.zeros((n,), jnp.float32).at[idx].set(amp_pos)
    nv = 1e-4 * float(jnp.mean((A @ x) ** 2)) * m
    y = A @ x + jnp.sqrt(nv) * jax.random.normal(kn, (m,))
    prior = NNGMPrior(
        jnp.asarray([1.0]), jnp.asarray([1.0]), jnp.asarray([1.0]), p1=k / n
    )
    lik = CAwgnLikelihood(y, jnp.asarray(nv, jnp.float32))
    res = gamp(prior, lik, MatrixOp(A), nit=80)
    assert not jnp.iscomplexobj(res.x)
    nmse = float(jnp.sum((res.x - x) ** 2) / jnp.sum(x**2))
    assert nmse < 0.05, nmse


def test_gamp_adaptive_step(key):
    """GampOpt.adaptStep analog: on a well-conditioned problem the adaptive
    step matches the fixed step exactly; on a strongly correlated operator
    (where fixed-step GAMP diverges to NaN) it degrades gracefully."""
    # well-conditioned: identical recovery
    A, x, y, nv, beta = _sparse_problem(key)
    op = MatrixOp(A)
    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    lik = CAwgnLikelihood(y, jnp.asarray(nv, jnp.float32))
    res_f = gamp(prior, lik, op, nit=80)
    res_a = gamp(prior, lik, op, nit=80, adaptive=True)
    nm_f = float(jnp.sum(jnp.abs(res_f.x - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    nm_a = float(jnp.sum(jnp.abs(res_a.x - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert nm_a < 0.05
    assert abs(nm_a - nm_f) < 0.02

    # correlated columns: fixed step NaNs, adaptive stays finite
    m, n, k = 128, 256, 12
    kA, kB, kx, ki, kn = jax.random.split(key, 5)
    from jstsp19.core import prng as _prng

    U = _prng.complex_normal(kA, (m, 30))
    V = _prng.complex_normal(kB, (30, n))
    A2 = (
        U @ V / np.sqrt(30)
        + 0.05 * _prng.complex_normal(jax.random.fold_in(key, 9), (m, n))
    ) / np.sqrt(m)
    beta = k / n
    idx = jax.random.choice(ki, n, (k,), replace=False)
    x2 = jnp.zeros((n,), jnp.complex64).at[idx].set(
        _prng.complex_normal(kx, (k,), var=1 / beta)
    )
    nv2 = float(jnp.mean(jnp.abs(A2 @ x2) ** 2)) * 1e-3
    y2 = A2 @ x2 + _prng.complex_normal(kn, (m,), var=nv2)
    prior2 = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    lik2 = CAwgnLikelihood(y2, jnp.asarray(nv2, jnp.float32))
    res_f2 = gamp(prior2, lik2, MatrixOp(A2), nit=300, step=0.9)
    res_a2 = gamp(prior2, lik2, MatrixOp(A2), nit=300, step=0.9, adaptive=True)
    assert not bool(jnp.all(jnp.isfinite(jnp.abs(res_f2.x))))  # fixed diverges
    assert bool(jnp.all(jnp.isfinite(jnp.abs(res_a2.x))))  # adaptive does not


def _spectrum_problem(cond, n=256, m=128, k=12, wvar=1e-5, seed=0):
    """Unitarily-invariant ensemble with log-spaced singular values,
    normalized to ||A||_F^2 = n (unit-norm columns on average)."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), m)
    A = U @ np.diag(s) @ V[:, :m].T
    A *= np.sqrt(n / np.sum(s**2))
    evals = (s * np.sqrt(n / np.sum(s**2))) ** 2
    x = np.zeros(n)
    idx = rng.choice(n, k, False)
    x[idx] = rng.standard_normal(k)
    y = A @ x + np.sqrt(wvar) * rng.standard_normal(m)
    from jstsp19.ops import MatrixOp
    from jstsp19.solvers.estim import AwgnPrior, SparsePrior

    op = MatrixOp(jnp.asarray(A, jnp.float32))
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=k / n)
    return op, prior, jnp.asarray(y, jnp.float32), x, jnp.asarray(evals, jnp.float32), wvar


def _nmse_np(xh, x):
    return float(np.sum((np.asarray(xh) - x) ** 2) / np.sum(x**2))


def test_amp_est_rvar_methods_agree_on_flat_spectrum():
    """ampEst.m's standard-branch rvar methods ('mean'/'median'/'wvar',
    ampEst.m:232-246) and the S-AMP branch all recover a well-conditioned
    unitarily-invariant problem to the same accuracy."""
    from jstsp19.solvers import amp_est

    op, prior, y, x, evals, wvar = _spectrum_problem(cond=1.0)
    for kwargs in (
        dict(rvar_method="mean"),
        dict(rvar_method="median"),
        dict(rvar_method="wvar", wvar=wvar),
        dict(evals_aah=evals, wvar=wvar),
    ):
        xh = amp_est(y, op, prior, nit=60, **kwargs)
        assert _nmse_np(xh, x) < 1e-3, kwargs


def test_s_amp_recovers_where_standard_amp_fails():
    """The exact-rvar S-AMP branch (ampEst.m:221-268: Onsager gain
    1-1/S(-xvar/rvar), rvar = wvar*S(-xvar/rvar) bisection fixed point)
    on a condition-10 log-spectrum ensemble: standard AMP diverges, S-AMP
    with damp=0.5 recovers to noise level."""
    from jstsp19.solvers import amp, amp_est

    op, prior, y, x, evals, wvar = _spectrum_problem(cond=10.0)
    nmse_amp = _nmse_np(amp(y, op, prior, nit=100), x)
    nmse_samp = _nmse_np(
        amp_est(y, op, prior, nit=200, wvar=wvar, evals_aah=evals, damp=0.5),
        x,
    )
    assert nmse_amp > 0.5, nmse_amp  # standard AMP fails here
    assert nmse_samp < 1e-3, nmse_samp
