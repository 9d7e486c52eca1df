"""GAMP state evolution vs empirical MSE trajectories — the
``stateEvo/gampSE.m`` oracle: SE must predict the per-iteration MSE of the
actual solver within MC error on the Bernoulli-Gaussian testbed (AWGN and
probit channels)."""
import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.ops.base import MatrixOp
from jstsp19.solvers.estim import (
    AwgnPrior,
    CAwgnLikelihood,
    ProbitLikelihood,
    SparsePrior,
)
from jstsp19.solvers.gamp_full import GampOptions, gamp_est
from jstsp19.solvers.gamp_se import (
    AwgnOutAvg,
    MCOutAvg,
    bg_sampler,
    estim_in_avg,
    gamp_se,
)


def _empirical_mse_traj(prior, like_fn, m, n, x_sampler, seed, nit=25):
    """Average per-iteration MSE of gamp_est over a few large realizations."""
    trajs = []
    for s in range(3):
        key = jax.random.PRNGKey(seed + s)
        ka, kx, kw = jax.random.split(key, 3)
        A = jax.random.normal(ka, (m, n)) / jnp.sqrt(m)
        x = x_sampler(kx, n)
        y = like_fn(kw, A @ x)
        fin, st, hist = gamp_est(
            prior,
            y,
            MatrixOp(A),
            GampOptions(nit=nit, adapt_step=False, step=1.0, tol=-1.0,
                        save_hist=True),
        )
        mse = jnp.mean(jnp.abs(hist["xhat"] - x[None, :]) ** 2, axis=1)
        trajs.append(np.asarray(mse))
    return np.mean(np.stack(trajs), axis=0)


def _close_with_shift(emp_db, se_db, tol_db):
    """Trajectory agreement allowing a ±1 iteration indexing offset."""
    best = np.inf
    for shift in (-1, 0, 1):
        a = emp_db[max(0, shift): len(emp_db) + min(0, shift)]
        b = se_db[max(0, -shift): len(se_db) + min(0, -shift)]
        k = min(len(a), len(b))
        best = min(best, np.max(np.abs(a[:k] - b[:k])))
    return best < tol_db


def test_se_matches_empirical_awgn():
    p1, var0, wvar = 0.1, 1.0, 1e-4
    m, n = 512, 1024
    beta = n / m
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=var0), p1=p1)
    sampler = bg_sampler(p1, var0)

    in_avg = estim_in_avg(prior, jax.random.PRNGKey(0), n_samp=65536,
                          sampler=sampler)
    se = gamp_se(in_avg, AwgnOutAvg(wvar=wvar), beta=beta, nit=24)

    def like_fn(kw, z):
        y = z + jnp.sqrt(wvar) * jax.random.normal(kw, z.shape)
        return CAwgnLikelihood(y=y, wvar=wvar)

    emp = _empirical_mse_traj(prior, like_fn, m, n, sampler, seed=10)
    # compare trajectories where the MSE is still above the noise floor
    se_db = 10 * np.log10(np.asarray(se["mse"]) + 1e-12)
    emp_db = 10 * np.log10(emp + 1e-12)
    k = min(len(se_db), len(emp_db), 12)
    assert _close_with_shift(emp_db[2:k], se_db[2:k], tol_db=2.0), (
        emp_db[:k],
        se_db[:k],
    )
    # steady state agrees tightly
    assert abs(emp_db[-1] - se_db[len(emp_db) - 1]) < 2.0


def test_se_matches_empirical_probit():
    p1, var0, wvar = 0.25, 1.0, 1e-2
    m, n = 2048, 1024  # oversampled: 1-bit needs m > n
    beta = n / m
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=var0), p1=p1)
    sampler = bg_sampler(p1, var0)

    def channel(key, z):
        # ProbitLikelihood encodes observations as y ∈ {0, 1}
        return (
            z + jnp.sqrt(wvar) * jax.random.normal(key, z.shape) > 0
        ).astype(jnp.float32)

    out_avg = MCOutAvg(
        like_factory=lambda y: ProbitLikelihood(y=y, wvar=wvar),
        channel=channel,
        key=jax.random.PRNGKey(1),
        n_samp=32768,
    )
    in_avg = estim_in_avg(prior, jax.random.PRNGKey(2), n_samp=65536,
                          sampler=sampler)
    se = gamp_se(in_avg, out_avg, beta=beta, nit=20)

    def like_fn(kw, z):
        return ProbitLikelihood(y=channel(kw, z), wvar=wvar)

    emp = _empirical_mse_traj(prior, like_fn, m, n, sampler, seed=20, nit=20)
    se_db = 10 * np.log10(np.asarray(se["mse"]) + 1e-12)
    emp_db = 10 * np.log10(emp + 1e-12)
    # probit SE is MC-noisy: require steady-state agreement within 2.5 dB
    assert abs(np.mean(emp_db[-4:]) - np.mean(se_db[-4:])) < 2.5, (
        emp_db[-4:],
        se_db[-4:],
    )
