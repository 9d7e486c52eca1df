"""State-evolution demo: predicted vs empirical GAMP MSE trajectories.

Runs the matched SE recursion (``stateEvo/gampSE.m`` capability,
``solvers/gamp_se.py``) for a Bernoulli-Gaussian prior under an AWGN
output channel and overlays the empirical per-iteration MSE of the
actual GAMP solver — the strongest hardware-free correctness oracle
for message-passing implementations.

Run: python examples/state_evolution.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from jstsp19.ops import MatrixOp
from jstsp19.solvers import (
    AwgnOutAvg,
    AwgnPrior,
    CAwgnLikelihood,
    GampOptions,
    SparsePrior,
    bg_sampler,
    estim_in_avg,
    gamp_est,
    gamp_se,
)


def main():
    p1, var0, wvar = 0.1, 1.0, 1e-4
    m, n, nit = 512, 1024, 16
    beta = n / m

    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=var0), p1=p1)
    sampler = bg_sampler(p1, var0)
    in_avg = estim_in_avg(
        prior, jax.random.PRNGKey(0), n_samp=65536, sampler=sampler
    )
    se = gamp_se(in_avg, AwgnOutAvg(wvar=wvar), beta=beta, nit=nit)

    # empirical trajectory, averaged over a few problem draws
    trajs = []
    for s in range(4):
        key = jax.random.PRNGKey(10 + s)
        ka, kx, kw = jax.random.split(key, 3)
        A = jax.random.normal(ka, (m, n)) / jnp.sqrt(m)
        x = sampler(kx, n)
        y = A @ x + jnp.sqrt(wvar) * jax.random.normal(kw, (m,))
        _, _, hist = gamp_est(
            prior,
            CAwgnLikelihood(y=y, wvar=wvar),
            MatrixOp(A),
            GampOptions(nit=nit, adapt_step=False, step=1.0, tol=-1.0,
                        save_hist=True),
        )
        trajs.append(
            np.asarray(jnp.mean(jnp.abs(hist["xhat"] - x[None, :]) ** 2, axis=1))
        )
    emp = np.mean(np.stack(trajs), axis=0)

    se_db = 10 * np.log10(np.asarray(se["mse"]) + 1e-12)
    emp_db = 10 * np.log10(emp + 1e-12)
    print("== GAMP state evolution vs empirical (BG-AWGN, n/m = 2) ==")
    print(f"  {'iter':>4s} {'SE (dB)':>9s} {'empirical (dB)':>15s}")
    for i in range(min(len(se_db), len(emp_db))):
        print(f"  {i:4d} {se_db[i]:9.2f} {emp_db[i]:15.2f}")
    gap = abs(se_db[len(emp_db) - 1] - emp_db[-1])
    print(f"  steady-state gap = {gap:.2f} dB")


if __name__ == "__main__":
    main()
