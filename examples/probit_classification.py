"""Probit (1-bit) sparse regression: empirical GAMP vs state evolution.

The reference's ``examples/ProbitSE/`` suite (``ProbitEmpirical.m``,
``ProbitStateEvo.m``, ``ProbitPhasePlane.m``): a Bernoulli-Gaussian
vector observed through y = sign(Ax + w) — sparse binary classification /
1-bit compressed sensing.  This demo

1. runs GAMP with ``ProbitLikelihood`` on one problem instance,
2. runs the matched SE recursion with a Monte-Carlo probit output
   average (``MCOutAvg`` — the ``ProbitStateEvoEstimOut.m`` analog), and
3. sweeps the measurement ratio m/n — the 1-D slice of the reference's
   phase plane.

Run: python examples/probit_classification.py [--cpu]
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
    AwgnPrior,
    GampOptions,
    MCOutAvg,
    ProbitLikelihood,
    SparsePrior,
    bg_sampler,
    estim_in_avg,
    gamp_est,
    gamp_se,
)

P1, VAR0, WVAR, NIT = 0.1, 1.0, 1e-2, 25


def channel(key, z):
    # ProbitLikelihood encodes observations as y in {0, 1}
    return (z + jnp.sqrt(WVAR) * jax.random.normal(key, z.shape) > 0).astype(
        jnp.float32
    )


def run_gamp(seed, m, n):
    key = jax.random.PRNGKey(seed)
    ka, kx, kw = jax.random.split(key, 3)
    A = jax.random.normal(ka, (m, n)) / jnp.sqrt(m)
    x = bg_sampler(P1, VAR0)(kx, n)
    y = channel(kw, A @ x)
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=VAR0), p1=P1)
    fin, _, _ = gamp_est(
        prior, ProbitLikelihood(y=y, wvar=WVAR), MatrixOp(A),
        GampOptions(nit=NIT, adapt_step=False, step=1.0, tol=-1.0),
    )
    return float(jnp.mean(jnp.abs(fin.xhat - x) ** 2))


def run_se(m, n):
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=VAR0), p1=P1)
    in_avg = estim_in_avg(
        prior, jax.random.PRNGKey(2), n_samp=65536, sampler=bg_sampler(P1, VAR0)
    )
    out_avg = MCOutAvg(
        like_factory=lambda y: ProbitLikelihood(y=y, wvar=WVAR),
        channel=channel, key=jax.random.PRNGKey(1), n_samp=32768,
    )
    se = gamp_se(in_avg, out_avg, beta=n / m, nit=NIT)
    return float(se["mse"][-1])


def main():
    n = 512
    print("== probit GAMP: empirical vs state evolution (BG prior, "
          f"p1={P1}, 1-bit AWGN-dithered sign measurements) ==")
    print(f"  {'m/n':>5s} {'empirical (dB)':>15s} {'SE (dB)':>9s}")
    for ratio in (2.0, 4.0, 6.0):
        m = int(ratio * n)
        emp = np.mean([run_gamp(30 + s, m, n) for s in range(4)])
        se = run_se(m, n)
        print(f"  {ratio:5.1f} {10 * np.log10(emp + 1e-12):15.2f} "
              f"{10 * np.log10(se + 1e-12):9.2f}")
    print("  (SE tracks the empirical MSE across the undersampling sweep —")
    print("   the ProbitPhasePlane.m slice at this sparsity.)")


if __name__ == "__main__":
    main()
