"""Sparse recovery through an impulsive (Bernoulli-Gaussian) noise channel.

Demonstrates the AWBGN likelihood (``main/AwbgnEstimOut.m`` analog): each
measurement is exactly noiseless w.p. (1−λ) and hit by a large Gaussian
impulse w.p. λ.  A GAMP run with the delta-spike-aware ``AwbgnLikelihood``
identifies the clean measurements and recovers the signal almost exactly,
while a naive AWGN likelihood matched only to the average noise power is
badly degraded.

Run: python examples/impulsive_noise.py [--cpu]
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
    AwbgnLikelihood,
    AwgnPrior,
    CAwgnLikelihood,
    SparsePrior,
)
from jstsp19.solvers.gamp_full import GampOptions, gamp_est


def main():
    rng = np.random.default_rng(7)
    n, m, k = 400, 240, 24
    lam, wvar = 0.1, 9.0  # 10% impulses, 9x-unit-variance hits

    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(m), jnp.float32)
    x_np = np.zeros(n)
    x_np[rng.choice(n, k, False)] = rng.standard_normal(k)
    x = jnp.asarray(x_np, jnp.float32)
    impulses = (rng.uniform(size=m) < lam) * (
        np.sqrt(wvar) * rng.standard_normal(m)
    )
    y = A @ x + jnp.asarray(impulses, jnp.float32)

    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=k / n)
    # pvar_min floors the near-deterministic channel's collapsing precision
    # (GampOpt.pvarMin analog) — see AwbgnLikelihood's docstring.
    opts = GampOptions(nit=100, pvar_min=1e-6)

    fin_awbgn, _, _ = gamp_est(
        prior,
        AwbgnLikelihood(y=y, wvar=jnp.asarray(wvar), lam=jnp.asarray(lam)),
        MatrixOp(A), opts,
    )
    fin_awgn, _, _ = gamp_est(
        prior,
        CAwgnLikelihood(y=y, wvar=jnp.asarray(lam * wvar)),
        MatrixOp(A), opts,
    )

    def nmse_db(xhat):
        e = float(jnp.sum(jnp.abs(xhat - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
        return 10 * np.log10(max(e, 1e-30))

    print(f"n={n} m={m} k={k}  lambda={lam} wvar={wvar}")
    print(f"GAMP + AwbgnLikelihood (impulse-aware): {nmse_db(fin_awbgn.xhat):8.1f} dB NMSE")
    print(f"GAMP + CAwgnLikelihood (avg-power AWGN): {nmse_db(fin_awgn.xhat):7.1f} dB NMSE")


if __name__ == "__main__":
    main()
