"""Rank-one matrix factorization: AMP-style fit vs state evolution.

The ``matrixFactor/`` capability (``rankOneFit.m``, ``rankOneSE.m``,
``rankOneTest.m``): fit A = u0·v0ᵀ + noise with Onsager-corrected
alternating MMSE estimation, and overlay the empirical squared
correlations against the scalar SE prediction.

Run: python examples/rank_one_factorization.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from jstsp19.solvers import (
    AwgnPrior,
    DiscretePrior,
    mc_prior_mse,
    prior_moments,
    rank_one_fit,
    rank_one_se,
)


def main():
    m, n = 1000, 500
    # u Gaussian; v sparse-exponential on the reference's discrete grid
    # (rankOneSE.m:53-66)
    nx = 100
    x = np.linspace(1 / nx, 2, nx)
    px = np.exp(-x)
    px = 0.1 * px / px.sum()
    estimu = AwgnPrior(jnp.asarray(0.0), jnp.asarray(1.0))
    estimv = DiscretePrior(
        jnp.asarray(np.concatenate([[0.0], x]), jnp.float32),
        jnp.asarray(np.concatenate([[0.9], px]), jnp.float32),
    )
    um, uv = prior_moments(estimu)
    vm, vv = prior_moments(estimv)
    usq0 = float(um**2 + uv)
    vsq0 = float(vm**2 + vv)

    key = jax.random.key(0)
    ku, kv, kw = jax.random.split(key, 3)
    u0 = jax.random.normal(ku, (m,))
    w = estimv.weights / jnp.sum(estimv.weights)
    v0 = estimv.atoms[jax.random.choice(kv, estimv.atoms.shape[0], (n,), p=w)]

    print("snr(dB)  fit corr(u)  fit corr(v)  SE corr(u)  SE corr(v)")
    for snr_db in (0.0, 5.0, 10.0):
        wvar = usq0 * vsq0 * 10 ** (-0.1 * snr_db)
        A = jnp.outer(u0, v0) + jnp.sqrt(m * wvar) * jax.random.normal(kw, (m, n))
        res = rank_one_fit(A, estimu, estimv, jnp.asarray(wvar), nit=10)

        def corr(a, b):
            return float(
                jnp.abs(jnp.vdot(a, b)) ** 2
                / (jnp.vdot(a, a).real * jnp.vdot(b, b).real)
            )

        mse_u = mc_prior_mse(lambda k, nn: jax.random.normal(k, (nn,)), estimu)
        mse_v = mc_prior_mse(
            lambda k, nn: estimv.atoms[
                jax.random.choice(k, estimv.atoms.shape[0], (nn,), p=w)
            ],
            estimv,
        )
        corru_se, corrv_se = rank_one_se(
            mse_u, mse_v, n / m, um, uv, vm, vv, jnp.asarray(wvar), nit=10
        )
        print(
            f"{snr_db:7.1f}  {corr(res.u, u0):11.4f}  {corr(res.v, v0):11.4f}"
            f"  {float(corru_se[-1]):10.4f}  {float(corrv_se[-1]):10.4f}"
        )


if __name__ == "__main__":
    main()
