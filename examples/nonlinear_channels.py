"""Nonlinear output channels: saturated sigmoid and Poisson counting.

Covers the reference's ``examples/sparseNL/`` (y = f(Ax) + w with a
saturating sigmoid f — ``sparseNL.m``, ``sparseNLParam.m:36``) and the
linear-nonlinear-Poisson family of ``examples/LNPAdapt/`` (count
observations y ~ Poisson(rate(Ax)) — ``LNPTest.m``): both reduce to
swapping the ``EstimOut`` module, everything else in GAMP unchanged.

1. sparseNL: GAMP with the quadrature ``NLLikelihood`` on the sigmoid
   channel, vs a naive AWGN-GAMP that ignores the nonlinearity.
2. LNP: GAMP with ``PoissonLikelihood`` on counts with a linear rate,
   vs AWGN-GAMP treating counts as Gaussian.

Run: python examples/nonlinear_channels.py [--cpu]
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
    CAwgnLikelihood,
    GampOptions,
    NLLikelihood,
    NNGMPrior,
    PoissonLikelihood,
    SparsePrior,
    bg_sampler,
    gamp_est,
)


def nmse_db(xhat, x):
    return 10 * np.log10(
        float(jnp.sum(jnp.abs(xhat - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    )


def main():
    # -- 1. saturating sigmoid channel (sparseNLParam.m setup) ------------
    m, n, p1, snr_db = 500, 1000, 0.1, 20
    wvar = 10 ** (-0.1 * snr_db)
    # ascale chosen so ~30% of z-draws hit the +-0.5 saturation knee
    # (sparseNLParam.m:31: ascale = 1/sqrt(2 zvar0)/satlev/erfinv(1-psat))
    zvar0 = p1 * 1.0
    from scipy.special import erfinv  # scipy is available transitively

    ascale = 1.0 / np.sqrt(2 * zvar0) / 0.5 / erfinv(1 - 0.3)
    out_fn = lambda z: 2.0 / (1.0 + jnp.exp(-ascale * z)) - 1.0

    key = jax.random.PRNGKey(7)
    ka, kx, kw = jax.random.split(key, 3)
    A = jax.random.normal(ka, (m, n)) / jnp.sqrt(m)
    x = bg_sampler(p1, 1.0)(kx, n)
    z = A @ x
    y = out_fn(z) + jnp.sqrt(wvar) * jax.random.normal(kw, (m,))

    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=p1)
    opt = GampOptions(nit=30, adapt_step=False, step=0.7, tol=-1.0)
    fin_nl, _, _ = gamp_est(
        prior, NLLikelihood(y=y, wvar=wvar, out_fn=out_fn), MatrixOp(A), opt
    )
    # naive: pretend y ~ a'·z + noise with the small-signal slope at 0
    slope = float((out_fn(1e-3) - out_fn(0.0)) / 1e-3)
    fin_aw, _, _ = gamp_est(
        prior, CAwgnLikelihood(y=y / slope, wvar=wvar / slope**2),
        MatrixOp(A), opt,
    )
    print("== sparseNL: y = sigmoid(Ax) + w, 30% saturated ==")
    print(f"  GAMP + NLLikelihood   NMSE = {nmse_db(fin_nl.xhat, x):7.2f} dB")
    print(f"  GAMP + linearized AWGN NMSE = {nmse_db(fin_aw.xhat, x):7.2f} dB")

    # -- 2. Poisson counting channel (LNPAdapt family) --------------------
    # low-count regime (a few photons per measurement): the Poisson
    # variance=mean structure matters, a single-variance Gaussian can't
    # represent it
    mp, np_, scale = 800, 200, 8.0
    key = jax.random.PRNGKey(8)
    ka, kx, kp = jax.random.split(key, 3)
    # non-negative sparse intensity via a one-component truncated GM
    act = jax.random.uniform(jax.random.fold_in(kx, 0), (np_,)) < p1
    mag = jax.random.exponential(jax.random.fold_in(kx, 1), (np_,))
    x_nn = jnp.where(act, mag, 0.0)
    # sparse random photon-counting mask (compressive-imaging style):
    # each measurement integrates ~25% of the scene
    A_nn = (
        (jax.random.uniform(ka, (mp, np_)) < 0.25).astype(jnp.float32)
        * jax.random.uniform(jax.random.fold_in(ka, 1), (mp, np_))
        * (8.0 / np_)
    )
    rate = scale * (A_nn @ x_nn)
    y_cnt = jax.random.poisson(kp, rate).astype(jnp.float32)

    prior_nn = NNGMPrior(
        jnp.asarray([1.0]), jnp.asarray([1.0]), jnp.asarray([1.0]),
        p1=jnp.asarray(p1),
    )
    # positive mixing matrix -> strong mean component; GAMP's zero-mean-A
    # assumption fails without the mean-removal augmentation
    # (gampEst.m:238-272 capability)
    opt_p = GampOptions(nit=40, adapt_step=False, step=0.5, tol=-1.0,
                        remove_mean=True)
    fin_p, _, _ = gamp_est(
        prior_nn, PoissonLikelihood(y=y_cnt, scale=scale), MatrixOp(A_nn),
        opt_p,
    )
    # naive Gaussian treatment: y/scale = z + N(0, mean-count/scale^2)
    gvar = float(jnp.mean(y_cnt) / scale**2) + 1e-9
    fin_g, _, _ = gamp_est(
        prior_nn, CAwgnLikelihood(y=y_cnt / scale, wvar=gvar), MatrixOp(A_nn),
        opt_p,
    )
    print(f"== LNP: y ~ Poisson({scale:.0f} * Ax), non-negative sparse x ==")
    print(f"  GAMP + PoissonLikelihood NMSE = {nmse_db(fin_p.xhat, x_nn):7.2f} dB")
    print(f"  GAMP + Gaussian approx   NMSE = {nmse_db(fin_g.xhat, x_nn):7.2f} dB")


if __name__ == "__main__":
    main()
