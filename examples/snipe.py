"""SNIPE as an overmatched Bernoulli-Gaussian denoiser.

The reference's ``examples/SNIPE/snipe_as_overmatched_BernGauss.m``:
SNIPE (sparsifying non-informative parameter estimator, the
infinite-slab-variance limit of a Bernoulli-Gaussian prior) recovers
BG signals almost as well as the MATCHED BG prior while needing only a
single tuning scalar omega — and is insensitive to it over a wide range.

Run: python examples/snipe.py [--cpu]
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
    SNIPEPrior,
    SparsePrior,
    bg_sampler,
    gamp_est,
)


def main():
    m, n, p1, wvar = 300, 512, 0.08, 1e-4
    opt = GampOptions(nit=40, adapt_step=False, step=0.8, tol=-1.0)

    def trial(seed, prior):
        key = jax.random.PRNGKey(seed)
        ka, kx, kw = jax.random.split(key, 3)
        A = jax.random.normal(ka, (m, n)) / jnp.sqrt(m)
        x = bg_sampler(p1, 1.0)(kx, n)
        y = A @ x + jnp.sqrt(wvar) * jax.random.normal(kw, (m,))
        fin, _, _ = gamp_est(prior, CAwgnLikelihood(y=y, wvar=wvar),
                             MatrixOp(A), opt)
        return float(
            jnp.sum(jnp.abs(fin.xhat - x) ** 2) / jnp.sum(jnp.abs(x) ** 2)
        )

    seeds = range(40, 44)
    matched = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=p1)
    ref = np.mean([trial(s, matched) for s in seeds])
    print("== SNIPE vs matched Bernoulli-Gaussian (m/n = 0.59, p1 = 0.08) ==")
    print(f"  matched BG prior      : NMSE = {10 * np.log10(ref):7.2f} dB")
    print(f"  {'omega':>7s} {'SNIPE NMSE (dB)':>16s}")
    for omega in (0.0, 1.0, 2.0, 3.0, 4.0):
        e = np.mean([trial(s, SNIPEPrior(omega=jnp.asarray(omega)))
                     for s in seeds])
        print(f"  {omega:7.1f} {10 * np.log10(e):16.2f}")
    print("  (SNIPE tracks the matched prior to within a few dB over a wide")
    print("   omega band, with no knowledge of the sparsity rate or the")
    print("   slab amplitude — the overmatched-BG point of the reference.)")


if __name__ == "__main__":
    main()
