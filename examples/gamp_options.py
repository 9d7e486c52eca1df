"""Full-capability GAMP demo: the gampEst.m options matrix on one testbed.

Runs the same Bernoulli-Gaussian compressed-sensing problem through the
sum-product / adaptive-step (log-likelihood and Bethe) / mean-removal /
uniform-variance / max-sum (MAP) modes of ``solvers/gamp_full.py``, and
shows the bit-exact warm-start contract (``main/gampEst.m:1-55``,
``main/GampOpt.m:1-30``, ``test/warmStart/``).

Run: python examples/gamp_options.py [--cpu]
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
    SoftThreshPrior,
    SparsePrior,
    gamp_est,
)


def nmse_db(xhat, x):
    return 10 * np.log10(
        float(np.sum(np.abs(np.asarray(xhat) - x) ** 2) / np.sum(np.abs(x) ** 2))
    )


def main():
    rng = np.random.default_rng(0)
    n, m, k, wvar = 512, 256, 32, 1e-4
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    x = np.zeros(n)
    x[rng.choice(n, k, False)] = rng.standard_normal(k)
    y = A @ x + np.sqrt(wvar) * rng.standard_normal(m)

    op = MatrixOp(jnp.asarray(A, jnp.float32))
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=k / n)
    like = CAwgnLikelihood(y=jnp.asarray(y, jnp.float32), wvar=wvar)

    print("== gampEst options matrix (BG-CS, n=512 m=256 k=32) ==")
    matrix = [
        ("plain step=0.9", GampOptions(nit=80, adapt_step=False, step=0.9)),
        ("adaptive (loglike)", GampOptions(nit=80)),
        ("adaptive (Bethe)", GampOptions(nit=80, adapt_step_bethe=True)),
        ("mean removal", GampOptions(nit=80, remove_mean=True)),
        ("uniform variance", GampOptions(nit=80, uniform_variance=True)),
        ("wvar autotune", GampOptions(nit=80, tune_wvar=True)),
    ]
    for label, opts in matrix:
        fin, _, _ = gamp_est(prior, like, op, opts)
        print(f"  {label:22s} NMSE = {nmse_db(fin.xhat, x):7.2f} dB")

    # max-sum (MAP) mode: LASSO via the SoftThresh prior
    fin, _, _ = gamp_est(
        SoftThreshPrior(lam=2.0), like, op,
        GampOptions(nit=200, max_sum=True, step=0.5),
    )
    print(f"  {'max-sum LASSO':22s} NMSE = {nmse_db(fin.xhat, x):7.2f} dB")

    # warm start: 15 + 25 resumed iterations equal 40 straight, bit-exact
    kw = dict(tol=-1.0, step_tol=-1.0)
    fin40, _, _ = gamp_est(prior, like, op, GampOptions(nit=40, **kw))
    _, st15, _ = gamp_est(prior, like, op, GampOptions(nit=15, **kw))
    fin_res, _, _ = gamp_est(
        prior, like, op, GampOptions(nit=25, **kw), state_in=st15
    )
    exact = bool(
        np.array_equal(np.asarray(fin40.xhat), np.asarray(fin_res.xhat))
    )
    print(f"  warm start (15+25 vs 40): bit-exact = {exact}")
    assert exact


if __name__ == "__main__":
    main()
