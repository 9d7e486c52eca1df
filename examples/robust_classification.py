"""Robust binary + multinomial classification through GAMP.

The reference's ``classification/`` tail (``TestRobitGAMP`` capability):
sparse weight recovery when a fraction of training labels are flipped,
comparing the clean probit channel against the outlier-robust variants
(robust probit, robust logit, robit/t2), plus a small multinomial-logit
posterior demo.

Run: python examples/robust_classification.py [--cpu]
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
    MultiLogitLikelihood,
    ProbitLikelihood,
    RobustLogitLikelihood,
    RobustProbitLikelihood,
    SparsePrior,
    TDistLikelihood,
    gamp,
)


def main():
    n, m, k = 64, 256, 8
    p_flip = 0.08
    key = jax.random.key(7)
    kA, kf = jax.random.split(key)
    A = jax.random.normal(kA, (m, n)) / np.sqrt(n)
    x0 = jnp.where(jnp.arange(n) < k, 2.0, 0.0)
    y_clean = (A @ x0 > 0).astype(jnp.float32)
    flip = jax.random.bernoulli(kf, p_flip, (m,))
    y = jnp.where(flip, 1.0 - y_clean, y_clean)

    prior = SparsePrior(AwgnPrior(jnp.asarray(0.0), jnp.asarray(4.0)), jnp.asarray(k / n))
    op = MatrixOp(A)

    def corr(xhat):
        return float(
            jnp.vdot(xhat, x0).real
            / jnp.maximum(jnp.linalg.norm(xhat) * jnp.linalg.norm(x0), 1e-12)
        )

    channels = {
        "probit (clean model)": ProbitLikelihood(y, jnp.asarray(0.04)),
        "robust probit": RobustProbitLikelihood(
            ProbitLikelihood(y, jnp.asarray(0.04)), jnp.asarray(p_flip)
        ),
        "robust logit": RobustLogitLikelihood(
            y, jnp.asarray(p_flip), jnp.asarray(3.0)
        ),
        "robit (t2 CDF)": TDistLikelihood(y, jnp.asarray(0.5)),
    }
    print(f"{m} samples, {p_flip:.0%} flipped labels — weight-vector corr:")
    for name, lik in channels.items():
        res = gamp(prior, lik, op, nit=30)
        print(f"  {name:22s} corr = {corr(res.x):.4f}")

    # multinomial softmax posterior (MultiLogitEstimOut capability)
    lik = MultiLogitLikelihood(jnp.asarray([0, 2]), D=3, n_particles=2048)
    phat = jnp.asarray([[0.5, -0.2, 0.1], [-1.0, 0.3, 0.8]])
    pvar = jnp.full((2, 3), 0.5)
    zhat, zvar = lik.estim(phat, pvar)
    print("multi-logit posterior means (labels 0, 2):")
    print(np.round(np.asarray(zhat), 3))


if __name__ == "__main__":
    main()
