"""Structured-sparsity turbo demos: Markov-chain support + EM learning.

A block-sparse signal defeats an i.i.d. spike-slab prior at a
measurement-starved operating point; the turbo loop's chain smoother
recovers it, and EM-turboGAMP learns the chain's transition probability
and sparsity rate from the data (``turboGAMP/EMturboGAMP.m``,
``ClassDefs/@MarkovChain1``).

Run: python examples/structured_sparsity.py [--cpu]
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
    CAwgnPrior,
    SparsePrior,
    em_turbo_markov_vamp,
    turbo_markov_vamp,
    vamp_slm,
)


def nmse_db(xhat, x):
    return 10 * np.log10(
        float(np.sum(np.abs(np.asarray(xhat) - x) ** 2) / np.sum(np.abs(x) ** 2))
    )


def main():
    rng = np.random.default_rng(2)
    n, m, wvar = 256, 110, 1e-3
    p01, lam = 0.05, 0.25  # sticky chain, stationary activity 0.25
    p10 = p01 * lam / (1 - lam)

    # draw chains until the realized activity is near the stationary rate
    # (a single short chain has high variance)
    while True:
        s = np.zeros(n, bool)
        st = rng.random() < lam
        for i in range(n):
            st = (rng.random() < (1 - p01)) if st else (rng.random() < p10)
            s[i] = st
        if abs(s.mean() - lam) < 0.02:
            break
    x = np.where(
        s, (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2), 0
    )
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(
        2 * m
    )
    y = A @ x + np.sqrt(wvar / 2) * (
        rng.standard_normal(m) + 1j * rng.standard_normal(m)
    )
    op = MatrixOp(jnp.asarray(A, jnp.complex64))
    yj = jnp.asarray(y, jnp.complex64)
    beta = float(s.mean())

    print(f"== block-sparse recovery (n={n} m={m}, {s.sum()} active) ==")
    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    res_iid = vamp_slm(prior, yj, op, gamw=1.0 / wvar, nit=40)
    print(f"  iid spike-slab VAMP     NMSE = {nmse_db(res_iid.x, x):7.2f} dB")

    res_tb = turbo_markov_vamp(
        yj, op, slab_var=1 / beta, gamw=1.0 / wvar, p01=p01, p10=p10,
        n_turbo=6, nit=40,
    )
    print(f"  turbo (true chain)      NMSE = {nmse_db(res_tb.x, x):7.2f} dB")

    res_em = em_turbo_markov_vamp(
        yj, op, 1 / beta, 1.0 / wvar, p01_init=0.5, lam_init=0.5, n_em=10
    )
    print(f"  EM-turbo (learned)      NMSE = {nmse_db(res_em.x, x):7.2f} dB")
    print(
        f"  learned p01 = {float(res_em.p01):.3f} (true {p01}), "
        f"lam = {float(res_em.lam):.3f} (true {beta:.3f})"
    )


if __name__ == "__main__":
    main()
