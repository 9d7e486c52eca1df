"""Low-rank matrix completion: SVT vs ADMM-MC vs BiG-AMP.

Run: python examples/matrix_completion.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from jstsp19.core import prng
from jstsp19.solvers import mc_svt, mc_admm, bigamp_mc


def main():
    key = prng.experiment_key(0)
    L, M, R, obs_frac, nv = 48, 64, 3, 0.5, 1e-3
    Af = prng.complex_normal(jax.random.fold_in(key, 0), (L, R))
    Xf = prng.complex_normal(jax.random.fold_in(key, 1), (R, M))
    Z = Af @ Xf
    mask = (jax.random.uniform(jax.random.fold_in(key, 2), (L, M)) < obs_frac).astype(
        jnp.float32
    )
    Y = mask * (Z + prng.complex_normal(jax.random.fold_in(key, 3), (L, M), var=nv))

    def nmse(Zh):
        return float(jnp.sum(jnp.abs(Zh - Z) ** 2) / jnp.sum(jnp.abs(Z) ** 2))

    Z_svt = mc_svt(Y, mask, Imax=300, tau=5.0, rho=1.0)
    Z_admm, _ = mc_admm(Z, Y, mask, Imax=300, tau=0.5, rho=1.0)
    Z_big = bigamp_mc(Y, mask, R, nv, jax.random.fold_in(key, 4), nit=300, step=0.5).Z
    print(f"{L}x{M} rank-{R}, {int(obs_frac*100)}% observed")
    print(f"  SVT-MC    NMSE = {nmse(Z_svt):.2e}")
    print(f"  ADMM-MC   NMSE = {nmse(Z_admm):.2e}")
    print(f"  BiG-AMP   NMSE = {nmse(Z_big):.2e}")


if __name__ == "__main__":
    main()
