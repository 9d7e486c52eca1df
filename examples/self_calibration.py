"""Self-calibration with parametric bilinear GAMP (P-BiG-AMP).

The reference's ``examples/PBiGAMP/PBiGAMPiidBGawgn.m`` /
``affine_BG_AWGN.m`` use case: a sensor array with UNKNOWN per-measurement
complex gains b measures a sparse vector c through a known matrix Phi,

    y_m = b_m . (Phi c)_m + w_m        i.e.  z_m = b^T A[m] c,

with the measurement tensor A[m] = e_m Phi_{m,:}.  P-BiG-AMP jointly
estimates the gains and the signal; the EM wrapper additionally learns the
noise level and sparsity rate (``solvers/pbigamp.py``).

Run: python examples/self_calibration.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from jstsp19.core import prng
from jstsp19.solvers import CAwgnPrior, SparsePrior, pbigamp


def main():
    key = jax.random.key(11)
    M, Nc, k = 96, 128, 8
    Phi = prng.complex_normal(jax.random.fold_in(key, 0), (M, Nc)) / np.sqrt(M)
    beta = k / Nc
    act = jax.random.uniform(jax.random.fold_in(key, 1), (Nc,)) < beta
    c_true = jnp.where(
        act,
        prng.complex_normal(jax.random.fold_in(key, 2), (Nc,), var=1 / beta),
        0.0,
    )
    gain_var = 0.05
    b_true = 1.0 + prng.complex_normal(
        jax.random.fold_in(key, 3), (M,), var=gain_var
    )
    z_true = b_true * (Phi @ c_true)
    nv = 1e-4 * float(jnp.mean(jnp.abs(z_true) ** 2))
    y = z_true + prng.complex_normal(jax.random.fold_in(key, 4), (M,), var=nv)

    A = jnp.zeros((M, M, Nc), jnp.complex64)
    A = A.at[jnp.arange(M), jnp.arange(M), :].set(Phi)

    prior_b = CAwgnPrior(jnp.asarray(1.0 + 0j), jnp.asarray(gain_var, jnp.float32))
    prior_c = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    res = pbigamp(
        y, A, prior_b, prior_c, nv, jax.random.fold_in(key, 5), nit=200, step=0.5
    )

    def nmse_db(e, t):
        return 10 * np.log10(
            float(jnp.sum(jnp.abs(e - t) ** 2) / jnp.sum(jnp.abs(t) ** 2))
        )

    # resolve the bilinear scale ambiguity before factor-wise NMSE
    al = jnp.vdot(res.c, c_true) / jnp.maximum(jnp.vdot(res.c, res.c).real, 1e-30)
    print("== P-BiG-AMP self-calibration: unknown gains x sparse signal ==")
    print(f"  M={M} measurements, Nc={Nc} unknowns, k={k} active, "
          f"gain spread {gain_var}")
    print(f"  z  (ambiguity-free)  NMSE = {nmse_db(res.z, z_true):7.2f} dB")
    print(f"  c  (scale-aligned)   NMSE = {nmse_db(al * res.c, c_true):7.2f} dB")
    print(f"  b  (scale-aligned)   NMSE = "
          f"{nmse_db(res.b / jnp.conj(al), b_true):7.2f} dB")

    # genie baseline: gains known exactly -> plain LMMSE on active support
    Phi_g = b_true[:, None] * Phi
    c_lmmse = jnp.linalg.solve(
        Phi_g.conj().T @ Phi_g + nv * beta * jnp.eye(Nc, dtype=Phi.dtype),
        Phi_g.conj().T @ y,
    )
    print(f"  genie known-gain LMMSE c NMSE = {nmse_db(c_lmmse, c_true):7.2f} dB "
          "(dense; no sparsity)")


if __name__ == "__main__":
    main()
