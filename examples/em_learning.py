"""EM hyper-parameter learning demos: EM-BG-AMP, EM-GM-AMP, noise autotune.

The solver learns the prior (activity, mixture weights/means/variances)
and the noise level from the data alone — the ``EMGMAMP(new)/`` and
``CAwgnEstimOut.m`` (tune flags) capabilities.

Run: python examples/em_learning.py [--cpu]
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
from jstsp19.solvers import em_bg_vamp, em_gm_vamp


def main():
    rng = np.random.default_rng(0)
    n, m, wvar = 512, 300, 1e-3

    # ---- EM-BG: unknown sparsity + noise -----------------------------
    k = 40
    x = np.zeros(n, complex)
    idx = rng.choice(n, k, False)
    x[idx] = (rng.standard_normal(k) + 1j * rng.standard_normal(k)) / np.sqrt(2)
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(
        2 * m
    )
    y = A @ x + np.sqrt(wvar / 2) * (
        rng.standard_normal(m) + 1j * rng.standard_normal(m)
    )
    res = em_bg_vamp(jnp.asarray(y, jnp.complex64), MatrixOp(jnp.asarray(A, jnp.complex64)))
    nmse = 10 * np.log10(
        float(np.sum(np.abs(np.asarray(res.x) - x) ** 2) / np.sum(np.abs(x) ** 2))
    )
    print("== EM-BG-AMP (unknown sparsity/noise) ==")
    print(f"  true sparsity {k/n:.3f}  learned {float(jnp.mean(res.prior.p1)):.3f}")
    print(f"  true wvar {wvar:.1e}     learned {float(res.noise_var):.1e}")
    print(f"  NMSE = {nmse:.2f} dB")

    # ---- EM-GM: two-scale complex Gaussian-mixture amplitudes ---------
    beta = 0.08
    act = rng.random(n) < beta
    big = rng.random(n) < 0.5
    amp = np.where(big, 3.0, 0.5)
    x2 = np.where(
        act,
        amp * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2),
        0,
    )
    A2 = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(
        2 * m
    )
    nv2 = 1e-3 * float(np.mean(np.abs(x2) ** 2)) * n / m
    y2 = A2 @ x2 + np.sqrt(nv2 / 2) * (
        rng.standard_normal(m) + 1j * rng.standard_normal(m)
    )
    res2 = em_gm_vamp(
        jnp.asarray(y2, jnp.complex64), MatrixOp(jnp.asarray(A2, jnp.complex64)),
        n_components=3, n_em=10, nit=40,
    )
    nmse2 = 10 * np.log10(
        float(np.sum(np.abs(np.asarray(res2.x) - x2) ** 2) / np.sum(np.abs(x2) ** 2))
    )
    print("== EM-GM-AMP (two-scale complex mixture amplitudes) ==")
    print(f"  true activity {beta:.3f}  learned {float(res2.prior.p1):.3f}")
    print(f"  true wvar {nv2:.2e}    learned {float(res2.noise_var):.2e}")
    print(f"  NMSE = {nmse2:.2f} dB")


if __name__ == "__main__":
    main()
