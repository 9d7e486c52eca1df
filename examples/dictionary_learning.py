"""Bilinear GAMP demos: EM matrix completion with rank selection,
BiG-AMP-Lite's cheap all-Gaussian fast path, and EM dictionary learning.

The ``BiGAMP/`` capability family (``EMBiGAMP_MC.m``, ``BiGAMP_Lite.m``,
``EMBiGAMP_DL.m``): recover Z = A·X from partial / noisy observations with
both factors unknown.

Run: python examples/dictionary_learning.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from jstsp19.solvers import bigamp_lite, em_bigamp_dl, em_bigamp_mc


def nmse_db(Zhat, Z):
    return 10 * np.log10(
        float(np.sum(np.abs(np.asarray(Zhat) - Z) ** 2) / np.sum(np.abs(Z) ** 2))
    )


def main():
    rng = np.random.default_rng(0)

    # ---- EM matrix completion with BIC rank selection ------------------
    L, M, R, nv = 64, 64, 4, 1e-4
    A0 = (rng.standard_normal((L, R)) + 1j * rng.standard_normal((L, R))) / np.sqrt(2)
    X0 = (rng.standard_normal((R, M)) + 1j * rng.standard_normal((R, M))) / np.sqrt(2)
    Z0 = A0 @ X0
    mask = (rng.random((L, M)) < 0.5).astype(float)
    Y = (Z0 + np.sqrt(nv / 2) * (rng.standard_normal((L, M))
                                 + 1j * rng.standard_normal((L, M)))) * mask
    res = em_bigamp_mc(
        jnp.asarray(Y, jnp.complex64), jnp.asarray(mask, jnp.float32), 8,
        jax.random.PRNGKey(0), nit=300, n_em=3, step=0.5,
    )
    print("== EM-BiG-AMP matrix completion (50% observed, true rank 4) ==")
    print(f"  selected rank = {res.rank},  NMSE = {nmse_db(res.Z, Z0):.2f} dB")

    # ---- BiG-AMP-Lite: closed-form all-Gaussian fast path ---------------
    r_lite, hist = bigamp_lite(
        jnp.asarray(Y, jnp.complex64), jnp.asarray(mask, jnp.float32), R,
        1.0, 1.0, nv, jax.random.PRNGKey(0), nit=400, step=0.05,
    )
    print("== BiG-AMP-Lite (three matmuls per iteration) ==")
    print(
        f"  NMSE = {nmse_db(r_lite.Z, Z0):.2f} dB, "
        f"adaptive pass rate = {float(np.asarray(hist['passed']).mean()):.2f}"
    )

    # ---- EM dictionary learning -----------------------------------------
    L, R, M, lam_true = 24, 5, 400, 0.15
    D0 = (rng.standard_normal((L, R)) + 1j * rng.standard_normal((L, R))) / np.sqrt(2)
    support = rng.random((R, M)) < lam_true
    C0 = support * (
        rng.standard_normal((R, M)) + 1j * rng.standard_normal((R, M))
    ) / np.sqrt(2)
    Zd = D0 @ C0
    nvd = 1e-4 * float(np.mean(np.abs(Zd) ** 2))
    Yd = Zd + np.sqrt(nvd / 2) * (
        rng.standard_normal((L, M)) + 1j * rng.standard_normal((L, M))
    )
    res_dl = em_bigamp_dl(jnp.asarray(Yd, jnp.complex64), R, jax.random.PRNGKey(1))
    print("== EM-BiG-AMP dictionary learning (15%-sparse codes) ==")
    print(
        f"  reconstruction NMSE = {nmse_db(res_dl.Z, Zd):.2f} dB, "
        f"learned sparsity = {float(res_dl.sparsity):.3f} (true {lam_true})"
    )


if __name__ == "__main__":
    main()
