"""Basic GAMP walkthrough: the reference's ``examples/basic/`` quartet.

Three classical problems solved through the same ``gamp_est`` interface:

1. dense Gaussian x, real AWGN measurements — GAMP converges to the
   closed-form LMMSE solution (``examples/basic/simpleAWGN.m``);
2. dense complex-Gaussian x, complex AWGN — same, natively complex
   (``examples/basic/simpleCAWGN.m``, ``AWGsignal_CAWGNmeas.m``);
3. a near-noninformative prior — GAMP approaches the regularized
   least-squares / pseudo-inverse answer (``examples/basic/simpleLS.m``).

Run: python examples/basic_gamp.py [--cpu]
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
from jstsp19.ops import MatrixOp
from jstsp19.solvers import (
    AwgnPrior,
    CAwgnLikelihood,
    CAwgnPrior,
    GampOptions,
    gamp_est,
)


def nmse_db(xhat, x):
    return 10 * np.log10(
        float(jnp.sum(jnp.abs(xhat - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    )


def main():
    m, n, wvar = 300, 100, 0.01
    opt = GampOptions(nit=50, adapt_step=False, step=1.0, tol=1e-8)

    # -- 1. real Gaussian x, AWGN (simpleAWGN.m) --------------------------
    k = jax.random.PRNGKey(0)
    ka, kx, kw = jax.random.split(k, 3)
    A = jax.random.normal(ka, (m, n)) / jnp.sqrt(m)
    x = jax.random.normal(kx, (n,))
    y = A @ x + jnp.sqrt(wvar) * jax.random.normal(kw, (m,))
    fin, _, _ = gamp_est(
        AwgnPrior(mean0=0.0, var0=1.0), CAwgnLikelihood(y=y, wvar=wvar),
        MatrixOp(A), opt,
    )
    # closed-form LMMSE: (AᵀA + wvar·I)⁻¹ Aᵀ y (prior var 1)
    x_lmmse = jnp.linalg.solve(A.T @ A + wvar * jnp.eye(n), A.T @ y)
    print("== simpleAWGN: dense Gaussian x, real AWGN ==")
    print(f"  GAMP  NMSE = {nmse_db(fin.xhat, x):7.2f} dB")
    print(f"  LMMSE NMSE = {nmse_db(x_lmmse, x):7.2f} dB")
    print(f"  ||GAMP - LMMSE|| / ||LMMSE|| = "
          f"{float(jnp.linalg.norm(fin.xhat - x_lmmse) / jnp.linalg.norm(x_lmmse)):.2e}")

    # -- 2. complex Gaussian x, complex AWGN (simpleCAWGN.m) --------------
    k = jax.random.PRNGKey(1)
    Ac = prng.complex_normal(jax.random.fold_in(k, 0), (m, n), var=1.0 / m)
    xc = prng.complex_normal(jax.random.fold_in(k, 1), (n,))
    yc = Ac @ xc + prng.complex_normal(jax.random.fold_in(k, 2), (m,), var=wvar)
    fin, _, _ = gamp_est(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0, jnp.float32)),
        CAwgnLikelihood(y=yc, wvar=wvar), MatrixOp(Ac), opt,
    )
    xc_lmmse = jnp.linalg.solve(
        Ac.conj().T @ Ac + wvar * jnp.eye(n, dtype=Ac.dtype), Ac.conj().T @ yc
    )
    print("== simpleCAWGN: complex Gaussian x, complex AWGN ==")
    print(f"  GAMP  NMSE = {nmse_db(fin.xhat, xc):7.2f} dB")
    print(f"  LMMSE NMSE = {nmse_db(xc_lmmse, xc):7.2f} dB")

    # -- 3. near-noninformative prior → least squares (simpleLS.m) --------
    big = 1e4
    fin, _, _ = gamp_est(
        AwgnPrior(mean0=0.0, var0=big), CAwgnLikelihood(y=y, wvar=wvar),
        MatrixOp(A), opt,
    )
    x_ls, *_ = jnp.linalg.lstsq(A, y)
    print("== simpleLS: flat prior -> least squares ==")
    print(f"  GAMP NMSE = {nmse_db(fin.xhat, x):7.2f} dB, "
          f"LS NMSE = {nmse_db(x_ls, x):7.2f} dB")
    print(f"  ||GAMP - LS|| / ||LS|| = "
          f"{float(jnp.linalg.norm(fin.xhat - x_ls) / jnp.linalg.norm(x_ls)):.2e}")


if __name__ == "__main__":
    main()
