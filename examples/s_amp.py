"""S-AMP on a non-i.i.d. (unitarily-invariant) measurement ensemble.

Standard AMP assumes an i.i.d.-subgaussian operator; on a spectrally
shaped ensemble (here: log-spaced singular values, condition 10) it
diverges.  The reference toolbox's answer is ``ampEst.m``'s exact-rvar
mode (``opt.Stransform``, ``ampEst.m:221-268``): the Onsager gain
becomes ``1 − 1/S(−xvar/rvar)`` and the denoiser-input variance solves
the fixed point ``rvar = wvar·S(−xvar/rvar)``, with ``S`` the
S-transform of the operator spectrum.  This script compares plain AMP,
S-AMP (``amp_est`` with ``evals_aah``), and VAMP-SLM (whose LMMSE stage
handles arbitrary spectra exactly) on the same instance.

Run: python examples/s_amp.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from jstsp19.ops import KronDictOp, MatrixOp
from jstsp19.solvers import amp, amp_est, vamp_slm
from jstsp19.solvers.estim import AwgnPrior, SparsePrior


def main():
    rng = np.random.default_rng(0)
    n, m, k, wvar, cond = 256, 128, 12, 1e-5, 10.0

    # unitarily-invariant A = U diag(s) V^T with log-spaced spectrum,
    # normalized to unit-norm columns on average
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, -np.log10(cond), m)
    A = U @ np.diag(s) @ V[:, :m].T
    A *= np.sqrt(n / np.sum(s**2))
    evals = jnp.asarray((s * np.sqrt(n / np.sum(s**2))) ** 2, jnp.float32)

    x = np.zeros(n)
    idx = rng.choice(n, k, False)
    x[idx] = rng.standard_normal(k)
    y = jnp.asarray(A @ x + np.sqrt(wvar) * rng.standard_normal(m), jnp.float32)

    op = MatrixOp(jnp.asarray(A, jnp.float32))
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=k / n)

    def nmse(xh):
        return float(np.sum((np.asarray(xh) - x) ** 2) / np.sum(x**2))

    print(f"{n}x{m} log-spectrum ensemble, condition {cond:.0f}, k={k}")
    print(f"  AMP (i.i.d. assumption)  NMSE = {nmse(amp(y, op, prior, nit=100)):.2e}")
    xs = amp_est(y, op, prior, nit=200, wvar=wvar, evals_aah=evals, damp=0.5)
    print(f"  S-AMP (exact rvar)       NMSE = {nmse(xs):.2e}")
    kop = KronDictOp(jnp.asarray(A, jnp.float32), jnp.eye(1, dtype=jnp.float32))
    xv = vamp_slm(prior, y[:, None], kop, gamw=1.0 / wvar, nit=50).x[:, 0]
    print(f"  VAMP-SLM                 NMSE = {nmse(xv):.2e}")


if __name__ == "__main__":
    main()
