"""Sparse-recovery solver comparison on one synthetic problem.

Compares OMP, CoSaMP, FISTA, AMP, GAMP, VAMP-SLM and EM-BG-VAMP on a
Bernoulli-Gaussian compressed-sensing instance (the `examples/sparseEstim`
flavor of the reference toolbox).

Run: python examples/sparse_recovery.py [--cpu]
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
from jstsp19.ops import MatrixOp, KronDictOp
from jstsp19.solvers import (
    omp, cosamp, fista, gamp, vamp_slm, em_bg_vamp, em_gm_vamp,
    CAwgnPrior, SparsePrior, CAwgnLikelihood,
)
from jstsp19.solvers.gamp import amp, sure_amp


def main():
    key = prng.experiment_key(0)
    m, n, k, snr_db = 128, 256, 12, 30.0
    kA, kx, ki, kn = jax.random.split(key, 4)
    A = prng.complex_normal(kA, (m, n)) / np.sqrt(m)
    idx = jax.random.choice(ki, n, (k,), replace=False)
    beta = k / n
    x = jnp.zeros((n,), jnp.complex64).at[idx].set(
        prng.complex_normal(kx, (k,), var=1 / beta)
    )
    y_clean = A @ x
    nv = float(jnp.mean(jnp.abs(y_clean) ** 2)) * 10 ** (-snr_db / 10)
    y = y_clean + prng.complex_normal(kn, (m,), var=nv)

    op = MatrixOp(A)
    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    lik = CAwgnLikelihood(y, jnp.asarray(nv, jnp.float32))

    def nmse(xh):
        return float(jnp.sum(jnp.abs(xh - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))

    results = {
        "OMP": nmse(omp(A, y, k).x),
        "CoSaMP": nmse(cosamp(A, y, k)),
        "FISTA": nmse(fista(y, op, lam=0.002, nit=300)),
        "AMP": nmse(amp(y, op, prior, nit=60)),
        "SURE-AMP": nmse(sure_amp(y, op, nit=60)),  # no prior parameters
        "GAMP": nmse(gamp(prior, lik, op, nit=80).x),
        # everything learned by EM (prior + noise), nothing hand-tuned
        "EM-GM-VAMP": nmse(em_gm_vamp(y, op, n_components=3, n_em=8, nit=40).x),
    }
    # VAMP-SLM needs the kron-structured operator protocol; wrap as 1-col kron
    kop = KronDictOp(A, jnp.eye(1, dtype=A.dtype))
    results["VAMP-SLM"] = nmse(
        vamp_slm(prior, y[:, None], kop, gamw=1.0 / nv, nit=50).x[:, 0]
    )
    results["EM-BG-VAMP"] = nmse(em_bg_vamp(y[:, None], kop, n_em=8, nit=40).x[:, 0])

    print(f"m={m}, n={n}, k={k}, SNR={snr_db} dB")
    for name, e in results.items():
        print(f"  {name:12s} NMSE = {e:.2e}")


if __name__ == "__main__":
    main()
