"""Application-family demos: one small instance per capability.

Mirrors the reference's application example directories
(``MPbased_solvers/phase/``, ``classification/``, ``PBiGAMP/``,
``HUTAMP/``): phase retrieval with PR-GAMP, sparse logistic
classification, self-calibration with parametric bilinear GAMP, and
hyperspectral unmixing.

Run: python examples/applications.py [--cpu]
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
    CAwgnPrior,
    LogitLikelihood,
    MagnitudeLikelihood,
    SparsePrior,
    gamp,
    hutamp,
    pbigamp,
)


def phase_retrieval():
    key = jax.random.key(5)
    n, m = 64, 384
    A = prng.complex_normal(jax.random.fold_in(key, 0), (m, n)) / np.sqrt(n)
    x = prng.complex_normal(jax.random.fold_in(key, 1), (n,))
    wvar = 1e-4 * float(jnp.mean(jnp.abs(A @ x) ** 2))
    y = jnp.abs(A @ x + prng.complex_normal(jax.random.fold_in(key, 2), (m,), var=wvar))
    Mspec = A.conj().T @ (y[:, None] ** 2 * A) / m
    x0 = jnp.linalg.eigh(Mspec)[1][:, -1] * jnp.sqrt(n * 1.0)
    res = gamp(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0, jnp.float32)),
        MagnitudeLikelihood(y, jnp.asarray(wvar, jnp.float32)),
        MatrixOp(A), nit=150, step=0.5, x_init=x0,
    )
    ph = jnp.vdot(res.x, x)
    ph = ph / jnp.maximum(jnp.abs(ph), 1e-30)
    nmse = float(jnp.sum(jnp.abs(ph * res.x - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    print(f"  phase retrieval (m=6n)      NMSE = {nmse:.2e}")


def classification():
    key = jax.random.key(7)
    n, p, k, scale = 128, 800, 8, 3.0
    X = jax.random.normal(jax.random.fold_in(key, 0), (p, n)) / np.sqrt(k)
    idx = jax.random.choice(jax.random.fold_in(key, 1), n, (k,), replace=False)
    w = jnp.zeros((n,), jnp.float32).at[idx].set(
        jax.random.normal(jax.random.fold_in(key, 2), (k,))
    )
    y = (
        jax.random.uniform(jax.random.fold_in(key, 3), (p,))
        < jax.nn.sigmoid(scale * (X @ w))
    ).astype(jnp.float32)
    prior = SparsePrior(
        AwgnPrior(jnp.asarray(0.0), jnp.asarray(1.0, jnp.float32)),
        jnp.asarray(k / n, jnp.float32),
    )
    res = gamp(prior, LogitLikelihood(y, scale), MatrixOp(X), nit=60, step=0.5)
    corr = float(
        jnp.abs(jnp.vdot(res.x, w))
        / jnp.maximum(jnp.linalg.norm(res.x) * jnp.linalg.norm(w), 1e-30)
    )
    print(f"  logit classification        weight corr = {corr:.3f}")


def self_calibration():
    key = jax.random.key(11)
    M, Nc, k = 96, 128, 8
    Phi = prng.complex_normal(jax.random.fold_in(key, 0), (M, Nc)) / np.sqrt(M)
    beta = k / Nc
    act = jax.random.uniform(jax.random.fold_in(key, 1), (Nc,)) < beta
    c = jnp.where(
        act, prng.complex_normal(jax.random.fold_in(key, 2), (Nc,), var=1 / beta), 0.0
    )
    b = 1.0 + prng.complex_normal(jax.random.fold_in(key, 3), (M,), var=0.05)
    z = b * (Phi @ c)
    nv = 1e-4 * float(jnp.mean(jnp.abs(z) ** 2))
    y = z + prng.complex_normal(jax.random.fold_in(key, 4), (M,), var=nv)
    A = jnp.zeros((M, M, Nc), jnp.complex64).at[
        jnp.arange(M), jnp.arange(M), :
    ].set(Phi)
    res = pbigamp(
        y, A,
        CAwgnPrior(jnp.asarray(1.0 + 0j), jnp.asarray(0.05, jnp.float32)),
        SparsePrior(
            CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / beta, jnp.float32)),
            jnp.asarray(beta, jnp.float32),
        ),
        nv, jax.random.fold_in(key, 5), nit=200, step=0.5,
    )
    nmse = float(jnp.sum(jnp.abs(res.z - z) ** 2) / jnp.sum(jnp.abs(z) ** 2))
    print(f"  self-calibration (PBiGAMP)  z-NMSE = {nmse:.2e}")


def unmixing():
    key = jax.random.key(9)
    N, T, R = 400, 48, 3
    t = np.linspace(0, 1, T)
    A_true = np.stack(
        [
            0.2 + np.exp(-0.5 * ((t - 0.25) / 0.08) ** 2),
            0.3 + 0.8 * np.exp(-0.5 * ((t - 0.6) / 0.15) ** 2),
            0.1 + 0.5 * t + 0.4 * np.exp(-0.5 * ((t - 0.9) / 0.1) ** 2),
        ]
    ).astype(np.float32)
    e = jax.random.exponential(jax.random.fold_in(key, 0), (N, R))
    S = e / jnp.sum(e, axis=1, keepdims=True)
    Z = S @ jnp.asarray(A_true)
    nv = 1e-4 * float(jnp.mean(Z**2))
    Y = Z + jnp.sqrt(nv) * jax.random.normal(jax.random.fold_in(key, 1), (N, T))
    res = hutamp(Y, R, jax.random.fold_in(key, 2), nit=150, n_em=3, step=0.3)
    nmse = float(jnp.sum((res.Z - Z) ** 2) / jnp.sum(Z**2))
    print(f"  hyperspectral unmixing      Z-NMSE = {nmse:.2e}")


if __name__ == "__main__":
    print("application-family demos:")
    phase_retrieval()
    classification()
    self_calibration()
    unmixing()
