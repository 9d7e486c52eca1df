"""Hyperspectral unmixing with HUTAMP (pure-pixel synthetic scene).

The reference's ``examples/hyperspectral/HU_pure_pixel.m``: a scene of
N pixels, each a convex combination of R endmember spectra, observed in
T bands with noise.  HUTAMP factors Y ~= S.A with non-negative spectra A
and simplex-constrained abundances S (sum-to-one pseudo-band + EM noise
refits, ``solvers/hutamp.py``).

Run: python examples/hyperspectral_unmixing.py [--cpu]
"""
import os
import sys
from itertools import permutations

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from jstsp19.solvers import hutamp


def main():
    key = jax.random.key(5)
    N, T, R = 600, 48, 3
    t = np.linspace(0, 1, T)
    # smooth positive "mineral" spectra
    A_true = np.stack(
        [
            0.2 + np.exp(-0.5 * ((t - 0.25) / 0.08) ** 2),
            0.3 + 0.8 * np.exp(-0.5 * ((t - 0.6) / 0.15) ** 2),
            0.1 + 0.5 * t + 0.4 * np.exp(-0.5 * ((t - 0.9) / 0.1) ** 2),
        ]
    ).astype(np.float32)
    # Dirichlet abundances + a few pure pixels per material
    e = jax.random.exponential(jax.random.fold_in(key, 0), (N, R))
    S_true = np.array(e / jnp.sum(e, axis=1, keepdims=True))
    for r in range(R):
        S_true[r * 5 : r * 5 + 5] = np.eye(R)[r]
    S_true = jnp.asarray(S_true)
    Z = S_true @ jnp.asarray(A_true)
    nv = 1e-4 * float(jnp.mean(Z**2))
    Y = Z + jnp.sqrt(nv) * jax.random.normal(jax.random.fold_in(key, 1), (N, T))

    res = hutamp(Y, R, jax.random.fold_in(key, 2), nit=150, n_em=3, step=0.3)

    znmse = float(jnp.sum((res.Z - Z) ** 2) / jnp.sum(Z**2))
    Ae = np.asarray(res.A)
    # permutation-align endmembers by cosine similarity
    best_p, best_c = None, -1.0
    for p in permutations(range(R)):
        c = np.mean(
            [
                np.dot(Ae[p[r]], A_true[r])
                / (np.linalg.norm(Ae[p[r]]) * np.linalg.norm(A_true[r]) + 1e-12)
                for r in range(R)
            ]
        )
        if c > best_c:
            best_p, best_c = p, c
    sad = [
        float(np.degrees(np.arccos(np.clip(
            np.dot(Ae[best_p[r]], A_true[r])
            / (np.linalg.norm(Ae[best_p[r]]) * np.linalg.norm(A_true[r]) + 1e-12),
            -1.0, 1.0,
        ))))
        for r in range(R)
    ]
    print(f"== HUTAMP unmixing: N={N} pixels, T={T} bands, R={R} materials ==")
    print(f"  scene reconstruction NMSE = {10 * np.log10(znmse + 1e-12):.2f} dB")
    print(f"  abundance rows on simplex: min={float(jnp.min(res.S)):.2e}, "
          f"row-sum err={float(jnp.max(jnp.abs(jnp.sum(res.S, 1) - 1))):.2e}")
    for r in range(R):
        print(f"  endmember {r}: spectral angle = {sad[r]:5.2f} deg")


if __name__ == "__main__":
    main()
