from itertools import permutations

import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.solvers.hutamp import hutamp


def test_hutamp_unmixes_synthetic_scene():
    """Three smooth positive endmembers, Dirichlet abundances: the
    reconstruction and the (permutation-aligned) endmembers must match."""
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
    S_true = e / jnp.sum(e, axis=1, keepdims=True)
    Z_true = S_true @ jnp.asarray(A_true)
    nv = 1e-4 * float(jnp.mean(Z_true**2))
    Y = Z_true + jnp.sqrt(nv) * jax.random.normal(jax.random.fold_in(key, 1), (N, T))

    res = hutamp(Y, R, jax.random.fold_in(key, 2), nit=150, n_em=3, step=0.3)
    znmse = float(jnp.sum((res.Z - Z_true) ** 2) / jnp.sum(Z_true**2))
    assert znmse < 0.01, znmse
    # abundances live on the simplex
    assert float(jnp.min(res.S)) >= 0.0
    np.testing.assert_allclose(np.asarray(jnp.sum(res.S, axis=1)), 1.0, atol=1e-5)
    # endmembers match up to permutation
    Ae = np.asarray(res.A)
    best = max(
        np.mean(
            [
                np.dot(Ae[p[r]], A_true[r])
                / (np.linalg.norm(Ae[p[r]]) * np.linalg.norm(A_true[r]) + 1e-12)
                for r in range(R)
            ]
        )
        for p in permutations(range(R))
    )
    assert best > 0.93, best
