import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.core import prng
from jstsp19.solvers.bigamp import bigamp, bigamp_mc
from jstsp19.solvers.estim import CAwgnPrior, SparsePrior


def test_bigamp_matrix_completion():
    key = jax.random.key(0)
    L, M, R = 40, 60, 3
    A = prng.complex_normal(jax.random.fold_in(key, 0), (L, R))
    X = prng.complex_normal(jax.random.fold_in(key, 1), (R, M))
    Z = A @ X
    mask = (jax.random.uniform(jax.random.fold_in(key, 2), (L, M)) < 0.6).astype(
        jnp.float32
    )
    nv = 1e-3
    Y = mask * (Z + prng.complex_normal(jax.random.fold_in(key, 3), (L, M), var=nv))
    res = bigamp_mc(Y, mask, R, nv, jax.random.fold_in(key, 4), nit=300, step=0.5)
    nmse = float(jnp.sum(jnp.abs(res.Z - Z) ** 2) / jnp.sum(jnp.abs(Z) ** 2))
    assert nmse < 1e-3, nmse


def test_bigamp_dictionary_learning_sparse_codes():
    # DL flavor: sparse prior on X — product should still be recovered.
    key = jax.random.key(1)
    L, M, R = 32, 80, 4
    beta = 0.3
    A = prng.complex_normal(jax.random.fold_in(key, 0), (L, R))
    act = jax.random.uniform(jax.random.fold_in(key, 1), (R, M)) < beta
    X = jnp.where(
        act, prng.complex_normal(jax.random.fold_in(key, 2), (R, M), var=1 / beta), 0.0
    )
    Z = A @ X
    nv = 1e-3
    Y = Z + prng.complex_normal(jax.random.fold_in(key, 3), (L, M), var=nv)
    pa = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    px = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    res = bigamp(
        Y, jnp.ones((L, M), jnp.float32), R, pa, px, nv,
        jax.random.fold_in(key, 4), nit=300, step=0.4,
    )
    nmse = float(jnp.sum(jnp.abs(res.Z - Z) ** 2) / jnp.sum(jnp.abs(Z) ** 2))
    assert nmse < 5e-2, nmse


def test_bigamp_rpca_low_rank_plus_outliers():
    from jstsp19.solvers.bigamp import bigamp_rpca

    key = jax.random.key(2)
    L, M, R = 40, 50, 2
    A = prng.complex_normal(jax.random.fold_in(key, 0), (L, R))
    X = prng.complex_normal(jax.random.fold_in(key, 1), (R, M))
    Z = A @ X
    # 5% gross outliers
    out_mask = jax.random.uniform(jax.random.fold_in(key, 2), (L, M)) < 0.05
    E = jnp.where(
        out_mask,
        prng.complex_normal(jax.random.fold_in(key, 3), (L, M), var=50.0),
        0.0,
    )
    nv = 1e-3
    Y = Z + E + prng.complex_normal(jax.random.fold_in(key, 4), (L, M), var=nv)
    res = bigamp_rpca(Y, R, nv, outlier_var=50.0, outlier_frac=0.05,
                      key=jax.random.fold_in(key, 5), nit=300)
    nmse = float(jnp.sum(jnp.abs(res.Z - Z) ** 2) / jnp.sum(jnp.abs(Z) ** 2))
    assert nmse < 5e-2, nmse
    # plain (non-robust) completion on the same data is much worse
    res_plain = bigamp_mc(Y, jnp.ones_like(Y.real), R, nv,
                          jax.random.fold_in(key, 5), nit=300, step=0.5)
    nmse_plain = float(
        jnp.sum(jnp.abs(res_plain.Z - Z) ** 2) / jnp.sum(jnp.abs(Z) ** 2)
    )
    assert nmse < nmse_plain


def test_em_bigamp_mc_learns_noise_and_rank():
    """EM-BiGAMP-MC: true rank 3 run at max_rank 8 — the learned component
    energies must separate true from spurious, and the noise variance
    must land near truth."""
    from jstsp19.solvers.bigamp import em_bigamp_mc
    from jstsp19.core import prng

    key = jax.random.key(13)
    L, M, R, maxR = 40, 56, 3, 8
    A = prng.complex_normal(jax.random.fold_in(key, 0), (L, R))
    X = prng.complex_normal(jax.random.fold_in(key, 1), (R, M))
    Z = A @ X
    nv_true = 1e-3 * float(jnp.mean(jnp.abs(Z) ** 2))
    mask = (jax.random.uniform(jax.random.fold_in(key, 3), (L, M)) < 0.6).astype(
        jnp.float32
    )
    Y = mask * (
        Z + prng.complex_normal(jax.random.fold_in(key, 2), (L, M), var=nv_true)
    )

    res = em_bigamp_mc(
        Y, mask, maxR, jax.random.fold_in(key, 4), nit=300, n_em=3, step=0.5
    )
    nmse = float(jnp.sum(jnp.abs(res.Z - Z) ** 2) / jnp.sum(jnp.abs(Z) ** 2))
    assert nmse < 1e-2, nmse
    assert res.rank == R, (res.rank, res.bic)
    assert 0.2 * nv_true < float(res.noise_var) < 5 * nv_true


def test_em_bigamp_dl_learns_sparse_codes():
    """EM-BiGAMP dictionary learning (EMBiGAMP_DL.m capability): recover a
    dictionary-sparse factorization and its hyperparameters (activity,
    slab variance, noise) from data alone."""
    from jstsp19.solvers.bigamp import em_bigamp_dl

    key = jax.random.PRNGKey(7)
    L, R, M = 24, 5, 400
    lam_true = 0.15
    kA, kX, kS, kN = jax.random.split(key, 4)
    A = (jax.random.normal(kA, (L, R)) + 1j * jax.random.normal(
        jax.random.fold_in(kA, 1), (L, R))) / np.sqrt(2)
    support = jax.random.uniform(kS, (R, M)) < lam_true
    X = support * (jax.random.normal(kX, (R, M)) + 1j * jax.random.normal(
        jax.random.fold_in(kX, 1), (R, M))) / np.sqrt(2)
    Z = A @ X
    nv = 1e-4 * float(jnp.mean(jnp.abs(Z) ** 2))
    noise = jnp.sqrt(nv / 2) * (jax.random.normal(kN, (L, M))
                                + 1j * jax.random.normal(jax.random.fold_in(kN, 1), (L, M)))
    Y = Z + noise

    res = em_bigamp_dl(Y, rank=R, key=jax.random.PRNGKey(3))
    err = float(jnp.sum(jnp.abs(res.Z - Z) ** 2) / jnp.sum(jnp.abs(Z) ** 2))
    assert err < 0.05
    # hyperparameters learned to the right scale
    assert 0.05 < float(res.sparsity) < 0.45
    assert float(res.noise_var) < 0.05 * float(jnp.mean(jnp.abs(Z) ** 2))
