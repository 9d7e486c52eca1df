"""End-to-end application capabilities of the solver toolbox.

Integration tests mirroring the reference's application example families
(``MPbased_solvers/phase/`` PR-GAMP, ``MPbased_solvers/MRI/`` compressed-
sensing MRI, ``MPbased_solvers/classification/`` logit GAMP, and
``MPbased_solvers/groupSparse/``): each drives a full solver loop, not just
estimator moments.
"""
import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.core import prng
from jstsp19.ops import MatrixOp, KronDictOp, DFTOp
from jstsp19.solvers.estim import (
    AwgnPrior,
    CAwgnLikelihood,
    CAwgnPrior,
    GroupSparsePrior,
    LogitLikelihood,
    MagnitudeLikelihood,
    SparsePrior,
)
from jstsp19.solvers.gamp import gamp


def test_phase_retrieval_gamp():
    """PR-GAMP (``phase/`` family): recover complex x from y = |Ax + w|
    with a spectral initialization; global phase aligned before scoring."""
    key = jax.random.key(5)
    n, m = 64, 384
    A = prng.complex_normal(jax.random.fold_in(key, 0), (m, n)) / np.sqrt(n)
    x = prng.complex_normal(jax.random.fold_in(key, 1), (n,))
    z = A @ x
    wvar = 1e-4 * float(jnp.mean(jnp.abs(z) ** 2))
    y = jnp.abs(z + prng.complex_normal(jax.random.fold_in(key, 2), (m,), var=wvar))

    # spectral init: leading eigenvector of Aᴴ diag(y²) A
    Mspec = A.conj().T @ (y[:, None] ** 2 * A) / m
    _, evecs = jnp.linalg.eigh(Mspec)
    x0 = evecs[:, -1] * jnp.sqrt(n * 1.0)

    prior = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0, jnp.float32))
    lik = MagnitudeLikelihood(y, jnp.asarray(wvar, jnp.float32))
    res = gamp(prior, lik, MatrixOp(A), nit=150, step=0.5, x_init=x0)
    ph = jnp.vdot(res.x, x)
    ph = ph / jnp.maximum(jnp.abs(ph), 1e-30)
    nmse = float(jnp.sum(jnp.abs(ph * res.x - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert nmse < 1e-3, nmse


def test_cs_mri_partial_fourier_gamp():
    """CS-MRI (``MRI/`` family): sparse signal from randomly subsampled
    unitary DFT measurements; unobserved bins get a huge noise variance
    (zero information) so the mask stays shape-static under jit."""
    key = jax.random.key(6)
    n, k, keep = 256, 16, 96
    kx, ki, kn, km = jax.random.split(key, 4)
    idx = jax.random.choice(ki, n, (k,), replace=False)
    beta = k / n
    x = jnp.zeros((n,), jnp.complex64).at[idx].set(
        prng.complex_normal(kx, (k,), var=1 / beta)
    )
    op = DFTOp(n)
    z = op.mv(x)
    nv = 1e-4 * float(jnp.mean(jnp.abs(z) ** 2))
    y_full = z + prng.complex_normal(kn, (n,), var=nv)
    sel = np.zeros(n, bool)
    sel[np.asarray(jax.random.choice(km, n, (keep,), replace=False))] = True
    mask = jnp.asarray(sel)
    wvar = jnp.where(mask, nv, 1e6).astype(jnp.float32)
    y = jnp.where(mask, y_full, 0.0)

    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    res = gamp(prior, CAwgnLikelihood(y, wvar), op, nit=100)
    nmse = float(jnp.sum(jnp.abs(res.x - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert nmse < 0.05, nmse


def test_logit_classification_gamp():
    """Sparse logistic regression (``classification/`` family): recover the
    direction of a sparse weight vector from binary labels."""
    key = jax.random.key(7)
    n, p, k, scale = 128, 800, 8, 3.0
    kX, kw, ki, ky = jax.random.split(key, 4)
    X = jax.random.normal(kX, (p, n)) / np.sqrt(k)
    idx = jax.random.choice(ki, n, (k,), replace=False)
    w = jnp.zeros((n,), jnp.float32).at[idx].set(jax.random.normal(kw, (k,)))
    pr = jax.nn.sigmoid(scale * (X @ w))
    y = (jax.random.uniform(ky, (p,)) < pr).astype(jnp.float32)

    prior = SparsePrior(
        AwgnPrior(jnp.asarray(0.0), jnp.asarray(1.0, jnp.float32)),
        jnp.asarray(k / n, jnp.float32),
    )
    res = gamp(prior, LogitLikelihood(y, scale), MatrixOp(X), nit=60, step=0.5)
    corr = float(
        jnp.abs(jnp.vdot(res.x, w))
        / jnp.maximum(jnp.linalg.norm(res.x) * jnp.linalg.norm(w), 1e-30)
    )
    assert corr > 0.85, corr
    # support detection: the true atoms should carry most of the energy
    topk = jnp.argsort(-jnp.abs(res.x))[:k]
    hits = len(set(np.asarray(topk).tolist()) & set(np.asarray(idx).tolist()))
    assert hits >= k - 2, hits


def test_group_sparse_gamp_beats_iid():
    """Group sparsity (``groupSparse/`` family): rows of X share activity;
    pooling the evidence over the group axis beats the iid prior at a
    measurement-starved operating point."""
    key = jax.random.key(8)
    G, Lg, m = 48, 8, 22
    kA, ka, kx, kn = jax.random.split(key, 4)
    A = prng.complex_normal(kA, (m, G)) / np.sqrt(m)
    B = jnp.eye(Lg, dtype=jnp.complex64)
    op = KronDictOp(A, B)
    p_act = 0.15
    act = jax.random.uniform(ka, (G, 1)) < p_act
    X = jnp.where(act, prng.complex_normal(kx, (G, Lg), var=1 / p_act), 0.0)
    nv = 1e-3 * float(jnp.mean(jnp.abs(op.mv(X)) ** 2))
    Y = op.mv(X) + prng.complex_normal(kn, (m, Lg), var=nv)
    lik = CAwgnLikelihood(Y, jnp.asarray(nv, jnp.float32))

    base = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / p_act, jnp.float32))
    res_grp = gamp(
        GroupSparsePrior(base, jnp.asarray(p_act, jnp.float32)), lik, op, nit=80
    )
    res_iid = gamp(
        SparsePrior(base, jnp.asarray(p_act, jnp.float32)), lik, op, nit=80
    )
    e_grp = float(jnp.sum(jnp.abs(res_grp.x - X) ** 2) / jnp.sum(jnp.abs(X) ** 2))
    e_iid = float(jnp.sum(jnp.abs(res_iid.x - X) ** 2) / jnp.sum(jnp.abs(X) ** 2))
    assert np.isfinite(e_grp)
    assert e_grp < e_iid, (e_iid, e_grp)
    assert e_grp < 0.05, e_grp
