"""main/ utility stragglers (round 5): genSparseMat, pcgHelper,
s_transform analogs — `MPbased_solvers/main/{genSparseMat,pcgHelper,
s_transform}.m`."""
import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.ops import MatrixOp, genie_normal_matvec, sparse_signed_op
from jstsp19.solvers import s_transform


def test_sparse_signed_op_structure(key):
    nz, nx, d = 40, 16, 5
    op = sparse_signed_op(key, nz, nx, d)
    A = np.asarray(op.A)
    assert A.shape == (nz, nx)
    scale = np.sqrt(nz / (d * nx))
    # exactly d nonzeros per column, every value ±scale
    nnz = (A != 0).sum(axis=0)
    np.testing.assert_array_equal(nnz, d)
    vals = np.abs(A[A != 0])
    np.testing.assert_allclose(vals, scale, rtol=1e-6)
    # both signs occur (Rademacher draw, not the 0/1 expander)
    assert (A > 0).any() and (A < 0).any()
    # adjoint contract through the MatrixOp protocol
    x = np.random.default_rng(0).standard_normal(nx).astype(np.float32)
    y = np.random.default_rng(1).standard_normal(nz).astype(np.float32)
    lhs = np.vdot(y, np.asarray(op.mv(jnp.asarray(x))))
    rhs = np.vdot(np.asarray(op.rmv(jnp.asarray(y))), x)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


def test_genie_normal_matvec_matches_explicit_and_cg(key):
    rng = np.random.default_rng(2)
    M, N = 12, 24
    A = (rng.standard_normal((M, N)) + 1j * rng.standard_normal((M, N))) / np.sqrt(
        2 * M
    )
    op = MatrixOp(jnp.asarray(A, jnp.complex64))
    support = jnp.asarray(rng.random(N) < 0.3)
    reg = 0.07
    x = jnp.asarray(
        rng.standard_normal(M) + 1j * rng.standard_normal(M), jnp.complex64
    )
    mv = genie_normal_matvec(op, reg, support)
    S = np.asarray(support)
    expl = (A[:, S] @ A[:, S].conj().T + reg * np.eye(M)) @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(mv(x)), expl, rtol=1e-4, atol=1e-5)
    # the muGampExample.m:92 usage: solve the genie normal equations
    # matrix-free with CG and compare against the dense solve
    sol, _ = jax.scipy.sparse.linalg.cg(mv, x, tol=1e-10, maxiter=200)
    dense = np.linalg.solve(
        A[:, S] @ A[:, S].conj().T + reg * np.eye(M), np.asarray(x)
    )
    np.testing.assert_allclose(np.asarray(sol), dense, rtol=1e-3, atol=1e-4)


def test_s_transform_identity_spectrum():
    """All eigenvalues equal c → η(γ)=1/(1+cγ) is invertible in closed
    form and S(y)=1/c for every interior y; endpoints follow the
    reference's conventions (s_transform.m:78-80)."""
    c, N = 2.5, 64
    eigs = np.full(N, c, np.float32)
    y = jnp.asarray([-0.9, -0.5, -0.1, -0.01])
    out = np.asarray(s_transform(y, eigs, N))
    np.testing.assert_allclose(out, 1.0 / c, rtol=1e-4)
    assert float(s_transform(0.0, eigs, N)) == 1.0
    assert np.isinf(float(s_transform(-1.0, eigs, N)))


def test_s_transform_matches_scalar_bisection():
    """Random low-rank PSD spectrum: the vectorized fixed-count bisection
    must agree with a scalar numpy root-find of η(γ)=1+y."""
    rng = np.random.default_rng(3)
    N, R = 32, 20
    eigs = np.sort(rng.random(R).astype(np.float32))[::-1] * 3.0
    lam = np.concatenate([eigs, np.zeros(N - R, np.float32)])

    def eta(g):
        return np.mean(1.0 / (1.0 + lam * g))

    ys = np.array([-0.6, -0.3, -0.05]) * R / N
    ref = []
    for y in ys:
        lo, hi = 0.0, 1e8
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if eta(mid) < 1 + y:
                hi = mid
            else:
                lo = mid
        g = 0.5 * (lo + hi)
        ref.append(-(y + 1) / y * g)
    out = np.asarray(s_transform(jnp.asarray(ys, jnp.float32), eigs, N))
    np.testing.assert_allclose(out, ref, rtol=1e-3)
