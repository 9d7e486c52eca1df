"""Operator contract tests: adjointness via the <Ax, y> == <x, A^H y>
identity (the ``testlintrans.m:28-42`` pattern) for every operator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.ops import (
    MatrixOp,
    ScaledOp,
    ComposedOp,
    KronDictOp,
    MaskOp,
    DiagOp,
    DFTOp,
    FWHTOp,
    fwht,
    ToeplitzOp,
)


def crandn(key, shape):
    k1, k2 = jax.random.split(key)
    return (jax.random.normal(k1, shape) + 1j * jax.random.normal(k2, shape)) / np.sqrt(2)


def inner(a, b):
    return np.vdot(np.asarray(a), np.asarray(b))  # conj(a)·b, any shape


def check_adjoint(op, key, atol=1e-4):
    kx, ky = jax.random.split(key)
    x = crandn(kx, op.in_shape)
    y = crandn(ky, op.out_shape)
    lhs = inner(y, op.mv(x))
    rhs = inner(op.rmv(y), x)
    assert abs(lhs - rhs) < atol * (1 + abs(lhs)), (lhs, rhs)


@pytest.mark.parametrize("seed", [0, 1])
def test_matrix_op_adjoint(seed):
    key = jax.random.key(seed)
    A = crandn(key, (7, 5))
    check_adjoint(MatrixOp(A), jax.random.fold_in(key, 9))


def test_scaled_and_composed_adjoint(key):
    A = crandn(key, (6, 4))
    B = crandn(jax.random.fold_in(key, 1), (4, 3))
    op = ComposedOp(ScaledOp(MatrixOp(A), jnp.asarray(1.5 - 0.5j)), MatrixOp(B))
    check_adjoint(op, jax.random.fold_in(key, 2))
    x = crandn(jax.random.fold_in(key, 3), (3,))
    ref = (1.5 - 0.5j) * (A @ (B @ x))
    np.testing.assert_allclose(np.asarray(op.mv(x)), np.asarray(ref), atol=1e-5)


def test_kron_dict_op_matches_materialized(key):
    A = crandn(key, (6, 4))
    B = crandn(jax.random.fold_in(key, 1), (3, 5))
    op = KronDictOp(A, B)
    S = crandn(jax.random.fold_in(key, 2), (4, 3))
    # kron(B.', A) acts on the column-major vec of S
    K2 = np.asarray(op.materialize())
    vec_cm = np.asarray(S).flatten(order="F")
    out = K2 @ vec_cm
    np.testing.assert_allclose(
        np.asarray(op.mv(S)).flatten(order="F"), out, atol=1e-4
    )
    check_adjoint(op, jax.random.fold_in(key, 3))


def test_kron_gram_consistency(key):
    A = crandn(key, (6, 4))
    B = crandn(jax.random.fold_in(key, 1), (3, 5))
    op = KronDictOp(A, B)
    S = crandn(jax.random.fold_in(key, 2), (4, 3))
    np.testing.assert_allclose(
        np.asarray(op.gram(S)), np.asarray(op.rmv(op.mv(S))), atol=1e-4
    )
    Y = crandn(jax.random.fold_in(key, 3), (6, 5))
    np.testing.assert_allclose(
        np.asarray(op.gram_out(Y)), np.asarray(op.mv(op.rmv(Y))), atol=1e-4
    )


def test_kron_eigbasis_diagonalizes_gram_out(key):
    A = crandn(key, (5, 4))
    B = crandn(jax.random.fold_in(key, 1), (3, 6))
    op = KronDictOp(A, B)
    Ua, Ub, d = op.gram_out_eig()
    Y = crandn(jax.random.fold_in(key, 2), (5, 6))
    # gram_out(Y) == from_eig( d * to_eig(Y) )
    lhs = op.gram_out(Y)
    rhs = op.from_eigbasis(Ua, Ub, d * op.to_eigbasis(Ua, Ub, Y))
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-4)


def test_kron_pinv_is_least_squares(key):
    A = crandn(key, (8, 3))
    B = crandn(jax.random.fold_in(key, 1), (2, 7))  # K2 is (56, 6) tall
    op = KronDictOp(A, B)
    Y = crandn(jax.random.fold_in(key, 2), (8, 7))
    S = op.pinv_rmv(Y)
    # least-squares optimality: residual orthogonal to range  =>  A^H r B^H = 0
    r = Y - op.mv(S)
    np.testing.assert_allclose(
        np.asarray(op.rmv(r)), np.zeros((3, 2)), atol=1e-4
    )


def test_mask_and_diag_ops(key):
    Om = (jax.random.uniform(key, (4, 6)) > 0.5).astype(jnp.float32)
    check_adjoint(MaskOp(Om), jax.random.fold_in(key, 1))
    d = crandn(jax.random.fold_in(key, 2), (9,))
    check_adjoint(DiagOp(d), jax.random.fold_in(key, 3))


def test_dft_op_unitary(key):
    op = DFTOp(16)
    x = crandn(key, (16,))
    np.testing.assert_allclose(np.asarray(op.rmv(op.mv(x))), np.asarray(x), atol=1e-5)
    check_adjoint(op, jax.random.fold_in(key, 1))


def _walsh_matrix_sequency(n):
    # Sylvester Hadamard, rows sorted by sign-change count.
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    changes = (np.diff(H, axis=1) != 0).sum(axis=1)
    return H[np.argsort(changes)]


@pytest.mark.parametrize("n", [8, 16, 32])
def test_fwht_sequency_matches_direct(n, key):
    x = jax.random.normal(key, (n,))
    ref = _walsh_matrix_sequency(n) @ np.asarray(x) / np.sqrt(n)
    np.testing.assert_allclose(np.asarray(fwht(x)), ref, atol=1e-4)


def test_fwht_op_self_inverse(key):
    op = FWHTOp(64)
    x = jax.random.normal(key, (64,)) + 0j
    np.testing.assert_allclose(np.asarray(op.rmv(op.mv(x))), np.asarray(x), atol=1e-4)
    check_adjoint(op, jax.random.fold_in(key, 1))


def test_toeplitz_op_matches_dense(key):
    col = crandn(key, (6,))
    row = crandn(jax.random.fold_in(key, 1), (4,)).at[0].set(col[0])
    op = ToeplitzOp(col, row)
    Tdense = np.asarray(op.materialize())
    assert Tdense.shape == (6, 4)
    # Toeplitz structure
    for i in range(1, 6):
        for j in range(1, 4):
            np.testing.assert_allclose(Tdense[i, j], Tdense[i - 1, j - 1], atol=1e-6)
    x = crandn(jax.random.fold_in(key, 2), (4,))
    np.testing.assert_allclose(np.asarray(op.mv(x)), Tdense @ np.asarray(x), atol=1e-4)
    check_adjoint(op, jax.random.fold_in(key, 3))


def test_sq_ops_nonnegative(key):
    A = crandn(key, (5, 4))
    op = MatrixOp(A)
    x = jax.random.uniform(key, (4,))
    assert np.all(np.asarray(op.sq_mv(x)) >= 0)
    # exact |A|^2 product
    np.testing.assert_allclose(
        np.asarray(op.sq_mv(x)), np.abs(np.asarray(A)) ** 2 @ np.asarray(x), atol=1e-5
    )


def test_blockdiag_op(key):
    from jstsp19.ops import BlockDiagOp

    A = crandn(key, (3, 5, 4))
    op = BlockDiagOp(A)
    check_adjoint(op, jax.random.fold_in(key, 1))
    x = crandn(jax.random.fold_in(key, 2), (3, 4))
    ref = np.stack([np.asarray(A[b]) @ np.asarray(x[b]) for b in range(3)])
    np.testing.assert_allclose(np.asarray(op.mv(x)), ref, atol=1e-5)


def test_concat_op(key):
    from jstsp19.ops import ConcatOp

    A1 = crandn(key, (6, 4))
    A2 = crandn(jax.random.fold_in(key, 1), (3, 4))
    op = ConcatOp((MatrixOp(A1), MatrixOp(A2)))
    x = crandn(jax.random.fold_in(key, 2), (4,))
    y1, y2 = op.mv(x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(A1) @ np.asarray(x), atol=1e-5)
    # adjoint identity over the stacked output
    ys = (crandn(jax.random.fold_in(key, 3), (6,)), crandn(jax.random.fold_in(key, 4), (3,)))
    lhs = inner(ys[0], y1) + inner(ys[1], y2)
    rhs = inner(op.rmv(ys), x)
    assert abs(lhs - rhs) < 1e-4 * (1 + abs(lhs))


def test_dct_matches_scipy_and_adjoint(key):
    import scipy.fft
    from jstsp19.ops import DCTOp, dct, idct

    for n in (8, 9, 32, 33):
        x = np.random.default_rng(n).normal(size=n).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(dct(jnp.asarray(x))),
            scipy.fft.dct(x, norm="ortho"),
            atol=2e-5,
        )
        np.testing.assert_allclose(
            np.asarray(idct(dct(jnp.asarray(x)))), x, atol=2e-5
        )
    op = DCTOp(32)
    x = jax.random.normal(key, (32,))
    y = jax.random.normal(jax.random.fold_in(key, 1), (32,))
    lhs = jnp.vdot(op.mv(x), y)
    rhs = jnp.vdot(x, op.rmv(y))
    assert abs(float(lhs - rhs)) < 1e-4
