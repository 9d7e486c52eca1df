"""Contract tests for the structured operator wave (Identity/Subset/Center/
TV/Haar + unitary/expander/kernel constructors) — adjointness via the
⟨Ax, y⟩ = ⟨x, Aᴴy⟩ identity (reference: ``test/testlintrans.m:28-42``) and
exact |A|² variance maps checked against the densified operator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.ops import (
    CenterOp,
    HaarOp,
    IdentityOp,
    MatrixOp,
    SubsetOp,
    TVOp,
    expander_graph_op,
    random_unitary_op,
    rbf_kernel_op,
)

KEY = jax.random.PRNGKey(1234)


def _crandn(key, shape):
    kr, ki = jax.random.split(key)
    return jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape)


def check_adjoint(op, key, atol=1e-4):
    kx, ky = jax.random.split(key)
    x = _crandn(kx, tuple(op.in_shape))
    y = _crandn(ky, tuple(op.out_shape))
    lhs = jnp.vdot(y, op.mv(x))
    rhs = jnp.vdot(op.rmv(y), x)
    assert abs(complex(lhs - rhs)) < atol * max(1.0, abs(complex(lhs)))


def _dense(op, n):
    """Densify a vector operator by mapping the identity through mv."""
    return jax.vmap(op.mv)(jnp.eye(n, dtype=jnp.complex64)).T


def check_sq_maps(op, key, atol=1e-4):
    n = int(np.prod(op.in_shape))
    A = _dense(op, n)
    x = jax.random.uniform(key, tuple(op.in_shape))
    y = jax.random.uniform(jax.random.fold_in(key, 1), tuple(op.out_shape))
    assert np.allclose(
        np.asarray(op.sq_mv(x)), np.abs(np.asarray(A)) ** 2 @ np.asarray(x),
        atol=atol,
    )
    assert np.allclose(
        np.asarray(op.sq_rmv(y)),
        (np.abs(np.asarray(A)) ** 2).T @ np.asarray(y),
        atol=atol,
    )


def test_identity_op():
    op = IdentityOp(7)
    check_adjoint(op, KEY)
    check_sq_maps(op, KEY)


def test_subset_op_adjoint_and_sq():
    A = _crandn(KEY, (9, 5))
    op = SubsetOp(MatrixOp(A), idx=(0, 3, 8))
    check_adjoint(op, jax.random.fold_in(KEY, 1))
    check_sq_maps(op, jax.random.fold_in(KEY, 2))
    x = _crandn(jax.random.fold_in(KEY, 3), (5,))
    assert np.allclose(
        np.asarray(op.mv(x)), np.asarray((A @ x))[[0, 3, 8]], atol=1e-6
    )


def test_center_op_is_demeaning_projector():
    op = CenterOp(6)
    check_adjoint(op, KEY)
    check_sq_maps(op, KEY)
    x = _crandn(KEY, (6,))
    assert abs(complex(jnp.sum(op.mv(x)))) < 1e-5


@pytest.mark.parametrize("n", [2, 9])
def test_tv_op(n):
    op = TVOp(n)
    check_adjoint(op, KEY)
    check_sq_maps(op, KEY)
    x = jnp.arange(float(n)) + 0j
    assert np.allclose(np.asarray(op.mv(x)), 1.0)


@pytest.mark.parametrize("n,levels", [(8, 1), (8, 3), (32, 4)])
def test_haar_op_orthonormal(n, levels):
    op = HaarOp(n, levels)
    check_adjoint(op, KEY)
    check_sq_maps(op, KEY)
    x = _crandn(KEY, (n,))
    y = op.mv(x)
    # orthonormal: norm preserved, rmv inverts
    assert float(jnp.linalg.norm(y)) == pytest.approx(
        float(jnp.linalg.norm(x)), rel=1e-5
    )
    assert np.allclose(np.asarray(op.rmv(y)), np.asarray(x), atol=1e-5)
    # constant input concentrates on the level-L approximation coeffs
    c = op.mv(jnp.ones((n,), dtype=jnp.complex64))
    assert np.allclose(np.asarray(c[n >> levels :]), 0.0, atol=1e-6)


def test_random_unitary_op_is_unitary():
    op = random_unitary_op(KEY, 12)
    Q = np.asarray(op.A)
    assert np.allclose(Q.conj().T @ Q, np.eye(12), atol=1e-5)


def test_expander_graph_op_columns():
    op = expander_graph_op(KEY, m=16, n=10, d=4)
    A = np.asarray(op.A)
    # exactly d nonzeros per column, unit column norms
    assert (np.count_nonzero(A, axis=0) == 4).all()
    assert np.allclose(np.linalg.norm(A, axis=0), 1.0, atol=1e-6)


def test_rbf_kernel_op_gram():
    X = jax.random.normal(KEY, (6, 3))
    op = rbf_kernel_op(X, gamma=0.7)
    K = np.asarray(op.A)
    assert np.allclose(np.diag(K), 1.0, atol=1e-5)
    assert np.allclose(K, K.T, atol=1e-6)
    d2 = np.sum((np.asarray(X)[0] - np.asarray(X)[1]) ** 2)
    assert K[0, 1] == pytest.approx(np.exp(-0.7 * d2), rel=1e-4)
