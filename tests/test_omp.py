import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.solvers import omp, omp_mmv, cosamp


def crandn(key, shape):
    k1, k2 = jax.random.split(key)
    return (jax.random.normal(k1, shape) + 1j * jax.random.normal(k2, shape)) / np.sqrt(2)


def _sparse_problem(key, M=64, n=128, k=5, T=None, snr_db=40.0):
    kA, kx, ki, kn = jax.random.split(key, 4)
    A = crandn(kA, (M, n))
    A = A / jnp.linalg.norm(A, axis=0, keepdims=True)
    idx = jax.random.choice(ki, n, (k,), replace=False)
    shape = (k,) if T is None else (k, T)
    coefs = crandn(kx, shape) * 3.0
    x = jnp.zeros((n,) if T is None else (n, T), jnp.complex64)
    x = x.at[idx].set(coefs)
    y = A @ x
    noise = crandn(kn, y.shape) * (10 ** (-snr_db / 20))
    return A, x, y + noise, idx


def test_omp_exact_recovery(key):
    A, x, y, idx = _sparse_problem(key)
    res = omp(A, y, 5)
    assert set(np.asarray(res.support)) == set(np.asarray(idx))
    nmse = np.sum(np.abs(np.asarray(res.x - x)) ** 2) / np.sum(np.abs(np.asarray(x)) ** 2)
    assert nmse < 1e-3


def test_omp_overshoot_sparsity_still_accurate(key):
    A, x, y, idx = _sparse_problem(key)
    res = omp(A, y, 10)  # more iterations than true sparsity
    nmse = np.sum(np.abs(np.asarray(res.x - x)) ** 2) / np.sum(np.abs(np.asarray(x)) ** 2)
    assert nmse < 1e-2


def test_omp_mmv_exact_recovery(key):
    A, X, Y, idx = _sparse_problem(key, T=8)
    res = omp_mmv(A, Y, 5)
    assert set(np.asarray(res.support)) == set(np.asarray(idx))
    nmse = np.sum(np.abs(np.asarray(res.x - X)) ** 2) / np.sum(np.abs(np.asarray(X)) ** 2)
    assert nmse < 1e-3


def test_omp_mmv_beats_single_at_low_snr(key):
    A, X, Y, idx = _sparse_problem(key, T=16, snr_db=5.0)
    res_j = omp_mmv(A, Y, 5)
    # column-by-column single OMP
    errs_single = []
    for t in range(4):
        r = omp(A, Y[:, t], 5)
        errs_single.append(
            np.sum(np.abs(np.asarray(r.x - X[:, t])) ** 2)
            / np.sum(np.abs(np.asarray(X[:, t])) ** 2)
        )
    err_joint = np.sum(np.abs(np.asarray(res_j.x - X)) ** 2) / np.sum(
        np.abs(np.asarray(X)) ** 2
    )
    assert err_joint <= np.mean(errs_single) * 1.2


def test_cosamp_recovery(key):
    A, x, y, idx = _sparse_problem(key, snr_db=30.0)
    xh = cosamp(A, y, 5, n_iter=15)
    nmse = np.sum(np.abs(np.asarray(xh - x)) ** 2) / np.sum(np.abs(np.asarray(x)) ** 2)
    assert nmse < 1e-2


def test_omp_jit_vmap(key):
    A, x, y, idx = _sparse_problem(key)
    ys = jnp.stack([y, y])
    out = jax.vmap(lambda v: omp(A, v, 5).x)(ys)
    assert out.shape == (2, 128)
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(out[1]), atol=1e-6)


def test_omp_td_equals_explicit_kron_omp(key):
    """omp_td (implicit kron Gram) == single OMP on the materialized
    kron(B^T, A) dictionary, atom for atom."""
    import jax
    import jax.numpy as jnp

    from jstsp19.solvers import omp, omp_td

    k1, k2, k3 = jax.random.split(key, 3)
    M, Gr, K, T = 12, 8, 6, 10
    A = (jax.random.normal(k1, (M, Gr)) + 1j * jax.random.normal(k1, (M, Gr))).astype(jnp.complex64)
    B = (jax.random.normal(k2, (K, T)) + 1j * jax.random.normal(k2, (K, T))).astype(jnp.complex64)
    S = jnp.zeros((Gr, K), jnp.complex64).at[1, 2].set(2.0).at[5, 0].set(-1.5j)
    Y = A @ S @ B
    res = omp_td(A, B, Y, 4)
    # materialized dictionary: vec(Y) row-major = Phi_full @ vec(S) with
    # Phi_full[(m,t),(i,j)] = A[m,i]·B[j,t]
    Phi_full = jnp.einsum("mi,jt->mtij", A, B).reshape(M * T, Gr * K)
    ref = omp(Phi_full, Y.reshape(-1), 4)
    np.testing.assert_allclose(
        np.asarray(res.x.reshape(-1)), np.asarray(ref.x), atol=1e-4
    )
    # exact recovery of the planted support
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(S), atol=1e-4
    )


def test_omp_gram_degenerate_atoms_guarded():
    """Duplicate (perfectly collinear) atoms make the bordered-Schur
    complement s_raw -> 0; the relative rank guard (s_raw <= 1e-6 ·
    max(d, 1e-30) freezes the update) must keep the progressive inverse
    finite and the recovery exact on the distinct-atom subproblem."""
    rng = np.random.default_rng(5)
    M, n = 24, 12
    A_half = rng.standard_normal((M, n // 2)) + 1j * rng.standard_normal((M, n // 2))
    A = jnp.asarray(np.concatenate([A_half, A_half], axis=1) / np.sqrt(2 * M),
                    jnp.complex64)  # columns j and j+6 identical
    x = np.zeros(n, complex)
    x[1] = 2.0
    x[4] = -1.0 + 0.5j
    v = A @ jnp.asarray(x, jnp.complex64)
    res = omp(A, v, 6)
    assert bool(jnp.all(jnp.isfinite(res.x.real) & jnp.isfinite(res.x.imag)))
    # reconstruction must be exact even though the support may land on
    # either duplicate of each atom
    assert float(jnp.linalg.norm(A @ res.x - v) / jnp.linalg.norm(v)) < 1e-4


def test_omp_gram_kron_matches_dense_kron():
    """The blocked kron core (round 5, no 512^2 Gram / per-step gathers)
    must reproduce the dense-kron omp_gram run exactly: same support
    sequence, same coefficients (identical g/rhs gathers -> identical
    bordered-inverse chain)."""
    from jstsp19.solvers.omp import omp_gram, omp_gram_kron

    rng = np.random.default_rng(17)
    na, nb, M, T, k = 16, 8, 12, 20, 25
    A = jnp.asarray(
        rng.standard_normal((M, na)) + 1j * rng.standard_normal((M, na)),
        jnp.complex64,
    )
    B = jnp.asarray(
        rng.standard_normal((nb, T)) + 1j * rng.standard_normal((nb, T)),
        jnp.complex64,
    )
    Y = jnp.asarray(
        rng.standard_normal((M, T)) + 1j * rng.standard_normal((M, T)),
        jnp.complex64,
    )
    GA = A.conj().T @ A
    GB = jnp.conj(B @ B.conj().T)
    C0 = A.conj().T @ Y @ B.conj().T
    r_dense = omp_gram(jnp.kron(GA, GB), C0.reshape(-1), k)
    r_kron = omp_gram_kron(GA, GB, C0, k)
    np.testing.assert_array_equal(
        np.asarray(r_dense.support), np.asarray(r_kron.support)
    )
    np.testing.assert_allclose(
        np.asarray(r_dense.x), np.asarray(r_kron.x), atol=1e-5
    )
