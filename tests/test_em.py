import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.core import prng
from jstsp19.ops import KronDictOp
from jstsp19.solvers.em import em_bg_vamp


def test_em_bg_vamp_learns_noise_and_sparsity():
    key = jax.random.key(0)
    N_, Gr, K, M_ = 24, 16, 8, 30
    A = prng.complex_normal(jax.random.fold_in(key, 0), (N_, Gr)) / np.sqrt(N_)
    B = prng.complex_normal(jax.random.fold_in(key, 1), (K, M_)) / np.sqrt(K)
    op = KronDictOp(A, B)
    beta = 0.1
    act = jax.random.uniform(jax.random.fold_in(key, 2), (Gr, K)) < beta
    X = jnp.where(
        act,
        prng.complex_normal(jax.random.fold_in(key, 3), (Gr, K), var=1 / beta),
        0.0,
    )
    nv_true = 0.005
    Y = op.mv(X) + prng.complex_normal(
        jax.random.fold_in(key, 4), (N_, M_), var=nv_true
    )
    res = em_bg_vamp(Y, op, n_em=10, nit=40)
    nmse = float(jnp.sum(jnp.abs(res.x - X) ** 2) / jnp.sum(jnp.abs(X) ** 2))
    assert nmse < 1e-2, nmse
    # hyperparameters learned within a factor ~2
    assert 0.3 * nv_true < float(res.noise_var) < 3 * nv_true
    assert 0.03 < float(res.prior.p1) < 0.3


def test_em_gm_vamp_learns_mixture():
    """Full EM-GM-AMP: two-scale GM amplitudes, everything learned."""
    from jstsp19.solvers.em import em_gm_vamp
    from jstsp19.ops import MatrixOp

    key = jax.random.key(3)
    m, n, beta = 200, 400, 0.06
    A = prng.complex_normal(jax.random.fold_in(key, 0), (m, n)) / np.sqrt(m)
    act = jax.random.uniform(jax.random.fold_in(key, 1), (n,)) < beta
    big = jax.random.uniform(jax.random.fold_in(key, 2), (n,)) < 0.5
    amp = jnp.where(big, 3.0, 0.5)
    x = jnp.where(
        act, amp * prng.complex_normal(jax.random.fold_in(key, 3), (n,)), 0.0
    )
    nv_true = 1e-3 * float(jnp.mean(jnp.abs(x) ** 2)) * n / m
    y = A @ x + prng.complex_normal(jax.random.fold_in(key, 4), (m,), var=nv_true)
    res = em_gm_vamp(y, MatrixOp(A), n_components=3, n_em=10, nit=40)
    nmse = float(jnp.sum(jnp.abs(res.x - x) ** 2) / jnp.sum(jnp.abs(x) ** 2))
    assert nmse < 0.02, nmse
    assert 0.02 < float(res.prior.p1) < 0.2
    assert 0.2 * nv_true < float(res.noise_var) < 5 * nv_true


def test_em_nngm_gamp_recovers_nonnegative():
    """EMNNAMP: sparse non-negative signal, no hand-tuned hyperparameters."""
    from jstsp19.solvers.em import em_nngm_gamp
    from jstsp19.ops import MatrixOp

    key = jax.random.key(7)
    m, n, k = 160, 320, 16
    A = (jax.random.normal(jax.random.fold_in(key, 0), (m, n)) / np.sqrt(m)).astype(
        jnp.float32
    )
    idx = jax.random.choice(jax.random.fold_in(key, 1), n, (k,), replace=False)
    vals = jnp.abs(jax.random.normal(jax.random.fold_in(key, 2), (k,))) + 0.5
    x = jnp.zeros((n,), jnp.float32).at[idx].set(vals)
    nv_true = 1e-4 * float(jnp.mean((A @ x) ** 2)) * m
    y = A @ x + jnp.sqrt(nv_true) * jax.random.normal(jax.random.fold_in(key, 3), (m,))
    res = em_nngm_gamp(y, MatrixOp(A), n_components=3, n_em=10, nit=40)
    assert not jnp.iscomplexobj(res.x)
    nmse = float(jnp.sum((res.x - x) ** 2) / jnp.sum(x**2))
    assert nmse < 0.03, nmse
    assert float(jnp.min(res.x)) > -1e-3  # non-negativity respected
