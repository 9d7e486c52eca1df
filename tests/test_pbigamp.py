import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.core import prng
from jstsp19.solvers.estim import CAwgnPrior, SparsePrior
from jstsp19.solvers.pbigamp import pbigamp


def _align(est, true):
    """Resolve the bilinear scale ambiguity: scale est to LS-match true."""
    alpha = jnp.vdot(est, true) / jnp.maximum(jnp.vdot(est, est).real, 1e-30)
    return alpha * est


def test_pbigamp_self_calibration():
    """Self-calibration (PBiGAMP flagship use): y = diag(b)·Phi·c with
    unknown near-unity gains b and sparse c; A[m]_{ij} = delta_{im} Phi_{mj}.
    """
    key = jax.random.key(11)
    M, Nc, k = 96, 128, 8
    Phi = prng.complex_normal(jax.random.fold_in(key, 0), (M, Nc)) / np.sqrt(M)
    beta = k / Nc
    act = jax.random.uniform(jax.random.fold_in(key, 1), (Nc,)) < beta
    c_true = jnp.where(
        act, prng.complex_normal(jax.random.fold_in(key, 2), (Nc,), var=1 / beta), 0.0
    )
    gain_var = 0.05
    b_true = 1.0 + prng.complex_normal(
        jax.random.fold_in(key, 3), (M,), var=gain_var
    )
    z_true = b_true * (Phi @ c_true)
    nv = 1e-4 * float(jnp.mean(jnp.abs(z_true) ** 2))
    y = z_true + prng.complex_normal(jax.random.fold_in(key, 4), (M,), var=nv)

    # measurement tensor: A[m] = e_m Phi_{m,:}^T
    A = jnp.zeros((M, M, Nc), jnp.complex64)
    A = A.at[jnp.arange(M), jnp.arange(M), :].set(Phi)

    prior_b = CAwgnPrior(jnp.asarray(1.0 + 0j), jnp.asarray(gain_var, jnp.float32))
    prior_c = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    res = pbigamp(
        y, A, prior_b, prior_c, nv, jax.random.fold_in(key, 5), nit=200, step=0.5
    )
    z_nmse = float(
        jnp.sum(jnp.abs(res.z - z_true) ** 2) / jnp.sum(jnp.abs(z_true) ** 2)
    )
    assert z_nmse < 0.02, z_nmse
    c_al = _align(res.c, c_true)
    c_nmse = float(
        jnp.sum(jnp.abs(c_al - c_true) ** 2) / jnp.sum(jnp.abs(c_true) ** 2)
    )
    assert c_nmse < 0.05, c_nmse


def test_pbigamp_rank_one_projections():
    """Matrix recovery from rank-one projections: z_m = u_m^T (b c^T) v_m,
    i.e. A[m] = u_m v_m^T.  The outer product b·c^T is ambiguity-free."""
    key = jax.random.key(21)
    M, Nb, Nc = 200, 12, 12
    U = prng.complex_normal(jax.random.fold_in(key, 0), (M, Nb), var=1.0)
    V = prng.complex_normal(jax.random.fold_in(key, 1), (M, Nc), var=1.0)
    b_true = prng.complex_normal(jax.random.fold_in(key, 2), (Nb,))
    c_true = prng.complex_normal(jax.random.fold_in(key, 3), (Nc,))
    A = jnp.einsum("mi,mj->mij", U, V) / np.sqrt(M)
    z_true = jnp.einsum("mij,i,j->m", A, b_true, c_true)
    nv = 1e-4 * float(jnp.mean(jnp.abs(z_true) ** 2))
    y = z_true + prng.complex_normal(jax.random.fold_in(key, 4), (M,), var=nv)

    prior = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0, jnp.float32))
    res = pbigamp(y, A, prior, prior, nv, jax.random.fold_in(key, 5), nit=300, step=0.4)
    G_true = jnp.outer(b_true, c_true)
    G_est = jnp.outer(res.b, res.c)
    g_nmse = float(
        jnp.sum(jnp.abs(G_est - G_true) ** 2) / jnp.sum(jnp.abs(G_true) ** 2)
    )
    assert g_nmse < 0.05, g_nmse


def test_em_pbigamp_calibration_learns_hyperparams():
    """EM-P-BiG-AMP (``PBiGAMP/EMPBiGAMP.m``): on the self-calibration
    testbed the EM wrapper must recover z, the AWGN noise variance, and the
    sparse-c activity rate without being told any of them."""
    import numpy as np
    from jstsp19.solvers.pbigamp import em_pbigamp

    rng = np.random.default_rng(0)
    M, Nb, Nc, k = 300, 8, 64, 6
    A = (
        rng.standard_normal((M, Nb, Nc)) + 1j * rng.standard_normal((M, Nb, Nc))
    ) / np.sqrt(2 * Nb * Nc)
    b0 = 1.0 + 0.2 * (rng.standard_normal(Nb) + 1j * rng.standard_normal(Nb)) / np.sqrt(2)
    c0 = np.zeros(Nc, complex)
    c0[rng.choice(Nc, k, False)] = (
        rng.standard_normal(k) + 1j * rng.standard_normal(k)
    ) / np.sqrt(2)
    z0 = np.einsum("mij,i,j->m", A, b0, c0)
    wvar = 1e-4 * np.mean(np.abs(z0) ** 2)
    y = z0 + np.sqrt(wvar / 2) * (
        rng.standard_normal(M) + 1j * rng.standard_normal(M)
    )
    res = em_pbigamp(
        jnp.asarray(y, jnp.complex64),
        jnp.asarray(A, jnp.complex64),
        jax.random.PRNGKey(0),
        n_em=6,
        nit=120,
    )
    znm = 10 * np.log10(
        float(np.sum(np.abs(np.asarray(res.z) - z0) ** 2) / np.sum(np.abs(z0) ** 2))
    )
    assert znm < -40.0
    assert 0.3 * wvar < float(res.noise_var) < 3.0 * wvar
    p1 = float(jnp.mean(jnp.asarray(res.prior_c.p1)))
    assert abs(p1 - k / Nc) < 0.05
