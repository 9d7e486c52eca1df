import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.core import prng
from jstsp19.ops import KronDictOp
from jstsp19.solvers.estim import CAwgnPrior, SparsePrior
from jstsp19.solvers.turbo import turbo_markov_vamp, _markov_extrinsic
from jstsp19.solvers.vamp_slm import vamp_slm


def _block_sparse_problem(key, Gr=32, K=8, N=16, M=30, nv=5e-2):
    """Support forms contiguous runs along axis 0 (Markov-friendly)."""
    kA, kB, kx, kn = jax.random.split(key, 4)
    A = prng.complex_normal(kA, (N, Gr)) / np.sqrt(N)
    B = prng.complex_normal(kB, (K, M)) / np.sqrt(K)
    op = KronDictOp(A, B)
    # two active runs of length 5 per column
    sup = np.zeros((Gr, K), bool)
    rng = np.random.default_rng(0)
    for k in range(K):
        for _ in range(2):
            s = rng.integers(0, Gr - 5)
            sup[s : s + 5, k] = True
    beta_eff = sup.mean()
    X = jnp.where(
        jnp.asarray(sup), prng.complex_normal(kx, (Gr, K), var=1 / beta_eff), 0.0
    )
    Y = op.mv(X) + prng.complex_normal(kn, (N, M), var=nv)
    return op, X, Y, nv, beta_eff, sup


def test_markov_extrinsic_smooths_runs():
    # strong evidence in a run should raise extrinsic LLR of its neighbors
    llr = jnp.asarray([[-5.0], [8.0], [0.0], [8.0], [-5.0], [-5.0]])
    ext = _markov_extrinsic(llr, 0.05, 0.3)
    # middle element (no own evidence counted) gets positive support from
    # its strong neighbors
    assert float(ext[2, 0]) > 0.5
    # far-off element stays negative-ish
    assert float(ext[5, 0]) < float(ext[2, 0])


def test_turbo_beats_iid_prior_on_block_sparse(key):
    op, X, Y, nv, beta, sup = _block_sparse_problem(key)
    # iid spike-slab VAMP
    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    res_iid = vamp_slm(prior, Y, op, gamw=1.0 / nv, nit=40)
    e_iid = float(jnp.sum(jnp.abs(res_iid.x - X) ** 2) / jnp.sum(jnp.abs(X) ** 2))
    # turbo with Markov support
    res_tb = turbo_markov_vamp(
        Y, op, slab_var=1 / beta, gamw=1.0 / nv, p01=0.09, p10=0.2,
        n_turbo=6, nit=40,
    )
    e_tb = float(jnp.sum(jnp.abs(res_tb.x - X) ** 2) / jnp.sum(jnp.abs(X) ** 2))
    assert np.isfinite(e_tb)
    # structured support should clearly beat the iid prior at this
    # measurement-starved operating point
    assert e_tb < e_iid, (e_iid, e_tb)
    # learned activity map correlates with the true support
    p1 = np.asarray(res_tb.p1)
    assert p1[np.asarray(sup)].mean() > p1[~np.asarray(sup)].mean()


def test_gauss_markov_extrinsic_interpolates():
    from jstsp19.solvers.turbo import _gauss_markov_extrinsic

    # chain of 7, observe nodes 1 and 5 at value ~2, middle unobserved:
    # the extrinsic mean at node 3 should be pulled toward 2
    r = jnp.zeros((7, 1), jnp.complex64).at[1, 0].set(2.0).at[5, 0].set(2.0)
    prec = jnp.zeros((7, 1), jnp.float32).at[1, 0].set(50.0).at[5, 0].set(50.0)
    eta, kappa = _gauss_markov_extrinsic(r, prec, alpha=0.1, sigma2=4.0)
    assert float(jnp.real(eta[3, 0])) > 0.8
    # observed nodes' extrinsic excludes own obs but includes neighbors'
    assert float(kappa[3, 0]) < 4.0  # tighter than the stationary prior


def test_turbo_gauss_markov_beats_iid_on_smooth_amplitudes(key):
    """Dense smooth (AR(1)) amplitude sequence, undersampled: the
    Gauss-Markov amplitude structure must beat the iid Gaussian prior."""
    from jstsp19.solvers.turbo import turbo_gauss_markov_vamp

    n, m, alpha, nv = 96, 48, 0.05, 1e-2
    a = 1 - alpha
    kA, kw, kn = jax.random.split(key, 3)
    w = prng.complex_normal(kw, (n,))
    # stationary AR(1) with unit variance
    def ar(carry, wt):
        th = a * carry + jnp.sqrt(1 - a * a) * wt
        return th, th
    _, theta = jax.lax.scan(ar, w[0], w)
    A = prng.complex_normal(kA, (m, n)) / np.sqrt(m)
    y = A @ theta + prng.complex_normal(kn, (m,), var=nv)
    from jstsp19.ops import MatrixOp
    op = MatrixOp(A)

    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0, jnp.float32)),
        jnp.asarray(1.0 - 1e-6, jnp.float32),
    )
    res_iid = vamp_slm(prior, y, op, gamw=1.0 / nv, nit=40)
    e_iid = float(
        jnp.sum(jnp.abs(res_iid.x - theta) ** 2) / jnp.sum(jnp.abs(theta) ** 2)
    )
    res_gm = turbo_gauss_markov_vamp(
        y, op, sigma2=1.0, gamw=1.0 / nv, alpha=alpha, n_turbo=6, nit=40
    )
    e_gm = float(
        jnp.sum(jnp.abs(res_gm.x - theta) ** 2) / jnp.sum(jnp.abs(theta) ** 2)
    )
    assert np.isfinite(e_gm)
    assert e_gm < e_iid, (e_iid, e_gm)


def test_turbo_mrf_beats_iid_on_clustered_support(key):
    """2-D blob support on the coefficient grid: the row+column MRF
    decomposition must beat both the iid prior."""
    from jstsp19.solvers.turbo import turbo_mrf_vamp

    kA, kB, kx, kn = jax.random.split(key, 4)
    Gr, K, N, M, nv = 32, 16, 14, 28, 5e-2
    A = prng.complex_normal(kA, (N, Gr)) / np.sqrt(N)
    B = prng.complex_normal(kB, (K, M)) / np.sqrt(K)
    op = KronDictOp(A, B)
    sup = np.zeros((Gr, K), bool)
    rng = np.random.default_rng(1)
    for _ in range(3):  # rectangular blobs
        r0 = rng.integers(0, Gr - 6)
        c0 = rng.integers(0, K - 4)
        sup[r0 : r0 + 6, c0 : c0 + 4] = True
    beta = sup.mean()
    X = jnp.where(jnp.asarray(sup), prng.complex_normal(kx, (Gr, K), var=1 / beta), 0.0)
    Y = op.mv(X) + prng.complex_normal(kn, (N, M), var=nv)

    prior = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1 / beta, jnp.float32)),
        jnp.asarray(beta, jnp.float32),
    )
    res_iid = vamp_slm(prior, Y, op, gamw=1.0 / nv, nit=40)
    e_iid = float(jnp.sum(jnp.abs(res_iid.x - X) ** 2) / jnp.sum(jnp.abs(X) ** 2))
    res_mrf = turbo_mrf_vamp(
        Y, op, slab_var=1 / beta, gamw=1.0 / nv, p01=0.08, p10=0.25,
        n_turbo=6, nit=40,
    )
    e_mrf = float(jnp.sum(jnp.abs(res_mrf.x - X) ** 2) / jnp.sum(jnp.abs(X) ** 2))
    assert np.isfinite(e_mrf)
    assert e_mrf < e_iid, (e_iid, e_mrf)
    p1 = np.asarray(res_mrf.p1)
    assert p1[np.asarray(sup)].mean() > p1[~np.asarray(sup)].mean()
