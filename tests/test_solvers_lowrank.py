import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.solvers import svt, mc_svt, mc_admm, soft_threshold, sparse_admm


def crandn(key, shape):
    k1, k2 = jax.random.split(key)
    return (jax.random.normal(k1, shape) + 1j * jax.random.normal(k2, shape)) / np.sqrt(2)


def svd_shrink_ref(Y, tau):
    U, s, Vh = np.linalg.svd(np.asarray(Y, dtype=np.complex128), full_matrices=False)
    return (U * np.maximum(s - tau, 0)) @ Vh


def test_svt_matches_svd_shrinkage_wide(key):
    Y = crandn(key, (6, 10))
    np.testing.assert_allclose(
        np.asarray(svt(Y, 0.5)), svd_shrink_ref(Y, 0.5), atol=1e-4
    )


def test_svt_matches_svd_shrinkage_tall(key):
    Y = crandn(key, (10, 6))
    np.testing.assert_allclose(
        np.asarray(svt(Y, 0.7)), svd_shrink_ref(Y, 0.7), atol=1e-4
    )


def test_svt_large_tau_gives_zero(key):
    Y = crandn(key, (5, 8))
    np.testing.assert_allclose(np.asarray(svt(Y, 100.0)), 0.0, atol=1e-5)


def test_svt_nan_guard():
    Y = jnp.full((4, 4), jnp.nan + 0j)
    out = np.asarray(svt(Y, 0.1))
    assert np.all(np.isfinite(out))


def test_svt_batched(key):
    Ys = crandn(key, (3, 6, 10))
    out = svt(Ys, 0.5)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(out[i]), svd_shrink_ref(Ys[i], 0.5), atol=1e-4
        )


def _lowrank_completion_problem(key, n=16, m=24, rank=2, obs_frac=0.7):
    kL, kR, kM = jax.random.split(key, 3)
    Lf = crandn(kL, (n, rank))
    Rf = crandn(kR, (rank, m))
    X = Lf @ Rf
    Omega = (jax.random.uniform(kM, (n, m)) < obs_frac).astype(jnp.float32)
    return X, Omega


def test_mc_admm_recovers_lowrank(key):
    X, Omega = _lowrank_completion_problem(key)
    Xh, errs = mc_admm(X, Omega * X, Omega, Imax=200, tau=0.1, rho=1.0)
    nmse = np.sum(np.abs(np.asarray(Xh - X)) ** 2) / np.sum(np.abs(np.asarray(X)) ** 2)
    assert nmse < 0.05
    assert errs.shape == (200,)
    assert errs[-1] < errs[0]


def test_mc_svt_reduces_error(key):
    X, Omega = _lowrank_completion_problem(key, obs_frac=0.8)
    Xh = mc_svt(Omega * X, Omega, Imax=300, tau=2.0, rho=1.0)
    nmse = np.sum(np.abs(np.asarray(Xh - X)) ** 2) / np.sum(np.abs(np.asarray(X)) ** 2)
    assert nmse < 0.3


def test_soft_threshold():
    v = jnp.asarray([3.0 + 0.5j, -0.2 + 2.0j, 0.1 - 0.1j])
    out = np.asarray(soft_threshold(v, 0.5))
    np.testing.assert_allclose(out[0], 2.5 + 0.0j, atol=1e-6)
    np.testing.assert_allclose(out[1], 0.0 + 1.5j, atol=1e-6)
    np.testing.assert_allclose(out[2], 0.0, atol=1e-6)


def test_sparse_admm_recovers_sparse_beamspace(key):
    from jstsp19.channel import dft_dictionary

    Mr, Mt = 16, 8
    Dr = dft_dictionary(Mr, Mr) * np.sqrt(Mr)  # unitary scaling
    Dt = dft_dictionary(Mt, Mt) * np.sqrt(Mt)
    S_true = jnp.zeros((Mr, Mt), jnp.complex64).at[3, 2].set(2.0 + 1j).at[10, 5].set(-1.5 + 0.5j)
    H = Dr @ S_true @ Dt.conj().T
    S, errs = sparse_admm(H, H, Dr, Dt, Imax=100)
    nmse = np.sum(np.abs(np.asarray(S - S_true)) ** 2) / np.sum(
        np.abs(np.asarray(S_true)) ** 2
    )
    assert nmse < 0.05
    assert errs[-1] < 0.05


def test_mc_svt_tracked_matches_eigh():
    """The warm-started tracked SVT inside matrix completion (round 4,
    ops/tracked.py) must reproduce the eigh path — same contract as the
    flagship ADMM's tracked chain."""
    import jax

    rng = np.random.default_rng(3)
    N, M = 16, 40
    L = (rng.standard_normal((N, 3)) + 1j * rng.standard_normal((N, 3)))
    R = (rng.standard_normal((3, M)) + 1j * rng.standard_normal((3, M)))
    X0 = jnp.asarray(L @ R / 3, jnp.complex64)
    Om = jnp.asarray(rng.uniform(size=(N, M)) < 0.6, jnp.complex64)
    OH = Om * X0
    tau = 1.0 / float(jnp.sum(jnp.abs(OH) ** 2))
    a = jax.jit(lambda: mc_svt(OH, Om, 60, tau, 0.1))()
    b = jax.jit(lambda: mc_svt(OH, Om, 60, tau, 0.1, svt_method="tracked"))()
    # the Y iterate accumulates to O(3) here — compare relative to its scale
    scale = float(np.abs(np.asarray(a)).max())
    np.testing.assert_allclose(
        np.asarray(a) / scale, np.asarray(b) / scale, atol=3e-4
    )


def test_mc_admm_tracked_matches_eigh():
    """Tracked SVT inside mc_admm on the canonical-config completion
    problem (the configuration bench_all times): end-to-end NMSE must
    match the eigh path.  (Basis-tracking fidelity depends on how fast the
    SVT input drifts — for tiny rho the dual swings outpace one rotation
    round per step; the canonical driver's rho tracks to ~1e-4.)"""
    from jstsp19.core import prng
    from jstsp19.core.metrics import clamped_nmse
    from jstsp19.harness.pipeline import PointConfig, _proposed_frontend
    from jstsp19.solvers import ls_estimate

    pc = PointConfig()
    nv = jnp.asarray(1.0, jnp.float32)

    def one(key, method):
        ch, obs, A, B, tau, tauS, rho = _proposed_frontend(key, pc, nv)
        X, _ = mc_admm(obs.Y_full, obs.Y, obs.Omega, pc.Imax, tau, rho,
                       svt_method=method)
        return clamped_nmse(ls_estimate(X, A, B), ch.Zbar)

    keys = prng.realization_keys(prng.experiment_key(0), 0, 4)
    outs = {
        m: np.asarray(jax.jit(jax.vmap(lambda k: one(k, m)))(keys))
        for m in ("eigh", "tracked")
    }
    np.testing.assert_allclose(outs["tracked"], outs["eigh"], atol=1e-3)
