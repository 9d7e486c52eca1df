"""EM-turboGAMP tests: exact forward/backward sufficient statistics
(brute-force oracle), EM recovery of chain hyperparameters
(``MarkovChain1.m`` p01/lambda, ``GaussMarkov.m`` alpha/sigma2), and the
3-D / arbitrary-neighborhood MRF supports."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.ops.base import MatrixOp
from jstsp19.solvers.turbo_em import (
    em_turbo_gauss_markov_vamp,
    em_turbo_markov_vamp,
    markov_fb,
    turbo_mrf3d_vamp,
    turbo_mrf_arb_vamp,
)


def test_markov_fb_matches_brute_force():
    """s_post and s_corr from the vectorized chain smoother equal exact
    enumeration over all 2^N supports (MarkovChain1.m:460-552)."""
    rng = np.random.default_rng(0)
    N, lam, p01 = 6, 0.3, 0.15
    p10 = p01 * lam / (1 - lam)
    pi_out = rng.uniform(0.05, 0.95, (N, 1))
    T = np.array([[1 - p10, p10], [p01, 1 - p01]])
    post = np.zeros(N)
    corr = np.zeros(N - 1)
    Z = 0.0
    for s in itertools.product([0, 1], repeat=N):
        pr = lam if s[0] else 1 - lam
        for k in range(1, N):
            pr *= T[s[k - 1], s[k]]
        like = np.prod(
            [pi_out[k, 0] if s[k] else 1 - pi_out[k, 0] for k in range(N)]
        )
        w = pr * like
        Z += w
        post += w * np.asarray(s)
        corr += w * np.asarray(s[:-1]) * np.asarray(s[1:])
    post /= Z
    corr /= Z
    _, s_post, s_corr = markov_fb(jnp.asarray(pi_out, jnp.float32), lam, p01)
    np.testing.assert_allclose(np.asarray(s_post)[:, 0], post, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_corr)[:, 0], corr, atol=1e-5)


def _markov_support_problem(seed=0, n=256, m=140, p01=0.1, lam=0.25, wvar=1e-3):
    rng = np.random.default_rng(seed)
    p10 = p01 * lam / (1 - lam)
    s = np.zeros(n, bool)
    st = rng.random() < lam
    for i in range(n):
        st = (rng.random() < (1 - p01)) if st else (rng.random() < p10)
        s[i] = st
    x = np.where(
        s, (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2), 0
    )
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(
        2 * m
    )
    y = A @ x + np.sqrt(wvar / 2) * (
        rng.standard_normal(m) + 1j * rng.standard_normal(m)
    )
    return MatrixOp(jnp.asarray(A, jnp.complex64)), jnp.asarray(y, jnp.complex64), x, s


def test_em_markov_learns_hyperparams():
    """From (p01, lam) = (0.5, 0.5) the EM loop must move both toward the
    truth and still solve the recovery problem (EMturboGAMP.m purpose)."""
    op, y, x, s = _markov_support_problem()
    res = em_turbo_markov_vamp(
        y, op, 1.0, 1e3, p01_init=0.5, lam_init=0.5, n_em=10
    )
    nmse = 10 * np.log10(
        float(np.sum(np.abs(np.asarray(res.x) - x) ** 2) / np.sum(np.abs(x) ** 2))
    )
    assert nmse < -25.0
    assert float(res.p01) < 0.3  # true 0.1, init 0.5
    assert abs(float(res.lam) - s.mean()) < 0.05


def test_em_gauss_markov_learns_hyperparams():
    rng = np.random.default_rng(3)
    n, m, wvar = 256, 140, 1e-3
    alpha_t, sig2_t = 0.1, 1.0
    a = 1 - alpha_t
    q = (1 - a * a) * sig2_t
    th = np.zeros(n, complex)
    th[0] = np.sqrt(sig2_t / 2) * (rng.standard_normal() + 1j * rng.standard_normal())
    for i in range(1, n):
        th[i] = a * th[i - 1] + np.sqrt(q / 2) * (
            rng.standard_normal() + 1j * rng.standard_normal()
        )
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(
        2 * m
    )
    y = A @ th + np.sqrt(wvar / 2) * (
        rng.standard_normal(m) + 1j * rng.standard_normal(m)
    )
    r = em_turbo_gauss_markov_vamp(
        jnp.asarray(y, jnp.complex64),
        MatrixOp(jnp.asarray(A, jnp.complex64)),
        1 / wvar,
        alpha_init=0.6,
        sigma2_init=3.0,
        n_em=12,
    )
    nmse = 10 * np.log10(
        float(np.sum(np.abs(np.asarray(r.x) - th) ** 2) / np.sum(np.abs(th) ** 2))
    )
    assert nmse < -8.0  # underdetermined dense AR(1): structure is the win
    assert float(r.alpha) < 0.35  # moved from 0.6 toward 0.1
    assert 0.5 < float(r.sigma2) < 2.0  # moved from 3.0 toward 1.0


def _clustered_3d_problem(seed=4, shape=(8, 8, 4), m=128, wvar=1e-3):
    rng = np.random.default_rng(seed)
    d0, d1, d2 = shape
    n = d0 * d1 * d2
    s = np.zeros(shape, bool)
    # one active 3-D blob
    c = (rng.integers(2, d0 - 2), rng.integers(2, d1 - 2), rng.integers(1, d2 - 1))
    s[c[0] - 2 : c[0] + 2, c[1] - 2 : c[1] + 2, c[2] - 1 : c[2] + 1] = True
    sv = s.reshape(-1)
    x = np.where(
        sv, (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2), 0
    )
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) / np.sqrt(
        2 * m
    )
    y = A @ x + np.sqrt(wvar / 2) * (
        rng.standard_normal(m) + 1j * rng.standard_normal(m)
    )
    return MatrixOp(jnp.asarray(A, jnp.complex64)), jnp.asarray(y, jnp.complex64), x


def test_mrf3d_recovers_clustered_support():
    op, y, x = _clustered_3d_problem()
    res = turbo_mrf3d_vamp(y, op, 1.0, 1e3, shape3d=(8, 8, 4))
    nmse = 10 * np.log10(
        float(np.sum(np.abs(np.asarray(res.x) - x) ** 2) / np.sum(np.abs(x) ** 2))
    )
    assert nmse < -15.0


def test_mrf_arb_ring_adjacency():
    """An arbitrary-adjacency MRF with a ring graph behaves like the chain
    smoother: clustered 1-D supports recovered from few measurements."""
    op, y, x, _ = _markov_support_problem(seed=5, p01=0.08, lam=0.2, m=120)
    n = op.in_shape[0]
    adj = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = 1
    adj[idx, (idx - 1) % n] = 1
    res = turbo_mrf_arb_vamp(
        y, op, 1.0, 1e3, jnp.asarray(adj), coupling=0.8, field=-1.2
    )
    nmse = 10 * np.log10(
        float(np.sum(np.abs(np.asarray(res.x) - x) ** 2) / np.sum(np.abs(x) ** 2))
    )
    assert nmse < -20.0
