"""EM-turboGAMP: EM hyperparameter learning around the turbo solvers, plus
3-D and arbitrary-neighborhood MRF supports.

Counterparts of ``turboGAMP/Functions/EMturboGAMP.m`` (the EM loop),
``ClassDefs/MarkovChain1.m:436-570`` (forward/backward support messages and
the closed-form EM update of the active-to-inactive transition p01),
``ClassDefs/GaussMarkov.m`` (EM of the amplitude AR(1) hyperparameters),
``ClassDefs/@MarkovField3D`` (3-D lattice supports) and
``ClassDefs/@MarkovFieldArb`` (arbitrary-adjacency supports).

Design notes: the chain smoothers run in the probability domain as
``lax.scan`` along the chain axis, vectorized over every other axis; the
EM updates are closed-form posterior-moment expressions, so one EM round is
one inner turbo solve plus elementwise work.  The arbitrary-neighborhood
MRF uses damped loopy BP with the adjacency as a dense matrix (a dense
matmul per BP sweep — the matmul form of sparse neighborhood sums).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jstsp19.solvers.estim import CAwgnPrior, SparsePrior
from jstsp19.solvers.turbo import _channel_llr, _markov_extrinsic
from jstsp19.solvers.vamp_slm import vamp_slm

_LLR_CAP = 30.0


def markov_fb(pi_out, lam, p01):
    """Forward/backward activity messages along axis 0 in the probability
    domain — a vectorized transcription of the recursion in
    ``MarkovChain1.m:460-516``.

    pi_out: (N, ...) extrinsic channel activity probabilities;
    lam: stationary activity rate; p01 = P(on→off).  p10 is tied to keep
    the chain stationary at lam (``MarkovChain1.m:455-457``).

    Returns (pi_in, s_post, s_corr) where pi_in is the extrinsic prior
    activity, s_post = E[s_n | everything], and s_corr = E[s_n·s_{n+1}]
    (shape (N-1, ...)) — the sufficient statistics of the EM p01 update.
    """
    p10 = p01 * lam / jnp.maximum(1.0 - lam, 1e-12)
    eps = 1e-12

    def fwd(lf, pi_prev):
        num = p10 * (1 - pi_prev) * (1 - lf) + (1 - p01) * pi_prev * lf
        den = (1 - pi_prev) * (1 - lf) + pi_prev * lf
        return num / jnp.maximum(den, eps), lf

    # lf[n] = forward message INTO node n; the scan emits the carry BEFORE
    # consuming pi_out[n], so ys = lf[0..N-2] and the final carry is lf[N-1]
    lf0 = jnp.full(pi_out.shape[1:], lam)
    lf_last, lf_head = jax.lax.scan(fwd, lf0, pi_out[:-1])
    lf = jnp.concatenate([lf_head, lf_last[None]])

    def bwd(lb, pi_next):
        num = p01 * (1 - pi_next) * (1 - lb) + (1 - p01) * pi_next * lb
        den = (1 - p10 + p01) * (1 - pi_next) * (1 - lb) + (
            1 - p01 + p10
        ) * pi_next * lb
        return num / jnp.maximum(den, eps), lb

    # reversed scan: ys = lb[N-1..1], final carry = lb[0]
    lbN = jnp.full(pi_out.shape[1:], 0.5)
    lb_first, lb_tail_rev = jax.lax.scan(bwd, lbN, pi_out[1:][::-1])
    lb = jnp.concatenate([lb_first[None], lb_tail_rev[::-1]])

    pi_in = lf * lb / jnp.maximum((1 - lf) * (1 - lb) + lf * lb, eps)
    s_post = (
        pi_out * lf * lb
        / jnp.maximum((1 - pi_out) * (1 - lf) * (1 - lb) + pi_out * lf * lb, eps)
    )
    # pairwise posteriors (MarkovChain1.m:528-552)
    lfh, pih = lf[:-1], pi_out[:-1]
    lbt, pit = lb[1:], pi_out[1:]
    off_h = (1 - lfh) * (1 - pih)
    on_h = lfh * pih
    off_t = (1 - lbt) * (1 - pit)
    on_t = lbt * pit
    ps00 = (1 - p10) * off_h * off_t
    ps10 = p10 * off_h * on_t
    ps01 = p01 * on_h * off_t
    ps11 = (1 - p01) * on_h * on_t
    s_corr = ps11 / jnp.maximum(ps00 + ps10 + ps01 + ps11, eps)
    return pi_in, s_post, s_corr


class EmTurboResult(NamedTuple):
    x: jnp.ndarray
    p1: jnp.ndarray
    p01: jnp.ndarray
    lam: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("n_em", "nit"))
def em_turbo_markov_vamp(
    y,
    op,
    slab_var,
    gamw,
    p01_init: float = 0.2,
    lam_init: float = 0.2,
    n_em: int = 8,
    nit: int = 30,
) -> EmTurboResult:
    """EM-turboGAMP with a Markov-chain support: each EM round runs the
    inner VAMP, converts its pseudo-data to activity evidence, smooths it
    along the chain, and CLOSED-FORM re-estimates p01 and the sparsity rate
    from the chain's posterior sufficient statistics
    (``MarkovChain1.m:554-567``: p01 ← Σ(μ_s − s_corr)/Σ μ_s,
    ``MarkovChain1.m:295-323``: λ ← mean(s_post))."""
    base = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(slab_var, jnp.float32))

    def em_round(carry, _):
        p01, lam, p1, _ = carry
        prior = SparsePrior(base, p1)
        res = vamp_slm(prior, y, op, gamw=gamw, nit=nit)
        rvar = jnp.broadcast_to(1.0 / res.gam1, res.r1.shape)
        llr_obs = jnp.clip(_channel_llr(base, res.r1, rvar), -8.0, 8.0)
        pi_out = jax.nn.sigmoid(llr_obs)
        pi_in, s_post, s_corr = markov_fb(pi_out, lam, p01)
        # EM updates
        mu_head = s_post[:-1]
        p01_new = jnp.clip(
            jnp.sum(mu_head - s_corr) / jnp.maximum(jnp.sum(mu_head), 1e-12),
            1e-4,
            1.0 - 1e-4,
        )
        lam_new = jnp.clip(jnp.mean(s_post), 1e-4, 1.0 - 1e-4)
        p1_new = jnp.clip(pi_in, 5e-3, 1 - 5e-3)
        return (p01_new, lam_new, p1_new, res.x), None

    p1_0 = jnp.full(op.in_shape, lam_init, jnp.float32)
    init = (
        jnp.asarray(p01_init, jnp.float32),
        jnp.asarray(lam_init, jnp.float32),
        p1_0,
        jnp.zeros(op.in_shape, y.dtype),
    )
    (p01, lam, p1, x), _ = jax.lax.scan(em_round, init, None, length=n_em)
    return EmTurboResult(x=x, p1=p1, p01=p01, lam=lam)


class EmGaussMarkovResult(NamedTuple):
    x: jnp.ndarray
    alpha: jnp.ndarray
    sigma2: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("n_em", "nit"))
def em_turbo_gauss_markov_vamp(
    y,
    op,
    gamw,
    alpha_init: float = 0.5,
    sigma2_init: float = 1.0,
    n_em: int = 10,
    nit: int = 30,
) -> EmGaussMarkovResult:
    """EM learning of the Gauss-Markov amplitude hyperparameters
    (``GaussMarkov.m`` EM updates, posterior-moment form): the AR(1)
    coefficient a = 1−alpha from the posterior lag-1 correlation
    (Yule-Walker on posterior moments) and the stationary variance sigma2
    from the posterior second moment."""
    from jstsp19.solvers.turbo import _gauss_markov_extrinsic

    def em_round(carry, _):
        alpha, sigma2, eta, kappa, _ = carry
        base = CAwgnPrior(eta, kappa)
        res = vamp_slm(base, y, op, gamw=gamw, nit=nit)
        rvar = jnp.broadcast_to(1.0 / res.gam1, res.r1.shape)
        obs_prec = 1.0 / rvar
        eta_new, kappa_new = _gauss_markov_extrinsic(
            res.r1, obs_prec, alpha, sigma2
        )
        # full posterior of theta (extrinsic × own observation)
        prec_post = 1.0 / kappa_new + obs_prec
        v_post = 1.0 / prec_post
        m_post = v_post * (eta_new / kappa_new + obs_prec * res.r1)
        # EM: Yule-Walker on posterior MEANS — a mean-field approximation
        # of the exact EM lag-1 statistic, which would add the smoother's
        # posterior cross-covariance E[θ_t θ_{t-1}*] − m_t m_{t-1}* to the
        # numerator (GaussMarkov.m's Kalman-smoother EM).  With only the
        # factorized extrinsics carried here the cross term is
        # unavailable; the approximation shrinks a_new toward 0 when
        # v_post ≈ |m_post|² (low SNR), i.e. it UNDER-estimates temporal
        # correlation — conservative, and the turbo iterations re-supply
        # the correlation through the extrinsic pass each round.
        num = jnp.sum(jnp.real(m_post[1:] * jnp.conj(m_post[:-1])))
        den = jnp.sum(jnp.abs(m_post[:-1]) ** 2 + v_post[:-1])
        a_new = jnp.clip(num / jnp.maximum(den, 1e-12), 0.01, 0.999)
        alpha_new = 1.0 - a_new
        sigma2_new = jnp.maximum(jnp.mean(jnp.abs(m_post) ** 2 + v_post), 1e-9)
        return (
            alpha_new,
            sigma2_new,
            eta_new,
            kappa_new.astype(jnp.float32),
            res.x,
        ), None

    eta0 = jnp.zeros(op.in_shape, y.dtype)
    kappa0 = jnp.full(op.in_shape, sigma2_init, jnp.float32)
    init = (
        jnp.asarray(alpha_init, jnp.float32),
        jnp.asarray(sigma2_init, jnp.float32),
        eta0,
        kappa0,
        jnp.zeros(op.in_shape, y.dtype),
    )
    (alpha, sigma2, _, _, x), _ = jax.lax.scan(em_round, init, None, length=n_em)
    return EmGaussMarkovResult(x=x, alpha=alpha, sigma2=sigma2)


class TurboResult3D(NamedTuple):
    x: jnp.ndarray
    p1: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("shape3d", "n_turbo", "nit"))
def turbo_mrf3d_vamp(
    y,
    op,
    slab_var,
    gamw,
    shape3d,
    p01: float = 0.05,  # P(off->on) — turbo.py's convention, NOT
    p10: float = 0.3,   # markov_fb's p01 = P(on->off) above!
    n_turbo: int = 5,
    nit: int = 30,
) -> TurboResult3D:
    """3-D Markov-random-field support (``@MarkovField3D``): the coefficient
    vector reshapes to ``shape3d`` and three chain smoothers (one per
    lattice axis) contribute additive extrinsic LLRs — the same turbo
    product-of-chains decomposition the 2-D variant uses."""
    pi_on = p01 / (p01 + p10)
    base = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(slab_var, jnp.float32))
    p1 = jnp.full(op.in_shape, pi_on, jnp.float32)
    d0, d1, d2 = shape3d

    def turbo_round(carry, _):
        p1, best_x, best_res = carry
        prior = SparsePrior(base, p1)
        res = vamp_slm(prior, y, op, gamw=gamw, nit=nit)
        rvar = jnp.broadcast_to(1.0 / res.gam1, res.r1.shape)
        llr_obs = jnp.clip(_channel_llr(base, res.r1, rvar), -8.0, 8.0)
        cube = llr_obs.reshape(d0, d1, d2)
        e0 = _markov_extrinsic(cube.reshape(d0, -1), p01, p10).reshape(cube.shape)
        e1 = jnp.moveaxis(
            _markov_extrinsic(
                jnp.moveaxis(cube, 1, 0).reshape(d1, -1), p01, p10
            ).reshape(d1, d0, d2),
            0,
            1,
        )
        e2 = jnp.moveaxis(
            _markov_extrinsic(
                jnp.moveaxis(cube, 2, 0).reshape(d2, -1), p01, p10
            ).reshape(d2, d0, d1),
            0,
            2,
        )
        llr_ext = jnp.clip(e0 + e1 + e2, -_LLR_CAP, _LLR_CAP).reshape(
            op.in_shape
        )
        p1_new = 0.5 * jnp.clip(jax.nn.sigmoid(llr_ext), 5e-2, 1 - 5e-2) + 0.5 * p1
        resid = jnp.sum(jnp.abs(y - op.mv(res.x)) ** 2)
        better = resid < best_res
        best_x = jnp.where(better, res.x, best_x)
        best_res = jnp.where(better, resid, best_res)
        return (p1_new, best_x, best_res), None

    init = (p1, jnp.zeros(op.in_shape, y.dtype), jnp.asarray(jnp.inf, jnp.float32))
    (p1, x, _), _ = jax.lax.scan(turbo_round, init, None, length=n_turbo)
    return TurboResult3D(x=x, p1=p1)


@functools.partial(jax.jit, static_argnames=("n_turbo", "nit", "n_bp"))
def turbo_mrf_arb_vamp(
    y,
    op,
    slab_var,
    gamw,
    adjacency,
    coupling: float = 0.8,
    field: float = -1.0,
    n_turbo: int = 5,
    nit: int = 30,
    n_bp: int = 8,
) -> TurboResult3D:
    """Arbitrary-neighborhood MRF support (``@MarkovFieldArb``): an Ising
    prior on the support with user-supplied adjacency.  Extrinsic activity
    LLRs come from damped loopy BP; with a dense (N, N) adjacency each BP
    sweep is one matmul (the dense form of the reference's
    neighbor-sum loops)."""
    base = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(slab_var, jnp.float32))
    (n,) = op.in_shape
    adj = adjacency.astype(jnp.float32)
    p1 = jnp.full((n,), jax.nn.sigmoid(field), jnp.float32)
    tanh_j = jnp.tanh(coupling)

    def bp_extrinsic(llr_obs):
        # node beliefs b_i; messages approximated at belief level
        # (flooding schedule): m_i = 2·atanh(tanh(J)·tanh(b_i/2))
        def sweep(b, _):
            msg = 2.0 * jnp.arctanh(
                jnp.clip(tanh_j * jnp.tanh(b / 2.0), -0.999999, 0.999999)
            )
            b_new = field + llr_obs + adj @ msg
            return 0.5 * b_new + 0.5 * b, None

        b0 = field + llr_obs
        b, _ = jax.lax.scan(sweep, b0, None, length=n_bp)
        # extrinsic: belief minus own observation
        return jnp.clip(b - llr_obs, -_LLR_CAP, _LLR_CAP)

    def turbo_round(carry, _):
        p1, best_x, best_res = carry
        prior = SparsePrior(base, p1)
        res = vamp_slm(prior, y, op, gamw=gamw, nit=nit)
        rvar = jnp.broadcast_to(1.0 / res.gam1, res.r1.shape)
        llr_obs = jnp.clip(_channel_llr(base, res.r1, rvar), -8.0, 8.0)
        llr_ext = bp_extrinsic(llr_obs)
        p1_new = 0.5 * jnp.clip(jax.nn.sigmoid(llr_ext), 5e-2, 1 - 5e-2) + 0.5 * p1
        resid = jnp.sum(jnp.abs(y - op.mv(res.x)) ** 2)
        better = resid < best_res
        best_x = jnp.where(better, res.x, best_x)
        best_res = jnp.where(better, resid, best_res)
        return (p1_new, best_x, best_res), None

    init = (p1, jnp.zeros(op.in_shape, y.dtype), jnp.asarray(jnp.inf, jnp.float32))
    (p1, x, _), _ = jax.lax.scan(turbo_round, init, None, length=n_turbo)
    return TurboResult3D(x=x, p1=p1)
