"""Turbo message passing with a Markov-chain support prior.

Counterpart of the reference's turboGAMP framework
(``MPbased_solvers/turboGAMP/EMturboGAMP.m`` with a ``SupportStruct``
Markov chain): the sparse solver (VAMP-SLM here) exchanges extrinsic
activity log-likelihood ratios with a binary Markov-chain smoother running
along one axis of the coefficient matrix (beamspace supports are correlated
along the angle axis), BCJR-style forward–backward in the log domain.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jstsp19.solvers.estim import CAwgnPrior, SparsePrior
from jstsp19.solvers.vamp_slm import vamp_slm

_LLR_CAP = 30.0


def _channel_llr(base: CAwgnPrior, r1, rvar):
    """Per-element activity evidence log p(r|on) − log p(r|off)."""
    loglike1 = base.loglikey(r1, rvar)
    loglike0 = -(jnp.log(jnp.pi) + jnp.log(rvar) + jnp.abs(r1) ** 2 / rvar)
    return jnp.clip(loglike1 - loglike0, -_LLR_CAP, _LLR_CAP)


def _markov_extrinsic(llr_in: jnp.ndarray, p01, p10) -> jnp.ndarray:
    """Forward–backward along axis 0 of a binary Markov chain.

    llr_in: (n, ...) channel LLRs per chain element.  Returns the extrinsic
    prior LLR for each element (excluding its own observation), log domain,
    jit-safe scans.  Transitions: p01 = P(off→on), p10 = P(on→off).
    """
    log_T = jnp.log(
        jnp.asarray([[1 - p01, p01], [p10, 1 - p10]], jnp.float32) + 1e-30
    )  # [from, to]
    pi_on = p01 / (p01 + p10)
    log_prior0 = jnp.log(jnp.asarray([1 - pi_on, pi_on]) + 1e-30)

    # per-element observation log-potentials (…, 2)
    obs = jnp.stack([jnp.zeros_like(llr_in), llr_in], axis=-1)

    def fwd(alpha, o):
        # alpha: (..., 2) log messages INTO current node (before its obs)
        a_ext = alpha  # extrinsic forward message
        a_full = alpha + o
        nxt = jax.scipy.special.logsumexp(
            a_full[..., :, None] + log_T, axis=-2
        )
        nxt = nxt - jax.scipy.special.logsumexp(nxt, axis=-1, keepdims=True)
        return nxt, a_ext

    init = jnp.broadcast_to(log_prior0, obs.shape[1:])
    _, alphas = jax.lax.scan(fwd, init, obs)

    def bwd(beta, o):
        b_ext = beta
        b_full = beta + o
        prv = jax.scipy.special.logsumexp(
            b_full[..., None, :] + log_T, axis=-1
        )
        prv = prv - jax.scipy.special.logsumexp(prv, axis=-1, keepdims=True)
        return prv, b_ext

    zero = jnp.zeros(obs.shape[1:])
    _, betas_rev = jax.lax.scan(bwd, zero, obs[::-1])
    betas = betas_rev[::-1]

    ext = alphas + betas  # extrinsic node marginals (no own obs)
    return jnp.clip(ext[..., 1] - ext[..., 0], -_LLR_CAP, _LLR_CAP)


class TurboResult(NamedTuple):
    x: jnp.ndarray
    p1: jnp.ndarray  # final per-element activity prior


@functools.partial(jax.jit, static_argnames=("n_turbo", "nit"))
def turbo_markov_vamp(
    y,
    op,
    slab_var,
    gamw,
    p01: float = 0.05,
    p10: float = 0.3,
    n_turbo: int = 5,
    nit: int = 30,
) -> TurboResult:
    """Structured-sparsity recovery: VAMP inner solver + Markov support
    smoother along axis 0 of the coefficient matrix."""
    pi_on = p01 / (p01 + p10)
    base = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(slab_var, jnp.float32))
    p1 = jnp.full(op.in_shape, pi_on, jnp.float32)

    def turbo_round(carry, _):
        p1, best_x, best_p1, best_res = carry
        prior = SparsePrior(base, p1)
        res = vamp_slm(prior, y, op, gamw=gamw, nit=nit)
        rvar = 1.0 / res.gam1
        llr_obs = jnp.clip(
            _channel_llr(base, res.r1, jnp.broadcast_to(rvar, res.r1.shape)),
            -8.0, 8.0,
        )
        llr_ext = _markov_extrinsic(llr_obs, p01, p10)
        # damped, clamped prior refresh — per-element activity priors can
        # destabilize the scalar-variance VAMP, so updates stay conservative
        p1_new = 0.5 * jnp.clip(jax.nn.sigmoid(llr_ext), 5e-2, 1 - 5e-2) + 0.5 * p1
        # keep the best iterate by data residual (turbo rounds can degrade
        # on ill-posed instances; the residual is an observable criterion)
        resid = jnp.sum(jnp.abs(y - op.mv(res.x)) ** 2)
        better = resid < best_res
        best_x = jnp.where(better, res.x, best_x)
        best_p1 = jnp.where(better, p1, best_p1)
        best_res = jnp.where(better, resid, best_res)
        return (p1_new, best_x, best_p1, best_res), None

    init = (
        p1,
        jnp.zeros(op.in_shape, y.dtype),
        p1,
        jnp.asarray(jnp.inf, jnp.float32),
    )
    (p1, best_x, best_p1, _), _ = jax.lax.scan(
        turbo_round, init, None, length=n_turbo
    )
    return TurboResult(x=best_x, p1=best_p1)


def _gauss_markov_extrinsic(robs, obs_prec, alpha, sigma2):
    """Extrinsic Gaussian messages of a stationary AR(1) (Gauss-Markov)
    chain along axis 0 — the ``AmplitudeStruct`` Gauss-Markov capability of
    turboGAMP (``turboGAMP/ClassDefs/GaussMarkov.m``).

    Chain model: theta_t = (1-alpha)·theta_{t-1} + w_t with stationary
    variance sigma2 (so var(w) = (1-(1-alpha)²)·sigma2).  ``robs`` are
    per-element pseudo-observations of theta with precision ``obs_prec``
    (zero precision = uninformative).  Returns (eta, kappa): the mean and
    variance of each element's extrinsic Gaussian prior — the product of
    the forward and backward chain messages, excluding the element's own
    observation.
    """
    a = 1.0 - alpha
    q = jnp.maximum((1.0 - a * a) * sigma2, 1e-12)

    def _directional(robs_d, prec_d):
        # message INTO node t from the past: predict of the filtered t-1
        def step(carry, inp):
            m_f, P_f = carry  # filtered posterior of previous node
            r, lam = inp
            m_pred = a * m_f
            P_pred = a * a * P_f + q
            # combine prediction with obs at current node -> filtered
            prec_post = 1.0 / P_pred + lam
            P_post = 1.0 / prec_post
            m_post = P_post * (m_pred / P_pred + lam * r)
            return (m_post, P_post), (m_pred, P_pred)

        # carry init (0, sigma2): the predict step then hands node 0 the
        # stationary prior (a²·sigma2 + q = sigma2); each scan step emits
        # the predict-from-previous, i.e. the message INTO node t.
        m0 = jnp.zeros(robs_d.shape[1:], robs_d.dtype)
        P0 = jnp.full(robs_d.shape[1:], sigma2, jnp.float32)
        _, (m_in, P_in) = jax.lax.scan(step, (m0, P0), (robs_d, prec_d))
        return m_in, P_in

    mf, Pf = _directional(robs, obs_prec)
    mb_r, Pb_r = _directional(robs[::-1], obs_prec[::-1])
    mb, Pb = mb_r[::-1], Pb_r[::-1]
    # product of the two incoming Gaussian messages (precisions add)
    prec = 1.0 / Pf + 1.0 / Pb - 1.0 / sigma2  # stationary prior counted twice
    prec = jnp.maximum(prec, 1.0 / (10.0 * sigma2))
    kappa = 1.0 / prec
    eta = kappa * (mf / Pf + mb / Pb)
    return eta, kappa


@functools.partial(jax.jit, static_argnames=("n_turbo", "nit"))
def turbo_gauss_markov_vamp(
    y,
    op,
    sigma2,
    gamw,
    alpha: float = 0.1,
    p1: float = 1.0,
    n_turbo: int = 6,
    nit: int = 30,
) -> TurboResult:
    """Turbo VAMP with a Gauss-Markov *amplitude* structure — the
    ``AmplitudeStruct`` capability of turboGAMP: coefficient amplitudes are
    correlated along axis 0 (theta_t = (1-alpha)·theta_{t-1} + noise), and
    the chain smoother exchanges extrinsic per-element Gaussian priors
    CN(eta, kappa) with the spike-slab inner solver."""
    sigma2 = jnp.asarray(sigma2, jnp.float32)
    p1_arr = jnp.full(op.in_shape, p1, jnp.float32)
    eta = jnp.zeros(op.in_shape, y.dtype)
    kappa = jnp.full(op.in_shape, sigma2, jnp.float32)

    def turbo_round(carry, _):
        eta, kappa, _ = carry
        base = CAwgnPrior(eta, kappa)
        prior = SparsePrior(base, p1_arr)
        res = vamp_slm(prior, y, op, gamw=gamw, nit=nit)
        rvar = jnp.broadcast_to(1.0 / res.gam1, res.r1.shape)
        # activity posterior weights the chain observations
        llr = _channel_llr(base, res.r1, rvar)
        py1 = jax.nn.sigmoid(
            jnp.clip(llr + jnp.log(p1_arr) - jnp.log1p(-p1_arr + 1e-12), -30, 30)
        )
        obs_prec = py1 / rvar
        eta_new, kappa_new = _gauss_markov_extrinsic(
            res.r1, obs_prec, alpha, sigma2
        )
        # the extrinsic prior tightens monotonically — keep the last round
        # (a data-residual criterion would keep the overfitted first round)
        return (eta_new, kappa_new.astype(jnp.float32), res.x), None

    init = (eta, kappa, jnp.zeros(op.in_shape, y.dtype))
    (eta, kappa, x), _ = jax.lax.scan(turbo_round, init, None, length=n_turbo)
    return TurboResult(x=x, p1=p1_arr)


@functools.partial(jax.jit, static_argnames=("n_turbo", "nit"))
def turbo_mrf_vamp(
    y,
    op,
    slab_var,
    gamw,
    p01: float = 0.05,
    p10: float = 0.3,
    n_turbo: int = 5,
    nit: int = 30,
) -> TurboResult:
    """Structured-sparsity recovery with a 2-D Markov-random-field support
    prior — the ``SupportStruct`` MRF capability of turboGAMP
    (``turboGAMP/ClassDefs/MarkovField.m``): clustered supports on a 2-D
    grid.  The MRF is approximated turbo-style as the product of a
    row-chain and a column-chain BCJR smoother (their extrinsic LLRs add),
    the standard decomposition for AMP with 2-D supports."""
    pi_on = p01 / (p01 + p10)
    base = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(slab_var, jnp.float32))
    p1 = jnp.full(op.in_shape, pi_on, jnp.float32)

    def turbo_round(carry, _):
        p1, best_x, best_p1, best_res = carry
        prior = SparsePrior(base, p1)
        res = vamp_slm(prior, y, op, gamw=gamw, nit=nit)
        rvar = 1.0 / res.gam1
        llr_obs = jnp.clip(
            _channel_llr(base, res.r1, jnp.broadcast_to(rvar, res.r1.shape)),
            -8.0, 8.0,
        )
        ext_rows = _markov_extrinsic(llr_obs, p01, p10)  # along axis 0
        ext_cols = _markov_extrinsic(llr_obs.T, p01, p10).T  # along axis 1
        llr_ext = jnp.clip(ext_rows + ext_cols, -_LLR_CAP, _LLR_CAP)
        p1_new = 0.5 * jnp.clip(jax.nn.sigmoid(llr_ext), 5e-2, 1 - 5e-2) + 0.5 * p1
        resid = jnp.sum(jnp.abs(y - op.mv(res.x)) ** 2)
        better = resid < best_res
        best_x = jnp.where(better, res.x, best_x)
        best_p1 = jnp.where(better, p1, best_p1)
        best_res = jnp.where(better, resid, best_res)
        return (p1_new, best_x, best_p1, best_res), None

    init = (
        p1,
        jnp.zeros(op.in_shape, y.dtype),
        p1,
        jnp.asarray(jnp.inf, jnp.float32),
    )
    (p1, best_x, best_p1, _), _ = jax.lax.scan(
        turbo_round, init, None, length=n_turbo
    )
    return TurboResult(x=best_x, p1=best_p1)
