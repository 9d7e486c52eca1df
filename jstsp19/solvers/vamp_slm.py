"""VAMP for the Standard Linear Model + its state evolution.

Counterparts of ``VAMP/VampSlmEst.m`` (estimate x from y = A·x + CN(0,1/gamw))
and the analytic performance predictors ``VAMP/VampSlmSE.m`` /
``stateEvo/gampSE.m``.  The SE is the strongest correctness oracle the
reference ships (demos overlay empirical vs SE curves); here the denoiser
MSE expectation is evaluated by a fixed-key Monte-Carlo average, the linear
stage analytically from the operator spectrum.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jstsp19.core import prng

GAM_MIN = 1e-11
GAM_MAX = 1e11


class VampSlmResult(NamedTuple):
    x: jnp.ndarray
    gam1: jnp.ndarray
    mse_track: jnp.ndarray  # (nit,) E[xvar1] per iteration
    r1: jnp.ndarray  # final denoiser-input message (for EM wrappers)


@functools.partial(jax.jit, static_argnames=("nit",))
def vamp_slm(prior, y, op, gamw, nit: int = 50, damp: float = 0.9) -> VampSlmResult:
    """VAMP-SLM with the LMMSE stage in the operator's input-Gram eigenbasis.

    ``op`` must provide ``gram_in_eig`` / ``to_eigbasis`` / ``from_eigbasis``
    (KronDictOp) and ``rmv``; ``gamw`` is the noise precision.
    """
    Va, Vb, d = op.gram_in_eig()
    Ahy = op.rmv(y)
    Ahy_t = op.to_eigbasis(Va, Vb, Ahy)

    r1 = jnp.zeros(op.in_shape, y.dtype)
    gam1 = jnp.asarray(GAM_MIN, jnp.float32)
    # keep-best tracking (see solvers/vamp.py): the mean iteration can
    # destabilize after settling; return the iterate with the smallest
    # relative step instead of the last
    x_prev = jnp.zeros(op.in_shape, y.dtype)
    best_x = jnp.zeros(op.in_shape, y.dtype)
    best_r1 = r1
    best_gam1 = gam1
    best_rc = jnp.asarray(jnp.inf, jnp.float32)

    def body(carry, i):
        r1, gam1, x_prev, best_x, best_r1, best_gam1, best_rc = carry
        x1, xvar1 = prior.estim(r1, 1.0 / gam1)
        eta1 = 1.0 / jnp.maximum(jnp.mean(xvar1), 1e-30)
        gam2 = jnp.clip(eta1 - gam1, 1e-3 * eta1, GAM_MAX)
        r2 = (x1 * eta1 - r1 * gam1) / gam2
        # LMMSE: (gamw·AᴴA + gam2·I)⁻¹(gamw·Aᴴy + gam2·r2)
        rhs_t = gamw * Ahy_t + gam2 * op.to_eigbasis(Va, Vb, r2)
        x2 = op.from_eigbasis(Va, Vb, rhs_t / (gamw * d + gam2))
        alpha = jnp.mean(gam2 / (gamw * d + gam2))
        alpha = jnp.clip(alpha, 1e-6, 1.0 - 1e-6)
        r1n = (x2 - alpha * r2) / (1.0 - alpha)
        gam1n = jnp.clip(gam2 * (1.0 - alpha) / alpha, GAM_MIN, GAM_MAX)
        r1n = damp * r1n + (1 - damp) * r1
        gam1n = damp * gam1n + (1 - damp) * gam1
        # divergence guard (see vamp.py): rescale runaway messages in f32
        cap = 1e6
        mx = jnp.max(jnp.abs(r1n))
        r1n = r1n * jnp.where(mx > cap, cap / mx, 1.0)
        rc = jnp.sum(jnp.abs(x1 - x_prev) ** 2) / jnp.maximum(
            jnp.sum(jnp.abs(x1) ** 2), jnp.finfo(jnp.float32).tiny
        )
        rc = jnp.where(i == 0, jnp.asarray(jnp.inf, jnp.float32), rc.astype(jnp.float32))
        # i==0 seeds the best slot unconditionally (otherwise nit=1 would
        # return the zero initialization)
        better = (rc < best_rc) | (i == 0)
        return (
            r1n, gam1n, x1,
            jnp.where(better, x1, best_x),
            jnp.where(better, r1, best_r1),
            jnp.where(better, gam1, best_gam1),
            jnp.minimum(rc, best_rc),
        ), jnp.mean(xvar1)

    carry, mse = jax.lax.scan(
        body,
        (r1, gam1, x_prev, best_x, best_r1, best_gam1, best_rc),
        jnp.arange(nit),
    )
    r1_f, gam1_f, x_last, best_x, best_r1, best_gam1, best_rc = carry
    # final candidate: one more denoise of the last (updated) message —
    # the pre-keep-best return value; it wins unless the tail diverged
    x_f, _ = prior.estim(r1_f, 1.0 / gam1_f)
    rc_f = jnp.sum(jnp.abs(x_f - x_last) ** 2) / jnp.maximum(
        jnp.sum(jnp.abs(x_f) ** 2), jnp.finfo(jnp.float32).tiny
    )
    take_f = rc_f <= best_rc
    return VampSlmResult(
        x=jnp.where(take_f, x_f, best_x),
        gam1=jnp.where(take_f, gam1_f, best_gam1),
        mse_track=mse,
        r1=jnp.where(take_f, r1_f, best_r1),
    )


def vamp_slm_se(
    prior_sampler,
    prior,
    d_spectrum: jnp.ndarray,
    gamw,
    nit: int = 50,
    n_samples: int = 4096,
    seed: int = 0,
) -> jnp.ndarray:
    """State evolution of VAMP-SLM: predicted denoiser MSE per iteration.

    ``prior_sampler(key, n)`` draws x⁰ samples from the prior;
    ``d_spectrum`` are the eigenvalues of AᴴA (zeros included).  Returns
    the (nit,) sequence of predicted E|x̂−x⁰|² — compare against the
    empirical ``mse_track`` of :func:`vamp_slm` (the reference's
    ``VampSlmSE.m`` overlay test).
    """
    key = prng.experiment_key(seed)
    x0 = prior_sampler(key, n_samples)
    noise_key = jax.random.fold_in(key, 1)
    gam1 = jnp.asarray(GAM_MIN, jnp.float32)

    def denoiser_mse(gam1):
        # E over the prior and the effective Gaussian channel
        w = prng.complex_normal(noise_key, (n_samples,), var=1.0)
        r = x0 + w / jnp.sqrt(gam1)
        xhat, _ = prior.estim(r, 1.0 / gam1)
        return jnp.mean(jnp.abs(xhat - x0) ** 2)

    def body(gam1, _):
        mse1 = jnp.maximum(denoiser_mse(gam1), 1e-30)
        eta1 = 1.0 / mse1
        gam2 = jnp.clip(eta1 - gam1, 1e-3 * eta1, GAM_MAX)
        alpha = jnp.mean(gam2 / (gamw * d_spectrum + gam2))
        alpha = jnp.clip(alpha, 1e-6, 1.0 - 1e-6)
        gam1n = jnp.clip(gam2 * (1.0 - alpha) / alpha, GAM_MIN, GAM_MAX)
        return gam1n, mse1

    _, mses = jax.lax.scan(body, gam1, None, length=nit)
    return mses


def amp_se(
    prior_sampler,
    prior,
    delta: float,
    wvar,
    nit: int = 50,
    n_samples: int = 8192,
    seed: int = 0,
) -> jnp.ndarray:
    """State evolution of AMP/GAMP for an i.i.d. unit-column operator and
    AWGN output (the ``stateEvo/gampSE.m`` capability):

        τ²_{t+1} = wvar + (1/δ)·E|η(X + τ_t·Z) − X|²

    Returns the (nit,) sequence of predicted denoiser MSEs — compare with
    the empirical MSE of :func:`jstsp19.solvers.gamp.amp`.
    """
    key = prng.experiment_key(seed)
    x0 = prior_sampler(key, n_samples)
    w = prng.complex_normal(jax.random.fold_in(key, 1), (n_samples,), var=1.0)

    def body(tau2, _):
        r = x0 + w * jnp.sqrt(tau2)
        xhat, _ = prior.estim(r, tau2)
        mse = jnp.mean(jnp.abs(xhat - x0) ** 2)
        tau2_new = wvar + mse / delta
        return tau2_new, mse

    x2 = jnp.mean(jnp.abs(x0) ** 2)
    _, mses = jax.lax.scan(body, wvar + x2 / delta, None, length=nit)
    return mses
