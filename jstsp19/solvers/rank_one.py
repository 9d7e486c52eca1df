"""Rank-one matrix factorization by AMP-style alternating estimation + SE.

JAX counterpart of the reference's ``matrixFactor/`` family:
``rankOneFit.m:1`` (the iterative fit with Onsager-corrected power steps,
scalar second-order tracking, and the 'linear' / MMSE estimator branches),
``rankOneSE.m:1`` (the scalar state-evolution recursion on the squared
correlations), and the ``rankOneTest.m`` golden methodology (fit vs SE
overlay at fixed SNR; ``data/rankOneTest_*.mat``).

Given A = u0·v0ᵀ + sqrt(m·wvar)·W the fit alternates

    p = (1/m)·A·v + μu·u     →  û = E[u | p]      (Onsager term μu)
    q = (1/m)·Aᵀ·û + μv·v    →  v̂ = E[v | q]

with the pseudo-data rescaled by the tracked second-order statistics
(au1/au0/av1/av0 — ``rankOneFit.m:100-215``).  Everything runs as a fixed
``lax.scan`` with scalar carries — no dynamic shapes.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from jstsp19.core import prng


def prior_moments(prior):
    """(mean0, var0) of a prior module — the ``estimInit()`` analog
    (``rankOneFit.m:46-48``).  Supports the scalar priors used by the
    matrixFactor family (Awgn/CAwgn, spike-slab, discrete)."""
    if hasattr(prior, "atoms"):  # DiscretePrior
        w = prior.weights / jnp.sum(prior.weights)
        m0 = jnp.sum(w * prior.atoms)
        v0 = jnp.sum(w * jnp.abs(prior.atoms - m0) ** 2)
        return m0, v0
    if hasattr(prior, "base"):  # SparsePrior
        mb, vb = prior_moments(prior.base)
        m0 = prior.p1 * mb
        v0 = prior.p1 * (vb + jnp.abs(mb) ** 2) - jnp.abs(m0) ** 2
        return m0, v0
    return jnp.asarray(prior.mean0), jnp.asarray(prior.var0)


class RankOneResult(NamedTuple):
    u: jnp.ndarray  # (m,) estimate of u0
    v: jnp.ndarray  # (n,) estimate of v0
    corru: jnp.ndarray  # (nit,) predicted squared correlation of u
    corrv: jnp.ndarray  # (nit,) predicted squared correlation of v


@functools.partial(
    jax.jit, static_argnames=("nit", "lin_est", "norm_uv", "vvar_init")
)
def rank_one_fit(
    A: jnp.ndarray,
    estimu,
    estimv,
    wvar,
    key=None,
    nit: int = 10,
    lin_est: bool = False,
    norm_uv: bool = True,
    vvar_init: Optional[float] = None,
    min_au: float = 0.01,
    min_av: float = 0.01,
) -> RankOneResult:
    """Fit A ≈ u·vᵀ (``rankOneFit.m``).

    ``estimu``/``estimv``: prior modules with ``estim(rhat, rvar)``
    (the EstimIn analogs).  ``lin_est=True`` selects the normalized
    linear (power-iteration) branch (``rankOneFit.m:107-116``);
    otherwise the MMSE branch with the reference's variance floors
    (``minau``/``minav``) and theoretical renormalization (``normu/v``,
    RankOneFitOpt.m defaults).
    """
    m, n = A.shape
    beta = n / m
    rdt = A.real.dtype
    umean0, uvar0 = prior_moments(estimu)
    vmean0, vvar0 = prior_moments(estimv)
    usq0 = jnp.abs(umean0) ** 2 + uvar0
    vsq0 = jnp.abs(vmean0) ** 2 + vvar0

    if key is None:
        key = prng.experiment_key(0)
    v_init = jnp.full((n,), vmean0, A.dtype)
    # rankOneFit.m seeds vhat RANDOMLY: a deterministic zero-mean init is
    # an exact fixed point of the alternating MMSE recursion (u = v = 0
    # forever, round 5).  vvar_init=None (default) seeds at the prior's
    # own variance; pass 0.0 to force the deterministic mean init.
    seed_var = jnp.real(vvar0) if vvar_init is None else (
        vvar_init if vvar_init > 0 else None
    )
    if seed_var is not None:
        v_init = v_init + jnp.sqrt(
            jnp.asarray(seed_var, rdt)
        ) * jax.random.normal(key, (n,), rdt).astype(A.dtype)

    eps = jnp.finfo(rdt).tiny

    class Carry(NamedTuple):
        u: jnp.ndarray
        v: jnp.ndarray
        muu: jnp.ndarray
        av0: jnp.ndarray
        av1: jnp.ndarray
        corrv: jnp.ndarray

    init = Carry(
        u=jnp.zeros((m,), A.dtype),
        v=v_init,
        muu=jnp.zeros((), rdt),
        av0=jnp.maximum(jnp.abs(vmean0) ** 2, 1e-12).astype(rdt),
        av1=jnp.maximum(jnp.abs(vmean0) ** 2, 1e-12).astype(rdt),
        corrv=(jnp.abs(vmean0) ** 2 / jnp.maximum(vsq0, eps)).astype(rdt),
    )

    def body(c: Carry, _):
        # ---- U half-step (rankOneFit.m:100-146) -------------------------
        p = A @ c.v / m + c.muu * c.u
        if lin_est:
            scale = jnp.sqrt(m * 1.0) / jnp.maximum(jnp.linalg.norm(p), eps)
            u = scale * p
            muv = -wvar * scale
            corru = (
                beta * usq0 * vsq0 * c.corrv
                / (beta * usq0 * vsq0 * c.corrv + wvar)
            )
            au0 = jnp.ones((), rdt)
            au1 = jnp.sqrt(corru * usq0)
        else:
            pvar = beta * wvar * c.av0
            pscale = beta * c.av1
            y = p / pscale
            yvar1 = pvar / jnp.maximum(pscale**2, eps)
            u, uvart = estimu.estim(y, yvar1)
            uvart = jnp.maximum(jnp.mean(uvart), min_au * uvar0)
            uvart = jnp.minimum(uvar0 * yvar1 / (uvar0 + yvar1), uvart)
            au1 = jnp.maximum(usq0 - uvart, min_au * usq0)
            au0 = au1
            muv = -wvar * uvart / jnp.maximum(yvar1, eps) / pscale
            corru = au1**2 / au0 / usq0
            if norm_uv:
                u = u * jnp.sqrt(m * au0) / jnp.maximum(jnp.linalg.norm(u), eps)

        # ---- V half-step (:160-215) -------------------------------------
        q = A.conj().T @ u / m + muv * c.v
        if lin_est:
            v = q
            muu = jnp.asarray(-beta * wvar, rdt)
            corrv = usq0 * vsq0 * corru / (usq0 * vsq0 * corru + wvar)
            av0 = jnp.real(jnp.vdot(q, q)) / n
            av1 = jnp.sqrt(av0 * corrv * vsq0)
        else:
            qscale = au1
            qvar = wvar * au0
            y = q / qscale
            yvar1 = qvar / jnp.maximum(qscale**2, eps)
            v, vvart = estimv.estim(y, yvar1)
            vvart = jnp.maximum(jnp.mean(vvart), min_av * vvar0)
            av1 = jnp.maximum(vsq0 - vvart, min_av * vsq0)
            av0 = av1
            corrv = av1**2 / av0 / vsq0
            muu = (-beta * wvar * vvart / jnp.maximum(yvar1, eps) / qscale).astype(rdt)
            if norm_uv:
                v = v * jnp.sqrt(n * av0) / jnp.maximum(jnp.linalg.norm(v), eps)

        return (
            Carry(u=u, v=v, muu=muu, av0=av0, av1=av1, corrv=corrv),
            (corru, corrv),
        )

    final, (corru_t, corrv_t) = jax.lax.scan(body, init, None, length=nit)
    return RankOneResult(u=final.u, v=final.v, corru=corru_t, corrv=corrv_t)


def mc_prior_mse(prior_sampler, prior, n_samples: int = 8192, seed: int = 0):
    """Monte-Carlo average denoiser MSE ``rvar ↦ E|x̂ − x⁰|²`` — the
    ``stateEvo`` ``MCEstimInAvg.avgMSE`` analog used by the SE recursion
    (``rankOneSE.m:75-80``)."""
    key = prng.experiment_key(seed)
    x0 = prior_sampler(key, n_samples)
    kw = jax.random.fold_in(key, 1)
    if jnp.iscomplexobj(x0):
        w = prng.complex_normal(kw, x0.shape, var=1.0)
    else:
        w = jax.random.normal(kw, x0.shape, x0.dtype)

    def avg_mse(rvar):
        r = x0 + w * jnp.sqrt(rvar)
        xhat, _ = prior.estim(r, rvar)
        return jnp.mean(jnp.abs(xhat - x0) ** 2)

    return avg_mse


def rank_one_se(
    mse_u: Callable,
    mse_v: Callable,
    beta: float,
    umean0,
    uvar0,
    vmean0,
    vvar0,
    wvar,
    nit: int = 10,
):
    """Scalar state evolution of the rank-one fit (``rankOneSE.m:96-109``):

        snru_t = β·vsq0/wvar·corrv_t;   corru_t = 1 − mse_u(1/snru)/usq0
        snrv_t = usq0/wvar·corru_t;     corrv_{t+1} = 1 − mse_v(1/snrv)/vsq0

    Returns (corru (nit,), corrv (nit+1,)) squared-correlation trajectories.
    """
    usq0 = jnp.abs(umean0) ** 2 + uvar0
    vsq0 = jnp.abs(vmean0) ** 2 + vvar0
    corrv0 = jnp.abs(vmean0) ** 2 / vsq0

    def body(corrv, _):
        snru = beta * vsq0 / wvar * corrv
        corru = 1.0 - mse_u(1.0 / jnp.maximum(snru, 1e-30)) / usq0
        snrv = usq0 / wvar * corru
        corrv_n = 1.0 - mse_v(1.0 / jnp.maximum(snrv, 1e-30)) / vsq0
        return corrv_n, (corru, corrv_n)

    corrv_fin, (corru_t, corrv_t) = jax.lax.scan(
        body, jnp.asarray(corrv0, jnp.float32), None, length=nit
    )
    return corru_t, jnp.concatenate([jnp.asarray([corrv0], jnp.float32), corrv_t])
