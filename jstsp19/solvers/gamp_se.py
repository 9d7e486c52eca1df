"""State evolution for GAMP/AMP — the ``stateEvo/gampSE.m`` capability.

The reference implements SE with averaging classes (``EstimInAvg.m`` — MC
averaging of the input denoiser; ``AwgnEstimOutAvg.m`` /
``IntEstimOutAvg.m`` — closed-form or numerically-integrated output
updates) driven by a scalar recursion (``gampSE.m:44-67``).  This module is
the matched (Bayes-optimal sum-product) form of that recursion, which is
the case every reference test exercises (``SEopt.tauxieq=true`` with
matched priors):

    taup_t = beta * Avar * taux_t
    svar̄_t = E_(p,y)[ (1 - zvar(p,y)/taup_t) / taup_t ]   (output average)
    taur_t = 1 / (Avar_col * svar̄_t)
    taux_{t+1}, mse_{t+1} = input average at taur_t          (EstimInAvg)

with A i.i.d., var(A_ij) = 1/m (unit-norm columns), beta = n/m.  For the
AWGN output the average collapses to taur = taup + wvar (the classic AMP
SE fixed-point map tau' = wvar + beta*mmse(tau)); for general likelihoods
it is Monte-Carlo averaged over the exact joint (z = p + d, p ⟂ d,
var d = taup, y ~ p(y|z)) — the vectorized analog of
``IntEstimOutAvg.m``'s nested quadrature.

Everything is batched over the sample axis and jitted; the SE loop itself
is a ``lax.scan`` over iterations.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class EstimInAvg:
    """MC input averaging (``stateEvo/EstimInAvg.m``): given samples
    x ~ p(x) and fixed unit noise w, returns E|x − g(x+√rvar·w; rvar)|²
    and E[xvar]."""

    prior: object
    x: jnp.ndarray
    w: jnp.ndarray

    def avg(self, rvar):
        rhat = self.x + jnp.sqrt(rvar) * self.w
        xhat, xvar = self.prior.estim(rhat, rvar * jnp.ones_like(jnp.real(self.x)))
        mse = jnp.mean(jnp.abs(self.x - xhat) ** 2)
        return mse, jnp.mean(xvar)


def estim_in_avg(prior, key, n_samp: int = 4096, sampler=None, cplx=False):
    """Build an :class:`EstimInAvg` by drawing x from ``sampler(key, n)``
    (defaults to the prior's ``sample`` method if present)."""
    kx, kw = jax.random.split(key)
    if sampler is None:
        sampler = prior.sample
    x = sampler(kx, n_samp)
    if jnp.iscomplexobj(x) or cplx:
        kr, ki = jax.random.split(kw)
        w = (
            jax.random.normal(kr, (n_samp,)) + 1j * jax.random.normal(ki, (n_samp,))
        ) / jnp.sqrt(2.0)
    else:
        w = jax.random.normal(kw, (n_samp,))
    return EstimInAvg(prior=prior, x=x, w=w)


@dataclasses.dataclass(frozen=True)
class AwgnOutAvg:
    """Closed-form output average for y = z + N(0, wvar)
    (``stateEvo/AwgnEstimOutAvg.m``): zvar = taup·wvar/(taup+wvar)
    independent of (p, y), so svar̄ = 1/(taup + wvar)."""

    wvar: float

    def svar_avg(self, taup, varz):
        return 1.0 / (taup + self.wvar)


@dataclasses.dataclass(frozen=True)
class MCOutAvg:
    """Monte-Carlo output average for an arbitrary likelihood factory
    (the vectorized ``IntEstimOutAvg.m``): ``like_factory(y)`` must return
    an estimator with ``estim(phat, pvar)``; ``channel(key, z)`` draws
    y ~ p(y|z)."""

    like_factory: object            # static: y -> likelihood pytree
    channel: object                 # static: (key, z) -> y
    key: jnp.ndarray
    n_samp: int = 8192
    cplx: bool = False

    def svar_avg(self, taup, varz):
        kp, kd, ky = jax.random.split(self.key, 3)
        vp = jnp.maximum(varz - taup, 1e-12)
        if self.cplx:
            kpr, kpi = jax.random.split(kp)
            kdr, kdi = jax.random.split(kd)
            p = jnp.sqrt(vp / 2) * (
                jax.random.normal(kpr, (self.n_samp,))
                + 1j * jax.random.normal(kpi, (self.n_samp,))
            )
            d = jnp.sqrt(taup / 2) * (
                jax.random.normal(kdr, (self.n_samp,))
                + 1j * jax.random.normal(kdi, (self.n_samp,))
            )
        else:
            p = jnp.sqrt(vp) * jax.random.normal(kp, (self.n_samp,))
            d = jnp.sqrt(taup) * jax.random.normal(kd, (self.n_samp,))
        z = p + d
        y = self.channel(ky, z)
        like = self.like_factory(y)
        _, zvar = like.estim(p, taup * jnp.ones(self.n_samp))
        return jnp.mean((1.0 - zvar / taup) / taup)


def gamp_se(in_avg: EstimInAvg, out_avg, beta: float, nit: int = 30,
            rvar_min: float = 1e-12):
    """Run the matched SE recursion (``gampSE.m:44-67``); returns the dict
    of trajectories {mse, taux, taup, taur} each of length nit (mse[0] is
    the prior variance)."""
    varx = jnp.mean(jnp.abs(in_avg.x) ** 2)
    varz = beta * varx

    def body(carry, _):
        mse, taux = carry
        taup = beta * jnp.maximum(taux, rvar_min)
        svar = out_avg.svar_avg(taup, varz)
        taur = jnp.maximum(1.0 / jnp.maximum(svar, 1e-30), rvar_min)
        mse_new, taux_new = in_avg.avg(taur)
        return (mse_new, taux_new), dict(mse=mse_new, taux=taux_new,
                                         taup=taup, taur=taur)

    mse0, _ = in_avg.avg(jnp.asarray(1e6))  # ≈ prior variance
    (_, _), traj = jax.lax.scan(body, (mse0, mse0), None, length=nit)
    return dict(
        mse=jnp.concatenate([mse0[None], traj["mse"]]),
        taux=jnp.concatenate([mse0[None], traj["taux"]]),
        taup=traj["taup"],
        taur=traj["taur"],
    )


# convenience samplers for the standard testbeds ---------------------------

def bg_sampler(p1: float, var0: float = 1.0, cplx: bool = False) -> Callable:
    """Bernoulli-Gaussian x ~ p1·N(0, var0) + (1−p1)·δ0."""

    def sample(key, n):
        ka, kg = jax.random.split(key)
        act = jax.random.uniform(ka, (n,)) < p1
        if cplx:
            kr, ki = jax.random.split(kg)
            g = (
                jax.random.normal(kr, (n,)) + 1j * jax.random.normal(ki, (n,))
            ) * jnp.sqrt(var0 / 2)
        else:
            g = jax.random.normal(kg, (n,)) * jnp.sqrt(var0)
        return jnp.where(act, g, 0.0)

    return sample


def s_transform(y, eigs, N: int, nit: int = 60):
    """S-transform of an N×N PSD Hermitian matrix with eigenvalues ``eigs``
    (``main/s_transform.m``, bisection branch): for y ∈ [−R/N, 0],

        S(y) = −(y+1)/y · η⁻¹(1+y),   η(γ) = mean(1/(1+λ·γ))

    over the zero-padded spectrum (R = rank).  The reference uses this in
    ``ampEst.m:221-268`` / ``Mini_AMP.m`` for the exact-rvar AMP mode on
    unitarily-invariant (non-i.i.d.) ensembles — the capability this
    framework covers via ``vamp_slm``'s LMMSE stage, so here the transform
    is exposed as a standalone spectral utility (SE analysis / oracle
    checks).  Vectorized over ``y``; fixed-count bisection → jit-friendly.
    Endpoints follow the reference: S(0)=1, S(−R/N)=inf; inputs outside
    [−R/N, 0] return NaN (the reference raises)."""
    y = jnp.asarray(y, jnp.float32)
    lam = jnp.zeros((N,), jnp.float32).at[: len(eigs)].set(
        jnp.asarray(eigs, jnp.float32)
    )
    pos = lam > 0
    R = jnp.sum(pos)
    lam_mean = jnp.mean(lam)
    inv_mean = jnp.sum(jnp.where(pos, 1.0 / jnp.where(pos, lam, 1.0), 0.0)) / R

    def eta(gam):
        return jnp.mean(1.0 / (1.0 + lam[..., :] * gam[..., None]), axis=-1)

    rn = R / N
    interior = (y > -rn) & (y < 0)
    ys = jnp.where(interior, y, -0.5 * rn)  # safe stand-in for the masked lanes
    lo = (1.0 / (1.0 + ys) - 1.0) / lam_mean
    hi = inv_mean / (ys + rn)

    def body(_, carry):
        lo, hi = carry
        gam = 0.5 * (lo + hi)
        too_big = eta(gam) < 1.0 + ys
        return jnp.where(too_big, lo, gam), jnp.where(too_big, gam, hi)

    lo, hi = jax.lax.fori_loop(0, nit, body, (lo, hi))
    gam = 0.5 * (lo + hi)
    s = -(ys + 1.0) / ys * gam
    out = jnp.where(interior, s, jnp.nan)
    out = jnp.where(y == 0, 1.0, out)
    out = jnp.where(y == -rn, jnp.inf, out)
    return out
