"""Generalized AMP and FISTA solvers.

JAX counterparts of the GAMPmatlab core loop
(``MPbased_solvers/main/gampEst.m`` — sum-product GAMP with Onsager
correction) and ``main/fistaEst.m`` (FISTA for l1).  The estimator modules
of :mod:`jstsp19.solvers.estim` play the EstimIn/EstimOut roles; any
:class:`jstsp19.ops.base.LinOp` (with its exact ``sq_mv``/``sq_rmv``
variance pair) plays the LinTrans role.  Scalar-variance mode (the
``GampOpt.uniformVariance`` analog) keeps the state one scalar per side —
the fully-batched default.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jstsp19.solvers.sparse import soft_threshold


class GampResult(NamedTuple):
    x: jnp.ndarray
    xvar: jnp.ndarray
    rhat: jnp.ndarray
    rvar: jnp.ndarray


def _state_dtype(x0, yref):
    """complex64 iff either the prior's initial moment or the observation
    is complex; fully-real problems (e.g. non-negative priors with real or
    interval observations) keep a real float32 state."""
    if jnp.iscomplexobj(jnp.asarray(x0)):
        return jnp.complex64
    if yref is not None and jnp.iscomplexobj(yref):
        return jnp.complex64
    return jnp.float32


@functools.partial(jax.jit, static_argnames=("nit", "dtype", "adaptive"))
def gamp(
    prior,
    likelihood,
    op,
    nit: int = 50,
    step: float = 0.9,
    var_floor: float = 1e-12,
    dtype=None,
    x_init=None,
    adaptive: bool = False,
) -> GampResult:
    """Sum-product GAMP for ``y ~ p(y | op.mv(x))``.

    The core recursion of ``gampEst.m`` (forward variance → output posterior
    → Onsager-corrected residual → backward variance → input posterior) with
    constant step damping on (xhat, shat); adaptive-step Bethe acceptance is
    not replicated (fixed iterations compile better and the damped loop is
    stable on the workloads here).
    """
    x0, v0 = prior.init_moments()
    yref = getattr(likelihood, "y", getattr(likelihood, "lo", None))
    xdtype = dtype if dtype is not None else _state_dtype(x0, yref)
    if x_init is not None:
        # e.g. a spectral initialization for phase retrieval — the
        # symmetric zero start is a fixed point of magnitude-only channels
        xhat = jnp.asarray(x_init, xdtype)
    else:
        xhat = jnp.broadcast_to(jnp.asarray(x0, xdtype), op.in_shape).astype(xdtype)
    xvar = jnp.broadcast_to(jnp.asarray(v0, jnp.float32), op.in_shape).astype(
        jnp.float32
    )
    shat = jnp.zeros(op.out_shape, xdtype)
    rhat0 = xhat
    rvar0 = jnp.ones_like(xvar)

    def _iterate(xhat, xvar, shat, stp):
        # output linear stage
        zvar = jnp.maximum(op.sq_mv(xvar), var_floor)
        phat = op.mv(xhat) - zvar * shat
        # output nonlinear stage
        z0, zvar0 = likelihood.estim(phat, zvar)
        shat_new = (z0 - phat) / zvar
        svar = jnp.maximum((1.0 - zvar0 / zvar) / zvar, var_floor)
        shat_new = stp * shat_new + (1 - stp) * shat
        # input linear stage
        rvar = 1.0 / jnp.maximum(op.sq_rmv(svar), var_floor)
        rhat = xhat + rvar * op.rmv(shat_new)
        # input nonlinear stage
        xhat_new, xvar_new = prior.estim(rhat, rvar)
        xhat_new = stp * xhat_new + (1 - stp) * xhat
        xvar_new = jnp.maximum(xvar_new, var_floor)
        return xhat_new, xvar_new, shat_new, rhat, rvar, z0, zvar

    if not adaptive:

        def body(carry, _):
            xhat, xvar, shat, _, _ = carry
            xhat, xvar, shat, rhat, rvar, _, _ = _iterate(xhat, xvar, shat, step)
            return (xhat, xvar, shat, rhat, rvar), None

        (xhat, xvar, shat, rhat, rvar), _ = jax.lax.scan(
            body, (xhat, xvar, shat, rhat0, rvar0), None, length=nit
        )
        return GampResult(x=xhat, xvar=xvar, rhat=rhat, rvar=rvar)

    # adaptive-step mode (the ``GampOpt.adaptStep`` capability,
    # ``gampEst.m`` step acceptance): a candidate update is accepted only
    # if the normalized output-residual cost does not increase; rejection
    # reverts the state and shrinks the step (the scan-friendly form of
    # gampEst's redo-with-smaller-step), acceptance grows it back.
    STEP_MIN, STEP_MAX, INCR, DECR = 0.05, 1.0, 1.1, 0.5

    def body_a(carry, _):
        state, stp, cost_prev = carry
        xhat, xvar, shat, rhat, rvar = state
        xh_n, xv_n, sh_n, rh_n, rv_n, z0, zvar = _iterate(xhat, xvar, shat, stp)
        # unnormalized output residual: dividing by zvar would penalize the
        # growing confidence of good iterates and reject them
        cost = jnp.mean(jnp.abs(z0 - op.mv(xh_n)) ** 2)
        accept = cost <= cost_prev
        new_state = (xh_n, xv_n, sh_n, rh_n, rv_n)
        state_next = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), new_state, state
        )
        stp_next = jnp.where(
            accept,
            jnp.minimum(stp * INCR, STEP_MAX),
            jnp.maximum(stp * DECR, STEP_MIN),
        )
        cost_next = jnp.where(accept, cost, cost_prev)
        return (state_next, stp_next, cost_next), None

    init = (
        (xhat, xvar, shat, rhat0, rvar0),
        jnp.asarray(step, jnp.float32),
        jnp.asarray(jnp.inf, jnp.float32),
    )
    (state, _, _), _ = jax.lax.scan(body_a, init, None, length=nit)
    xhat, xvar, shat, rhat, rvar = state
    return GampResult(x=xhat, xvar=xvar, rhat=rhat, rvar=rvar)


@functools.partial(jax.jit, static_argnames=("nit",))
def fista(y, op, lam, nit: int = 100, lipschitz=None):
    """FISTA for ``min ½‖y − op.mv(x)‖² + λ‖x‖₁`` (complex soft-threshold),
    the ``fistaEst.m`` capability.  ``lipschitz`` defaults to a power-iteration
    estimate of ‖AᴴA‖."""
    if lipschitz is None:
        v = jnp.ones(op.in_shape, jnp.complex64)

        def power(v, _):
            w = op.rmv(op.mv(v))
            return w / jnp.maximum(jnp.linalg.norm(w.reshape(-1)), 1e-20), None

        v, _ = jax.lax.scan(power, v, None, length=20)
        w = op.rmv(op.mv(v))
        lipschitz = jnp.real(jnp.vdot(v, w)) / jnp.maximum(
            jnp.real(jnp.vdot(v, v)), 1e-20
        )
    L = jnp.maximum(lipschitz, 1e-12)

    x = jnp.zeros(op.in_shape, jnp.complex64)
    z = x
    t = jnp.asarray(1.0, jnp.float32)

    def body(carry, _):
        x, z, t = carry
        grad = op.rmv(op.mv(z) - y)
        x_new = soft_threshold(z - grad / L, lam / L)
        t_new = (1.0 + jnp.sqrt(1.0 + 4.0 * t**2)) / 2.0
        z_new = x_new + (t - 1.0) / t_new * (x_new - x)
        return (x_new, z_new, t_new), None

    (x, z, t), _ = jax.lax.scan(body, (x, z, t), None, length=nit)
    return x


@functools.partial(jax.jit, static_argnames=("nit",))
def amp(y, op, prior, nit: int = 50):
    """Plain AMP with Onsager correction (the ``ampEst.m`` capability) for
    ``y = op.mv(x) + w`` with an i.i.d.-subgaussian operator of unit-norm
    columns; variance tracked by the scalar state of the standard AMP
    recursion."""
    M = 1
    for s in op.out_shape:
        M *= s
    N = 1
    for s in op.in_shape:
        N *= s
    delta = M / N
    xdtype = _state_dtype(prior.init_moments()[0], y)
    x = jnp.zeros(op.in_shape, xdtype)
    z = y

    def body(carry, _):
        x, z = carry
        tau2 = jnp.mean(jnp.abs(z) ** 2)
        r = x + op.rmv(z)
        x_new, xvar = prior.estim(r, tau2 / delta)
        onsager = jnp.mean(xvar) / (tau2 / delta) / delta
        z_new = y - op.mv(x_new) + z * onsager
        return (x_new, z_new), None

    (x, z), _ = jax.lax.scan(body, (x, z), None, length=nit)
    return x


def _sure_soft(r, v, tau_grid):
    """SURE values of the (complex-aware) soft threshold over a threshold
    grid: Stein's unbiased risk estimate of E‖η_τ(r) − x‖² given
    r = x + noise(var v).  Complex entries count two real dimensions."""
    mag = jnp.abs(r)
    m = mag[..., None]
    t = tau_grid
    resid2 = jnp.minimum(m, t) ** 2
    alive = (m > t).astype(jnp.float32)
    if jnp.iscomplexobj(r):
        div = alive * (2.0 - t / jnp.maximum(m, 1e-30))
    else:
        div = alive * 2.0
    n = mag.size
    return jnp.sum(resid2.reshape(-1, t.shape[-1]), axis=0) + v * (
        jnp.sum(div.reshape(-1, t.shape[-1]), axis=0) - n
    )


@functools.partial(jax.jit, static_argnames=("nit", "n_grid"))
def sure_amp(y, op, nit: int = 50, n_grid: int = 32):
    """AMP with a per-iteration SURE-optimal soft threshold — the
    ``SURE_BAMP`` capability (``MPbased_solvers/SURE_BAMP/``): no prior
    parameters to hand-tune; the threshold minimizing Stein's unbiased risk
    estimate over a quantile grid of |r| is selected each iteration."""
    M = 1
    for s in op.out_shape:
        M *= s
    N = 1
    for s in op.in_shape:
        N *= s
    delta = M / N
    xdtype = jnp.complex64 if jnp.iscomplexobj(y) else jnp.float32
    x = jnp.zeros(op.in_shape, xdtype)
    z = y
    qs = jnp.linspace(0.0, 1.0, n_grid)

    def body(carry, _):
        x, z = carry
        tau2 = jnp.mean(jnp.abs(z) ** 2)
        v = tau2 / delta
        r = x + op.rmv(z)
        grid = jnp.quantile(jnp.abs(r).reshape(-1), qs)
        sure = _sure_soft(r, v, grid)
        tau = grid[jnp.argmin(sure)]
        mag = jnp.abs(r)
        shrunk = jnp.maximum(mag - tau, 0.0)
        x_new = jnp.where(mag > 0, r / jnp.maximum(mag, 1e-30) * shrunk, 0.0)
        # empirical divergence for the Onsager term
        alive = (mag > tau).astype(jnp.float32)
        if jnp.iscomplexobj(y):
            df = jnp.mean(alive * (1.0 - 0.5 * tau / jnp.maximum(mag, 1e-30)))
        else:
            df = jnp.mean(alive)
        z_new = y - op.mv(x_new) + z * df / delta
        return (x_new, z_new), None

    (x, z), _ = jax.lax.scan(body, (x, z), None, length=nit)
    return x


@functools.partial(
    jax.jit, static_argnames=("nit", "rvar_method", "bisect_iters", "damp")
)
def amp_est(
    y,
    op,
    prior,
    nit: int = 50,
    rvar_method: str = "mean",
    wvar=None,
    evals_aah=None,
    rvar_min: float = 1e-12,
    bisect_iters: int = 50,
    damp: float = 1.0,
):
    """The full ``ampEst.m`` main loop (``ampEst.m:180-290``), both
    variance branches:

    * **standard AMP** — Onsager gain ``(n/m)·xvar/rvar``; denoiser-input
      variance by ``rvar_method``: ``'mean'`` (power of the corrected
      residual), ``'median'`` (robust MAD estimate,
      ``ampEst.m:236-241`` — the complex branch uses √(2/log4)·median|v̂|),
      or ``'wvar'`` (the oracle ``wvar + (n/m)·xvar``, needs ``wvar``);
    * **S-AMP** (``evals_aah`` given: the spectrum of A·Aᴴ) — for
      unitarily-invariant NON-i.i.d. ensembles: Onsager gain
      ``1 − 1/S(−xvar/rvar)`` (``ampEst.m:221-222``) and ``rvar`` from the
      fixed point ``rvar = wvar·S(−xvar/rvar)`` by bisection
      (``ampEst.m:250-268``), with ``S`` the :func:`s_transform` of the
      operator spectrum.  Needs ``wvar``.

    Assumes unit-norm columns (the reference's ``normalizeA`` path —
    callers normalize; ``checkA`` is a host-side assertion there).
    Returns the final estimate ``x``.

    ``damp`` (documented deviation; 1.0 = reference-faithful): convex
    damping of the corrected-residual recursion.  The reference clips the
    S-transform query at ``m/n − 1e-3`` (``ampEst.m:221``), and near that
    rank edge S explodes, driving the Onsager gain to 1 (the residual
    memory stops decaying) — at high spectral condition the undamped
    recursion then diverges exactly like the reference's would.
    ``damp≈0.5`` recovers convergence at condition 100+ (tested); same
    damping role as ``VampGlmOpt.damp``.
    """
    from jstsp19.solvers.gamp_se import s_transform

    M = 1
    for s in op.out_shape:
        M *= s
    N = 1
    for s in op.in_shape:
        N *= s
    delta = M / N
    x0, xvar0 = prior.init_moments()
    xdtype = _state_dtype(x0, y)
    cplx = jnp.iscomplexobj(jnp.zeros((), xdtype))
    # start from the prior mean, as the reference's EstimIn init does
    x = jnp.broadcast_to(jnp.asarray(x0, xdtype), op.in_shape)

    if evals_aah is not None:
        # s_transform's open domain is (−R/N, 0) with R = rank(A·Aᴴ) —
        # smaller than (−M/N, 0) for rank-deficient ensembles (and for
        # M > N the zero-padding caps R at N).  The reference clips only
        # at m/n − 1e-3 (ampEst.m:221) and NaNs outside; clamp to the
        # actual edge so rank-deficient spectra degrade gracefully.
        _rn = jnp.count_nonzero(evals_aah > 0) / N
        _edge = jnp.maximum(jnp.minimum(delta, _rn) - 1e-3, 1e-6)

    def S_of(div):
        return s_transform(jnp.clip(div, -_edge, -1e-9), evals_aah, N)

    def rvar_bisect(xvar):
        # rvar = wvar·S(−xvar/rvar): monotone in rvar → bisection
        # (ampEst.m:250-268).  The reference fixes hi = 100·lo and warns
        # when the bracket misses; here hi is expanded (×100 up to 4
        # times) until the endpoint error is nonnegative, so very sparse
        # priors (lo ≪ the fixed point) still bracket correctly.
        lo = jnp.maximum((1.0 / delta) * xvar, rvar_min)

        def err(r):
            return r - wvar * S_of(-xvar / r)

        def expand(_, hi):
            return jnp.where(err(hi) < 0, hi * 100.0, hi)

        hi = jax.lax.fori_loop(0, 4, expand, lo * 100.0)

        def body(_, carry):
            lo, hi = carry
            mid = 0.5 * (lo + hi)
            return jnp.where(err(mid) > 0, lo, mid), jnp.where(
                err(mid) > 0, mid, hi
            )

        lo, hi = jax.lax.fori_loop(0, bisect_iters, body, (lo, hi))
        return 0.5 * (lo + hi)

    def body(carry, _):
        x, vhat, rvar_prev, xvar, it = carry
        div = xvar / rvar_prev
        if evals_aah is not None:
            gain = 1.0 - 1.0 / S_of(-div)
        else:
            gain = div / delta
        vhat = damp * ((y - op.mv(x)) + gain * vhat) + (1.0 - damp) * vhat
        if evals_aah is not None:
            rvar = rvar_bisect(xvar)
        elif rvar_method == "median":
            mag = jnp.abs(vhat)
            if cplx:
                rvar = (jnp.sqrt(2.0 / jnp.log(4.0)) * jnp.median(mag)) ** 2
            else:
                rvar = (jnp.median(mag) / 0.6745) ** 2
        elif rvar_method == "wvar":
            rvar = wvar + xvar / delta
        else:  # 'mean'
            rvar = jnp.mean(jnp.abs(vhat) ** 2)
        # first iteration always uses the residual power (ampEst.m:229-231)
        rvar = jnp.where(it == 0, jnp.mean(jnp.abs(vhat) ** 2), rvar)
        rvar = jnp.maximum(rvar, rvar_min)
        rhat = x + op.rmv(vhat)
        x_new, Xvar = prior.estim(rhat, rvar)
        return (x_new, vhat, rvar, jnp.mean(jnp.real(Xvar)), it + 1), None

    carry0 = (
        x,
        jnp.zeros(op.out_shape, xdtype),
        jnp.asarray(1.0, jnp.float32),
        jnp.asarray(jnp.real(xvar0).mean(), jnp.float32),
        jnp.zeros((), jnp.int32),
    )
    (x, _, _, _, _), _ = jax.lax.scan(body, carry0, None, length=nit)
    return x
