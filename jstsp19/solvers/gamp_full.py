"""Full-capability GAMP core — the ``gampEst.m`` feature set, in JAX.

This is the complete counterpart of the reference's main loop
(``MPbased_solvers/main/gampEst.m:386-630`` with options from
``main/GampOpt.m:1-140``), as opposed to the lean fixed-iteration
:func:`jstsp19.solvers.gamp.gamp`.  Capabilities:

* per-element variances (vector pvar/rvar; the ``uniformVariance`` option
  wraps the operator in :class:`jstsp19.ops.structured.UnifVarOp`);
* mean removal (``GampOpt.removeMean``) via the exact augmented operator
  :func:`jstsp19.ops.structured.demean_rc` with the NullPrior /
  DiracLikelihood estimator expansion of ``LinTransDemeanRC.m:222-240``;
* adaptive step with the moving acceptance window (``GampOpt.stepWindow``),
  in either the expected-log-likelihood form (``scaEstOut.logLike``) or the
  Bethe-free-energy form (``adaptStepBethe`` → ``scaEstOut.logScale``);
* max-sum (MAP) mode dispatching to the estimators' ``estim_map`` branches;
* pvar/rvar step damping (``pvarStep``/``rvarStep``), variance
  normalization (``varNorm``/scaleFac), stepMax backoff after repeated
  failures (``maxBadSteps``/``maxStepDecr``), Barzilai–Borwein steps
  (``bbStep``), zvarToPvarMax clamp, pvarMin/rvarMin robustness floors;
* per-iteration likelihood autotuning (the ``CAwgnEstimOut.m:117-146``
  ML noise-variance update) via ``tune_wvar``;
* bit-exact warm start: the returned :class:`GampState` carry can be fed
  back via ``state_in`` and continues the iteration exactly (the analog of
  ``GampOpt.warmStartCopy`` / the ``*Next`` fields of ``estFin``);
* full per-iteration histories (``estHist``) under ``save_hist``.

Design notes: the loop is a single ``lax.scan`` over ``nit`` fixed
iterations; the reference's early-exit ``while`` (tol / stepTol) is realized
by a ``stopped`` flag that freezes the carry, which keeps the program
compile-once with static shapes while preserving gampEst's stopping
semantics.  The reference's NaN-sentinel lazy initialization of the damping
anchors (``gampEst.m:418-426,584-605``) is kept literally — NaN anchors are
replaced elementwise on first use — because it is what makes warm starting
exact.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from jstsp19.ops.structured import UnifVarOp, demean_rc
from jstsp19.solvers.estim import (
    ConcatLikelihood,
    ConcatPrior,
    DiracLikelihood,
    NullPrior,
)

_EPS = float(jnp.finfo(jnp.float32).eps)


@dataclasses.dataclass(frozen=True)
class GampOptions:
    """Static solver options — field-for-field ``main/GampOpt.m`` with
    snake_case names; defaults match the reference."""

    nit: int = 200
    step: float = 1.0
    step_min: float = 0.0
    step_max: float = 1.0
    step_incr: float = 1.1
    step_decr: float = 0.5
    step_window: int = 20
    step_tol: float = 1e-10
    adapt_step: bool = True
    adapt_step_bethe: bool = False
    bb_step: bool = False
    max_bad_steps: float = float("inf")
    max_step_decr: float = 0.8
    tol: float = 1e-4
    pvar_step: bool = True
    rvar_step: bool = False
    var_norm: bool = False
    pvar_min: float = 1e-12
    rvar_min: float = 1e-12
    zvar_to_pvar_max: float = float("inf")
    remove_mean: bool = False
    uniform_variance: bool = False
    max_sum: bool = False
    tune_wvar: bool = False
    save_hist: bool = False
    # decimated histories: keep iterations hist_intvl, 2·hist_intvl, …
    # (``GampOpt.m:134-136``)
    hist_intvl: int = 1
    # derive xvar0 from a good point estimate xhat0 by the estimInvert
    # fixed point (``GampOpt.m:128-132``, ``gampEst.m:292-330``)
    xvar0auto: bool = False
    # custom stopping criterion (``GampOpt.stopFcn``/``stopFcn2``,
    # GampOpt.m:80-93): a JITTABLE callable ``state -> bool scalar``;
    # True freezes the iteration (same mechanism as tol/stepTol).  The
    # stopFcn form's arguments (val, xhat, xhatPrev, Axhat) are the
    # state's ``val``/``xhat_final``/``xhat_prev_final``/``axhat_final``.
    stop_fn: Optional[object] = None


class GampState(NamedTuple):
    """Complete scan carry — every field the reference's warm start needs
    (``gampEst.m:632-636,701-728`` estFin ``*Next``/``*Opt`` exports)."""

    it: jnp.ndarray
    stopped: jnp.ndarray
    # current iterates
    xhat: jnp.ndarray
    xvar: jnp.ndarray
    shat: jnp.ndarray
    svar: jnp.ndarray
    rhat: jnp.ndarray
    rvar: jnp.ndarray
    zhat: jnp.ndarray
    zvar: jnp.ndarray
    # last output-stage targets (persist across failed steps)
    shat_new: jnp.ndarray
    svar_new: jnp.ndarray
    # damping anchors from the last passed iteration
    xhat_opt: jnp.ndarray
    xhat_damp: jnp.ndarray
    xhat_damp_opt: jnp.ndarray
    shat_opt: jnp.ndarray
    svar_opt: jnp.ndarray
    pvar_opt: jnp.ndarray
    rvar_opt: jnp.ndarray
    a2xvar_opt: jnp.ndarray
    # exports from the last passed iteration
    xhat_final: jnp.ndarray
    xvar_final: jnp.ndarray
    xhat_prev_final: jnp.ndarray
    rhat_final: jnp.ndarray
    rvar_final: jnp.ndarray
    phat_final: jnp.ndarray
    pvar_final: jnp.ndarray
    zhat_final: jnp.ndarray
    zvar_final: jnp.ndarray
    shat_final: jnp.ndarray
    svar_final: jnp.ndarray
    axhat_final: jnp.ndarray
    # adaptive-step machinery
    step: jnp.ndarray
    step_max: jnp.ndarray
    fail_count: jnp.ndarray
    val: jnp.ndarray
    val_in: jnp.ndarray
    val_window: jnp.ndarray
    scale_fac: jnp.ndarray
    # likelihood carried for autotuning (pytree)
    likelihood: object


class GampEstFin(NamedTuple):
    """User-facing results (contracted to the original coordinates when
    mean removal is on) — the ``estFin`` struct of ``gampEst.m:701-729``."""

    xhat: jnp.ndarray
    xvar: jnp.ndarray
    rhat: jnp.ndarray
    rvar: jnp.ndarray
    phat: jnp.ndarray
    pvar: jnp.ndarray
    zhat: jnp.ndarray
    zvar: jnp.ndarray
    shat: jnp.ndarray
    svar: jnp.ndarray
    axhat: jnp.ndarray
    val: jnp.ndarray
    step: jnp.ndarray
    nit: jnp.ndarray


def augment_problem(prior, likelihood, op, opts: GampOptions):
    """Apply the removeMean / uniformVariance augmentations of
    ``gampEst.m:262-289`` — mean removal builds the exact (m+2)×(n+2)
    demeaned operator and pads the estimators with NullPrior (inputs) and a
    zero-observation DiracLikelihood (outputs)."""
    if opts.remove_mean:
        n = op.in_shape[0]
        m = op.out_shape[0]
        op = demean_rc(op)
        prior = ConcatPrior(priors=(prior, NullPrior()), sizes=(n, 2))
        likelihood = ConcatLikelihood(
            likes=(likelihood, DiracLikelihood(y=jnp.zeros((2,)))), sizes=(m, 2)
        )
        if opts.uniform_variance:
            op = UnifVarOp(op, in_avg=n, out_avg=m)
    elif opts.uniform_variance:
        op = UnifVarOp(op)
    return prior, likelihood, op


def _complexity(prior, likelihood):
    x0, _ = prior.init_moments()
    yref = getattr(likelihood, "y", getattr(likelihood, "lo", None))
    return jnp.iscomplexobj(jnp.asarray(x0)) or (
        yref is not None and jnp.iscomplexobj(yref)
    )


def _init_state(prior, likelihood, op, opts, x_init, xvar_init, cplx):
    (n,) = op.in_shape
    (m,) = op.out_shape
    x0, v0 = prior.init_moments()
    xdtype = jnp.complex64 if cplx else jnp.float32
    if x_init is not None:
        xhat = jnp.broadcast_to(jnp.asarray(x_init, xdtype), (n,))
    else:
        xhat = jnp.broadcast_to(jnp.asarray(x0, xdtype), (n,)).astype(xdtype)
    if xvar_init is not None:
        xvar = jnp.broadcast_to(jnp.asarray(xvar_init, jnp.float32), (n,))
    else:
        xvar = jnp.broadcast_to(jnp.asarray(v0, jnp.float32), (n,))
    nanv = jnp.full((n,), jnp.nan, jnp.float32)
    nanm = jnp.full((m,), jnp.nan, jnp.float32)
    nanx = jnp.full((n,), jnp.nan, xdtype)
    nanz = jnp.full((m,), jnp.nan, xdtype)
    # +inf fill: unpopulated slots never win the min, so the acceptance
    # test `val >= min(window)` becomes real as soon as ONE value has
    # been recorded (the reference grows valOpt from empty — a step can
    # fail from iteration 2).  A -inf fill disabled adaptation entirely
    # for the first step_window+1 iterations (round 5).
    window = jnp.full((max(opts.step_window, 0) + 1,), jnp.inf, jnp.float32)
    return GampState(
        it=jnp.zeros((), jnp.int32),
        stopped=jnp.zeros((), bool),
        xhat=xhat,
        xvar=xvar,
        shat=jnp.zeros((m,), xdtype),
        svar=nanm,
        rhat=nanx,
        rvar=nanv,
        zhat=nanz,
        zvar=nanm,
        shat_new=jnp.zeros((m,), xdtype),
        svar_new=nanm,
        xhat_opt=xhat,
        xhat_damp=nanx,
        xhat_damp_opt=nanx,
        shat_opt=jnp.zeros((m,), xdtype),
        svar_opt=nanm,
        pvar_opt=nanm,
        rvar_opt=nanv,
        a2xvar_opt=nanm,
        xhat_final=nanx,
        xvar_final=nanv,
        xhat_prev_final=nanx,
        rhat_final=nanx,
        rvar_final=nanv,
        phat_final=nanz,
        pvar_final=nanm,
        zhat_final=nanz,
        zvar_final=nanm,
        shat_final=jnp.zeros((m,), xdtype),
        svar_final=nanm,
        axhat_final=nanz,
        step=jnp.asarray(opts.step, jnp.float32),
        step_max=jnp.asarray(opts.step_max, jnp.float32),
        fail_count=jnp.zeros((), jnp.int32),
        val=jnp.asarray(jnp.nan, jnp.float32),
        val_in=jnp.zeros((), jnp.float32),
        val_window=window,
        scale_fac=jnp.ones((), jnp.float32),
        likelihood=likelihood,
    )


def _nanfix(anchor, fresh):
    """``if any(isnan(anchor)), anchor = fresh`` — the reference's lazy
    first-iteration initialization (``gampEst.m:418-426,584-605``), applied
    elementwise (a no-op after the first pass)."""
    return jnp.where(jnp.isnan(anchor), fresh, anchor)


@functools.partial(jax.jit, static_argnames=("opts",))
def _gamp_scan(prior, op, state: GampState, opts: GampOptions, column_norms):
    adapt = opts.adapt_step
    max_sum = opts.max_sum

    def estim_in(like_unused, rhat, rvar):
        if max_sum:
            return prior.estim_map(rhat, rvar)
        return prior.estim(rhat, rvar)

    def estim_out(like, phat, pvar):
        if max_sum:
            return like.estim_map(phat, pvar)
        return like.estim(phat, pvar)

    def val_out_fn(like, axhat, pvar, phat):
        if not adapt:
            return jnp.zeros((), jnp.float32)
        if not hasattr(like, "logscale" if opts.adapt_step_bethe else "loglike"):
            # likelihood provides no cost — adaptive acceptance degrades to
            # the valIn-only criterion (the reference errors here instead;
            # a fallback composes better with exotic channels)
            return jnp.zeros((), jnp.float32)
        if opts.adapt_step_bethe:
            return jnp.sum(like.logscale(axhat, pvar, phat)).astype(jnp.float32)
        if max_sum:
            # max-sum utility is the point log-likelihood at Axhat
            # (AwgnEstimOut.m logLike maxSum branch drops the pvar term)
            return jnp.sum(like.loglike(axhat, jnp.zeros_like(pvar))).astype(
                jnp.float32
            )
        return jnp.sum(like.loglike(axhat, pvar)).astype(jnp.float32)

    def val_in_fn(rhat, rvar, xhat, xvar):
        if not adapt:
            return jnp.zeros((), jnp.float32)
        if max_sum:
            if hasattr(prior, "val_map"):
                return jnp.sum(jnp.real(prior.val_map(xhat))).astype(jnp.float32)
            return jnp.zeros((), jnp.float32)
        if hasattr(prior, "val_neg_kl"):
            return jnp.sum(
                jnp.real(prior.val_neg_kl(rhat, rvar, xhat, xvar))
            ).astype(jnp.float32)
        return jnp.zeros((), jnp.float32)

    def body(st: GampState, _):
        if opts.stop_fn is not None:
            # custom stopping criterion (``GampOpt.stopFcn``/``stopFcn2``,
            # GampOpt.m:80-93): a jittable callable over the completed
            # state, evaluated at loop top so a True freezes this body
            # entirely — the fixed-shape analog of the reference's
            # ``break`` (the stopFcn arguments val/xhat/xhatPrev/Axhat
            # are the state's val/xhat_final/xhat_prev_final/axhat_final)
            st = st._replace(stopped=st.stopped | opts.stop_fn(st))
        like = st.likelihood
        # ---- output linear stage (gampEst.m:404-433) ----
        a2xvar = op.sq_mv(st.xvar)
        pvar = a2xvar
        axhat = op.mv(st.xhat)
        if opts.pvar_step:
            pvar_opt0 = _nanfix(st.pvar_opt, pvar)
            a2xvar_opt0 = _nanfix(st.a2xvar_opt, a2xvar)
            pvar = (1.0 - st.step) * pvar_opt0 + st.step * pvar
            a2xvar = (1.0 - st.step) * a2xvar_opt0 + st.step * a2xvar
        phat = axhat - (a2xvar / st.scale_fac) * st.shat
        pvar_robust = jnp.maximum(pvar, opts.pvar_min)

        # ---- utility and pass test (gampEst.m:437-455) ----
        val = val_out_fn(like, axhat, pvar, phat) + st.val_in
        val_min = jnp.min(st.val_window)
        passed = (
            (st.it == 0)
            | jnp.asarray(not adapt)
            | (st.step <= opts.step_min)
            | (val >= val_min)
            # no finite utility recorded yet (the it-0 NaN-sentinel val is
            # stored as +inf): auto-pass, the reference's isempty(valMin)
            # branch (gampEst.m:454)
            | ~jnp.isfinite(val_min)
        )

        # ---- pass branch: anchors, window, exports (gampEst.m:465-519) ----
        def sel(new, old):
            return jax.tree_util.tree_map(
                lambda a, b: jnp.where(passed, a, b), new, old
            )

        # likelihood autotuning on pass (CAwgnEstimOut.m ML tuning)
        if opts.tune_wvar:
            if isinstance(like, ConcatLikelihood):
                # mean-removal augmentation wraps the original likelihood
                # as the FIRST Concat block (the augmented rows are exact
                # zero-observation Diracs with nothing to tune) — tune
                # that block on its own slice, as the reference's
                # gampEst + autoTune + LinTransDemeanRC combination does
                base = like.likes[0]
                m0 = like.sizes[0]
                pv0 = (
                    pvar_robust[..., :m0]
                    if jnp.ndim(pvar_robust)
                    else pvar_robust
                )
                wvar_new = base.tune_wvar_ml(phat[..., :m0], pv0)
                base = dataclasses.replace(
                    base, wvar=jnp.where(passed, wvar_new, base.wvar)
                )
                like = dataclasses.replace(
                    like, likes=(base,) + like.likes[1:]
                )
            else:
                wvar_new = like.tune_wvar_ml(phat, pvar_robust)
                like = dataclasses.replace(
                    like, wvar=jnp.where(passed, wvar_new, like.wvar)
                )
            # utilities are only comparable under ONE noise level: after a
            # tune, re-evaluate the utility under the tuned likelihood so
            # the acceptance window keeps a consistent baseline (otherwise
            # each tune inflates val vs stale entries and the tune/accept
            # feedback spirals wvar toward zero)
            val = val_out_fn(like, axhat, pvar, phat) + st.val_in


        a2xvar_opt = sel(a2xvar, st.a2xvar_opt)
        pvar_opt = sel(pvar, st.pvar_opt)
        shat_opt = sel(st.shat, st.shat_opt)
        svar_opt = sel(st.svar, st.svar_opt)
        rvar_opt = sel(st.rvar, st.rvar_opt)
        xhat_damp_opt = sel(st.xhat_damp, st.xhat_damp_opt)
        xhat_opt = sel(st.xhat, st.xhat_opt)
        val_window = sel(
            # a NaN utility (forced pass) records +inf, which never
            # constrains future acceptances — recording -inf silently
            # re-disabled adaptation for a whole window length
            jnp.roll(st.val_window, -1)
            .at[-1]
            .set(jnp.where(jnp.isnan(val), jnp.inf, val)),
            st.val_window,
        )
        xhat_prev_final = sel(st.xhat_final, st.xhat_prev_final)
        xhat_final = sel(st.xhat, st.xhat_final)
        xvar_final = sel(st.xvar, st.xvar_final)
        rhat_final = sel(st.rhat, st.rhat_final)
        rvar_final = sel(st.rvar * st.scale_fac, st.rvar_final)
        phat_final = sel(phat, st.phat_final)
        pvar_final = sel(pvar, st.pvar_final)
        zhat_final = sel(st.zhat, st.zhat_final)
        zvar_final = sel(st.zvar, st.zvar_final)
        shat_final = sel(st.shat / st.scale_fac, st.shat_final)
        svar_final = sel(st.svar / st.scale_fac, st.svar_final)
        axhat_final = sel(axhat, st.axhat_final)

        # convergence (gampEst.m:496-498)
        dx = jnp.linalg.norm((xhat_prev_final - xhat_final).reshape(-1))
        nx = jnp.linalg.norm(xhat_final.reshape(-1))
        resid = jnp.where(nx > 0, dx / nx, jnp.inf)
        conv = passed & (st.it > 0) & (opts.tol > 0) & (resid < opts.tol)
        conv = conv & ~jnp.any(jnp.isnan(xhat_prev_final))

        # variance normalization (gampEst.m:515-519)
        scale_fac = jnp.where(
            passed & jnp.asarray(opts.var_norm),
            jnp.mean(pvar_robust),
            st.scale_fac,
        )

        # ---- output nonlinear stage (gampEst.m:521-524) ----
        zhat_cand, zvar_cand = estim_out(like, phat, pvar_robust)
        shat_cand = (scale_fac / pvar_robust) * (zhat_cand - phat)
        svar_cand = (scale_fac / pvar_robust) * (
            1.0 - jnp.minimum(zvar_cand / pvar_robust, opts.zvar_to_pvar_max)
        )
        zhat = sel(zhat_cand, st.zhat)
        zvar = sel(zvar_cand, st.zvar)
        shat_new = sel(shat_cand, st.shat_new)
        svar_new = sel(svar_cand, st.svar_new)


        # ---- step update (gampEst.m:526-557) ----
        step_pass = st.step
        if opts.bb_step:
            s_bb = xhat_opt - xhat_damp_opt
            num = jnp.sum(jnp.abs(s_bb * column_norms) ** 2)
            den = jnp.maximum(jnp.sum(jnp.abs(op.mv(s_bb)) ** 2), 1e-30)
            step_bb = num / den
            step_pass = jnp.where(
                st.it > 2, jnp.where(jnp.isnan(step_bb), step_pass, step_bb),
                step_pass,
            )
        fail_count = jnp.where(passed, st.fail_count, st.fail_count + 1)
        backoff = (~passed) & (fail_count > opts.max_bad_steps)
        fail_count = jnp.where(backoff, 0, fail_count)
        step_max = jnp.where(
            backoff,
            jnp.maximum(opts.step_min, opts.max_step_decr * st.step_max),
            st.step_max,
        )
        step = jnp.where(
            passed,
            jnp.minimum(
                opts.step_incr * jnp.maximum(step_pass, opts.step_min), step_max
            ),
            jnp.minimum(
                jnp.maximum(opts.step_min, opts.step_decr * st.step), step_max
            ),
        )
        stop_step = (~passed) & (opts.step_tol > 0) & (step < opts.step_tol)
        stopped = conv | stop_step

        # ---- damping (gampEst.m:583-606) ----
        svar_opt_d = _nanfix(svar_opt, svar_new)
        xhat_damp_opt_d = _nanfix(xhat_damp_opt, xhat_opt)
        shat = (1.0 - step) * shat_opt + step * shat_new
        svar = (1.0 - step) * svar_opt_d + step * svar_new
        svar = jnp.where(jnp.abs(svar) < _EPS, _EPS, svar)
        xhat_damp = (1.0 - step) * xhat_damp_opt_d + step * xhat_opt
        rvar = 1.0 / op.sq_rmv(svar)
        if opts.rvar_step:
            rvar_opt_d = _nanfix(rvar_opt, rvar)
            rvar = (1.0 - step) * rvar_opt_d + step * rvar

        # ---- input stages (gampEst.m:608-627) ----
        rhat = xhat_damp + rvar * op.rmv(shat)
        rvar_robust = jnp.maximum(rvar, opts.rvar_min)
        xhat, xvar = estim_in(like, rhat, rvar_robust * scale_fac)
        xvar = jnp.real(xvar)
        val_in = val_in_fn(rhat, rvar_robust * scale_fac, xhat, xvar)

        new = GampState(
            it=st.it + 1,
            stopped=st.stopped | stopped,
            xhat=xhat,
            xvar=xvar,
            shat=shat,
            svar=svar,
            rhat=rhat,
            rvar=rvar,
            zhat=zhat,
            zvar=zvar,
            shat_new=shat_new,
            svar_new=svar_new,
            xhat_opt=xhat_opt,
            xhat_damp=xhat_damp,
            xhat_damp_opt=xhat_damp_opt_d,
            shat_opt=shat_opt,
            svar_opt=svar_opt_d,
            pvar_opt=pvar_opt,
            rvar_opt=rvar_opt,
            a2xvar_opt=a2xvar_opt,
            xhat_final=xhat_final,
            xvar_final=xvar_final,
            xhat_prev_final=xhat_prev_final,
            rhat_final=rhat_final,
            rvar_final=rvar_final,
            phat_final=phat_final,
            pvar_final=pvar_final,
            zhat_final=zhat_final,
            zvar_final=zvar_final,
            shat_final=shat_final,
            svar_final=svar_final,
            axhat_final=axhat_final,
            step=step,
            step_max=step_max,
            fail_count=fail_count,
            val=val,
            val_in=val_in,
            val_window=val_window,
            scale_fac=scale_fac,
            likelihood=like,
        )
        # freeze everything once stopped (fixed-shape analog of the
        # reference's while-loop exit)
        out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(st.stopped, a, b), st, new
        )
        if opts.save_hist:
            ys = dict(
                xhat=out.xhat_final,
                xvar=out.xvar_final,
                rhat=out.rhat_final,
                rvar=out.rvar_final,
                phat=out.phat_final,
                pvar=out.pvar_final,
                zhat=out.zhat_final,
                zvar=out.zvar_final,
                shat=out.shat_final,
                svar=out.svar_final,
                val=val,
                step=out.step,
                passed=passed & ~st.stopped,
                resid=resid,
                stopped=st.stopped,
            )
        else:
            ys = dict(val=val, step=out.step, passed=passed & ~st.stopped,
                      resid=resid, stopped=st.stopped)
        return out, ys

    return jax.lax.scan(body, state, None, length=opts.nit)


def _estim_invert(mod, target, var, iters: int = 50, stepsize: float = 0.25):
    """Find ``phat`` such that ``mod.estim(phat, var)[0] ≈ target`` by a
    damped fixed-point iteration (``main/estimInvert.m:10``; stepsize
    matches the reference's 0.25 default)."""

    def body(_, ph):
        zh, _ = mod.estim(ph, var)
        return ph + stepsize * (target - zh)

    ph = jax.lax.fori_loop(0, iters, body, target)
    zh, zv = mod.estim(ph, var)
    return ph, zh, zv


def _xvar0_auto(prior, likelihood, op, xhat0, opts, iters: int = 20):
    """Automatic xvar0 from a point estimate (``gampEst.m:292-330``): the
    fixed point of GAMP's variance propagation with the means pinned at
    ``xhat0`` via inverted estimators."""
    eps = 1e-20
    xhat0 = jnp.broadcast_to(jnp.asarray(xhat0), op.in_shape)  # scalar ok
    ax = op.mv(xhat0)
    xvar0 = jnp.maximum(jnp.mean(jnp.abs(xhat0) ** 2), 1e-12)
    xvar = jnp.broadcast_to(xvar0.astype(jnp.float32), op.in_shape)

    def body(_, xvar):
        pvar = jnp.maximum(opts.pvar_min, op.sq_mv(xvar))
        _, _, zvar = _estim_invert(likelihood, ax, pvar)
        svar = (1.0 - zvar / pvar) / pvar
        svar = jnp.where(jnp.abs(svar) < eps, eps, svar)
        rvar = jnp.maximum(
            opts.rvar_min, 1.0 / jnp.maximum(op.sq_rmv(svar), eps)
        )
        _, _, xvar_new = _estim_invert(prior, xhat0, rvar)
        return jnp.broadcast_to(jnp.real(xvar_new), xvar.shape)

    return jax.lax.fori_loop(0, iters, body, xvar)


def gamp_est(
    prior,
    likelihood,
    op,
    opts: Optional[GampOptions] = None,
    state_in: Optional[GampState] = None,
    x_init=None,
    xvar_init=None,
):
    """Run the full GAMP loop; returns ``(estfin, state, hist)``.

    ``state_in`` (a previous call's ``state``) warm-starts bit-exactly —
    running ``nit=a`` then ``nit=b`` from its state equals one ``nit=a+b``
    run (the ``test/warmStart`` contract of the reference).  ``estfin`` is
    reported in the ORIGINAL coordinates (mean-removal augmentation is
    contracted away per ``gampEst.m:663-684``); ``state`` stays in the
    augmented coordinates so it can be fed back.
    """
    opts = opts or GampOptions()
    cplx = _complexity(prior, likelihood) or (
        x_init is not None and jnp.iscomplexobj(jnp.asarray(x_init))
    )
    if (
        opts.xvar0auto
        and state_in is None
        and x_init is not None
        and xvar_init is None
    ):
        xvar_init = _xvar0_auto(
            prior, likelihood, op, jnp.asarray(x_init), opts
        )
    prior_a, like_a, op_a = augment_problem(prior, likelihood, op, opts)
    if state_in is None:
        # with remove_mean, (n,)-shaped user inits can't seed the (n+2,)
        # augmented state directly — init with the prior placeholders and
        # apply the exact expansion below (round 5: a vector x_init /
        # xvar_init / the xvar0auto output previously crashed broadcasting)
        state = _init_state(
            prior_a, like_a, op_a, opts,
            None if opts.remove_mean else x_init,
            None if opts.remove_mean else xvar_init,
            cplx,
        )
        if opts.remove_mean:
            # replace the NullPrior placeholder init of the two augmented
            # entries by the exact expansion (gampEst.m:271-272)
            dm = op_a.base if opts.uniform_variance else op_a
            n = dm.base.in_shape[0]
            x_base = (
                jnp.asarray(x_init, state.xhat.dtype)
                if x_init is not None
                else state.xhat[..., :n]
            )
            x_exp = dm.expand_xhat(jnp.broadcast_to(x_base, (n,)))
            v_base = (
                jnp.asarray(xvar_init, jnp.float32)
                if xvar_init is not None
                else state.xvar[..., :n]
            )
            v_exp = dm.expand_xvar(jnp.broadcast_to(v_base, (n,)))
            state = state._replace(xhat=x_exp, xhat_opt=x_exp, xvar=v_exp)
    else:
        state = state_in
    if opts.bb_step:
        column_norms = jnp.sqrt(op_a.sq_rmv(jnp.ones(op_a.out_shape)))
    else:
        column_norms = jnp.zeros(op_a.in_shape, jnp.float32)
    state, hist = _gamp_scan(prior_a, op_a, state, opts, column_norms)

    def contract(v):
        return v[..., :-2] if opts.remove_mean else v

    estfin = GampEstFin(
        xhat=contract(state.xhat_final),
        xvar=contract(state.xvar_final),
        rhat=contract(state.rhat_final),
        rvar=contract(state.rvar_final),
        phat=contract(state.phat_final),
        pvar=contract(state.pvar_final),
        zhat=contract(state.zhat_final),
        zvar=contract(state.zvar_final),
        shat=contract(state.shat_final),
        svar=contract(state.svar_final),
        axhat=contract(state.axhat_final),
        val=state.val,
        step=state.step,
        nit=state.it,
    )
    if opts.hist_intvl > 1:
        # decimated histories: iterations intvl, 2·intvl, … (GampOpt.m:134-136)
        k = opts.hist_intvl
        hist = jax.tree_util.tree_map(lambda a: a[k - 1 :: k], hist)
    return estfin, state, hist
