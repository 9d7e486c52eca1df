"""Full BiG-AMP: per-element variances, adaptive step, X2 variant, Lite.

JAX counterparts of the remaining BiGAMP-family capabilities:

* :func:`bigamp_est` — the complete Parker–Schniter recursion of
  ``BiGAMP/BiGAMP.m:370-830`` with PER-ELEMENT variances (the
  ``uniformVariance=false`` mode the scalar core in
  :mod:`jstsp19.solvers.bigamp` does not cover), masked observations,
  arbitrary elementwise likelihoods, adaptive step with the
  moving-window acceptance test, pvar damping, gain modes, and an optional
  KNOWN linear branch ``Z = A·X + A2·X2`` — which is exactly the
  ``BiGAMP/BiGAMP_X2.m`` variant (self-calibration: a known dictionary A2
  with unknown coefficients X2 alongside the unknown bilinear part).
* :func:`bigamp_lite` — ``BiGAMP/BiGAMP_Lite.m:110-520``: the
  all-Gaussian scalar-variance fast path where both input nonlinear stages
  collapse to closed-form gains (no estimator-module dispatch at all) —
  the reference's high-throughput mode, and the natural accelerator shape (three
  dense matmuls per iteration, everything else elementwise).

Shapes follow the repo convention: Z (L, M) = A (L, R) · X (R, M), mask
(L, M).  The reference's M×N·N×L is the transpose of this — docstring
citations map accordingly.

Everything is a fixed-length ``lax.scan`` (compile-once, static shapes);
the adaptive pass/fail machinery freezes the anchors exactly as
``gampEst``-style fail steps do.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class BigAmpOptions:
    """Static options — ``BiGAMP/BiGAMPOpt.m`` defaults."""

    nit: int = 250
    step: float = 0.05
    step_min: float = 0.05
    step_max: float = 0.5
    step_incr: float = 1.1
    step_decr: float = 0.5
    step_window: int = 1
    step_filter: float = 0.0
    adapt_step: bool = True
    pvar_step: bool = True
    pvar_min: float = 1e-13
    xvar_min: float = 0.0
    avar_min: float = 0.0
    zvar_to_pvar_max: float = 0.99
    var_thresh: float = 1e6
    gain_mode: int = 1
    var_norm: bool = False


class BigAmpFullResult(NamedTuple):
    A: jnp.ndarray
    X: jnp.ndarray
    Z: jnp.ndarray
    Avar: jnp.ndarray
    Xvar: jnp.ndarray
    X2: Optional[jnp.ndarray] = None
    # EM quantities (BiGAMP.m saveEM exports)
    Rx: jnp.ndarray = None
    rvar_x: jnp.ndarray = None
    Qa: jnp.ndarray = None
    qvar_a: jnp.ndarray = None


def _rand_init(key, shape, m0, v0, dtype):
    ex2 = jnp.abs(m0) ** 2 + v0
    if jnp.issubdtype(dtype, jnp.complexfloating):
        w = (
            jax.random.normal(key, shape)
            + 1j * jax.random.normal(jax.random.fold_in(key, 1), shape)
        ).astype(dtype) * jnp.sqrt(ex2 / 2)
    else:
        w = jax.random.normal(key, shape).astype(dtype) * jnp.sqrt(ex2)
    return jnp.asarray(m0, dtype) + w


@functools.partial(
    jax.jit, static_argnames=("rank", "opts", "has_x2", "likelihood_none")
)
def _bigamp_pev_scan(
    Y,
    mask,
    rank,
    prior_a,
    prior_x,
    noise_var,
    key,
    opts: BigAmpOptions,
    likelihood,
    likelihood_none: bool,
    A2,
    prior_x2,
    has_x2: bool,
    init_A,
    init_X,
):
    L, M = Y.shape
    R = rank
    cdt = Y.dtype
    rdt = jnp.float32
    m = mask.astype(rdt)
    nv = jnp.asarray(noise_var, rdt)

    kA, kX, kX2 = jax.random.split(key, 3)
    ma, va = prior_a.init_moments()
    mx, vx = prior_x.init_moments()
    Ahat = init_A if init_A is not None else _rand_init(kA, (L, R), ma, va, cdt)
    Xhat = init_X if init_X is not None else _rand_init(kX, (R, M), mx, vx, cdt)
    Avar = jnp.broadcast_to(jnp.asarray(jnp.real(va), rdt), (L, R))
    Xvar = jnp.broadcast_to(jnp.asarray(jnp.real(vx), rdt), (R, M))

    if has_x2:
        N2 = A2.shape[1]
        mx2, vx2 = prior_x2.init_moments()
        X2hat = jnp.full((N2, M), mx2, cdt)  # deterministic prior mean
        X2var = jnp.broadcast_to(jnp.asarray(jnp.real(vx2), rdt), (N2, M))
        A2sq = jnp.abs(A2) ** 2
    else:
        X2hat = jnp.zeros((1, M), cdt)
        X2var = jnp.zeros((1, M), rdt)
        A2sq = None

    Shat = jnp.zeros((L, M), cdt)
    Svar = jnp.zeros((L, M), rdt)

    def out_estim(phat, pvar):
        if not likelihood_none:
            return likelihood.estim(phat, pvar)
        gain = pvar / (pvar + nv)
        return phat + gain * (Y - phat), gain * nv

    def out_loglike(zhat, pvar):
        if not likelihood_none and hasattr(likelihood, "loglike"):
            return likelihood.loglike(zhat, pvar)
        return -(jnp.abs(Y - zhat) ** 2 + pvar) / jnp.maximum(nv, 1e-20)

    class Carry(NamedTuple):
        it: jnp.ndarray
        Ahat: jnp.ndarray
        Avar: jnp.ndarray
        Xhat: jnp.ndarray
        Xvar: jnp.ndarray
        X2hat: jnp.ndarray
        X2var: jnp.ndarray
        Shat: jnp.ndarray
        Svar: jnp.ndarray
        AhatBar: jnp.ndarray
        XhatBar: jnp.ndarray
        ShatOpt: jnp.ndarray
        SvarOpt: jnp.ndarray
        # last ACCEPTED output-stage targets (BiGAMP.m keeps shatNew
        # across failed steps; falling back to the damped Shat compounds
        # the shrink geometrically on repeated failures)
        ShatNewOpt: jnp.ndarray
        SvarNewOpt: jnp.ndarray
        AhatBarOpt: jnp.ndarray
        XhatBarOpt: jnp.ndarray
        AhatOpt: jnp.ndarray
        XhatOpt: jnp.ndarray
        pvarOpt: jnp.ndarray
        zvarOpt: jnp.ndarray
        step: jnp.ndarray
        val_window: jnp.ndarray
        val_in: jnp.ndarray
        Rx: jnp.ndarray
        rvar_x: jnp.ndarray
        Qa: jnp.ndarray
        qvar_a: jnp.ndarray

    carry0 = Carry(
        it=jnp.zeros((), jnp.int32),
        Ahat=Ahat,
        Avar=Avar,
        Xhat=Xhat,
        Xvar=Xvar,
        X2hat=X2hat,
        X2var=X2var,
        Shat=Shat,
        Svar=Svar,
        AhatBar=Ahat,
        XhatBar=Xhat,
        ShatOpt=Shat,
        SvarOpt=Svar,
        ShatNewOpt=Shat,
        SvarNewOpt=Svar,
        AhatBarOpt=Ahat,
        XhatBarOpt=Xhat,
        AhatOpt=Ahat,
        XhatOpt=Xhat,
        pvarOpt=jnp.zeros((L, M), rdt),
        zvarOpt=jnp.zeros((L, M), rdt),
        # the first-iteration step1=1 special case is handled inside the
        # body; the carried step must start at the CONFIGURED opts.step
        # (a 1.0 init silently ran ~10x the documented 0.05 default)
        step=jnp.asarray(opts.step, rdt),
        # +inf fill: unpopulated slots never win the min, so the
        # acceptance test is live from iteration 2 (see gamp_full r5)
        val_window=jnp.full((max(opts.step_window, 0) + 1,), jnp.inf, rdt),
        val_in=jnp.zeros((), rdt),
        Rx=Xhat,
        rvar_x=jnp.ones((R, M), rdt),
        Qa=Ahat,
        qvar_a=jnp.ones((L, R), rdt),
    )

    def body(c: Carry, _):
        # ---- output linear stage (BiGAMP.m:370-420) ----
        Ahat2 = jnp.abs(c.Ahat) ** 2
        Xhat2 = jnp.abs(c.Xhat) ** 2
        zvar = c.Avar @ Xhat2 + Ahat2 @ c.Xvar
        pvar = zvar + c.Avar @ c.Xvar
        if has_x2:
            pvar = pvar + A2sq @ c.X2var
        zhat = c.Ahat @ c.Xhat
        if has_x2:
            zhat = zhat + A2 @ c.X2hat
        if opts.pvar_step:
            first = c.it == 0
            pvar = jnp.where(
                first, pvar, c.step * pvar + (1 - c.step) * c.pvarOpt
            )
            zvar = jnp.where(
                first, zvar, c.step * zvar + (1 - c.step) * c.zvarOpt
            )
        phat = zhat - c.Shat * zvar  # note: zvar, not pvar (BiGAMP.m:417)
        pvar_b = jnp.maximum(pvar, opts.pvar_min)

        # ---- cost and pass test (BiGAMP.m:423-456) ----
        val = jnp.sum(m * out_loglike(zhat, pvar)) + c.val_in
        val = val.astype(rdt)
        _val_min = jnp.min(c.val_window)
        passed = (
            (c.it == 0)
            | jnp.asarray(not opts.adapt_step)
            | (c.step <= opts.step_min)
            | (val > _val_min)
            | ~jnp.isfinite(_val_min)  # empty window auto-pass (see gamp_full)
        )

        def sel(new, old):
            return jnp.where(passed, new, old)

        ShatOpt = sel(c.Shat, c.ShatOpt)
        SvarOpt = sel(c.Svar, c.SvarOpt)
        XhatBarOpt = sel(c.XhatBar, c.XhatBarOpt)
        XhatOpt = sel(c.Xhat, c.XhatOpt)
        AhatBarOpt = sel(c.AhatBar, c.AhatBarOpt)
        AhatOpt = sel(c.Ahat, c.AhatOpt)
        pvarOpt = sel(pvar, c.pvarOpt)
        zvarOpt = sel(zvar, c.zvarOpt)
        val_window = jnp.where(
            passed,
            jnp.roll(c.val_window, -1)
            .at[-1]
            .set(jnp.where(jnp.isnan(val), jnp.inf, val)),
            c.val_window,
        )

        # ---- output nonlinear stage, on pass (BiGAMP.m:494-530) ----
        zhat0, zvar0 = out_estim(phat, pvar_b)
        pvar_inv = m / pvar_b
        ShatNew = pvar_inv * (zhat0 - phat)
        SvarNew = pvar_inv * (
            1.0 - jnp.minimum(zvar0 / pvar_b, opts.zvar_to_pvar_max)
        )
        ShatNew = sel(ShatNew, c.ShatNewOpt)
        SvarNew = sel(SvarNew, c.SvarNewOpt)

        step = jnp.where(
            passed,
            jnp.minimum(
                jnp.maximum(opts.step_incr * c.step, opts.step_min),
                opts.step_max,
            ),
            jnp.maximum(opts.step_min, opts.step_decr * c.step),
        )

        # ---- damping (BiGAMP.m:668-676): step1 = step with stepFilter ----
        it_f = c.it.astype(rdt) + 1.0
        step1 = jnp.where(
            c.it == 0,
            jnp.asarray(1.0, rdt),
            step * jnp.where(
                opts.step_filter >= 1.0, it_f / (it_f + opts.step_filter), 1.0
            ),
        )
        Shat = (1 - step1) * ShatOpt + step1 * ShatNew
        Svar = (1 - step1) * SvarOpt + step1 * SvarNew
        XhatBar = (1 - step1) * XhatBarOpt + step1 * XhatOpt
        AhatBar = (1 - step1) * AhatBarOpt + step1 * AhatOpt
        # first-iteration anchors (BiGAMP.m equivalent of the NaN-init)
        Shat = jnp.where(c.it == 0, ShatNew, Shat)
        Svar = jnp.where(c.it == 0, SvarNew, Svar)
        XhatBar = jnp.where(c.it == 0, XhatOpt, XhatBar)
        AhatBar = jnp.where(c.it == 0, AhatOpt, AhatBar)

        # ---- input linear for X (BiGAMP.m:687-750) ----
        AhatBar2 = jnp.abs(AhatBar) ** 2
        rvar = 1.0 / jnp.maximum(AhatBar2.T @ Svar, 1e-30)
        rvar = jnp.minimum(rvar, opts.var_thresh)
        if opts.gain_mode == 1:
            rgain = 1.0 - rvar * (c.Avar.T @ Svar)
        elif opts.gain_mode == 2:
            rgain = 1.0 - rvar * (c.Avar.T @ jnp.abs(Shat) ** 2)
        else:
            rgain = jnp.ones_like(rvar)
        rgain = jnp.clip(rgain, 0.0, 1.0)
        Rx = XhatBar * rgain + rvar * (AhatBar.conj().T @ Shat)
        rvar = jnp.maximum(rvar, opts.xvar_min)

        # ---- input linear for A (BiGAMP.m:753-817) ----
        XhatBar2 = jnp.abs(XhatBar) ** 2
        qvar = 1.0 / jnp.maximum(Svar @ XhatBar2.T, 1e-30)
        qvar = jnp.minimum(qvar, opts.var_thresh)
        if opts.gain_mode == 1:
            qgain = 1.0 - qvar * (Svar @ c.Xvar.T)
        elif opts.gain_mode == 2:
            qgain = 1.0 - qvar * (jnp.abs(Shat) ** 2 @ c.Xvar.T)
        else:
            qgain = jnp.ones_like(qvar)
        qgain = jnp.clip(qgain, 0.0, 1.0)
        Qa = AhatBar * qgain + qvar * (Shat @ XhatBar.conj().T)
        qvar = jnp.maximum(qvar, opts.avar_min)

        # ---- input nonlinear (BiGAMP.m:819-830) ----
        Xn, Xvar_n = prior_x.estim(Rx, rvar)
        An, Avar_n = prior_a.estim(Qa, qvar)
        if hasattr(prior_x, "val_neg_kl") and opts.adapt_step:
            val_in = jnp.sum(
                jnp.real(prior_x.val_neg_kl(Rx, rvar, Xn, Xvar_n))
            ).astype(rdt)
        else:
            val_in = jnp.zeros((), rdt)
        if hasattr(prior_a, "val_neg_kl") and opts.adapt_step:
            val_in = val_in + jnp.sum(
                jnp.real(prior_a.val_neg_kl(Qa, qvar, An, Avar_n))
            ).astype(rdt)

        # ---- X2 branch: plain GAMP through the known A2 (BiGAMP_X2.m) ----
        if has_x2:
            r2var = 1.0 / jnp.maximum(A2sq.T @ Svar, 1e-30)
            r2var = jnp.minimum(r2var, opts.var_thresh)
            R2 = c.X2hat + r2var * (A2.conj().T @ Shat)
            X2n, X2var_n = prior_x2.estim(R2, r2var)
        else:
            X2n, X2var_n = c.X2hat, c.X2var

        return (
            Carry(
                it=c.it + 1,
                Ahat=An,
                Avar=jnp.maximum(jnp.real(Avar_n), 1e-30),
                Xhat=Xn,
                Xvar=jnp.maximum(jnp.real(Xvar_n), 1e-30),
                X2hat=X2n,
                X2var=jnp.maximum(jnp.real(X2var_n), 1e-30),
                Shat=Shat,
                Svar=Svar,
                AhatBar=AhatBar,
                XhatBar=XhatBar,
                ShatOpt=ShatOpt,
                SvarOpt=SvarOpt,
                ShatNewOpt=ShatNew,
                SvarNewOpt=SvarNew,
                AhatBarOpt=AhatBarOpt,
                XhatBarOpt=XhatBarOpt,
                AhatOpt=AhatOpt,
                XhatOpt=XhatOpt,
                pvarOpt=pvarOpt,
                zvarOpt=zvarOpt,
                step=step,
                val_window=val_window,
                val_in=val_in,
                Rx=Rx,
                rvar_x=rvar,
                Qa=Qa,
                qvar_a=qvar,
            ),
            val,
        )

    c, vals = jax.lax.scan(body, carry0, None, length=opts.nit)
    return c, vals


def bigamp_pev(
    Y,
    mask,
    rank,
    prior_a,
    prior_x,
    noise_var,
    key,
    opts: Optional[BigAmpOptions] = None,
    likelihood=None,
    A2=None,
    prior_x2=None,
    init_A=None,
    init_X=None,
) -> BigAmpFullResult:
    """Per-element-variance BiG-AMP (``BiGAMP.m`` with
    ``uniformVariance=false``), optionally with the known linear branch
    Z = A·X + A2·X2 of ``BiGAMP_X2.m``.  Returns posterior factor moments
    plus the (Rx, rvar)/(Qa, qvar) pseudo-data the EM wrappers consume."""
    opts = opts or BigAmpOptions()
    has_x2 = A2 is not None
    c, _ = _bigamp_pev_scan(
        Y,
        mask,
        rank,
        prior_a,
        prior_x,
        noise_var,
        key,
        opts,
        likelihood,
        likelihood is None,
        A2 if has_x2 else jnp.zeros((Y.shape[0], 1), Y.dtype),
        prior_x2,
        has_x2,
        init_A,
        init_X,
    )
    # final iterates (BiGAMP.m estFin exports xhat/Ahat of the LAST
    # input-stage update) — the *Opt slots lag one iteration and would
    # pair a stale A/X with the final Avar/Xvar
    Z = c.Ahat @ c.Xhat
    if has_x2:
        Z = Z + A2 @ c.X2hat
    return BigAmpFullResult(
        A=c.Ahat,
        X=c.Xhat,
        Z=Z,
        Avar=c.Avar,
        Xvar=c.Xvar,
        X2=c.X2hat if has_x2 else None,
        Rx=c.Rx,
        rvar_x=c.rvar_x,
        Qa=c.Qa,
        qvar_a=c.qvar_a,
    )


class BigAmpLiteResult(NamedTuple):
    A: jnp.ndarray
    X: jnp.ndarray
    Z: jnp.ndarray
    Avar: jnp.ndarray
    Xvar: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("rank", "nit", "adapt_step"))
def bigamp_lite(
    Y,
    mask,
    rank,
    nux,
    nua,
    nuw,
    key,
    nit: int = 250,
    step: float = 0.5,
    adapt_step: bool = True,
    init_A=None,
    init_X=None,
) -> BigAmpLiteResult:
    """BiG-AMP Lite (``BiGAMP_Lite.m:110-520``): AWGN output, i.i.d.
    zero-mean Gaussian priors on both factors, scalar variances — every
    input nonlinear stage collapses to a closed-form gain, so one
    iteration is exactly three dense matmuls (Z = A·X, AᴴV, V·Xᴴ) plus
    elementwise work: the speed-of-light BiG-AMP shape."""
    L, M = Y.shape
    R = rank
    cdt = Y.dtype
    rdt = jnp.float32
    m = mask.astype(rdt)
    p1 = jnp.maximum(jnp.mean(m), 1e-6)
    Y = Y * m

    kA, kX = jax.random.split(key)
    Ahat = init_A if init_A is not None else _rand_init(kA, (L, R), 0.0, nua, cdt)
    Xhat = init_X if init_X is not None else _rand_init(kX, (R, M), 0.0, nux, cdt)

    class C(NamedTuple):
        it: jnp.ndarray
        Ahat: jnp.ndarray
        Xhat: jnp.ndarray
        Avar: jnp.ndarray
        Xvar: jnp.ndarray
        Vhat: jnp.ndarray
        xBar: jnp.ndarray
        ABar: jnp.ndarray
        pvarOpt: jnp.ndarray
        holderOpt: jnp.ndarray
        VhatOpt: jnp.ndarray
        xBarOpt: jnp.ndarray
        ABarOpt: jnp.ndarray
        xhatOpt: jnp.ndarray
        AhatOpt: jnp.ndarray
        Vgain: jnp.ndarray
        step: jnp.ndarray
        val_prev: jnp.ndarray
        val_in: jnp.ndarray

    c0 = C(
        it=jnp.zeros((), jnp.int32),
        Ahat=Ahat,
        Xhat=Xhat,
        Avar=jnp.asarray(nua, rdt),
        Xvar=jnp.asarray(nux, rdt),
        Vhat=jnp.zeros((L, M), cdt),
        xBar=Xhat,
        ABar=Ahat,
        pvarOpt=jnp.asarray(1e-13, rdt),
        holderOpt=jnp.zeros((L, M), cdt),
        VhatOpt=jnp.zeros((L, M), cdt),
        xBarOpt=Xhat,
        ABarOpt=Ahat,
        xhatOpt=Xhat,
        AhatOpt=Ahat,
        Vgain=jnp.zeros((), rdt),
        step=jnp.minimum(jnp.asarray(step, rdt), 0.5),
        val_prev=jnp.asarray(-jnp.inf, rdt),
        val_in=jnp.zeros((), rdt),
    )

    def body(c: C, _):
        # step1 tracks the ADAPTIVE step from the end of the previous
        # iteration (BiGAMP_Lite.m:386-391); 1 on the first iteration
        step1 = jnp.where(c.it == 0, 1.0, c.step)
        # output stage (BiGAMP_Lite.m:212-247)
        zhat = m * (c.Ahat @ c.Xhat)
        holder = Y - zhat
        Xf2 = jnp.sum(jnp.abs(c.Xhat) ** 2)
        Af2 = jnp.sum(jnp.abs(c.Ahat) ** 2)
        pvar = step1 * (
            c.Avar * Xf2 / M + c.Xvar * Af2 / L + R * c.Avar * c.Xvar
        ) + (1 - step1) * c.pvarOpt
        pvar = jnp.maximum(pvar, 1e-13)
        pvarOpt0 = jnp.where(c.it == 0, pvar, c.pvarOpt)
        # cost (BiGAMP_Lite.m:237-256)
        val = -0.5 * jnp.sum(m * (jnp.abs(holder) ** 2 + pvar)) / jnp.maximum(
            nuw, 1e-20
        ) + c.val_in
        passed = (
            (c.it == 0)
            | jnp.asarray(not adapt_step)
            | (val > c.val_prev)
            | (c.step <= 0.05)  # forced pass at stepMin (BiGAMP_Lite.m:268-270)
        )

        def sel(new, old):
            return jnp.where(passed, new, old)

        pvarOpt = sel(pvar, pvarOpt0)
        # Vgain uses the freshly-accepted pvarOpt like every other gain in
        # this iteration (BiGAMP_Lite.m) — the stale pvarOpt0 denominator
        # was an off-by-one in the Onsager correction (round 5)
        Vgain = sel(
            (c.Avar * Xf2 / M + c.Xvar * Af2 / L) / (pvarOpt + nuw), c.Vgain
        )
        holderOpt = sel(holder, c.holderOpt)
        xhatOpt = sel(c.Xhat, c.xhatOpt)
        AhatOpt = sel(c.Ahat, c.AhatOpt)
        xBarOpt0 = sel(c.xBar, c.xBarOpt)
        ABarOpt0 = sel(c.ABar, c.ABarOpt)
        VhatOpt0 = sel(c.Vhat, c.VhatOpt)
        val_prev = sel(val, c.val_prev)
        stp = jnp.where(
            passed,
            jnp.minimum(jnp.maximum(1.1 * c.step, 0.05), 0.5),
            jnp.maximum(0.05, 0.5 * c.step),
        )
        # bars (BiGAMP_Lite.m:393-403) use the freshly-updated step
        step1b = jnp.where(c.it == 0, 1.0, stp)
        xBar = step1b * xhatOpt + (1 - step1b) * xBarOpt0
        ABar = step1b * AhatOpt + (1 - step1b) * ABarOpt0
        Vhat = step1b * holderOpt + (1 + step1b * Vgain - step1b) * VhatOpt0
        xBarOpt = jnp.where(c.it == 0, xBar, xBarOpt0)
        ABarOpt = jnp.where(c.it == 0, ABar, ABarOpt0)
        VhatOpt = jnp.where(c.it == 0, Vhat, VhatOpt0)
        # gains (BiGAMP_Lite.m:405-469, gainMode 1)
        Xbarf2 = jnp.maximum(jnp.sum(jnp.abs(xBar) ** 2), 1e-30)
        Abarf2 = jnp.maximum(jnp.sum(jnp.abs(ABar) ** 2), 1e-30)
        Xgain = nux / (nux + R * (nuw + pvarOpt) / Abarf2 / p1)
        Again = nua / (nua + R * (nuw + pvarOpt) / Xbarf2 / p1)
        Vf2 = jnp.sum(jnp.abs(Vhat) ** 2)
        rGain = jnp.clip(
            1.0 - c.Avar * Vf2 * R / Abarf2 / (nuw + pvarOpt) / p1 / M, 0.0, 1.0
        )
        qGain = jnp.clip(
            1.0 - c.Xvar * Vf2 * R / Xbarf2 / (nuw + pvarOpt) / p1 / L, 0.0, 1.0
        )
        Xn = Xgain * (xBar * rGain + R / p1 / Abarf2 * (ABar.conj().T @ Vhat))
        An = Again * (ABar * qGain + R / p1 / Xbarf2 * (Vhat @ xBar.conj().T))
        Xvar_n = nux - nux * Xgain
        Avar_n = nua - nua * Again
        # input utility (BiGAMP_Lite.m:480-486)
        valX = 0.5 * (
            jnp.log(Xvar_n / nux) + (1 - Xvar_n / nux)
        ) * Xn.size - 0.5 * jnp.sum(jnp.abs(Xn) ** 2) / nux
        valA = 0.5 * (
            jnp.log(Avar_n / nua) + (1 - Avar_n / nua)
        ) * An.size - 0.5 * jnp.sum(jnp.abs(An) ** 2) / nua
        return (
            C(
                it=c.it + 1,
                Ahat=An,
                Xhat=Xn,
                Avar=Avar_n,
                Xvar=Xvar_n,
                Vhat=Vhat,
                xBar=xBar,
                ABar=ABar,
                pvarOpt=pvarOpt,
                holderOpt=holderOpt,
                VhatOpt=VhatOpt,
                xBarOpt=xBarOpt,
                ABarOpt=ABarOpt,
                xhatOpt=xhatOpt,
                AhatOpt=AhatOpt,
                Vgain=Vgain,
                step=stp,
                val_prev=val_prev,
                val_in=(valX + valA).astype(rdt),
            ),
            dict(val=val, step=stp, passed=passed),
        )

    c, hist = jax.lax.scan(body, c0, None, length=nit)
    return (
        BigAmpLiteResult(
            A=c.AhatOpt,
            X=c.xhatOpt,
            Z=c.AhatOpt @ c.xhatOpt,
            Avar=c.Avar,
            Xvar=c.Xvar,
        ),
        hist,
    )
