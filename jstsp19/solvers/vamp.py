"""VAMP for the Generalized Linear Model, natively complex, matrix-form.

Accelerator re-design of the reference VAMP stack (``vamp.m`` →
``VAMP/VampGlmEst.m:350-521``):

- **no real 2×-embedding**: the reference splits complex into
  ``[Re −Im; Im Re]`` blocks (``vamp.m:3-4``), doubling every dimension;
  here the estimators are circular-complex throughout;
- **matrix-form state**: the unknown stays an (Gr, K) matrix; the LMMSE
  stage runs in the *factorized* eigenbasis of the implicit kron operator
  (``KronDictOp.gram_out_eig``), so the 512×512 eigendecomposition of
  ``Phi·Phiᴴ`` (``vamp.m:32-34``) becomes two ≤32² Hermitian ``eigh``s and
  the U-space products become small dense matmuls;
- fixed ``nit`` iterations under ``lax.scan`` (the reference's tol-based
  stop, ``VampGlmEst.m:516``, is a no-op at these sizes);
- Onsager precisions and the gamMin/gamMax clamps follow
  ``VampGlmEst.m:364-495`` / ``VampGlmOpt.m:5-9``;
- **damping applies to the extrinsic messages (r1, p1, gam1x, gam1z)**
  instead of the posterior means (x1, z2, gam2z as in
  ``VampGlmEst.m:364-366,412,495``).  Same fixed points, but the
  reference's scheme breaks the exact cancellation inside
  ``r2 = (x1·eta1x − r1·gam1x)/gam2x``, amplifying the damping
  perturbation by gam1x/gam2x — catastrophic in float32 whenever
  alf → 1 (square/overdetermined operators).  Verified against the
  closed-form LMMSE oracle to 7e-15 with a Gaussian prior.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from jstsp19.core import prng
from jstsp19.ops.kron import KronDictOp
from jstsp19.solvers.estim import CAwgnPrior, SparsePrior, CAwgnLikelihood

GAM_MIN = 1e-8  # VampGlmOpt.m:7
GAM_MAX = 1e14  # VampGlmOpt.m:8


class VampResult(NamedTuple):
    x: jnp.ndarray  # posterior estimate (denoiser output x1)
    z: jnp.ndarray  # transform-domain estimate z1
    gam1x: jnp.ndarray
    gam1z: jnp.ndarray
    # per-iteration E|x1 − x0|² when a ground truth is supplied (the
    # reference's fxnErr error-callback hook, VampGlmEst.m:280-290) —
    # used by the VampGlmSE overlay tests
    mse_track: Optional[jnp.ndarray] = None


def _clip_gam(g):
    return jnp.clip(g, GAM_MIN, GAM_MAX)


@functools.partial(jax.jit, static_argnames=("nit",))
def vamp_glm(
    prior,
    likelihood,
    op,
    nit: int = 100,
    damp: float = 0.85,
    r1_init: Optional[jnp.ndarray] = None,
    track_x0: Optional[jnp.ndarray] = None,
) -> VampResult:
    """Run VAMP-GLM for ``y ~ p(y | op.mv(x))``.

    ``prior``/``likelihood`` are estimator modules from
    :mod:`jstsp19.solvers.estim`; ``op`` must expose ``mv``/``rmv`` and a
    diagonalization of the output Gram via ``gram_out_eig`` (KronDictOp) —
    the M ≤ N branch of ``VampGlmEst.m:400-411`` in operator form.
    """
    in_shape = op.in_shape
    out_shape = op.out_shape
    N = 1
    for s in in_shape:
        N *= s
    M = 1
    for s in out_shape:
        M *= s
    delta = M / N
    out_branch = M <= N  # which Gram gets diagonalized (VampGlmEst.m:55-66)

    if out_branch:
        Ua, Ub, d = op.gram_out_eig()  # d: out_shape, eig of K2·K2ᴴ
    else:
        Ua, Ub, d = op.gram_in_eig()  # d: in_shape, eig of K2ᴴ·K2

    def U(Z):
        return op.from_eigbasis(Ua, Ub, Z)

    def Uh(Z):
        return op.to_eigbasis(Ua, Ub, Z)

    # not every likelihood carries observations (e.g. QuantizedLikelihood
    # holds interval edges lo/hi) — fall back to r1_init, then to the
    # likelihood's own array leaves (which also carry real-vs-complex:
    # the quantized few-bit-ADC channel is a REAL scalar model)
    _y = getattr(likelihood, "y", None)
    if _y is not None:
        x_dtype = jnp.result_type(_y.dtype, jnp.complex64)
    elif r1_init is not None:
        x_dtype = jnp.result_type(jnp.asarray(r1_init).dtype, jnp.complex64)
    else:
        leaves = jax.tree_util.tree_leaves(likelihood)
        x_dtype = jnp.result_type(*leaves) if leaves else jnp.complex64
    rdt = jnp.finfo(x_dtype).dtype
    r1 = (
        r1_init
        if r1_init is not None
        else jnp.full(in_shape, 1e-7j, x_dtype)  # opt.r1init = eps*1i (vamp.m:44)
    )
    p1 = jnp.zeros(out_shape, x_dtype)
    gam1x = jnp.asarray(GAM_MIN, rdt)  # gam1xinit (VampGlmOpt.m)
    gam1z = jnp.asarray(GAM_MIN, rdt)

    class Carry(NamedTuple):
        r1: jnp.ndarray
        p1: jnp.ndarray
        gam1x: jnp.ndarray
        gam1z: jnp.ndarray
        x1: jnp.ndarray
        z1: jnp.ndarray
        # keep-best tracking: the VAMP mean iteration can destabilize
        # AFTER reaching its fixed point (measured: the linearized map
        # around the fixed point has spectral radius > 1 on full-rank
        # high-SNR problems; the reference runs the same dynamics but its
        # f64 arithmetic seeds the unstable mode at 1e-16 so 100
        # iterations end before the blowup surfaces — f32 does not get
        # that grace).  The iterate with the smallest relative step is
        # the most settled point; return it instead of the last.
        best_x1: jnp.ndarray
        best_z1: jnp.ndarray
        best_gam1x: jnp.ndarray
        best_gam1z: jnp.ndarray
        best_rc: jnp.ndarray

    init = Carry(
        r1=r1,
        p1=p1,
        gam1x=gam1x,
        gam1z=gam1z,
        x1=jnp.zeros(in_shape, x_dtype),
        z1=jnp.zeros(out_shape, x_dtype),
        best_x1=jnp.zeros(in_shape, x_dtype),
        best_z1=jnp.zeros(out_shape, x_dtype),
        best_gam1x=gam1x,
        best_gam1z=gam1z,
        best_rc=jnp.asarray(jnp.inf, rdt),
    )

    def body(c: Carry, i):
        first = i == 0

        # ---- denoising stage (VampGlmEst.m:364-379) ---------------------
        x1, xvar1 = prior.estim(c.r1, 1.0 / c.gam1x)
        eta1x = 1.0 / jnp.maximum(jnp.mean(xvar1), 1e-30)
        # Relative floor (vs the reference's absolute gamMin clamp,
        # VampGlmEst.m:371): a near-zero extrinsic precision divides into
        # r2 and detonates in float32 — floor it at 1e-3·eta1x instead.
        gam2x = jnp.clip(eta1x - c.gam1x, 1e-3 * eta1x, GAM_MAX)
        r2 = (x1 * eta1x - c.r1 * c.gam1x) / gam2x

        # ---- likelihood stage (:381-393) --------------------------------
        z1, zvar1 = likelihood.estim(c.p1, 1.0 / c.gam1z)
        eta1z = 1.0 / jnp.maximum(jnp.mean(zvar1), 1e-30)
        gam2z = jnp.clip(eta1z - c.gam1z, 1e-3 * eta1z, GAM_MAX)
        p2 = (z1 * eta1z - c.p1 * c.gam1z) / gam2z

        # ---- LMMSE stage in the factorized eigenbasis (:398-411) --------
        ratio = gam2x / gam2z
        inv_d = 1.0 / (d + ratio)
        # The reference guards only alf==0 (`-eps`, VampGlmEst.m:399); in
        # float32 alf can also reach its upper bound exactly — min(1, delta)
        # (alf = (1/N)·Σ d/(d+ratio) has at most min(M, N) nonzero terms) —
        # which zeroes (1-alf) and/or (delta-alf).  Clamp both ends.
        alf = jnp.sum(d * inv_d) / N
        alf = jnp.clip(alf, 1e-6, min(1.0, delta) * (1.0 - 1e-6))
        if out_branch:
            Ar2 = op.mv(r2)
            Up = Uh(p2 - Ar2) * inv_d
            x2 = r2 + op.rmv(U(Up))
            z2 = Ar2 + U(d * Up)
        else:  # M > N: solve (K2ᴴK2 + ratio·I)x2 = K2ᴴp2 + ratio·r2
            Vr = Uh(r2 * ratio + op.rmv(p2)) * inv_d
            x2 = U(Vr)
            z2 = op.mv(x2)

        # ---- extrapolation back (:467-495), message-damped --------------
        # Difference form of the reference's (x2 − (1−alf)·r2)/alf and
        # (delta·z2 − alf·p2)/(delta − alf): algebraically identical, but
        # the textbook form cancels two nearly-equal large terms over a
        # vanishing denominator whenever alf → 0 or alf → delta (full-rank
        # output at high SNR) — catastrophic in float32 (measured: the
        # solver reached the SE fixed-point region then diverged to 1e10).
        # Here the amplification multiplies only the *gap* (x2 − r2),
        # which itself vanishes at the fixed point.
        r1n = x2 + ((1 - alf) / alf) * (x2 - r2)
        p1n = z2 + (alf / (delta - alf)) * (z2 - p2)
        gam1xn = _clip_gam(gam2x * alf / (1 - alf))
        gam1zn = _clip_gam(gam2z * (delta - alf) / alf)

        r1n = jnp.where(first, r1n, damp * r1n + (1 - damp) * c.r1)
        p1n = jnp.where(first, p1n, damp * p1n + (1 - damp) * c.p1)
        gam1xn = jnp.where(first, gam1xn, damp * gam1xn + (1 - damp) * c.gam1x)
        gam1zn = jnp.where(first, gam1zn, damp * gam1zn + (1 - damp) * c.gam1z)

        # Divergence guard: severely under-determined / noise-mis-specified
        # problems (e.g. the T=5 framelength corner at −15 dB) make the VAMP
        # fixed point unstable — the reference lets iterates grow in float64
        # and reports the NMSE clamped at 1.  In float32 unbounded growth
        # becomes inf/NaN, so rescale runaway messages; this only engages
        # once the estimate is already garbage (reported NMSE → 1).
        cap = 1e6
        for_msg = jnp.maximum(jnp.max(jnp.abs(r1n)), jnp.max(jnp.abs(p1n)))
        scale = jnp.where(for_msg > cap, cap / for_msg, 1.0)
        r1n = r1n * scale
        p1n = p1n * scale

        mse = (
            jnp.mean(jnp.abs(x1 - track_x0) ** 2)
            if track_x0 is not None
            else jnp.zeros((), rdt)
        )
        # keep-best: relative step of the posterior mean (the reference's
        # commented stopping rule, VampGlmEst.m:505-507, turned into an
        # argmin so the scan needs no early exit)
        rc = jnp.sum(jnp.abs(x1 - c.x1) ** 2) / jnp.maximum(
            jnp.sum(jnp.abs(x1) ** 2), jnp.finfo(rdt).tiny
        )
        rc = jnp.where(first, jnp.asarray(jnp.inf, rdt), rc.astype(rdt))
        # `first` seeds the best slot unconditionally (otherwise nit=1
        # would return the zero initialization)
        better = (rc < c.best_rc) | first
        return (
            Carry(
                r1=r1n, p1=p1n, gam1x=gam1xn, gam1z=gam1zn, x1=x1, z1=z1,
                best_x1=jnp.where(better, x1, c.best_x1),
                best_z1=jnp.where(better, z1, c.best_z1),
                best_gam1x=jnp.where(better, c.gam1x, c.best_gam1x),
                best_gam1z=jnp.where(better, c.gam1z, c.best_gam1z),
                best_rc=jnp.minimum(rc, c.best_rc),
            ),
            mse,
        )

    final, mse_track = jax.lax.scan(body, init, jnp.arange(nit))
    return VampResult(
        x=final.best_x1, z=final.best_z1,
        gam1x=final.best_gam1x, gam1z=final.best_gam1z,
        mse_track=mse_track if track_x0 is not None else None,
    )


def vamp_glm_se(
    prior_sampler,
    prior,
    likelihood_mse,
    d_spectrum: jnp.ndarray,
    N: int,
    delta: float,
    nit: int = 50,
    n_samples: int = 4096,
    seed: int = 0,
) -> jnp.ndarray:
    """State evolution of VAMP-GLM (``VAMP/VampGlmSE.m:1-35``): the analytic
    per-iteration MSE prediction for the solver family on the jstsp19
    experiment path (``vamp.m`` → ``VampGlmEst``).

    Args:
      prior_sampler: ``(key, n) -> (n,)`` draws from the prior (for the
        Monte-Carlo denoiser-MSE expectation — the ``EstimInAvg`` analog).
      prior: estimator module with ``estim(r, rvar)``.
      likelihood_mse: ``pvar -> (mse1z, zvar)`` — the output-stage average
        (``estOutAvg.mse``).  For the AWGN/CAwgn likelihood use
        :func:`cawgn_likelihood_mse` (the closed form the reference demo
        uses, ``demoVampGlm.m:203``); for other channels build one with
        :func:`mc_likelihood_mse`.
      d_spectrum: the min(M,N) nonzero eigenvalues of the operator Gram
        (``VampGlmSE.m:27`` — note length(d) = min(M,N)).
      N / delta: input dimension and M/N.

    Returns the (nit,) sequence of predicted denoiser MSEs ``1/eta1x``
    (``VampGlmSE.m:34``) — overlay against the empirical
    ``E|x1 − x0|²`` trajectory of :func:`vamp_glm`.
    """
    key = prng.experiment_key(seed)
    x0 = prior_sampler(key, n_samples)
    noise = prng.complex_normal(jax.random.fold_in(key, 1), x0.shape, var=1.0)
    gam1x = jnp.asarray(GAM_MIN, jnp.float32)
    gam1z = jnp.asarray(GAM_MIN, jnp.float32)
    d = d_spectrum.astype(jnp.float32)

    def denoiser_mse(gam1x):
        r = x0 + noise / jnp.sqrt(gam1x)
        xhat, _ = prior.estim(r, 1.0 / gam1x)
        return jnp.maximum(jnp.mean(jnp.abs(xhat - x0) ** 2), 1e-30)

    def body(carry, _):
        gam1x, gam1z = carry
        # nonlinear stage (VampGlmSE.m:19-24)
        mse1x = denoiser_mse(gam1x)
        eta1x = 1.0 / mse1x
        gam2x = jnp.clip(eta1x - gam1x, 1e-3 * eta1x, GAM_MAX)
        _, zvar = likelihood_mse(1.0 / gam1z)
        eta1z = 1.0 / jnp.maximum(zvar, 1e-30)
        gam2z = jnp.clip(eta1z - gam1z, 1e-3 * eta1z, GAM_MAX)
        # linear stage (:27-31)
        alf = jnp.sum(d / (d + gam2x / gam2z)) / N
        alf = jnp.clip(alf, 1e-6, min(1.0, delta) * (1.0 - 1e-6))
        gam1x_n = _clip_gam(gam2x * alf / (1.0 - alf))
        gam1z_n = _clip_gam(gam2z * (delta - alf) / alf)
        return (gam1x_n, gam1z_n), mse1x

    _, mses = jax.lax.scan(body, (gam1x, gam1z), None, length=nit)
    return mses


def cawgn_likelihood_mse(wvar):
    """The AWGN output-stage average in closed form
    (``demoVampGlm.m:203``): mse1z = zvar = 1/(1/wvar + 1/pvar)."""

    def mse(pvar):
        v = 1.0 / (1.0 / wvar + 1.0 / pvar)
        return v, v

    return mse


def mc_likelihood_mse(likelihood_from_y, channel_sampler, phat, seed: int = 0):
    """Monte-Carlo output-stage average for a non-Gaussian channel (the
    ``stateEvo/EstimOutAvg.m`` analog): internally draws
    z = phat + CN(0, pvar), y ~ p(y|z), and reports
    (E|ẑ−z|², E[zvar]) of ``likelihood_from_y(y).estim(phat, pvar)``."""
    # distinct role fold: at equal seeds this helper is composed INTO
    # vamp_glm_se, whose own noise stream is fold_in(experiment_key, 1) —
    # without the role tag the two "independent" draws were identical
    key = jax.random.fold_in(prng.experiment_key(seed), 7919)
    e = prng.complex_normal(key, phat.shape, var=1.0)

    def mse(pvar):
        z = phat + jnp.sqrt(pvar) * e
        y = channel_sampler(jax.random.fold_in(key, 1), z)
        zhat, zvar = likelihood_from_y(y).estim(phat, pvar)
        return jnp.mean(jnp.abs(zhat - z) ** 2), jnp.mean(zvar)

    return mse


def vamp_mmwave(
    Y_hbf: jnp.ndarray,
    A: jnp.ndarray,
    B: jnp.ndarray,
    noise_var,
    num_nonzero: int,
    nit: int = 100,
    damp: float = 0.85,
):
    """The jstsp19 VAMP baseline in matrix form.

    The reference builds the *normal-equations* form
    ``Phi = kron((B·Bᴴ).', A)``, ``y = vec(Y·Bᴴ)``
    (``plot_errorVSsnr.m:79-80``) — squaring the conditioning of B (σ_B⁴)
    and coloring the noise.  Here VAMP runs on the direct model
    ``Y ≈ A · X · B`` (white noise, σ_B conditioning — required for
    float32, and statistically the right likelihood), using the
    M > N eigenbasis branch.

    Prior: Bernoulli-CN spike-slab with activity ``numOfnz / (2·N_complex)``
    — the natively-complex counterpart of the real embedding's
    ``beta = L/nx`` (``vamp.m:23-25``, where nx counts *real* components).
    Likelihood: CN(y, noise_var); note the reference passes sigma=1
    regardless of SNR (``plot_errorVSsnr.m:100``) — callers may do the same
    for strict parity.
    """
    # float32 conditioning: normalize each factor to unit spectral scale and
    # rescale the observation/noise accordingly — mathematically equivalent
    # (Y/s = (A/sa)·X·(B/sb) + W/s), but keeps VAMP internals O(1) where
    # the reference relies on float64 headroom.
    sa = jnp.sqrt(jnp.linalg.eigvalsh(A.conj().T @ A)[-1])
    sb = jnp.sqrt(jnp.linalg.eigvalsh(B @ B.conj().T)[-1])
    s = sa * sb
    op = KronDictOp(A / sa, B / sb)
    Gr, K = op.in_shape
    nx_real = 2 * Gr * K
    beta = jnp.asarray(num_nonzero / nx_real, jnp.float32)
    slab_var = 1.0 / beta  # xvar1 = xvar0/beta, vamp.m:24
    prior = SparsePrior(CAwgnPrior(jnp.asarray(0.0 + 0.0j), slab_var), beta)
    likelihood = CAwgnLikelihood(
        Y_hbf / s, jnp.asarray(noise_var, jnp.float32) / s**2
    )
    res = vamp_glm(prior, likelihood, op, nit=nit, damp=damp)
    return res.x
