"""Scalar prior / likelihood modules for message-passing solvers.

The JAX analog of the reference's EstimIn / EstimOut class trees
(``MPbased_solvers/main/EstimIn.m`` etc.): plain pytree dataclasses with an
``estim(rhat, rvar) -> (xhat, xvar)`` posterior-moment method, natively
complex (circular Gaussians) — no real 2×-embedding.

Implemented (★ = on the jstsp19 experiment path):
  ★ CAwgnPrior        — circular-Gaussian prior          (CAwgnEstimIn.m:93-101)
  ★ SparsePrior       — Bernoulli spike-slab wrapper     (SparseScaEstim.m:77-115)
  ★ CAwgnLikelihood   — AWGN output channel              (CAwgnEstimOut.m:100-112)
    AwgnPrior         — real Gaussian prior              (AwgnEstimIn.m)
    SoftThreshPrior   — Laplacian / soft-threshold MAP   (SoftThreshEstimIn.m)
    CGMPrior          — circular Gaussian mixture        (GMEstimIn.m)
    LaplacePrior      — Laplacian MMSE prior             (LaplaceEstimIn.m)
    UnifPrior         — uniform prior on [a,b]           (UnifEstimIn.m)
    NNGMPrior         — non-negative Gaussian mixture    (EMNNAMP's NNGMEstimIn.m)
    SNIPEPrior        — sparsifying non-informative      (SNIPEstim.m)
    EllpPrior         — l_p-norm MAP denoiser, p≤1       (EllpEstimIn.m)
    DiscretePrior     — finite-alphabet prior            (DisScaEstim.m)
    GroupSparsePrior  — group-shared Bernoulli slab      (turboGAMP group sparsity)
    ProbitLikelihood  — binary probit channel            (ProbitEstimOut.m)
    LogitLikelihood   — binary logistic channel          (LogitEstimOut.m)
    PoissonLikelihood — count channel                    (PoissonEstim.m)
    QuantizedLikelihood — few-bit-ADC interval channel
    OutlierLikelihood — 2-comp Gaussian-mixture noise    (GaussMixEstimOut.m)
    AwbgnLikelihood   — delta-spike + Gaussian noise      (AwbgnEstimOut.m)
    TruthReporterPrior — in-flight diagnostics wrapper    (TruthReporter.m)
    LaplaceLikelihood — Laplacian-noise channel          (LaplaceEstimOut.m)
    MagnitudeLikelihood — magnitude-only (Rician) channel (ncCAwgnEstimOut.m,
                          the PR-GAMP phase-retrieval observation)
    DiracPrior        — point mass                        (DiracEstimIn.m)
    NullPrior         — non-informative passthrough       (NullEstimIn.m)
    ElasticNetPrior   — l1+l2 MAP denoiser                (ElasticNetEstimIn.m)
    NNSoftThreshPrior — exponential (nonneg-Laplace) MMSE (NNSoftThreshEstimIn.m)
    MixPrior          — two-component prior mixture       (MixScaEstimIn.m)
    ConcatPrior       — blockwise prior concatenation     (EstimInConcat.m)
    DiracLikelihood   — noiseless observation             (DiracEstimOut.m)
    MaskedLikelihood  — missing-data wrapper              (MaskedEstimOut.m)
    GaussMixLikelihood — K-component Gaussian-mix noise   (GaussMixEstimOut.m /
                          CGaussMixEstimOut.m)
    CMultAwgnLikelihood — known complex per-entry gain    (CMultAwgnEstimOut.m)
    HingeLikelihood   — SVM hinge-loss channel            (TestSVMGAMP capability)
    ConcatLikelihood  — blockwise likelihood concat       (EstimOutConcat.m)
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_MAXARG = 500.0  # exparg clamp of SparseScaEstim.m:106-115


def _register(cls, data_fields, meta_fields=()):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


def _log1mexp(d):
    """log(1 − e^d) for d ≤ 0, accurate for tiny |d| (Mächler's log1mexp:
    the log(−expm1) branch keeps precision where log1p(−exp) cancels —
    exp(d) rounds to exactly 1.0 for |d| below the float eps, so a naive
    clamp like min(d, −1e-20) is dead code and yields −inf)."""
    d = jnp.minimum(d, -1e-30)
    return jnp.where(
        d > -0.6931472,  # -log 2
        jnp.log(-jnp.expm1(d)),
        jnp.log1p(-jnp.exp(d)),
    )


def _log_ndiff(a, b):
    """log(Phi(b) − Phi(a)) for a ≤ b, stable in both tails.

    Uses the lower-tail form log Phi(b) + log1mexp(log Phi(a) − log Phi(b))
    when the interval sits in the left half, and the mirrored upper-tail form
    (Phi(b)−Phi(a) = Phi(−a)−Phi(−b)) when it sits in the right half.
    """
    logcdf = jax.scipy.stats.norm.logcdf
    lo_b, lo_a = logcdf(b), logcdf(a)
    lower = lo_b + _log1mexp(lo_a - lo_b)
    up_a, up_b = logcdf(-a), logcdf(-b)
    upper = up_a + _log1mexp(up_b - up_a)
    return jnp.where(a + b > 0, upper, lower)


def _tn_moments(phat, pvar, lo, hi):
    """Moments of N(phat, pvar) truncated to [lo, hi].

    Returns (mean, var, logZ) with logZ = log P(lo ≤ x ≤ hi); the pdf/mass
    ratios are formed in the log domain so extreme truncation (Z → 0) stays
    finite.  This is the single primitive behind the Unif prior, the
    quantized-output channel, the non-negative GM prior, and the Laplacian
    prior/likelihood half-line branches.

    f32 guard (round 5): for a FINITE interval, once pvar ≫ (hi−lo)² the
    posterior is numerically indistinguishable from the flat-prior one,
    but the raw formulas cancel catastrophically (both normalized edges
    collapse to the same f32 value — e.g. VAMP-GLM's GAM_MIN=1e-11
    precision init, pvar=1e11).  Capping pvar at 1e2·width² keeps both
    moments exact to f32 resolution (verified: the in-cell variance comes
    out at the uniform value width²/12); half-line intervals (±inf
    endpoints) are left uncapped.
    """
    width2 = (hi - lo) ** 2
    cap = 1e2 * jnp.maximum(width2, 1e-30)
    pvar = jnp.where(jnp.isfinite(width2), jnp.minimum(pvar, cap), pvar)
    sig = jnp.sqrt(pvar)
    a = (lo - phat) / sig
    b = (hi - phat) / sig
    logZ = _log_ndiff(a, b)
    log_norm = -0.5 * jnp.log(2 * jnp.pi)
    # phi(a)/Z and phi(b)/Z via exp(logpdf − logZ); ±inf endpoints give 0.
    pa = jnp.where(jnp.isfinite(a), jnp.exp(log_norm - 0.5 * a**2 - logZ), 0.0)
    pb = jnp.where(jnp.isfinite(b), jnp.exp(log_norm - 0.5 * b**2 - logZ), 0.0)
    apa = jnp.where(jnp.isfinite(a), a * pa, 0.0)
    bpb = jnp.where(jnp.isfinite(b), b * pb, 0.0)
    mean = phat + sig * (pa - pb)
    t = 1.0 + (apa - bpb) - (pa - pb) ** 2
    return mean, jnp.maximum(pvar * t, 1e-30), logZ


@dataclasses.dataclass(frozen=True)
class CAwgnPrior:
    """x ~ CN(mean0, var0).  Posterior from rhat = x + CN(0, rvar):
    ``gain = var0/(var0+rvar)`` (``CAwgnEstimIn.m:93-101``)."""

    mean0: jnp.ndarray = 0.0
    var0: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        gain = self.var0 / (self.var0 + rvar)
        xhat = gain * (rhat - self.mean0) + self.mean0
        return xhat, gain * rvar

    def loglikey(self, rhat, rvar):
        """log p(rhat) with rhat = x + CN(0, rvar)
        (``CAwgnEstimIn.m:176-181``)."""
        v = self.var0 + rvar
        return -(jnp.log(jnp.pi) + jnp.log(v) + jnp.abs(rhat - self.mean0) ** 2 / v)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Per-element negative KL divergence −D(p(x|r) ‖ p(x)) used by
        the adaptive-step utility (``CAwgnEstimIn.m:147-154``)."""
        ratio = rvar / (self.var0 + rvar)
        return (
            jnp.log(ratio) + (1.0 - ratio)
            - jnp.abs(xhat - self.mean0) ** 2 / self.var0
        )

    def estim_map(self, rhat, rvar):
        """Max-sum (MAP) branch — coincides with MMSE for a Gaussian prior
        (``CAwgnEstimIn.m`` maxSumVal=true)."""
        return self.estim(rhat, rvar)

    def val_map(self, xhat):
        """log p(xhat) for the max-sum utility (``CAwgnEstimIn.m:160-166``)."""
        return -(jnp.log(jnp.pi) + jnp.log(self.var0)
                 + jnp.abs(xhat - self.mean0) ** 2 / self.var0)

    def init_moments(self):
        return self.mean0, self.var0


_register(CAwgnPrior, ("mean0", "var0"))


@dataclasses.dataclass(frozen=True)
class AwgnPrior:
    """Real Gaussian prior x ~ N(mean0, var0)."""

    mean0: jnp.ndarray = 0.0
    var0: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        gain = self.var0 / (self.var0 + rvar)
        return gain * (rhat - self.mean0) + self.mean0, gain * rvar

    def loglikey(self, rhat, rvar):
        v = self.var0 + rvar
        return -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(v) + (rhat - self.mean0) ** 2 / v)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Real-Gaussian −D(p(x|r) ‖ p(x)) (``AwgnEstimIn.m`` val)."""
        ratio = rvar / (self.var0 + rvar)
        return 0.5 * (
            jnp.log(ratio) + (1.0 - ratio)
            - (xhat - self.mean0) ** 2 / self.var0
        )

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def val_map(self, xhat):
        return -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(self.var0)
                       + (xhat - self.mean0) ** 2 / self.var0)

    def init_moments(self):
        return self.mean0, self.var0


_register(AwgnPrior, ("mean0", "var0"))


@dataclasses.dataclass(frozen=True)
class SparsePrior:
    """Bernoulli spike-slab: x = base w.p. p1, else 0.

    Posterior activity via log-domain likelihood ratio with ±500 clamp
    (``SparseScaEstim.m:77-115``); complex (circular) spike likelihood.
    """

    base: CAwgnPrior
    p1: jnp.ndarray = 0.5

    def estim(self, rhat, rvar):
        rvar = jnp.maximum(rvar, jnp.finfo(jnp.float32).eps)
        loglike1 = self.base.loglikey(rhat, rvar)
        if jnp.iscomplexobj(rhat):
            loglike0 = -(jnp.log(jnp.pi) + jnp.log(rvar) + jnp.abs(rhat) ** 2 / rvar)
        else:
            loglike0 = -0.5 * (
                jnp.log(2 * jnp.pi) + jnp.log(rvar) + rhat**2 / rvar
            )
        exparg = loglike0 - loglike1 + jnp.log1p(-self.p1) - jnp.log(self.p1)
        exparg = jnp.clip(exparg, -_MAXARG, _MAXARG)
        py1 = 1.0 / (1.0 + jnp.exp(exparg))
        xhat1, xvar1 = self.base.estim(rhat, rvar)
        xhat = py1 * xhat1
        xvar = py1 * (jnp.abs(xhat1) ** 2 + xvar1) - jnp.abs(xhat) ** 2
        return xhat, xvar

    def init_moments(self):
        m1, v1 = self.base.init_moments()
        xhat = self.p1 * m1
        xvar = self.p1 * (jnp.abs(m1) ** 2 + v1) - jnp.abs(xhat) ** 2
        return xhat, xvar

    def _activity(self, rhat, rvar):
        rvar = jnp.maximum(rvar, jnp.finfo(jnp.float32).eps)
        loglike1 = self.base.loglikey(rhat, rvar)
        if jnp.iscomplexobj(rhat):
            loglike0 = -(jnp.log(jnp.pi) + jnp.log(rvar) + jnp.abs(rhat) ** 2 / rvar)
        else:
            loglike0 = -0.5 * (
                jnp.log(2 * jnp.pi) + jnp.log(rvar) + rhat**2 / rvar
            )
        exparg = loglike0 - loglike1 + jnp.log1p(-self.p1) - jnp.log(self.p1)
        return 1.0 / (1.0 + jnp.exp(jnp.clip(exparg, -_MAXARG, _MAXARG)))

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Spike-slab negative KL: activity-weighted slab KL plus the
        Bernoulli mixing entropy terms (``SparseScaEstim.m:166-171``)."""
        py1 = self._activity(rhat, rvar)
        py0 = 1.0 - py1
        x1, v1 = self.base.estim(rhat, rvar)
        kl1 = self.base.val_neg_kl(rhat, rvar, x1, v1)
        p1 = jnp.clip(self.p1, 1e-8, 1.0)
        return (
            py1 * kl1
            + py1 * jnp.log(jnp.maximum(p1, 1e-8) / jnp.maximum(py1, 1e-8))
            + py0 * jnp.log(jnp.maximum(1.0 - p1, 1e-8) / jnp.maximum(py0, 1e-8))
        )


_register(SparsePrior, ("base", "p1"))


@dataclasses.dataclass(frozen=True)
class SoftThreshPrior:
    """Laplacian-MAP denoiser (soft threshold), the ``SoftThreshEstimIn``
    analog: ``xhat = sign(r)·max(|r|−λ·rvar, 0)`` with df-based variance."""

    lam: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        thresh = self.lam * rvar
        mag = jnp.maximum(jnp.abs(rhat) - thresh, 0.0)
        xhat = jnp.where(
            jnp.abs(rhat) > 0, rhat / jnp.maximum(jnp.abs(rhat), 1e-30) * mag, 0.0
        )
        active = (mag > 0).astype(rvar.dtype if hasattr(rvar, "dtype") else jnp.float32)
        return xhat, rvar * active

    def estim_map(self, rhat, rvar):
        """Already the Laplacian-MAP prox (``SoftThreshEstimIn.m`` is
        max-sum only in the reference)."""
        return self.estim(rhat, rvar)

    def val_map(self, xhat):
        return -self.lam * jnp.abs(xhat)

    def init_moments(self):
        return jnp.zeros(()), 2.0 / self.lam**2


_register(SoftThreshPrior, ("lam",))


@dataclasses.dataclass(frozen=True)
class CGMPrior:
    """Circular Gaussian-mixture prior (the ``GMEstimIn``/EM-GM analog):
    x ~ Σ_k w_k · CN(mu_k, v_k).  Posterior moments from r = x + CN(0, rvar)
    via responsibility-weighted component posteriors."""

    weights: jnp.ndarray  # (K,)
    means: jnp.ndarray  # (K,) complex
    variances: jnp.ndarray  # (K,)

    def estim(self, rhat, rvar):
        r = rhat[..., None]
        v = self.variances + rvar[..., None]
        loglike = -(jnp.log(jnp.pi) + jnp.log(v) + jnp.abs(r - self.means) ** 2 / v)
        logw = jnp.log(self.weights) + loglike
        logw = logw - jax.scipy.special.logsumexp(logw, axis=-1, keepdims=True)
        resp = jnp.exp(logw)
        gain = self.variances / v
        post_mean = gain * (r - self.means) + self.means
        post_var = gain * rvar[..., None]
        xhat = jnp.sum(resp * post_mean, axis=-1)
        ex2 = jnp.sum(resp * (jnp.abs(post_mean) ** 2 + post_var), axis=-1)
        return xhat, jnp.maximum(ex2 - jnp.abs(xhat) ** 2, 0.0)

    def loglikey(self, rhat, rvar):
        """log p(r) with r = x + CN(0, rvar) — mixture marginal, needed by
        :class:`SparsePrior` spike/slab weighing."""
        r = rhat[..., None]
        rv = rvar[..., None] if jnp.ndim(rvar) else rvar
        v = self.variances + rv
        loglike = -(jnp.log(jnp.pi) + jnp.log(v) + jnp.abs(r - self.means) ** 2 / v)
        return jax.scipy.special.logsumexp(
            jnp.log(self.weights) + loglike, axis=-1
        )

    def init_moments(self):
        m = jnp.sum(self.weights * self.means)
        v = jnp.sum(
            self.weights * (jnp.abs(self.means) ** 2 + self.variances)
        ) - jnp.abs(m) ** 2
        return m, v


_register(CGMPrior, ("weights", "means", "variances"))


@dataclasses.dataclass(frozen=True)
class CAwgnLikelihood:
    """y = scale·z + CN(0, wvar).  Posterior of z from z ~ CN(phat, pvar):
    ``gain = pvar/(scale²·pvar + wvar)`` (``CAwgnEstimOut.m:100-112``)."""

    y: jnp.ndarray
    wvar: jnp.ndarray
    scale: jnp.ndarray = 1.0

    def estim(self, phat, pvar):
        gain = pvar / (self.scale**2 * pvar + self.wvar)
        zhat = (self.scale * gain) * (self.y - self.scale * phat) + phat
        return zhat, self.wvar * gain

    def loglike(self, phat, pvar):
        """E[log p(y|z)] with z ~ CN(phat, pvar) up to the constant
        −log(π·wvar) (``CAwgnEstimOut.m:218-233``, sum-product branch)."""
        w = jnp.maximum(self.wvar, 1e-20)
        return -(jnp.abs(self.y - self.scale * phat) ** 2
                 + self.scale**2 * pvar) / w

    def logscale(self, axhat, pvar, phat):
        """Bethe output cost, closed form (``CAwgnEstimOut.m:241-262``)."""
        w = jnp.maximum(self.wvar, 1e-20)
        s2 = jnp.abs(self.scale) ** 2
        return (
            -jnp.log(s2 * pvar + w)
            - jnp.abs(self.y - self.scale * axhat) ** 2 / w
            - jnp.log(jnp.pi)
        )

    def tune_wvar_ml(self, phat, pvar):
        """ML noise-variance update
        ``wvar = mean(|y − s·phat|² − s²·pvar)`` — the ``autoTune``/'ML'
        method of ``CAwgnEstimOut.m:117-131`` (joint dimension)."""
        s2 = jnp.abs(self.scale) ** 2
        w1 = jnp.mean(jnp.abs(self.y - self.scale * phat) ** 2 - s2 * pvar)
        return jnp.maximum(1e-20, w1)

    def tune_wvar_em(self, zhat, zvar):
        """EM noise-variance update ``wvar = mean(|y − s·zhat|² + s²·zvar)``
        from the output-posterior moments — the EM0/'EM' tuning branch of
        ``CAwgnEstimOut.m:132-146``."""
        s2 = jnp.abs(self.scale) ** 2
        w1 = jnp.mean(jnp.abs(self.y - self.scale * zhat) ** 2 + s2 * zvar)
        return jnp.maximum(1e-20, w1)

    def estim_map(self, phat, pvar):
        """Max-sum branch — MAP coincides with MMSE for the Gaussian
        channel (``CAwgnEstimOut.m`` maxSumVal=true)."""
        return self.estim(phat, pvar)


_register(CAwgnLikelihood, ("y", "wvar", "scale"))


@dataclasses.dataclass(frozen=True)
class ProbitLikelihood:
    """Binary observation y ∈ {0,1} of sign(z + noise) — the
    ``ProbitEstimOut`` analog for real z: posterior moments of
    z ~ N(phat, pvar) given y = 1{z + N(0, wvar) > 0}."""

    y: jnp.ndarray  # (…,) in {0, 1}
    wvar: jnp.ndarray = 1e-2

    def estim(self, phat, pvar):
        s = 2.0 * self.y - 1.0  # ±1
        denom = jnp.sqrt(pvar + self.wvar)
        alpha = s * phat / denom
        # N(alpha)/Phi(alpha) via the scaled complementary error function
        logpdf = -0.5 * alpha**2 - 0.5 * jnp.log(2 * jnp.pi)
        logcdf = jax.scipy.stats.norm.logcdf(alpha)
        ratio = jnp.exp(logpdf - logcdf)
        zhat = phat + s * pvar / denom * ratio
        zvar = pvar - pvar**2 / (pvar + self.wvar) * ratio * (alpha + ratio)
        return zhat, jnp.maximum(zvar, 1e-12)

    def loglike(self, phat, pvar):
        """``log Phi(±(zhat)/sqrt(zvar + wvar))`` — the sum-product logLike
        of ``classification/ProbitEstimOut.m:340-356`` (jax logcdf is
        tail-stable, covering the erfcx branch)."""
        s = 2.0 * self.y - 1.0
        return jax.scipy.stats.norm.logcdf(
            s * phat / jnp.sqrt(pvar + self.wvar)
        )


_register(ProbitLikelihood, ("y", "wvar"))


@dataclasses.dataclass(frozen=True)
class PoissonLikelihood:
    """Count observation y ~ Poisson(scale·z), z ≥ 0 — the
    ``PoissonEstim`` analog, with a Gaussian-approximated posterior
    (quadratic expansion of the log-likelihood at the prior mean)."""

    y: jnp.ndarray
    scale: jnp.ndarray = 1.0

    def estim(self, phat, pvar):
        # Laplace approximation around a positive operating point.
        z0 = jnp.maximum(phat, 1e-6)
        # d/dz [y·log(sz) − s·z] = y/z − s ;  −d²/dz² = y/z²
        grad = self.y / z0 - self.scale
        curv = self.y / z0**2
        post_prec = 1.0 / pvar + curv
        zhat = z0 + (grad + (phat - z0) / pvar) / post_prec
        return jnp.maximum(zhat, 0.0), 1.0 / post_prec


_register(PoissonLikelihood, ("y", "scale"))


@dataclasses.dataclass(frozen=True)
class QuantizedLikelihood:
    """Interval observation from a uniform scalar quantizer: y known to lie
    in [lo, hi] per component (ties the ``optimum_uniform_quantizer``
    front end into estimation — the few-bit-ADC receiver model).  Real
    scalar moments of z ~ N(phat, pvar) truncated to [lo, hi]."""

    lo: jnp.ndarray
    hi: jnp.ndarray

    def estim(self, phat, pvar):
        # large-pvar stability lives in the shared _tn_moments primitive
        # (finite-interval pvar cap + log1mexp — round 5)
        zhat, zvar, _ = _tn_moments(phat, pvar, self.lo, self.hi)
        return zhat, jnp.maximum(zvar, 1e-12)


_register(QuantizedLikelihood, ("lo", "hi"))


@dataclasses.dataclass(frozen=True)
class OutlierLikelihood:
    """Robust AWGN: y = z + noise where noise is a two-component mixture
    CN(0, wvar) w.p. (1−lam) and CN(0, wvar_out) w.p. lam — the
    sparse-outlier observation model behind robust PCA (the
    ``EMBiGAMP_RPCA`` capability).  Posterior moments of z ~ CN(phat, pvar)
    via responsibility-weighted component posteriors."""

    y: jnp.ndarray
    wvar: jnp.ndarray
    wvar_out: jnp.ndarray
    lam: jnp.ndarray = 0.05

    def estim(self, phat, pvar):
        def comp(wv):
            v = pvar + wv
            loglike = -(jnp.log(jnp.pi) + jnp.log(v) + jnp.abs(self.y - phat) ** 2 / v)
            gain = pvar / v
            zhat = phat + gain * (self.y - phat)
            zvar = wv * gain
            return loglike, zhat, zvar

        l0, z0, v0 = comp(self.wvar)
        l1, z1, v1 = comp(self.wvar_out)
        exparg = jnp.clip(
            l1 - l0 + jnp.log(self.lam) - jnp.log1p(-self.lam), -_MAXARG, _MAXARG
        )
        r1 = 1.0 / (1.0 + jnp.exp(-exparg))  # responsibility of the outlier comp
        zhat = (1 - r1) * z0 + r1 * z1
        ez2 = (1 - r1) * (jnp.abs(z0) ** 2 + v0) + r1 * (jnp.abs(z1) ** 2 + v1)
        return zhat, jnp.maximum(ez2 - jnp.abs(zhat) ** 2, 1e-12)


_register(OutlierLikelihood, ("y", "wvar", "wvar_out", "lam"))


@dataclasses.dataclass(frozen=True)
class AwbgnLikelihood:
    """Additive white *Bernoulli*-Gaussian noise (``main/AwbgnEstimOut.m``):

        p(y|z) = (1−λ)·δ(z−y) + λ·N(z; y, wvar)

    i.e. each measurement is exactly noiseless w.p. (1−λ) and Gaussian-noisy
    w.p. λ — the delta-spike/impulsive observation channel.  Unlike
    :class:`OutlierLikelihood` (two *Gaussian* components) the clean
    component here is a point mass, so the posterior of z ~ N(phat, pvar)
    is a mixture of δ(z−y) and the usual AWGN Gaussian posterior.

    Responsibilities (``AwbgnEstimOut.m:60-72``): the clean component's
    marginal evidence is N(y; phat, pvar), the noisy one's
    N(y; phat, pvar+wvar); posterior moments follow by mixture algebra
    (``AwbgnEstimOut.m:74-84``).  Real-valued (the reference errors on
    complex y).

    Note: with small λ most measurements are exactly noiseless, so posterior
    variances collapse toward 0 — in f32 GAMP this wants a precision floor
    (``GampOptions(pvar_min=1e-6)``, the reference's GampOpt ``pvarMin``) or
    a damped step for robust convergence (see
    ``tests/test_estim_round4.py::test_awbgn_gamp_impulsive_recovery``).
    """

    y: jnp.ndarray
    wvar: jnp.ndarray
    lam: jnp.ndarray = 0.1

    def estim(self, phat, pvar):
        d2 = (phat - self.y) ** 2
        loglike0 = -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(pvar) + d2 / pvar)
        v1 = pvar + self.wvar
        loglike1 = -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(v1) + d2 / v1)
        exparg = jnp.clip(
            loglike0 - loglike1 + jnp.log1p(-self.lam) - jnp.log(self.lam),
            -_MAXARG, _MAXARG,
        )
        py1 = 1.0 / (1.0 + jnp.exp(exparg))  # Pr{Z ≠ y | y}
        py0 = 1.0 - py1
        nu = self.wvar * pvar / v1
        gamma = (self.wvar * phat + self.y * pvar) / v1
        zhat = py1 * gamma + py0 * self.y
        ez2 = py1 * (gamma**2 + nu) + py0 * self.y**2
        return zhat, jnp.maximum(ez2 - zhat**2, 1e-14)

    def loglike(self, zhat, zvar):
        """Lower-bound output cost of the reference (``AwbgnEstimOut.m:96-103``):
        treat the channel as AWGN(wvar) scaled by λ.

        Deliberate deviation from the cited lines: the reference divides
        the ENTIRE bracket — including the ``log(2π)+log(wvar)`` terms —
        by ``wvar`` (a parenthesization slip that rescales the constant
        terms of the Gaussian log-density); here only the quadratic term
        is divided by ``wvar``, which is the correct AWGN log-likelihood.
        The cost is only used for step acceptance / adaptive damping, so
        the slip shifts the reference's cost by a zhat-independent offset
        scaled 1/wvar; this form keeps the documented lower-bound
        semantics exact."""
        wv = jnp.maximum(self.wvar, 1e-20)
        # per-element costs, like every other likelihood: consumers
        # (gamp_full's acceptance sum, ConcatLikelihood's block concat)
        # reduce them; an internal jnp.sum here broke that contract (r5)
        return (
            -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(wv)
                    + ((self.y - zhat) ** 2 + zvar) / wv)
            + jnp.log(self.lam)
        )


_register(AwbgnLikelihood, ("y", "wvar", "lam"))


@dataclasses.dataclass(frozen=True)
class TruthReporterPrior:
    """Debugging wrapper around a prior that prints in-flight GAMP
    diagnostics against a known truth (``main/TruthReporter.m``): the
    correlation of the rhat error with the signal (→0 for matched MMSE
    messages), the rhat-MSE/rvar and xhat-MSE/xvar consistency ratios, and
    the running NMSE in dB.  Uses ``jax.debug.print`` so it works inside
    jit/scan (prints at execution, not trace)."""

    base: object
    truth: jnp.ndarray

    def estim(self, rhat, rvar):
        xhat, xvar = self.base.estim(rhat, rvar)
        err = rhat - self.truth
        ec = jnp.sum(jnp.conj(err - err.mean()) * (self.truth - self.truth.mean()))
        denom = jnp.sqrt(
            jnp.sum(jnp.abs(err - err.mean()) ** 2)
            * jnp.sum(jnp.abs(self.truth - self.truth.mean()) ** 2)
        )
        err_corr = jnp.abs(ec) / jnp.maximum(denom, 1e-30)
        rhat_mse = jnp.mean(jnp.abs(err) ** 2)
        xhat_mse = jnp.mean(jnp.abs(xhat - self.truth) ** 2)
        nmse_db = 10.0 * jnp.log10(
            jnp.sum(jnp.abs(xhat - self.truth) ** 2)
            / jnp.maximum(jnp.sum(jnp.abs(self.truth) ** 2), 1e-30)
        )
        jax.debug.print(
            "truth: |corr(rhat-x,x)|={c:.2f} rhatMSE/rvar={r:.4f} "
            "xhatMSE/xvar={x:.4f} NMSE={n:.2f} dB",
            c=err_corr, r=rhat_mse / jnp.maximum(jnp.mean(rvar), 1e-30),
            x=xhat_mse / jnp.maximum(jnp.mean(xvar), 1e-30), n=nmse_db,
        )
        return xhat, xvar

    def __getattr__(self, name):
        # delegate estim_map / val_neg_kl / ... to the wrapped prior.
        # Guard dunders and the own fields: during deepcopy/unpickling the
        # instance exists before 'base' is set, and an unconditional
        # delegate would recurse on the 'base' lookup itself.
        if name.startswith("__") or name in ("base", "truth"):
            raise AttributeError(name)
        return getattr(self.base, name)


_register(TruthReporterPrior, ("base", "truth"))


@dataclasses.dataclass(frozen=True)
class LaplacePrior:
    """Laplacian MMSE prior p(x) = (lam/2)·exp(−lam|x|), real x — the
    ``LaplaceEstimIn.m`` analog (exact posterior, not the soft-threshold MAP
    of :class:`SoftThreshPrior`).

    With r = x + N(0, rvar) the posterior splits into two half-line
    truncated Gaussians: on x ≥ 0 it is TN(r − lam·rvar, rvar, [0,∞)) with
    log-weight −lam·r + log Phi((r − lam·rvar)/sqrt(rvar)); mirrored on
    x ≤ 0.  (The common factor exp(lam²·rvar/2) cancels in the softmax.)
    """

    lam: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        lam = self.lam
        sig = jnp.sqrt(rvar)
        mp = rhat - lam * rvar  # positive-branch untruncated mean
        mm = rhat + lam * rvar
        logcdf = jax.scipy.stats.norm.logcdf
        logw_p = -lam * rhat + logcdf(mp / sig)
        logw_m = lam * rhat + logcdf(-mm / sig)
        wmax = jnp.maximum(logw_p, logw_m)
        wp = jnp.exp(logw_p - wmax)
        wm = jnp.exp(logw_m - wmax)
        pi_p = wp / (wp + wm)
        mean_p, var_p, _ = _tn_moments(mp, rvar, 0.0, jnp.inf)
        mean_m, var_m, _ = _tn_moments(mm, rvar, -jnp.inf, 0.0)
        xhat = pi_p * mean_p + (1 - pi_p) * mean_m
        ex2 = pi_p * (mean_p**2 + var_p) + (1 - pi_p) * (mean_m**2 + var_m)
        return xhat, jnp.maximum(ex2 - xhat**2, 1e-30)

    def estim_map(self, rhat, rvar):
        """Max-sum branch: the soft-threshold prox of lam·|x|
        (``LaplaceEstimIn.m`` maxSumVal=true path)."""
        xhat = jnp.sign(rhat) * jnp.maximum(jnp.abs(rhat) - self.lam * rvar, 0.0)
        return xhat, rvar * (jnp.abs(xhat) > 0)

    def val_map(self, xhat):
        return jnp.log(self.lam / 2.0) - self.lam * jnp.abs(xhat)

    def init_moments(self):
        return jnp.zeros(()), 2.0 / self.lam**2


_register(LaplacePrior, ("lam",))


@dataclasses.dataclass(frozen=True)
class UnifPrior:
    """Uniform prior x ~ U[lo, hi], real — the ``UnifEstimIn.m`` analog.
    Posterior from r = x + N(0, rvar) is the truncated normal on [lo, hi]."""

    lo: jnp.ndarray = 0.0
    hi: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        xhat, xvar, _ = _tn_moments(rhat, rvar, self.lo, self.hi)
        return xhat, xvar

    def estim_map(self, rhat, rvar):
        """Max-sum branch: clip to the support; curvature is rvar strictly
        inside and 0 at the active bounds."""
        xhat = jnp.clip(rhat, self.lo, self.hi)
        interior = (rhat > self.lo) & (rhat < self.hi)
        return xhat, rvar * interior

    def init_moments(self):
        return (self.lo + self.hi) / 2.0, (self.hi - self.lo) ** 2 / 12.0


_register(UnifPrior, ("lo", "hi"))


@dataclasses.dataclass(frozen=True)
class NNGMPrior:
    """Non-negative (Bernoulli–truncated-)Gaussian-mixture prior, real x —
    the estimator behind the reference's EM-NN-AMP
    (``MPbased_solvers/EMNNAMP/``): x = 0 w.p. (1−p1), else a mixture
    Σ_k w_k·N(mu_k, v_k) truncated to x ≥ 0.

    Component posteriors are truncated normals on [0,∞); each component's
    responsibility includes its truncation mass via the logZ returned by
    :func:`_tn_moments`.  Set ``p1 = 1`` for the dense non-negative prior.
    """

    weights: jnp.ndarray  # (K,)
    means: jnp.ndarray  # (K,)
    variances: jnp.ndarray  # (K,)
    p1: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        r = rhat[..., None]
        rv = rvar[..., None] if hasattr(rvar, "ndim") and jnp.ndim(rvar) else rvar
        v = self.variances + rv
        # untruncated component posterior N(m_k, s_k) on x
        gain = self.variances / v
        m = gain * (r - self.means) + self.means
        s = gain * rv * jnp.ones_like(m)
        mean_k, var_k, logZ_k = _tn_moments(m, s, 0.0, jnp.inf)
        # evidence of comp k: N(r; mu_k, v)·Z_k / Phi(mu_k/sqrt(v_k)) —
        # the prior-side truncation mass renormalizes each component.
        logcdf = jax.scipy.stats.norm.logcdf
        log_ev = (
            -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(v) + (r - self.means) ** 2 / v)
            + logZ_k
            - logcdf(self.means / jnp.sqrt(self.variances))
        )
        logw = jnp.log(self.weights) + log_ev
        log_slab = jax.scipy.special.logsumexp(logw, axis=-1)
        resp = jnp.exp(logw - log_slab[..., None])
        slab_mean = jnp.sum(resp * mean_k, axis=-1)
        slab_ex2 = jnp.sum(resp * (mean_k**2 + var_k), axis=-1)
        # spike/slab mixing (p1 = 1 short-circuits to the slab)
        log_spike = -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(rvar) + rhat**2 / rvar)
        exparg = jnp.clip(
            log_spike - log_slab + jnp.log1p(-jnp.minimum(self.p1, 1 - 1e-12))
            - jnp.log(self.p1),
            -_MAXARG,
            _MAXARG,
        )
        py1 = 1.0 / (1.0 + jnp.exp(exparg))
        py1 = jnp.where(self.p1 >= 1.0, 1.0, py1)
        xhat = py1 * slab_mean
        ex2 = py1 * slab_ex2
        return xhat, jnp.maximum(ex2 - xhat**2, 1e-30)

    def init_moments(self):
        mean_k, var_k, _ = _tn_moments(self.means, self.variances, 0.0, jnp.inf)
        m = self.p1 * jnp.sum(self.weights * mean_k)
        ex2 = self.p1 * jnp.sum(self.weights * (mean_k**2 + var_k))
        return m, jnp.maximum(ex2 - m**2, 1e-30)


_register(NNGMPrior, ("weights", "means", "variances", "p1"))


@dataclasses.dataclass(frozen=True)
class SNIPEPrior:
    """SNIPE — sparsifying non-informative parameter estimator
    (``main/SNIPEstim.m``): the limit of a Bernoulli×flat-slab prior.
    Posterior is a point mass at 0 w.p. (1−g) and N(rhat, rvar) w.p. g,
    with gain g = sigmoid(|rhat|²/(c·rvar) − omega), c = 2 for real r and
    1 for complex (circular) r."""

    omega: jnp.ndarray = 2.0

    def estim(self, rhat, rvar):
        c = 1.0 if jnp.iscomplexobj(rhat) else 2.0
        exparg = jnp.clip(
            jnp.abs(rhat) ** 2 / (c * rvar) - self.omega, -_MAXARG, _MAXARG
        )
        g = 1.0 / (1.0 + jnp.exp(-exparg))
        xhat = g * rhat
        ex2 = g * (jnp.abs(rhat) ** 2 + rvar)
        return xhat, jnp.maximum(ex2 - jnp.abs(xhat) ** 2, 1e-30)

    def init_moments(self):
        return jnp.zeros(()), jnp.ones(())


_register(SNIPEPrior, ("omega",))


@dataclasses.dataclass(frozen=True)
class EllpPrior:
    """l_p-norm MAP denoiser, 0 < p ≤ 1 (``main/EllpEstimIn.m``):
    prox of lam·|x|^p by majorization — one reweighted soft-threshold step
    with the weight lam·p·|rhat|^{p−1} evaluated at the pseudo-data
    (IRL1 with a single inner step; exact at p = 1)."""

    lam: jnp.ndarray = 1.0
    p: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        mag = jnp.abs(rhat)
        w = self.lam * self.p * jnp.maximum(mag, 1e-12) ** (self.p - 1.0)
        thresh = w * rvar
        shrunk = jnp.maximum(mag - thresh, 0.0)
        xhat = jnp.where(mag > 0, rhat / jnp.maximum(mag, 1e-30) * shrunk, 0.0)
        active = (shrunk > 0).astype(jnp.float32)
        return xhat, jnp.maximum(rvar * active, 1e-30)

    def init_moments(self):
        return jnp.zeros(()), 2.0 / self.lam**2


_register(EllpPrior, ("lam", "p"))


@dataclasses.dataclass(frozen=True)
class DiscretePrior:
    """Finite-alphabet prior x ∈ {a_k} w.p. w_k — e.g. a QAM constellation.
    Posterior is the softmax over atoms.  Covers both of the reference's
    discrete scalar estimators in one class: the real ``main/DisScaEstim.m``
    (N(0,rvar) branch) and the complex ``main/DisCScaEstim.m:29-52``
    (CN(0,rvar) branch, selected when the alphabet or pseudo-data is
    complex)."""

    atoms: jnp.ndarray  # (K,)
    weights: jnp.ndarray  # (K,)

    def estim(self, rhat, rvar):
        r = rhat[..., None]
        rv = rvar[..., None] if jnp.ndim(rvar) else rvar
        if jnp.iscomplexobj(self.atoms) or jnp.iscomplexobj(rhat):
            loglike = -jnp.abs(r - self.atoms) ** 2 / rv
        else:
            loglike = -((r - self.atoms) ** 2) / (2.0 * rv)
        logw = jnp.log(self.weights) + loglike
        logw = logw - jax.scipy.special.logsumexp(logw, axis=-1, keepdims=True)
        resp = jnp.exp(logw)
        xhat = jnp.sum(resp * self.atoms, axis=-1)
        ex2 = jnp.sum(resp * jnp.abs(self.atoms) ** 2, axis=-1)
        return xhat, jnp.maximum(ex2 - jnp.abs(xhat) ** 2, 1e-30)

    def init_moments(self):
        m = jnp.sum(self.weights * self.atoms)
        v = jnp.sum(self.weights * jnp.abs(self.atoms) ** 2) - jnp.abs(m) ** 2
        return m, v


_register(DiscretePrior, ("atoms", "weights"))


@dataclasses.dataclass(frozen=True)
class GroupSparsePrior:
    """Group-shared Bernoulli spike-slab: the last axis of x is a group that
    is active or inactive as a whole (the turboGAMP group-sparsity
    capability).  The activity posterior pools the per-element
    log-likelihood ratios over the group axis before the sigmoid."""

    base: CAwgnPrior
    p1: jnp.ndarray = 0.5

    def estim(self, rhat, rvar):
        rvar = jnp.maximum(rvar, jnp.finfo(jnp.float32).eps)
        loglike1 = self.base.loglikey(rhat, rvar)
        if jnp.iscomplexobj(rhat):
            loglike0 = -(jnp.log(jnp.pi) + jnp.log(rvar) + jnp.abs(rhat) ** 2 / rvar)
        else:
            loglike0 = -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(rvar) + rhat**2 / rvar)
        # pool the evidence over the group (last) axis
        pooled = jnp.sum(loglike0 - loglike1, axis=-1, keepdims=True)
        exparg = jnp.clip(
            pooled + jnp.log1p(-self.p1) - jnp.log(self.p1), -_MAXARG, _MAXARG
        )
        py1 = 1.0 / (1.0 + jnp.exp(exparg))
        xhat1, xvar1 = self.base.estim(rhat, rvar)
        xhat = py1 * xhat1
        xvar = py1 * (jnp.abs(xhat1) ** 2 + xvar1) - jnp.abs(xhat) ** 2
        return xhat, jnp.maximum(xvar, 1e-30)

    def init_moments(self):
        m1, v1 = self.base.init_moments()
        xhat = self.p1 * m1
        return xhat, self.p1 * (jnp.abs(m1) ** 2 + v1) - jnp.abs(xhat) ** 2


_register(GroupSparsePrior, ("base", "p1"))


# 17-node Gauss–Hermite rule for N(0,1) expectations (numpy at module scope).
import numpy as _np

_GH_X, _GH_W = _np.polynomial.hermite.hermgauss(17)
_GH_X = _GH_X * _np.sqrt(2.0)  # nodes for unit-variance normal
_GH_W = _GH_W / _np.sqrt(_np.pi)
# wider 33-node rule for heavy-tailed channels (robit/t2)
_GH33_X, _GH33_W = _np.polynomial.hermite.hermgauss(33)
_GH33_X = _GH33_X * _np.sqrt(2.0)
_GH33_W = _GH33_W / _np.sqrt(_np.pi)


@dataclasses.dataclass(frozen=True)
class LogitLikelihood:
    """Binary logistic channel p(y=1|z) = sigmoid(scale·z), y ∈ {0,1}, real z
    (``main/LogitEstimOut.m``).  Posterior moments of z ~ N(phat, pvar) by a
    17-node Gauss–Hermite rule (static, jit-friendly — the reference uses the
    same numerical-integration strategy)."""

    y: jnp.ndarray
    scale: jnp.ndarray = 1.0

    def estim(self, phat, pvar):
        sig = jnp.sqrt(pvar)
        z = phat[..., None] + sig[..., None] * _GH_X  # (..., Q)
        s = (2.0 * self.y - 1.0)[..., None]
        loglike = -jnp.logaddexp(0.0, -s * self.scale * z)
        logw = jnp.log(_GH_W) + loglike
        logw = logw - jax.scipy.special.logsumexp(logw, axis=-1, keepdims=True)
        w = jnp.exp(logw)
        zhat = jnp.sum(w * z, axis=-1)
        ez2 = jnp.sum(w * z**2, axis=-1)
        return zhat, jnp.maximum(ez2 - zhat**2, 1e-12)


_register(LogitLikelihood, ("y", "scale"))


@dataclasses.dataclass(frozen=True)
class RobustProbitLikelihood:
    """Outlier-robust probit channel (``classification/RobustProbitEstimOut.m``):
    with probability ``p_flip`` the label was flipped, so
    ``p(y=1|z) = p_flip + (1 − 2·p_flip)·Φ(z/√wvar)``.  Posterior moments in
    closed form as the two-component mixture of the prior (flip component)
    and the standard probit posterior (``RobustProbitEstimOut.m:120-150``)."""

    probit: "ProbitLikelihood"
    p_flip: jnp.ndarray = 0.05

    def estim(self, phat, pvar):
        p = self.p_flip
        s = 2.0 * self.probit.y - 1.0
        c_bar = phat / jnp.sqrt(self.probit.wvar + pvar)
        sCDF = (1.0 - 2.0 * p) * jax.scipy.stats.norm.cdf(s * c_bar)
        C = jnp.maximum(p + sCDF, 1e-30)
        part = sCDF / C
        zhat_std, zvar_std = self.probit.estim(phat, pvar)
        zhat = p * phat / C + part * zhat_std
        secmom = (
            p * (pvar + jnp.abs(phat) ** 2) / C
            + part * (zvar_std + jnp.abs(zhat_std) ** 2)
        )
        return zhat, jnp.maximum(secmom - jnp.abs(zhat) ** 2, 1e-12)

    def loglike(self, phat, pvar):
        s = 2.0 * self.probit.y - 1.0
        cdf = jax.scipy.stats.norm.cdf(
            s * phat / jnp.sqrt(pvar + self.probit.wvar)
        )
        return jnp.log(jnp.maximum(self.p_flip + (1 - 2 * self.p_flip) * cdf, 1e-30))


_register(RobustProbitLikelihood, ("probit", "p_flip"))


@dataclasses.dataclass(frozen=True)
class RobustLogitLikelihood:
    """Outlier-robust logistic channel
    ``p(y|z) = p_flip + (1 − 2·p_flip)·sigmoid(scale·s·z)``, s = ±1
    (``classification/RobustLogitEstimOut.m:15-18``); posterior moments by
    the same Gauss–Hermite rule as :class:`LogitLikelihood`."""

    y: jnp.ndarray
    p_flip: jnp.ndarray = 0.05
    scale: jnp.ndarray = 1.0

    def _node_loglike(self, z):
        s = (2.0 * self.y - 1.0)[..., None]
        sig = jnp.exp(-jnp.logaddexp(0.0, -s * self.scale * z))
        return jnp.log(
            jnp.maximum(self.p_flip + (1 - 2 * self.p_flip) * sig, 1e-30)
        )

    def estim(self, phat, pvar):
        sig = jnp.sqrt(pvar)
        z = phat[..., None] + sig[..., None] * _GH_X  # (..., Q)
        logw = jnp.log(_GH_W) + self._node_loglike(z)
        logw = logw - jax.scipy.special.logsumexp(logw, axis=-1, keepdims=True)
        w = jnp.exp(logw)
        zhat = jnp.sum(w * z, axis=-1)
        ez2 = jnp.sum(w * z**2, axis=-1)
        return zhat, jnp.maximum(ez2 - zhat**2, 1e-12)


_register(RobustLogitLikelihood, ("y", "p_flip", "scale"))


def _t2_logcdf(x):
    """log F₂(x), the Student-t (ν=2) CDF ``0.5·(1 + x/√(2+x²))``, in the
    cancellation-free product forms: F = 1/(√(2+x²)·(√(2+x²) − x)) (exact;
    stable for x ≤ 0) with √(2+x²) − x = 2/(√(2+x²) + x) for x > 0."""
    r = jnp.sqrt(2.0 + x**2)
    diff = jnp.where(x > 0, 2.0 / (r + jnp.abs(x)), r - x)
    return -jnp.log(r) - jnp.log(diff)


@dataclasses.dataclass(frozen=True)
class TDistLikelihood:
    """Robit regression channel ``p(y=1|z) = F₂(z/sigma)`` with F₂ the
    Student-t(ν=2) CDF (``classification/TDistEstimOut.m:10-21``; Liu 2006).
    The reference ships only a max-sum Taylor approximation
    (``TDistEstimOut.m:110-150``); here the sum-product posterior moments
    are computed exactly (to quadrature accuracy) by a 33-node
    Gauss–Hermite rule — the t₂ CDF's polynomial (1/x²) tails carry real
    posterior mass far out, under-resolved by the 17-node rule the
    lighter-tailed channels use."""

    y: jnp.ndarray
    sigma: jnp.ndarray = 0.1

    def estim(self, phat, pvar):
        sd = jnp.sqrt(pvar)
        z = phat[..., None] + sd[..., None] * _GH33_X
        s = (2.0 * self.y - 1.0)[..., None]
        logw = jnp.log(_GH33_W) + _t2_logcdf(s * z / self.sigma)
        logw = logw - jax.scipy.special.logsumexp(logw, axis=-1, keepdims=True)
        w = jnp.exp(logw)
        zhat = jnp.sum(w * z, axis=-1)
        ez2 = jnp.sum(w * z**2, axis=-1)
        return zhat, jnp.maximum(ez2 - zhat**2, 1e-12)

    def loglike(self, phat, pvar):
        s = 2.0 * self.y - 1.0
        return _t2_logcdf(s * phat / self.sigma)


_register(TDistLikelihood, ("y", "sigma"))


@dataclasses.dataclass(frozen=True)
class MultiLogitLikelihood:
    """Multinomial logistic channel (``classification/MultiLogitEstimOut.m``):
    per sample, z ∈ R^D and ``p(y=d|z) = softmax(scale·z)_d``.  Posterior
    moments of each component of z ~ N(phat, diag(pvar)) by self-normalized
    importance sampling from the prior with a fixed quasi-random particle
    set — the batched form of the reference's particle ``method``
    (``MultiLogitEstimOut.m:100-113``): one (P, D) batch of fused
    elementwise ops, no data-dependent control flow."""

    y: jnp.ndarray  # (M,) integer class labels in [0, D)
    D: int = 2
    scale: jnp.ndarray = 1.0
    n_particles: int = 128
    seed: int = 0

    def _nodes(self):
        rng = _np.random.default_rng(self.seed)
        return jnp.asarray(
            rng.standard_normal((self.n_particles, self.D)), jnp.float32
        )

    def estim(self, phat, pvar):
        # phat/pvar: (M, D)
        eps = self._nodes()  # (P, D)
        z = phat[:, None, :] + jnp.sqrt(pvar)[:, None, :] * eps  # (M, P, D)
        logits = self.scale * z
        logp = jnp.take_along_axis(
            logits, self.y[:, None, None].astype(jnp.int32), axis=-1
        )[..., 0] - jax.scipy.special.logsumexp(logits, axis=-1)  # (M, P)
        logw = logp - jax.scipy.special.logsumexp(logp, axis=-1, keepdims=True)
        w = jnp.exp(logw)[..., None]  # (M, P, 1)
        zhat = jnp.sum(w * z, axis=1)  # (M, D)
        ez2 = jnp.sum(w * z**2, axis=1)
        return zhat, jnp.maximum(ez2 - zhat**2, 1e-12)

    def loglike(self, phat, pvar):
        logits = self.scale * phat
        return (
            jnp.take_along_axis(
                logits, self.y[:, None].astype(jnp.int32), axis=-1
            )[..., 0]
            - jax.scipy.special.logsumexp(logits, axis=-1)
        )


_register(
    MultiLogitLikelihood, ("y", "scale"), ("D", "n_particles", "seed")
)


@dataclasses.dataclass(frozen=True)
class LaplaceLikelihood:
    """Laplacian-noise channel y = z + Laplace(lam), real z
    (``main/LaplaceEstimOut.m``).  By symmetry u = y − z has the
    :class:`LaplacePrior` posterior structure: the posterior of z given
    z ~ N(phat, pvar) splits at z = y into two truncated Gaussians."""

    y: jnp.ndarray
    lam: jnp.ndarray = 1.0

    def estim(self, phat, pvar):
        lam = self.lam
        sig = jnp.sqrt(pvar)
        # z < y branch: noise u = y−z > 0 carries exp(−lam(y−z)) → shift +lam·pvar
        mp = phat + lam * pvar
        mm = phat - lam * pvar
        logcdf = jax.scipy.stats.norm.logcdf
        logw_p = lam * (phat - self.y) + logcdf((self.y - mp) / sig)  # z ≤ y
        logw_m = lam * (self.y - phat) + logcdf(-(self.y - mm) / sig)  # z ≥ y
        wmax = jnp.maximum(logw_p, logw_m)
        wp = jnp.exp(logw_p - wmax)
        wm = jnp.exp(logw_m - wmax)
        pi_p = wp / (wp + wm)
        mean_p, var_p, _ = _tn_moments(mp, pvar, -jnp.inf, self.y)
        mean_m, var_m, _ = _tn_moments(mm, pvar, self.y, jnp.inf)
        zhat = pi_p * mean_p + (1 - pi_p) * mean_m
        ez2 = pi_p * (mean_p**2 + var_p) + (1 - pi_p) * (mean_m**2 + var_m)
        return zhat, jnp.maximum(ez2 - zhat**2, 1e-12)


_register(LaplaceLikelihood, ("y", "lam"))


@dataclasses.dataclass(frozen=True)
class MagnitudeLikelihood:
    """Magnitude-only (noncoherent) channel y = |z + w|, w ~ CN(0, wvar) —
    the PR-GAMP phase-retrieval observation (``main/ncCAwgnEstimOut.m``).

    Closed-form posterior of z ~ CN(phat, pvar): with v = z + w, the phase
    of v given y is von Mises with concentration kappa = 2·y·|phat|/(pvar+wvar)
    and mean direction phat/|phat|, so E[v|y] = y·R(kappa)·phat/|phat| with
    R = I1/I0 (computed via the exponentially-scaled ``i1e/i0e``); z|v is the
    usual Gaussian conditional.  This gives
      zhat = (wvar·phat + pvar·y·R·phat/|phat|) / (pvar + wvar)
      zvar = pvar·wvar/(pvar+wvar) + (pvar/(pvar+wvar))²·y²·(1 − R²).
    """

    y: jnp.ndarray  # magnitudes, ≥ 0
    wvar: jnp.ndarray

    def estim(self, phat, pvar):
        tot = pvar + self.wvar
        mag_p = jnp.abs(phat)
        direction = jnp.where(mag_p > 1e-30, phat / jnp.maximum(mag_p, 1e-30), 0.0)
        kappa = 2.0 * self.y * mag_p / tot
        R = jax.scipy.special.i1e(kappa) / jnp.maximum(
            jax.scipy.special.i0e(kappa), 1e-30
        )
        g = pvar / tot
        zhat = (1.0 - g) * phat + g * self.y * R * direction
        zvar = pvar * self.wvar / tot + g**2 * self.y**2 * (1.0 - R**2)
        return zhat, jnp.maximum(zvar, 1e-12)


_register(MagnitudeLikelihood, ("y", "wvar"))


@dataclasses.dataclass(frozen=True)
class DiracPrior:
    """Point-mass prior x = x0 with certainty (``main/DiracEstimIn.m``)."""

    x0: jnp.ndarray = 0.0

    def estim(self, rhat, rvar):
        xhat = self.x0 * jnp.ones_like(rhat)
        return xhat, jnp.zeros(jnp.shape(rhat), dtype=jnp.result_type(rvar))

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def loglikey(self, rhat, rvar):
        if jnp.iscomplexobj(rhat):
            return -(jnp.log(jnp.pi) + jnp.log(rvar) + jnp.abs(rhat - self.x0) ** 2 / rvar)
        return -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(rvar) + (rhat - self.x0) ** 2 / rvar)

    def init_moments(self):
        return self.x0, jnp.zeros(())


_register(DiracPrior, ("x0",))


@dataclasses.dataclass(frozen=True)
class NullPrior:
    """Non-informative (flat) prior (``main/NullEstimIn.m``): the posterior
    equals the incoming Gaussian message."""

    def estim(self, rhat, rvar):
        return rhat, rvar

    def estim_map(self, rhat, rvar):
        return rhat, rvar

    def init_moments(self):
        return jnp.zeros(()), jnp.ones(())


_register(NullPrior, ())


@dataclasses.dataclass(frozen=True)
class ElasticNetPrior:
    """Elastic-net MAP denoiser (``main/ElasticNetEstimIn.m``): prox of
    lam1·|x| + (lam2/2)·x², i.e. soft threshold followed by ridge shrink
    ``xhat = soft(r, lam1·rvar)/(1 + lam2·rvar)``.  Works for real or
    complex (circular soft threshold) pseudo-data."""

    lam1: jnp.ndarray = 1.0
    lam2: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        mag = jnp.abs(rhat)
        shrunk = jnp.maximum(mag - self.lam1 * rvar, 0.0)
        xhat = jnp.where(mag > 0, rhat / jnp.maximum(mag, 1e-30) * shrunk, 0.0)
        xhat = xhat / (1.0 + self.lam2 * rvar)
        active = (shrunk > 0).astype(jnp.float32)
        return xhat, jnp.maximum(rvar * active / (1.0 + self.lam2 * rvar), 1e-30)

    def estim_map(self, rhat, rvar):
        """Already the elastic-net prox (MAP by construction)."""
        return self.estim(rhat, rvar)

    def val_map(self, xhat):
        return -self.lam1 * jnp.abs(xhat) - 0.5 * self.lam2 * jnp.abs(xhat) ** 2

    def init_moments(self):
        return jnp.zeros(()), 1.0 / (self.lam1**2 + self.lam2)


_register(ElasticNetPrior, ("lam1", "lam2"))


@dataclasses.dataclass(frozen=True)
class NNSoftThreshPrior:
    """Exponential prior p(x) = lam·exp(−lam·x)·1{x ≥ 0}, real x
    (``main/NNSoftThreshEstimIn.m``) — exact MMSE posterior: the tilted
    Gaussian N(r − lam·rvar, rvar) truncated to [0, ∞)."""

    lam: jnp.ndarray = 1.0

    def estim(self, rhat, rvar):
        xhat, xvar, _ = _tn_moments(rhat - self.lam * rvar, rvar, 0.0, jnp.inf)
        return xhat, xvar

    def loglikey(self, rhat, rvar):
        # log ∫ N(r; x, rvar)·lam·e^{−lam x} dx over x ≥ 0
        m = rhat - self.lam * rvar
        return (
            jnp.log(self.lam)
            + 0.5 * self.lam**2 * rvar
            - self.lam * rhat
            + jax.scipy.stats.norm.logcdf(m / jnp.sqrt(rvar))
        )

    def estim_map(self, rhat, rvar):
        """Max-sum branch: prox of lam·x + 1{x≥0}
        (``NNSoftThreshEstimIn.m`` maxSumVal=true)."""
        xhat = jnp.maximum(rhat - self.lam * rvar, 0.0)
        return xhat, rvar * (xhat > 0)

    def val_map(self, xhat):
        return jnp.log(self.lam) - self.lam * xhat

    def init_moments(self):
        return 1.0 / self.lam, 1.0 / self.lam**2


_register(NNSoftThreshPrior, ("lam",))


@dataclasses.dataclass(frozen=True)
class MixPrior:
    """Two-component prior mixture x ~ w·p_a(x) + (1−w)·p_b(x)
    (``main/MixScaEstimIn.m``): posterior responsibilities from each
    component's Gaussian-channel evidence ``loglikey``; both components must
    implement ``estim`` and ``loglikey``."""

    base_a: object
    base_b: object
    w: jnp.ndarray = 0.5

    def estim(self, rhat, rvar):
        la = self.base_a.loglikey(rhat, rvar)
        lb = self.base_b.loglikey(rhat, rvar)
        exparg = jnp.clip(
            lb - la + jnp.log1p(-self.w) - jnp.log(self.w), -_MAXARG, _MAXARG
        )
        ra = 1.0 / (1.0 + jnp.exp(exparg))
        xa, va = self.base_a.estim(rhat, rvar)
        xb, vb = self.base_b.estim(rhat, rvar)
        xhat = ra * xa + (1 - ra) * xb
        ex2 = ra * (jnp.abs(xa) ** 2 + va) + (1 - ra) * (jnp.abs(xb) ** 2 + vb)
        return xhat, jnp.maximum(ex2 - jnp.abs(xhat) ** 2, 1e-30)

    def loglikey(self, rhat, rvar):
        la = self.base_a.loglikey(rhat, rvar)
        lb = self.base_b.loglikey(rhat, rvar)
        return jnp.logaddexp(jnp.log(self.w) + la, jnp.log1p(-self.w) + lb)

    def init_moments(self):
        ma, va = self.base_a.init_moments()
        mb, vb = self.base_b.init_moments()
        m = self.w * ma + (1 - self.w) * mb
        ex2 = self.w * (jnp.abs(ma) ** 2 + va) + (1 - self.w) * (
            jnp.abs(mb) ** 2 + vb
        )
        return m, ex2 - jnp.abs(m) ** 2


_register(MixPrior, ("base_a", "base_b", "w"))


@dataclasses.dataclass(frozen=True)
class ConcatPrior:
    """Blockwise prior over the last axis (``main/EstimInConcat.m``): block
    k of static size ``sizes[k]`` uses ``priors[k]``."""

    priors: tuple
    sizes: tuple  # static block lengths summing to the last-axis size

    def estim(self, rhat, rvar):
        off = 0
        xs, vs = [], []
        for prior, size in zip(self.priors, self.sizes):
            rv = rvar[..., off : off + size] if jnp.ndim(rvar) else rvar
            x, v = prior.estim(rhat[..., off : off + size], rv)
            xs.append(x)
            vs.append(v * jnp.ones_like(jnp.real(x)))
            off += size
        return jnp.concatenate(xs, axis=-1), jnp.concatenate(vs, axis=-1)

    def estim_map(self, rhat, rvar):
        off = 0
        xs, vs = [], []
        for prior, size in zip(self.priors, self.sizes):
            rv = rvar[..., off : off + size] if jnp.ndim(rvar) else rvar
            x, v = prior.estim_map(rhat[..., off : off + size], rv)
            xs.append(x)
            vs.append(v * jnp.ones_like(jnp.real(x)))
            off += size
        return jnp.concatenate(xs, axis=-1), jnp.concatenate(vs, axis=-1)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Blockwise input utility; blocks whose prior lacks a cost hook
        (e.g. the NullPrior augmentation entries of mean removal)
        contribute zero."""
        off = 0
        vals = []
        for prior, size in zip(self.priors, self.sizes):
            sl = slice(off, off + size)
            rv = rvar[..., sl] if jnp.ndim(rvar) else rvar
            xv = xvar[..., sl] if jnp.ndim(xvar) else xvar
            if hasattr(prior, "val_neg_kl"):
                vals.append(prior.val_neg_kl(rhat[..., sl], rv, xhat[..., sl], xv))
            else:
                vals.append(jnp.zeros(jnp.shape(rhat[..., sl])))
            off += size
        return jnp.concatenate(vals, axis=-1)

    def init_moments(self):
        ms, vs = [], []
        for prior, size in zip(self.priors, self.sizes):
            m, v = prior.init_moments()
            ms.append(jnp.broadcast_to(m, (size,)))
            vs.append(jnp.broadcast_to(v, (size,)))
        return jnp.concatenate(ms), jnp.concatenate(vs)


_register(ConcatPrior, ("priors",), ("sizes",))


@dataclasses.dataclass(frozen=True)
class DiracLikelihood:
    """Noiseless observation y = z exactly (``main/DiracEstimOut.m``)."""

    y: jnp.ndarray

    def estim(self, phat, pvar):
        return (
            self.y * jnp.ones_like(phat),
            jnp.zeros(jnp.shape(phat), dtype=jnp.result_type(pvar)),
        )

    def estim_map(self, phat, pvar):
        return self.estim(phat, pvar)

    def loglike(self, phat, pvar):
        """Constraint rows carry no data cost (``DiracEstimOut.m`` logLike
        convention for the mean-removal augmentation)."""
        return jnp.zeros(jnp.shape(phat))

    def logscale(self, axhat, pvar, phat):
        return jnp.zeros(jnp.shape(phat))


_register(DiracLikelihood, ("y",))


@dataclasses.dataclass(frozen=True)
class MaskedLikelihood:
    """Missing-data wrapper (``main/MaskedEstimOut.m``): where ``mask`` is 0
    the measurement is unobserved and the posterior equals the prior
    message (phat, pvar); elsewhere the base likelihood applies."""

    base: object
    mask: jnp.ndarray  # 0/1 (or bool), broadcastable to z

    def estim(self, phat, pvar):
        zb, vb = self.base.estim(phat, pvar)
        keep = self.mask.astype(bool)
        return jnp.where(keep, zb, phat), jnp.where(keep, vb, pvar)


_register(MaskedLikelihood, ("base", "mask"))


@dataclasses.dataclass(frozen=True)
class GaussMixLikelihood:
    """K-component zero-mean Gaussian-mixture noise y = z + w,
    w ~ Σ_k w_k·N(0, v_k) (``main/GaussMixEstimOut.m`` /
    ``CGaussMixEstimOut.m``; the 2-component :class:`OutlierLikelihood`
    specializes this).  Real or complex (circular) per the dtype of y."""

    y: jnp.ndarray
    weights: jnp.ndarray  # (K,)
    variances: jnp.ndarray  # (K,)

    def estim(self, phat, pvar):
        r = (self.y - phat)[..., None]
        v = pvar[..., None] + self.variances
        if jnp.iscomplexobj(self.y) or jnp.iscomplexobj(phat):
            loglike = -(jnp.log(jnp.pi) + jnp.log(v) + jnp.abs(r) ** 2 / v)
        else:
            loglike = -0.5 * (jnp.log(2 * jnp.pi) + jnp.log(v) + r**2 / v)
        logw = jnp.log(self.weights) + loglike
        logw = logw - jax.scipy.special.logsumexp(logw, axis=-1, keepdims=True)
        resp = jnp.exp(logw)
        gain = pvar[..., None] / v
        zk = phat[..., None] + gain * r
        vk = self.variances * gain
        zhat = jnp.sum(resp * zk, axis=-1)
        ez2 = jnp.sum(resp * (jnp.abs(zk) ** 2 + vk), axis=-1)
        return zhat, jnp.maximum(ez2 - jnp.abs(zhat) ** 2, 1e-12)


_register(GaussMixLikelihood, ("y", "weights", "variances"))


@dataclasses.dataclass(frozen=True)
class CMultAwgnLikelihood:
    """Known per-entry complex gain y = c∘z + CN(0, wvar)
    (``main/CMultAwgnEstimOut.m``) — the fading / calibration-known channel.
    Gaussian×Gaussian posterior in precision form."""

    y: jnp.ndarray
    c: jnp.ndarray
    wvar: jnp.ndarray

    def estim(self, phat, pvar):
        prec = 1.0 / pvar + jnp.abs(self.c) ** 2 / self.wvar
        zvar = 1.0 / prec
        zhat = zvar * (phat / pvar + jnp.conj(self.c) * self.y / self.wvar)
        return zhat, zvar


_register(CMultAwgnLikelihood, ("y", "c", "wvar"))


@dataclasses.dataclass(frozen=True)
class HingeLikelihood:
    """SVM hinge-loss channel p(y|z) ∝ exp(−scale·max(0, 1 − s·z)),
    s = ±1 from y ∈ {0,1}, real z — the ``TestSVMGAMP`` capability.

    Exact posterior: the likelihood is flat on s·z ≥ 1 and exponential on
    s·z < 1, so (in the mirrored coordinate u = s·z ~ N(s·phat, pvar)) the
    posterior splits at u = 1 into a plain truncated Gaussian
    TN(mu, pvar, [1, ∞)) and a tilted one TN(mu + c·pvar, pvar, (−∞, 1]),
    with log-weights log Φ((mu−1)/σ) and c·(mu − 1) + c²·pvar/2 +
    log Φ((1 − mu − c·pvar)/σ) — the same two-branch structure as
    :class:`LaplaceLikelihood`."""

    y: jnp.ndarray
    scale: jnp.ndarray = 1.0

    def estim(self, phat, pvar):
        s = 2.0 * self.y - 1.0
        mu = s * phat  # posterior of u = s·z, then mirror back
        sig = jnp.sqrt(pvar)
        c = self.scale
        logcdf = jax.scipy.stats.norm.logcdf
        mt = mu + c * pvar  # tilted-branch untruncated mean
        logw_flat = logcdf((mu - 1.0) / sig)
        logw_tilt = c * (mu - 1.0) + 0.5 * c**2 * pvar + logcdf((1.0 - mt) / sig)
        wmax = jnp.maximum(logw_flat, logw_tilt)
        wf = jnp.exp(logw_flat - wmax)
        wt = jnp.exp(logw_tilt - wmax)
        pi_f = wf / (wf + wt)
        mean_f, var_f, _ = _tn_moments(mu, pvar, 1.0, jnp.inf)
        mean_t, var_t, _ = _tn_moments(mt, pvar, -jnp.inf, 1.0)
        uhat = pi_f * mean_f + (1 - pi_f) * mean_t
        eu2 = pi_f * (mean_f**2 + var_f) + (1 - pi_f) * (mean_t**2 + var_t)
        return s * uhat, jnp.maximum(eu2 - uhat**2, 1e-12)


_register(HingeLikelihood, ("y", "scale"))


@dataclasses.dataclass(frozen=True)
class ConcatLikelihood:
    """Blockwise likelihood over the last axis (``main/EstimOutConcat.m``)."""

    likes: tuple
    sizes: tuple

    def estim(self, phat, pvar):
        off = 0
        zs, vs = [], []
        for like, size in zip(self.likes, self.sizes):
            pv = pvar[..., off : off + size] if jnp.ndim(pvar) else pvar
            z, v = like.estim(phat[..., off : off + size], pv)
            zs.append(z)
            vs.append(v * jnp.ones_like(jnp.real(z)))
            off += size
        return jnp.concatenate(zs, axis=-1), jnp.concatenate(vs, axis=-1)

    def estim_map(self, phat, pvar):
        off = 0
        zs, vs = [], []
        for like, size in zip(self.likes, self.sizes):
            pv = pvar[..., off : off + size] if jnp.ndim(pvar) else pvar
            z, v = like.estim_map(phat[..., off : off + size], pv)
            zs.append(z)
            vs.append(v * jnp.ones_like(jnp.real(z)))
            off += size
        return jnp.concatenate(zs, axis=-1), jnp.concatenate(vs, axis=-1)

    def _blockwise_cost(self, name, *arrays):
        off = 0
        vals = []
        for like, size in zip(self.likes, self.sizes):
            sl = slice(off, off + size)
            blocks = [a[..., sl] if jnp.ndim(a) else a for a in arrays]
            if hasattr(like, name):
                vals.append(getattr(like, name)(*blocks))
            else:
                vals.append(jnp.zeros(jnp.shape(blocks[0])))
            off += size
        return jnp.concatenate(vals, axis=-1)

    def loglike(self, phat, pvar):
        return self._blockwise_cost("loglike", phat, pvar)

    def logscale(self, axhat, pvar, phat):
        return self._blockwise_cost("logscale", axhat, pvar, phat)


_register(ConcatLikelihood, ("likes",), ("sizes",))


@dataclasses.dataclass(frozen=True)
class BGZeroMeanPrior:
    """Zero-mean Bernoulli-Gaussian prior, specialized fast path
    (``main/BGZeroMeanEstimIn.m:49-90``): algebraically identical to
    ``SparsePrior(AwgnPrior(0, var0), p1)`` but with the intermediate
    evidence terms folded into one alpha expression.  Real signals (the
    reference class is real-only; use SparsePrior+CAwgnPrior for complex)."""

    var0: jnp.ndarray = 1.0
    p1: jnp.ndarray = 0.5

    def estim(self, rhat, rvar):
        nu = rvar * self.var0 / (self.var0 + rvar)
        gamma = nu * rhat / rvar
        exparg = jnp.clip(-0.5 * gamma**2 / nu, -_MAXARG, _MAXARG)
        alpha = 1.0 + (1.0 - self.p1) / self.p1 * jnp.sqrt(
            self.var0 / nu
        ) * jnp.exp(exparg)
        xhat = gamma / alpha
        xvar = gamma**2 * (alpha - 1.0) / alpha**2 + nu / alpha
        return xhat, jnp.maximum(xvar, 1e-30)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """Spike-slab negative KL in the folded form of
        ``BGZeroMeanEstimIn.m:70-84``."""
        nu = rvar * self.var0 / (self.var0 + rvar)
        gamma = nu * rhat / rvar
        exparg = jnp.clip(-0.5 * gamma**2 / nu, -_MAXARG, _MAXARG)
        alpha = 1.0 + (1.0 - self.p1) / self.p1 * jnp.sqrt(
            self.var0 / nu
        ) * jnp.exp(exparg)
        val = 0.5 * (jnp.log(nu / self.var0) + (1.0 - nu / self.var0)
                     - gamma**2 / self.var0)
        py1 = 1.0 / alpha
        py0 = 1.0 - py1
        p1 = jnp.clip(self.p1, 1e-8, 1.0)
        return (
            py1 * val
            + py1 * jnp.log(jnp.maximum(p1, 1e-8) / jnp.maximum(py1, 1e-8))
            + py0 * jnp.log(jnp.maximum(1.0 - p1, 1e-8) / jnp.maximum(py0, 1e-8))
        )

    def init_moments(self):
        return jnp.zeros(()), self.var0 * self.p1


_register(BGZeroMeanPrior, ("var0", "p1"))


@dataclasses.dataclass(frozen=True)
class EllpDMMPrior:
    """Donoho/Maleki/Montanari l_p thresholder, 0 < p ≤ 1
    (``main/EllpDMMEstimIn.m:35-52``): the threshold is set adaptively to
    ``alpha·sqrt(mean(rvar))`` each iteration (the AMP tuning style) rather
    than from a fixed lambda."""

    alpha: jnp.ndarray = 1.5
    p: float = 1.0

    def estim(self, rhat, rvar):
        thresh = self.alpha * jnp.sqrt(jnp.mean(rvar))
        mag = jnp.maximum(jnp.abs(rhat), 1e-30)
        shrunk = jnp.maximum(mag - thresh * mag ** (self.p - 1.0), 0.0)
        xhat = jnp.where(
            jnp.abs(rhat) > 0, rhat / mag * shrunk, jnp.zeros_like(rhat)
        )
        active = shrunk > 0
        # p < 2 makes mag**(p-2) explode at the 1e-30 clamp (inf in f32),
        # and inf·0 from the inactive mask is NaN — evaluate the power on
        # active entries only (inactive slots get a harmless 1.0)
        mag_safe = jnp.where(active, mag, 1.0)
        xvar = rvar * (
            1.0 - thresh * (self.p - 1.0) * mag_safe ** (self.p - 2.0)
        )
        return xhat, jnp.maximum(
            jnp.real(xvar) * active.astype(jnp.float32), 1e-30
        )

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def init_moments(self):
        return jnp.zeros(()), jnp.asarray(1e-2)


_register(EllpDMMPrior, ("alpha",), ("p",))


@dataclasses.dataclass(frozen=True)
class SoftThreshDMMPrior:
    """DMM-style soft threshold with AMP threshold tuning and optional
    debiasing (``main/SoftThreshDMMEstimIn.m:42-68``): threshold
    ``alpha·sqrt(mean(rvar))``; variance is ``rvar·mean(active)`` (the
    empirical divergence, which is what gives AMP its Onsager term)."""

    alpha: jnp.ndarray = 1.5
    debias: bool = False

    def estim(self, rhat, rvar):
        thresh = self.alpha * jnp.sqrt(jnp.mean(rvar))
        mag = jnp.abs(rhat)
        shrunk = jnp.maximum(mag - thresh, 0.0)
        xhat = jnp.where(
            mag > 0, rhat / jnp.maximum(mag, 1e-30) * shrunk, jnp.zeros_like(rhat)
        )
        active = (shrunk > 0).astype(jnp.float32)
        xvar = rvar * jnp.mean(active) * jnp.ones_like(mag)
        if self.debias:
            on = shrunk * active
            scale = 1.0 + thresh * jnp.sum(on) / jnp.maximum(
                jnp.sum(on**2), 1e-30
            )
            xhat = scale * xhat
            xvar = scale * xvar
        return xhat, jnp.maximum(xvar, 1e-30)

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def init_moments(self):
        return jnp.zeros(()), jnp.asarray(1e-2)


_register(SoftThreshDMMPrior, ("alpha",), ("debias",))


@dataclasses.dataclass(frozen=True)
class FxnhandlePrior:
    """Black-box (plug-and-play / D-AMP) denoiser prior
    (``main/FxnhandleEstimIn.m:49-88``): wraps an arbitrary
    ``denoise(rhat, rvar) -> xhat`` callable; the posterior variance is
    ``rvar·div`` with the divergence estimated by Monte-Carlo directional
    probing, clipped to [div_min, div_max].  The probe directions derive
    from a fixed key (deterministic per instance — keeps the solver a pure
    function of its inputs, which jit/scan require)."""

    key: jnp.ndarray            # jax PRNG key (data leaf)
    denoise: object = None      # static callable (rhat, rvar) -> xhat
    change_factor: float = 1e-1
    n_avg: int = 1
    div_min: float = 0.0
    div_max: float = 1.0 - 1e-5

    def estim(self, rhat, rvar):
        xhat = self.denoise(rhat, rvar)
        eps_mach = jnp.finfo(jnp.float32).eps
        epsilon = self.change_factor * jnp.minimum(
            jnp.sqrt(jnp.mean(rvar)), jnp.mean(jnp.abs(rhat))
        ) + eps_mach
        divs = []
        for i in range(self.n_avg):
            eta = jnp.sign(
                jax.random.normal(
                    jax.random.fold_in(self.key, i), jnp.shape(rhat)
                )
            )
            x_pert = self.denoise(rhat + epsilon * eta, rvar)
            divs.append(jnp.mean(jnp.real(eta * (x_pert - xhat))) / epsilon)
        div = jnp.clip(
            sum(divs) / self.n_avg, self.div_min, self.div_max
        )
        return xhat, rvar * div * jnp.ones(jnp.shape(rhat))

    def estim_map(self, rhat, rvar):
        return self.estim(rhat, rvar)

    def init_moments(self):
        return jnp.zeros(()), jnp.ones(())


_register(
    FxnhandlePrior,
    ("key",),
    ("denoise", "change_factor", "n_avg", "div_min", "div_max"),
)


@dataclasses.dataclass(frozen=True)
class MultiSNIPEPrior:
    """Multi-point SNIPE (``main/MultiSNIPEstim.m:42-66``): dirac masses at
    ``thetas`` with gravities ``omegas`` plus an infinitely-broad slab; the
    ``xvar_big`` option caps the slab variance for convergence control.
    Generalizes :class:`SNIPEPrior` (which is the single-theta=0 case)."""

    thetas: jnp.ndarray          # (L,)
    omegas: jnp.ndarray          # (L,) or scalar
    xvar_big: float = float("inf")

    def estim(self, rhat, rvar):
        rv = rvar[..., None] if jnp.ndim(rvar) else rvar
        dterm = jnp.abs(rhat[..., None] - self.thetas) ** 2 / rv
        eterm = jnp.exp(jnp.clip(self.omegas - dterm / 2.0, -_MAXARG, _MAXARG))
        d0 = jnp.sum(eterm, -1) + 1.0
        d1 = eterm @ self.thetas + rhat
        d2 = eterm @ jnp.abs(self.thetas) ** 2 + jnp.abs(rhat) ** 2 + rvar
        xhat = d1 / d0
        xvar = d2 / d0 - jnp.abs(xhat) ** 2
        if jnp.isfinite(self.xvar_big):
            gain = 1.0 / (1.0 + rvar / self.xvar_big)
            xhat = xhat * gain
            xvar = xvar * gain
        return xhat, jnp.maximum(jnp.real(xvar), 1e-30)

    def val_neg_kl(self, rhat, rvar, xhat, xvar):
        """``MultiSNIPEstim.m:66`` val output (log-scale + Gaussian-entropy
        correction)."""
        rv = rvar[..., None] if jnp.ndim(rvar) else rvar
        dterm = jnp.abs(rhat[..., None] - self.thetas) ** 2 / rv
        eterm = jnp.exp(jnp.clip(self.omegas - dterm / 2.0, -_MAXARG, _MAXARG))
        d0 = jnp.sum(eterm, -1) + 1.0
        return jnp.log(d0) + 0.5 * (
            jnp.log(2 * jnp.pi * rvar)
            + jnp.abs(xhat - rhat) ** 2 / rvar
            + xvar / rvar
        )

    def init_moments(self):
        return jnp.zeros(()), jnp.ones(())


_register(MultiSNIPEPrior, ("thetas", "omegas"), ("xvar_big",))


@dataclasses.dataclass(frozen=True)
class L1Likelihood:
    """Max-sum output estimator for the l1 penalty fout(z) = −scale·Σ|z|
    (``main/L1EstimOut.m:57-86``) — analysis-sparsity / TV-style output
    regularization.  ``estim`` is the soft-threshold prox; with
    ``auto_scale`` the scale tracks 1/mean(|zhat|) for ``nit_scale``
    inner rounds (the experimental autoScale feature)."""

    scale: jnp.ndarray = 1.0
    auto_scale: bool = False
    scale_min: float = 1e-3
    scale_max: float = 1e3
    nit_scale: int = 5

    def _prox(self, scale, phat, pvar):
        sat = scale * pvar
        mag = jnp.abs(phat)
        shrunk = jnp.maximum(mag - sat, 0.0)
        zhat = jnp.where(
            mag > 0, phat / jnp.maximum(mag, 1e-30) * shrunk, jnp.zeros_like(phat)
        )
        return zhat, pvar * (shrunk > 0)

    def estim(self, phat, pvar):
        if not self.auto_scale:
            return self._prox(self.scale, phat, pvar)
        scale = jnp.asarray(self.scale, jnp.float32)
        zhat, zvar = self._prox(scale, phat, pvar)
        for _ in range(self.nit_scale):
            scale = jnp.clip(
                1.0 / jnp.maximum(jnp.mean(jnp.abs(zhat)), 1e-30),
                self.scale_min,
                self.scale_max,
            )
            zhat, zvar = self._prox(scale, phat, pvar)
        return zhat, zvar

    def estim_map(self, phat, pvar):
        return self.estim(phat, pvar)

    def loglike(self, phat, pvar):
        return -self.scale * jnp.abs(phat)


_register(
    L1Likelihood,
    ("scale",),
    ("auto_scale", "scale_min", "scale_max", "nit_scale"),
)


@dataclasses.dataclass(frozen=True)
class NLLikelihood:
    """General nonlinear AWGN channel y = f(z) + N(0, wvar)
    (``main/NLEstimOut.m:41-118``): posterior moments by Gauss-Hermite-style
    quadrature over z ~ N(phat, pvar).  The reference loops over
    measurements; here the n_z-point grid is broadcast over all
    measurements at once (one (m, n_z) elementwise block — the batched
    form)."""

    y: jnp.ndarray
    wvar: jnp.ndarray = 1e-2
    out_fn: object = None       # static callable z -> f(z), elementwise
    n_z: int = 100

    def _grid(self, phat, pvar):
        umax = jnp.sqrt(2.0 * jnp.log(self.n_z / 2.0))
        u = jnp.linspace(-umax, umax, self.n_z)
        z = phat[..., None] + jnp.sqrt(pvar)[..., None] * u
        logpyu = -((self.y[..., None] - self.out_fn(z)) ** 2) / (2.0 * self.wvar)
        return u, logpyu

    def estim(self, phat, pvar):
        u, logpyu = self._grid(phat, pvar)
        logpuy = logpyu - u**2 / 2.0
        logpuy = logpuy - jax.scipy.special.logsumexp(logpuy, -1, keepdims=True)
        puy = jnp.exp(logpuy)
        umean = puy @ u
        uvar = jnp.sum(puy * (u - umean[..., None]) ** 2, -1)
        return (
            phat + jnp.sqrt(pvar) * umean,
            jnp.maximum(pvar * uvar, 1e-30),
        )

    def loglike(self, zhat, zvar):
        u, logpyu = self._grid(zhat, zvar)
        pu = jnp.exp(-(u**2) / 2.0)
        pu = pu / jnp.sum(pu)
        return logpyu @ pu


_register(NLLikelihood, ("y", "wvar"), ("out_fn", "n_z"))
