"""Bilinear GAMP (BiG-AMP): joint estimation of both factors of Z = A·X.

JAX counterpart of the reference's BiGAMP family
(``MPbased_solvers/BiGAMP/BiGAMP.m`` and the EMBiGAMP_DL / _MC / _RPCA
drivers): dictionary learning, matrix completion and robust PCA all
instantiate the same bilinear message-passing core.  This implementation
follows the Parker–Schniter BiG-AMP recursion with uniform (scalar)
variances — the ``BiGAMP_Lite`` regime — which keeps every quantity a dense
matrix op under ``lax.scan``:

    Z (L×M) = A (L×R) · X (R×M),  observed through an elementwise
    likelihood (AWGN with optional mask → matrix completion).

Priors on A and X are estimator modules from
:mod:`jstsp19.solvers.estim`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class BigAmpResult(NamedTuple):
    A: jnp.ndarray
    X: jnp.ndarray
    Z: jnp.ndarray
    # final input-stage pseudo-data for X (Rx ≈ X + N(0, rvar_x)) — lets EM
    # wrappers form exact posterior quantities (activity probabilities,
    # conditional moments) without re-running the solver
    Rx: jnp.ndarray = None
    rvar_x: jnp.ndarray = None


@functools.partial(jax.jit, static_argnames=("nit", "rank"))
def bigamp(
    Y: jnp.ndarray,
    mask: jnp.ndarray,
    rank: int,
    prior_a,
    prior_x,
    noise_var,
    key,
    nit: int = 50,
    step: float = 0.7,
    var_floor: float = 1e-9,
    likelihood=None,
    init_A=None,
    init_X=None,
) -> BigAmpResult:
    """Run BiG-AMP on (masked) observations ``Y ≈ mask ∘ (A·X)``.

    Y: (L, M); mask: (L, M) in {0,1} (all-ones = full observation);
    ``key`` seeds the random factor initialization (the bilinear problem is
    invariant to A·X ↦ (A·G)(G⁻¹·X), so the output is the product Z plus
    one arbitrary factorization).  ``likelihood``: optional elementwise
    output estimator replacing the default AWGN (e.g.
    :class:`~jstsp19.solvers.estim.OutlierLikelihood` for robust PCA).
    """
    L, M = Y.shape
    R = rank
    cdt = Y.dtype
    rdt = jnp.float32

    kA, kX = jax.random.split(key)
    # random init scaled to the prior's second moment (or caller-provided
    # spectral init — e.g. a winsorized truncated SVD for RPCA); real
    # observations (e.g. hyperspectral unmixing) keep a real state
    ma, va = prior_a.init_moments()
    mx, vx = prior_x.init_moments()

    def _rand(k, shape, m0, v0):
        ex2 = jnp.abs(m0) ** 2 + v0
        if jnp.issubdtype(cdt, jnp.complexfloating):
            w = (
                jax.random.normal(k, shape)
                + 1j * jax.random.normal(jax.random.fold_in(k, 1), shape)
            ).astype(cdt) * jnp.sqrt(ex2 / 2)
        else:
            w = jax.random.normal(k, shape).astype(cdt) * jnp.sqrt(ex2)
        return jnp.asarray(m0, cdt) + w

    Ahat = init_A if init_A is not None else _rand(kA, (L, R), ma, va)
    Xhat = init_X if init_X is not None else _rand(kX, (R, M), mx, vx)
    Avar = jnp.asarray(va, rdt)
    Xvar = jnp.asarray(vx, rdt)
    Shat = jnp.zeros((L, M), cdt)

    nv = jnp.asarray(noise_var, rdt)
    m = mask.astype(rdt)

    def body(carry, _):
        Ahat, Avar, Xhat, Xvar, Shat, _Rx, _rvx = carry
        a2 = jnp.mean(jnp.abs(Ahat) ** 2)
        x2 = jnp.mean(jnp.abs(Xhat) ** 2)

        # --- output linear stage (scalar-variance BiG-AMP) --------------
        zvar_bar = R * (a2 * Xvar + Avar * x2)  # plug-in variance
        zvar = zvar_bar + R * Avar * Xvar
        Phat = Ahat @ Xhat - Shat * zvar_bar
        zvar = jnp.maximum(zvar, var_floor)

        # --- output nonlinear (masked; AWGN or custom likelihood) -------
        if likelihood is not None:
            Z0, zvar0 = likelihood.estim(Phat, zvar)
        else:
            gain = zvar / (zvar + nv)
            Z0 = Phat + gain * (Y - Phat)
            zvar0 = gain * nv
        # unobserved entries carry no information
        Z0 = m * Z0 + (1 - m) * Phat
        zvar0_eff = m * zvar0 + (1 - m) * zvar
        Shat_new = (Z0 - Phat) / zvar
        svar = jnp.maximum((1.0 - jnp.mean(zvar0_eff) / zvar) / zvar, var_floor)
        Shat_new = step * Shat_new + (1 - step) * Shat

        # --- input linear stages ----------------------------------------
        rvar_x = 1.0 / jnp.maximum(L * svar * a2, var_floor)
        Rx = Xhat * (1.0 - rvar_x * L * svar * Avar) + rvar_x * (
            Ahat.conj().T @ Shat_new
        )
        rvar_a = 1.0 / jnp.maximum(M * svar * x2, var_floor)
        Ra = Ahat * (1.0 - rvar_a * M * svar * Xvar) + rvar_a * (
            Shat_new @ Xhat.conj().T
        )

        # --- input nonlinear --------------------------------------------
        Xn, Xvar_n = prior_x.estim(Rx, rvar_x)
        An, Avar_n = prior_a.estim(Ra, rvar_a)
        Xn = step * Xn + (1 - step) * Xhat
        An = step * An + (1 - step) * Ahat
        return (
            An,
            jnp.maximum(jnp.mean(Avar_n), var_floor),
            Xn,
            jnp.maximum(jnp.mean(Xvar_n), var_floor),
            Shat_new,
            Rx,
            rvar_x * jnp.ones((), rdt),
        ), None

    Rx0 = Xhat
    rvar_x0 = jnp.asarray(jnp.real(vx), rdt) * jnp.ones((), rdt)
    (Ahat, Avar, Xhat, Xvar, Shat, Rx_fin, rvar_x_fin), _ = jax.lax.scan(
        body, (Ahat, Avar, Xhat, Xvar, Shat, Rx0, rvar_x0), None, length=nit
    )
    return BigAmpResult(
        A=Ahat, X=Xhat, Z=Ahat @ Xhat, Rx=Rx_fin, rvar_x=rvar_x_fin
    )


def bigamp_mc(Y, mask, rank, noise_var, key, nit=100, step=0.7):
    """Matrix completion via BiG-AMP (the ``EMBiGAMP_MC`` capability):
    Gaussian priors on both factors."""
    from jstsp19.solvers.estim import CAwgnPrior

    pa = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    px = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    return bigamp(Y, mask, rank, pa, px, noise_var, key, nit=nit, step=step)


def bigamp_rpca(Y, rank, noise_var, outlier_var, outlier_frac, key, nit=300, step=0.05):
    """Robust PCA via BiG-AMP (the ``EMBiGAMP_RPCA`` capability): low-rank
    plus sparse-outlier decomposition.  Returns the BigAmpResult; the
    outlier field is ``Y − Z`` thresholded by the caller."""
    from jstsp19.solvers.estim import CAwgnPrior, OutlierLikelihood

    pa = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    px = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    lik = OutlierLikelihood(
        Y,
        jnp.asarray(noise_var, jnp.float32),
        jnp.asarray(outlier_var, jnp.float32),
        jnp.asarray(outlier_frac, jnp.float32),
    )
    mask = jnp.ones(Y.shape, jnp.float32)
    # Spectral initialization robust to gross outliers: winsorize |Y| at
    # 3x its median, truncated SVD -> rank-R factors (random init lets the
    # bilinear recursion lock onto the outliers instead of the subspace).
    mag = jnp.abs(Y)
    med = jnp.median(mag)
    Yw = jnp.where(mag > 3 * med, Y / jnp.maximum(mag, 1e-30) * 3 * med, Y)
    U, sv, Vh = jnp.linalg.svd(Yw, full_matrices=False)
    init_A = (U[:, :rank] * jnp.sqrt(sv[:rank])).astype(Y.dtype)
    init_X = (jnp.sqrt(sv[:rank])[:, None] * Vh[:rank]).astype(Y.dtype)
    return bigamp(
        Y, mask, rank, pa, px, noise_var, key, nit=nit, step=step,
        likelihood=lik, init_A=init_A, init_X=init_X,
    )


class EmBigAmpResult(NamedTuple):
    A: jnp.ndarray
    X: jnp.ndarray
    Z: jnp.ndarray
    noise_var: jnp.ndarray
    rank: int  # selected rank
    bic: tuple  # per-candidate-rank BIC scores


def em_bigamp_mc(
    Y,
    mask,
    max_rank: int,
    key,
    nit: int = 100,
    n_em: int = 3,
    step: float = 0.7,
):
    """EM-wrapped BiG-AMP matrix completion with rank selection — the
    ``EMBiGAMP_MC`` capability (``BiGAMP/EMBiGAMP_MC.m``): for each
    candidate rank the noise variance is EM-refit from the masked
    residual, and the rank is selected by BIC (observed-data Gaussian
    log-likelihood + complex-parameter-count penalty), matching the
    reference's penalized-likelihood rank search.  The scalar-variance
    BiG-AMP core is only stable near the true rank, so the explicit rank
    sweep doubles as the stabilizer (running far over-parameterized
    diverges — the reference contracts rank for the same reason).

    Python-level loop over candidate ranks; each rank's solver is a
    cached jit executable (static shapes per rank).
    """
    from jstsp19.solvers.estim import CAwgnPrior

    m = np.asarray(mask, np.float32)
    n_obs = max(float(m.sum()), 1.0)
    y_energy = float(np.sum(np.abs(np.asarray(Y)) ** 2 * m)) / n_obs
    pa = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    px = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))
    L, M = Y.shape

    best = None
    bics = []
    for r in range(1, max_rank + 1):
        nv = y_energy / 101.0
        k = jax.random.fold_in(key, r)
        res = None
        for _ in range(n_em):
            res = bigamp(Y, mask, r, pa, px, nv, k, nit=nit, step=step)
            # float64 residual: diverged candidate ranks overflow float32
            resid = (
                np.asarray(Y, np.complex128) - np.asarray(res.Z, np.complex128)
            ) * m
            nv = max(float(np.sum(np.abs(resid) ** 2)) / n_obs, 1e-12)
            k = jax.random.fold_in(k, 1)
        # BIC: n·ln(σ̂²) + k_params·ln(n); complex factor entries = 2 reals
        k_params = 2 * r * (L + M)
        bic = n_obs * np.log(nv) + k_params * np.log(n_obs)
        bics.append(float(bic))
        if not np.isfinite(bic):
            continue
        if best is None or bic < best[0]:
            best = (bic, r, res, nv)
    if best is None:
        raise RuntimeError("all candidate ranks diverged")
    _, r, res, nv = best
    return EmBigAmpResult(
        A=res.A, X=res.X, Z=res.Z, noise_var=jnp.asarray(nv), rank=r,
        bic=tuple(bics),
    )


class EmBigAmpDlResult(NamedTuple):
    A: jnp.ndarray  # learned dictionary (L, R)
    X: jnp.ndarray  # sparse codes (R, M)
    Z: jnp.ndarray  # reconstruction A·X
    sparsity: jnp.ndarray  # learned activity rate λ
    slab_var: jnp.ndarray  # learned active-coefficient variance θ
    noise_var: jnp.ndarray  # learned noise variance ψ


@functools.partial(jax.jit, static_argnames=("iters", "inner", "rank"))
def _dl_polish(Y, A0, X0, rank, tau0, tau1, iters=80, inner=5):
    """Alternating sparse-coding / LS-dictionary polish with soft-threshold
    continuation (τ decays geometrically τ0 → τ1).  The scalar-variance
    BiG-AMP core recovers the product A·X essentially exactly but leaves
    the R×R rotation ambiguity unresolved (its codes come out dense); the
    continuation drives the factorization to the sparse rotation — the
    role the per-entry variances play in the reference's ``EMBiGAMP_DL.m``.
    """
    R = rank
    eyeR = jnp.eye(R, dtype=Y.dtype)

    def outer(carry, it):
        A, X = carry
        tau = tau0 * (tau1 / tau0) ** (it / max(iters - 1, 1))
        Lc = jnp.maximum(jnp.linalg.norm(A, 2) ** 2, 1e-12)

        def ista(X, _):
            G = X + (A.conj().T @ (Y - A @ X)) / Lc
            mag = jnp.abs(G)
            X = jnp.where(
                mag > 0,
                G / jnp.maximum(mag, 1e-30) * jnp.maximum(mag - tau / Lc, 0.0),
                0.0,
            )
            return X, None

        X, _ = jax.lax.scan(ista, X, None, length=inner)
        XXh = X @ X.conj().T + 1e-9 * eyeR
        A = jnp.linalg.solve(XXh.conj().T, (Y @ X.conj().T).conj().T).conj().T
        nrm = jnp.maximum(jnp.linalg.norm(A, axis=0), 1e-12)
        return (A / nrm[None, :], X * nrm[:, None]), None

    (A, X), _ = jax.lax.scan(
        outer, (A0, X0), jnp.arange(iters, dtype=jnp.float32)
    )
    return A, X


def em_bigamp_dl(
    Y,
    rank: int,
    key,
    nit: int = 150,
    n_em: int = 4,
    step: float = 0.5,
    init_sparsity: float = 0.2,
    polish_iters: int = 80,
):
    """EM-wrapped BiG-AMP dictionary learning — the ``EMBiGAMP_DL``
    capability (``BiGAMP/EMBiGAMP_DL.m``): Y ≈ A·X with a Gaussian prior
    on the dictionary A and a Bernoulli-Gaussian (spike-slab) prior on the
    codes X whose activity rate λ, slab variance θ, and the noise variance
    ψ are all EM-learned:

      λ ← mean posterior activity  E[π | Rx]
      θ ← Σ π·E[|x|² | active] / Σ π      (slab second moment)
      ψ ← mean observed-residual power

    During the EM rounds the posterior activity/moments are computed
    exactly from the final input-stage pseudo-data (Rx, rvar_x) returned
    by :func:`bigamp` — the same spike-slab responsibility algebra as
    ``SparseScaEstim.m:77-115``.  A final :func:`_dl_polish` continuation
    resolves the rotation ambiguity of the scalar-variance core (verified:
    exact support recovery on synthetic Bernoulli-Gaussian problems), and
    the reported hyperparameters are re-fit on the polished factors.
    """
    from jstsp19.solvers.estim import CAwgnPrior, SparsePrior

    L, M = Y.shape
    y_energy = float(np.mean(np.abs(np.asarray(Y)) ** 2))
    pa = CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(1.0))

    lam = float(init_sparsity)
    # scale the slab so the product matches the observed energy:
    # E|y|² ≈ R·λ·θ·E|a|² (+ψ)
    theta = max(y_energy / (rank * lam), 1e-12)
    nv = y_energy / 101.0

    res = None
    for it in range(n_em):
        px = SparsePrior(
            CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.asarray(theta)),
            jnp.asarray(lam),
        )
        k = jax.random.fold_in(key, it)
        res = bigamp(Y, jnp.ones(Y.shape, jnp.float32), rank, pa, px, nv,
                     k, nit=nit, step=step)
        # exact spike-slab posterior from the final pseudo-data
        Rx, rvx = np.asarray(res.Rx), float(res.rvar_x)
        rvx = max(rvx, 1e-12)
        ll1 = -(np.log(np.pi) + np.log(theta + rvx)
                + np.abs(Rx) ** 2 / (theta + rvx))
        ll0 = -(np.log(np.pi) + np.log(rvx) + np.abs(Rx) ** 2 / rvx)
        exparg = np.clip(ll0 - ll1 + np.log1p(-lam) - np.log(lam), -500, 500)
        pi = 1.0 / (1.0 + np.exp(exparg))
        gain = theta / (theta + rvx)
        x1 = gain * Rx
        ex2_active = np.abs(x1) ** 2 + gain * rvx
        lam = float(np.clip(pi.mean(), 1e-4, 1 - 1e-4))
        theta = float(
            max(np.sum(pi * ex2_active) / max(np.sum(pi), 1e-9), 1e-12)
        )
        resid = np.asarray(Y, np.complex128) - np.asarray(res.Z, np.complex128)
        nv = max(float(np.mean(np.abs(resid) ** 2)), 1e-12)

    # sparsifying-rotation polish + hyperparameter re-fit
    rms = float(np.sqrt(np.mean(np.abs(np.asarray(Y)) ** 2)))
    A_fin, X_fin = _dl_polish(
        Y, res.A, res.X, rank,
        jnp.asarray(0.5 * rms), jnp.asarray(0.02 * rms), iters=polish_iters,
    )
    Xn = np.asarray(X_fin)
    active = np.abs(Xn) > 0
    lam = float(np.clip(active.mean(), 1e-4, 1 - 1e-4))
    theta = float(
        max(np.sum(np.abs(Xn) ** 2) / max(active.sum(), 1), 1e-12)
    )
    Z_fin = A_fin @ X_fin
    resid = np.asarray(Y, np.complex128) - np.asarray(Z_fin, np.complex128)
    nv = max(float(np.mean(np.abs(resid) ** 2)), 1e-12)
    return EmBigAmpDlResult(
        A=A_fin, X=X_fin, Z=Z_fin,
        sparsity=jnp.asarray(lam), slab_var=jnp.asarray(theta),
        noise_var=jnp.asarray(nv),
    )
