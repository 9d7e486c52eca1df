"""Low-rank estimators: singular-value thresholding and matrix completion.

Accelerator SVT: instead of a complex SVD per iteration (reference ``svt.m``),
shrinkage runs through a Hermitian ``eigh`` of the thin-side Gram —
``X·Xᴴ`` (N×N) for wide matrices — which XLA lowers better than
rectangular complex SVD, and batches cleanly under ``vmap``:

    X Xᴴ = U diag(σ²) Uᴴ  ⇒  shrink(X) = U diag(max(σ−τ,0)/σ) Uᴴ X.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _shrink_factors(sig2: jnp.ndarray, tau) -> jnp.ndarray:
    """max(σ−τ, 0)/σ with σ = sqrt(σ²), guarded at σ→0."""
    sig = jnp.sqrt(jnp.maximum(sig2, 0.0))
    return jnp.where(sig > 0, jnp.maximum(sig - tau, 0.0) / jnp.where(sig > 0, sig, 1.0), 0.0)


def svt(Y: jnp.ndarray, tau) -> jnp.ndarray:
    """Singular-value soft-thresholding prox of the nuclear norm.

    Matches ``benchmark_algorithms/svt.m:5-13`` (including its NaN guard:
    ``if(~isnan(softThres))`` on a MATRIX is true only when every entry
    is non-NaN, so ANY non-finite input maps the WHOLE matrix to zeros —
    per batch element here) but computes ``U·max(Σ−τ,0)·Vᴴ`` via the
    thin-side Hermitian eigendecomposition.  Batched over leading dims;
    ``tau`` may broadcast over the batch.
    """
    n, m = Y.shape[-2], Y.shape[-1]
    ok = jnp.all(
        jnp.isfinite(Y.real) & jnp.isfinite(Y.imag), axis=(-2, -1),
        keepdims=True,
    )
    Yc = jnp.where(ok, Y, 0.0)
    tau = jnp.asarray(tau)[..., None]
    if n <= m:
        G = Yc @ jnp.swapaxes(Yc.conj(), -2, -1)  # (..., n, n)
        sig2, U = jnp.linalg.eigh(G)
        f = _shrink_factors(sig2, tau)  # (..., n)
        # X = U diag(f) U^H Y
        return (U * f[..., None, :]) @ (jnp.swapaxes(U.conj(), -2, -1) @ Yc)
    G = jnp.swapaxes(Yc.conj(), -2, -1) @ Yc  # (..., m, m)
    sig2, V = jnp.linalg.eigh(G)
    f = _shrink_factors(sig2, tau)
    return (Yc @ V) * f[..., None, :] @ jnp.swapaxes(V.conj(), -2, -1)


def _resolve_svt_fn(svt_method: str):
    """Non-tracked inner-prox dispatch shared by mc_svt and mc_admm:
    'eigh' → :func:`svt`, 'jacobi' → the solver-shared
    ``ops/jacobi.py::jacobi_svt_fn`` (same sweep count as the proposed
    ADMM's jacobi path, so A/B comparisons compare like with like);
    anything else raises instead of silently substituting eigh."""
    if svt_method == "jacobi":
        from jstsp19.ops.jacobi import jacobi_svt_fn

        return jacobi_svt_fn
    if svt_method == "eigh":
        return svt
    raise ValueError(f"unknown svt_method {svt_method!r}")


def mc_svt(OH: jnp.ndarray, Omega: jnp.ndarray, Imax: int, tau, rho,
           svt_method: str = "eigh", track_rounds: int = 1,
           track_precision: str = "default") -> jnp.ndarray:
    """Cai–Candès–Shen SVT matrix completion (``mc_svt.m:7-10``).

    Iterates ``X = svt(Y, τ/ρ); Y += ρ(OH − Ω∘X)`` and returns the ``X``
    of the ``Imax``-th loop body — i.e. ``svt`` of ``Y`` after ``Imax−1``
    updates, exactly the reference's returned iterate (the reference's
    final ``Y`` update is computed but discarded there; skipped here).
    ``svt_method='tracked'`` replaces the per-iteration eigh with the
    warm-started rotation chain (``ops/tracked.py`` — the flagship ADMM's
    SVT machinery; the Y iterate drifts slowly, so one rotation round per
    step keeps the basis converged).
    """
    if svt_method == "tracked":
        from jstsp19.ops.tracked import make_tracked_svt

        N, M = OH.shape[-2], OH.shape[-1]
        U0, step = make_tracked_svt(
            N, M, OH.dtype, track_rounds, track_precision
        )

        def body(carry, i):
            Y, U = carry
            X, U = step(Y, tau / rho, U, i)
            return (Y + rho * (OH - Omega * X), U), None

        (Y, U), _ = jax.lax.scan(
            body, (jnp.zeros_like(OH), U0), jnp.arange(Imax - 1)
        )
        return step(Y, tau / rho, U, Imax - 1)[0]

    svt_fn = _resolve_svt_fn(svt_method)

    def body(_, Y):
        X = svt_fn(Y, tau / rho)
        return Y + rho * (OH - Omega * X)

    Y = jax.lax.fori_loop(0, Imax - 1, body, jnp.zeros_like(OH))
    return svt_fn(Y, tau / rho)


def mc_admm(
    Htrue: jnp.ndarray,
    OH: jnp.ndarray,
    Omega: jnp.ndarray,
    Imax: int,
    tau,
    rho,
    svt_method: str = "eigh",
    track_rounds: int = 1,
    track_precision: str = "default",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ADMM matrix completion (``mc_admm.m``), returning (X, NMSE-per-iter).

    The reference's (Mr·Mt)² mask normal matrix (``mc_admm.m:11-17``) is
    diagonal — the solve collapses to an elementwise division by
    ``Ω + ρ``.  ``svt_method='tracked'``: warm-started eigh-free SVT
    (``ops/tracked.py``), as in :func:`mc_svt` — note the basis-tracking
    fidelity depends on how fast the SVT input drifts per iteration: for
    very small ρ the dual swings can outpace one rotation round per step
    (raise ``track_rounds``); at the canonical driver's ρ the tracked path
    matches eigh to ~1e-4 (tests/test_solvers_lowrank.py).
    """
    denom = Omega + rho
    tracked = svt_method == "tracked"
    if tracked:
        from jstsp19.ops.tracked import make_tracked_svt

        N, M = OH.shape[-2], OH.shape[-1]
        U0, step = make_tracked_svt(
            N, M, OH.dtype, track_rounds, track_precision
        )
        svt_fn = None
    else:
        U0 = jnp.zeros((), OH.dtype)
        svt_fn = _resolve_svt_fn(svt_method)  # eigh / jacobi; raises on typos

    def body(carry, i):
        _, Y, Z, U = carry
        if tracked:
            X, U = step(Y - Z / rho, tau / rho, U, i)
        else:
            X = svt_fn(Y - Z / rho, tau / rho)
        Ynew = (OH + Z + rho * X) / denom
        Znew = Z + rho * (X - Ynew)
        # Per-iteration NMSE vs ground truth (`mc_admm.m:26`); Frobenius here
        # (the reference's spectral norm would cost an extra eigh per step).
        err = jnp.sum(jnp.abs(X - Htrue) ** 2) / jnp.sum(jnp.abs(Htrue) ** 2)
        return (X, Ynew, Znew, U), err

    z = jnp.zeros_like(OH)
    (X, _, _, _), errs = jax.lax.scan(
        body, (z, z, z, U0), jnp.arange(Imax)
    )
    return X, errs
