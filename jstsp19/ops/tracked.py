"""Warm-started tracked singular-value thresholding (shared machinery).

The eigh-free SVT chain developed for the proposed ADMM: carry the Gram eigenbasis U across solver iterations and refresh it
with ``track_rounds`` parallel-ordering Jacobi rotation rounds per call.
The rotated Gram ``T = P·Pᴴ`` (P = Uᴴ·W) is consumed entirely through
row reductions of P, the round matrix G has two nonzeros per row/column so
``U·G`` / ``Gᴴ·P`` are elementwise row/column combinations (gather + f32
elementwise math — no matmul, no precision hack), the shrunk singular values are
P's post-rotation row norms, and the reconstruction is ``U·(f∘P)`` — TWO
matmuls per call.  Valid because the SVT inputs of an iterative solver
drift slowly once it settles, so a partial sweep per step keeps the basis
converged (NMSE-identical to eigh per the ADMM regression tests).

For N > M inputs the chain runs on the transpose — ``SVT(Xᵀ)ᵀ == SVT(X)``
exactly (X = UΣVᴴ ⇒ Xᵀ = V̄Σ(Ū)ᴴ).

This factory is the shared form consumed by ``solvers/admm.py`` (the
flagship) and the ``solvers/lowrank.py`` matrix-completion solvers
(mc_svt / mc_admm), replacing the reference's SVD-per-iteration
(``svt.m:5-13`` inside ``mc_svt.m:7-10`` / ``mc_admm.m:20-28``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from jstsp19.ops.jacobi import _round_robin_schedule, _schedule_gather_tables


def make_tracked_svt(N: int, M: int, cdt, track_rounds: int = 1,
                     precision: str = "default"):
    """Build the tracked-SVT step for (N, M)-shaped inputs.

    Returns ``(U0, step)`` where ``U0`` is the initial basis carry and
    ``step(W, tau, U, i) -> (X, U2)`` computes the shrunk matrix and the
    refreshed basis (``i`` = solver iteration, used to rotate through the
    Ns−1 disjoint-pair schedules so all pairs are visited cyclically).
    """
    flip = N > M
    Ns = M if flip else N  # thin side = tracked-basis dimension
    if Ns % 2:
        raise ValueError("tracked SVT needs an even thin dimension")

    sched = jnp.asarray(_round_robin_schedule(Ns))  # (Ns-1, 2, Ns/2)
    part_t, slot_t, isp_t = (
        jnp.asarray(t) for t in _schedule_gather_tables(Ns)
    )  # (Ns-1, Ns) each: pair partner / pair slot / "is the p side"

    def _rounds(U, P, start):
        def rr(carry, j):
            U, P = carry
            ridx = (start + j) % (Ns - 1)
            p, q = sched[ridx, 0], sched[ridx, 1]  # (Ns/2,) each
            Pp = P[p, :]
            Pq = P[q, :]
            app = jnp.sum(jnp.abs(Pp) ** 2, axis=-1)
            aqq = jnp.sum(jnp.abs(Pq) ** 2, axis=-1)
            apq = jnp.sum(Pp * jnp.conj(Pq), axis=-1)
            mag = jnp.abs(apq)
            phase = jnp.where(
                mag > 0, apq / jnp.where(mag > 0, mag, 1.0), 1.0 + 0.0j
            )
            theta = 0.5 * jnp.arctan2(2.0 * mag, app - aqq)
            c = jnp.cos(theta)
            s = (jnp.sin(theta) * phase).astype(cdt)
            part, slot, isp = part_t[ridx], slot_t[ridx], isp_t[ridx]
            cf = c[..., slot]
            sf = s[..., slot]
            # G[p,p]=G[q,q]=c, G[p,q]=−s, G[q,p]=s̄ ⇒ elementwise combos
            bR = jnp.where(isp, jnp.conj(sf), -sf)
            bL = jnp.where(isp, sf, -jnp.conj(sf))
            U2 = U * cf[None, :] + jnp.take(U, part, axis=-1) * bR[None, :]
            P2 = P * cf[:, None] + jnp.take(P, part, axis=-2) * bL[:, None]
            return (U2, P2), None

        (U, P), _ = jax.lax.scan(rr, (U, P), jnp.arange(track_rounds))
        return U, P

    def _step_thin(W, tau, U, i):
        # svt.m's MATRIX-level NaN reset (any non-finite entry zeroes the
        # whole matrix) — same semantics as lowrank.svt / svt_jacobi so
        # 'tracked' and 'eigh' stay trajectory-identical on the guard path
        ok = jnp.all(jnp.isfinite(W.real) & jnp.isfinite(W.imag))
        Wc = jnp.where(ok, W, 0.0)
        with jax.default_matmul_precision(precision):
            P = U.conj().T @ Wc
            U2, P2 = _rounds(U, P, (i * track_rounds) % (Ns - 1))
            sig = jnp.sqrt(jnp.sum(jnp.abs(P2) ** 2, axis=-1))
            f = jnp.where(
                sig > 0,
                jnp.maximum(sig - tau, 0.0) / jnp.where(sig > 0, sig, 1.0),
                0.0,
            )
            return U2 @ (f[:, None] * P2), U2

    if flip:
        def step(W, tau, U, i):
            X, U2 = _step_thin(W.T, tau, U, i)
            return X.T, U2
    else:
        step = _step_thin

    return jnp.eye(Ns, dtype=cdt), step
