"""Batched Hermitian eigensolver: parallel-ordering cyclic Jacobi.

Motivation: XLA's ``eigh`` inside a ``lax.scan`` is the one op in the ADMM
inner loop without a matmul-shaped lowering (serialized QR-style sweeps).  Classic two-sided Jacobi with a round-robin ("tournament")
ordering applies n/2 *disjoint* rotations per round, which vectorizes into
two dense n×n matmuls per round — matmul-shaped work that batches over leading
dimensions and compiles to a small ``scan``.

For the n≈32 Hermitian Grams of this workload, ``sweeps=10`` reaches
float32 eigendecomposition accuracy (off-diagonal mass < 1e-6·‖A‖).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _round_robin_schedule(n: int) -> np.ndarray:
    """(n-1, 2, n//2) int array: per round, the p/q index vectors of the
    disjoint pair set (circle method; player 0 fixed, others rotate)."""
    if n % 2:
        raise ValueError("parallel Jacobi needs even n")
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        arr = [0] + others
        ps, qs = [], []
        for i in range(n // 2):
            a, b = arr[i], arr[n - 1 - i]
            ps.append(min(a, b))
            qs.append(max(a, b))
        rounds.append((ps, qs))
        others = [others[-1]] + others[:-1]
    return np.asarray(rounds, dtype=np.int32)  # (n-1, 2, n/2)


@functools.lru_cache(maxsize=None)
def _schedule_gather_tables(n: int):
    """Gather tables for applying one parallel-ordering round as elementwise
    row/column combinations instead of a dense G matmul (the round matrix
    has exactly two nonzeros per row/column).

    Returns (partner, slot, is_p), each (n-1, n):
      partner[r, i] — the index paired with i in round r;
      slot[r, i]    — the pair slot of i (index into the round's (n/2,)
                      rotation-coefficient vectors);
      is_p[r, i]    — True where i is the smaller ("p") member of its pair.
    """
    sched = _round_robin_schedule(n)  # (n-1, 2, n/2)
    partner = np.empty((n - 1, n), np.int32)
    slot = np.empty((n - 1, n), np.int32)
    is_p = np.zeros((n - 1, n), bool)
    for r in range(n - 1):
        for k in range(n // 2):
            p, q = sched[r, 0, k], sched[r, 1, k]
            partner[r, p], partner[r, q] = q, p
            slot[r, p] = slot[r, q] = k
            is_p[r, p] = True
    return partner, slot, is_p


@functools.partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh(A: jnp.ndarray, sweeps: int = 10):
    """Eigendecomposition of batched Hermitian matrices.

    A: (..., n, n) complex Hermitian (n even) → (eigvals ascending (..., n),
    eigvecs (..., n, n)) with ``A ≈ V · diag(w) · Vᴴ``.
    """
    n = A.shape[-1]
    sched = jnp.asarray(_round_robin_schedule(n))  # (n-1, 2, n/2)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)

    def round_step(carry, pq):
        A, V = carry
        p, q = pq[0], pq[1]  # (n/2,) each, p < q
        app = jnp.real(A[..., p, p])  # (..., n/2)
        aqq = jnp.real(A[..., q, q])
        apq = A[..., p, q]
        mag = jnp.abs(apq)
        # unit phase of apq (1 where apq == 0)
        phase = jnp.where(mag > 0, apq / jnp.where(mag > 0, mag, 1.0), 1.0 + 0.0j)
        # rotation angle: tan(2θ) = 2|apq| / (app − aqq)
        theta = 0.5 * jnp.arctan2(2.0 * mag, app - aqq)
        c = jnp.cos(theta).astype(A.dtype)
        s = (jnp.sin(theta) * phase).astype(A.dtype)
        # G = I with 2x2 blocks [[c, −s],[s̄, c]] at (p,p),(p,q),(q,p),(q,q)
        # (J = [[c, −sinθ·e^{iφ}], [sinθ·e^{−iφ}, c]] diagonalizes the
        # dephased real 2×2; verified against closed-form 2×2 eigh)
        G = eye
        G = G.at[..., p, p].set(c)
        G = G.at[..., q, q].set(c)
        G = G.at[..., p, q].set(-s)
        G = G.at[..., q, p].set(jnp.conj(s))
        Gh = jnp.swapaxes(G.conj(), -2, -1)
        A_new = Gh @ A @ G
        V_new = V @ G
        return (A_new, V_new), None

    rounds = jnp.tile(sched, (sweeps, 1, 1))
    (A_fin, V), _ = jax.lax.scan(round_step, (A, eye), rounds)
    w = jnp.real(jnp.diagonal(A_fin, axis1=-2, axis2=-1))
    order = jnp.argsort(w, axis=-1)
    w_sorted = jnp.take_along_axis(w, order, axis=-1)
    V_sorted = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w_sorted, V_sorted


def svt_jacobi(Y: jnp.ndarray, tau, sweeps: int = 10) -> jnp.ndarray:
    """Singular-value soft-thresholding via the Jacobi eigensolver — an
    eigh-free drop-in for :func:`jstsp19.solvers.lowrank.svt` when the
    thin side is even-sized (same matrix-level NaN reset as svt.m's
    ``if(~isnan(...))``: any non-finite entry zeroes the whole matrix)."""
    n, m = Y.shape[-2], Y.shape[-1]
    ok = jnp.all(
        jnp.isfinite(Y.real) & jnp.isfinite(Y.imag), axis=(-2, -1),
        keepdims=True,
    )
    Yc = jnp.where(ok, Y, 0.0)
    tau = jnp.asarray(tau)[..., None]
    if n <= m:
        G = Yc @ jnp.swapaxes(Yc.conj(), -2, -1)
        sig2, U = jacobi_eigh(G, sweeps=sweeps)
        sig = jnp.sqrt(jnp.maximum(sig2, 0.0))
        f = jnp.where(sig > 0, jnp.maximum(sig - tau, 0.0) / jnp.where(sig > 0, sig, 1.0), 0.0)
        return (U * f[..., None, :]) @ (jnp.swapaxes(U.conj(), -2, -1) @ Yc)
    G = jnp.swapaxes(Yc.conj(), -2, -1) @ Yc
    sig2, V = jacobi_eigh(G, sweeps=sweeps)
    sig = jnp.sqrt(jnp.maximum(sig2, 0.0))
    f = jnp.where(sig > 0, jnp.maximum(sig - tau, 0.0) / jnp.where(sig > 0, sig, 1.0), 0.0)
    return (Yc @ V) * f[..., None, :] @ jnp.swapaxes(V.conj(), -2, -1)


# Shared dispatch settings for svt_jacobi when it stands in for the eigh
# prox inside iterative solvers (proposed ADMM, mc_svt, mc_admm): ONE
# sweep count so jacobi-vs-eigh A/B comparisons across solvers compare
# like with like.
JACOBI_SVT_SWEEPS = 8


def jacobi_svt_fn(Y, tau):
    """``svt_jacobi`` at the solver-shared sweep count."""
    return svt_jacobi(Y, tau, sweeps=JACOBI_SVT_SWEEPS)
