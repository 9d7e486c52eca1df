"""Greedy pursuit: OMP (single & MMV) and CoSaMP.

The reference uses ``benchmark_algorithms/OMP.m`` plus the external
sparse-plex ``spx.pursuit.single/joint.OrthogonalMatchingPursuit``
(``plot_errorVSsnr.m:116-121``); CoSaMP exists at
``MPbased_solvers/neural/connectivity/cosamp.m``.  JAX versions:
fixed-m ``lax.fori_loop`` with static shapes, support tracked as index
arrays + masks (no dynamic growth), LS refit via a masked-Gram Cholesky
solve (identity padding on unused slots), all batchable under ``vmap``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


def _masked_ls(AhA_sel, Ahv_sel, active):
    """Solve (Gram over selected atoms) x = rhs with identity padding on
    inactive slots.  AhA_sel: (m, m), Ahv_sel: (m, ...), active: (m,) bool."""
    m = AhA_sel.shape[0]
    eye = jnp.eye(m, dtype=AhA_sel.dtype)
    mask2 = active[:, None] & active[None, :]
    G = jnp.where(mask2, AhA_sel, eye)
    amask = active[:, None] if Ahv_sel.ndim == 2 else active
    return jnp.linalg.solve(G, Ahv_sel * amask)


class OmpResult(NamedTuple):
    x: jnp.ndarray  # (n,) or (n, T) sparse estimate
    support: jnp.ndarray  # (m,) selected atom indices (int32)


@functools.partial(jax.jit, static_argnames=("m",))
def omp_gram(AhA: jnp.ndarray, Ahv: jnp.ndarray, m: int) -> OmpResult:
    """OMP core on a precomputed dictionary Gram ``AhA`` (n, n) and
    correlation vector ``Ahv`` (n,) — the dictionary itself never appears,
    so implicit (e.g. Kronecker) dictionaries plug in directly.

    The LS refit maintains the ACTIVE-Gram inverse by the bordered
    (Schur-complement) rank-1 update — O(m²) per greedy step instead of a
    fresh O(m³) solve (the same progressive-update idea as the reference's
    Cholesky-updating ``ompbox10`` MEX core, here in inverse form with
    static shapes: the inverse lives in an (m, m) buffer that is identity
    on inactive slots, so every step is fixed-shape masked elementwise math).
    """
    n = AhA.shape[0]
    rdt = jnp.finfo(AhA.dtype).dtype if jnp.iscomplexobj(AhA) else AhA.dtype

    def body(t, carry):
        idx, coef, inv = carry
        # residual correlations via the Gram: Aᴴr = Aᴴv − AhA[:, idx]·coef
        corr = Ahv - (AhA[:, idx] * coef[None, :]).sum(-1)
        # mask out already-selected atoms (only first t slots are valid)
        slot_valid = jnp.arange(m) < t
        sel_mask = jnp.zeros((n,), bool).at[jnp.where(slot_valid, idx, n)].set(
            True, mode="drop"
        )
        score = jnp.where(sel_mask, -jnp.inf, jnp.abs(corr))
        new = jnp.argmax(score).astype(jnp.int32)
        # bordered-inverse update: G_act grows by row/col g = AhA[idx, new]
        g = jnp.where(slot_valid, AhA[idx, new], 0.0)
        u = inv @ g  # = G_act⁻¹ g on active slots, 0 elsewhere
        d = AhA[new, new].real
        s_raw = d - jnp.real(jnp.vdot(g, u))
        # rank guard: an atom (numerically) inside the active span has
        # Schur complement ~0 — inverting it would explode the inverse, so
        # give the redundant slot a ZERO row/column instead (its coef stays
        # 0 and later updates proceed on the independent subset)
        tiny = s_raw <= 1e-6 * jnp.maximum(d, jnp.asarray(1e-30, rdt))
        s = jnp.where(tiny, jnp.asarray(1.0, rdt), s_raw).astype(AhA.dtype)
        u = jnp.where(tiny, 0.0, u)
        inv = inv + jnp.outer(u, u.conj()) / s
        inv_tt = jnp.where(tiny, 0.0, 1.0 / s)
        row_t = jnp.where(slot_valid, -u.conj() / s, 0.0).at[t].set(inv_tt)
        inv = inv.at[t, :].set(row_t)
        inv = inv.at[:, t].set(row_t.conj()).at[t, t].set(inv_tt)
        idx = idx.at[t].set(new)
        active = jnp.arange(m) <= t
        coef = inv @ jnp.where(active, Ahv[idx], 0.0)
        return idx, coef, inv

    idx0 = jnp.zeros((m,), jnp.int32)
    coef0 = jnp.zeros((m,), AhA.dtype)
    inv0 = jnp.eye(m, dtype=AhA.dtype)
    idx, coef, _ = jax.lax.fori_loop(0, m, body, (idx0, coef0, inv0))
    x = jnp.zeros((n,), AhA.dtype).at[idx].add(coef)
    return OmpResult(x=x, support=idx)


@functools.partial(jax.jit, static_argnames=("m",))
def omp_gram_kron(
    GA: jnp.ndarray, GB: jnp.ndarray, C0: jnp.ndarray, m: int
) -> OmpResult:
    """OMP core on the IMPLICIT Kronecker Gram ``kron(GA, GB)`` — the
    blocked form of :func:`omp_gram` for separable dictionaries.

    The (na·nb)² kron Gram never exists: residual correlations are the
    (na, nb) matrix ``C0 − GA[:, r_idx] · (coef ⊙ GB[:, c_idx]ᵀ)`` (one
    small matmul per step — a kron column is the outer product
    ``GA[:, r] ⊗ GB[:, c]``), and the active-Gram border row is the
    elementwise product ``GA[r_idx, r_new] ⊙ GB[c_idx, c_new]``.  At the
    TD-OMP config (na=32, nb=16, m=100) this removes the 512²-Gram
    materialization AND the (512, m) per-step gathers of a kron-dense
    core.

    ``C0``: initial correlation matrix (na, nb) = AᴴYBᴴ for the TD model.
    Atom index j = r·nb + c (row-major flatten of the (na, nb) support).
    Bordered-inverse refit and rank guard identical to :func:`omp_gram`.
    """
    na, nb = GA.shape[0], GB.shape[0]
    n = na * nb
    rdt = jnp.finfo(GA.dtype).dtype if jnp.iscomplexobj(GA) else GA.dtype
    Ahv = C0.reshape(-1)

    # Rather than re-gathering GA[:, r_idx] / GB[:, c_idx] / Ahv[idx]
    # every step (batched gathers), note that the support grows
    # by ONE atom per step, so every gathered quantity is carried as a
    # loop buffer updated by a single dynamic column write instead; the
    # remaining per-step indexing is scalar dynamic slicing.  Requires
    # Hermitian GA/GB (always true for Grams): the border row uses
    # GA[r_t, r_new] = conj(GAr[r_new, t]) from the carried buffer.
    def body(t, carry):
        idx, coef, inv, GAr, GBc, rhs, sel = carry
        # corr[p, q] = C0[p, q] − Σ_s coef_s · GA[p, r_s] · GB[q, c_s]
        corr = C0 - GAr @ (coef[:, None] * GBc.T)
        score = jnp.where(sel, -jnp.inf, jnp.abs(corr.reshape(-1)))
        new = jnp.argmax(score).astype(jnp.int32)
        r_new, c_new = new // nb, new % nb
        ga_col = jax.lax.dynamic_slice_in_dim(GA, r_new, 1, 1)[:, 0]
        gb_col = jax.lax.dynamic_slice_in_dim(GB, c_new, 1, 1)[:, 0]
        ga_row = jax.lax.dynamic_slice_in_dim(GAr, r_new, 1, 0)[0]
        gb_row = jax.lax.dynamic_slice_in_dim(GBc, c_new, 1, 0)[0]
        slot_valid = jnp.arange(m) < t
        g = jnp.where(slot_valid, jnp.conj(ga_row * gb_row), 0.0)
        u = inv @ g
        d = (
            jax.lax.dynamic_index_in_dim(ga_col, r_new, 0, False)
            * jax.lax.dynamic_index_in_dim(gb_col, c_new, 0, False)
        ).real
        s_raw = d - jnp.real(jnp.vdot(g, u))
        tiny = s_raw <= 1e-6 * jnp.maximum(d, jnp.asarray(1e-30, rdt))
        s = jnp.where(tiny, jnp.asarray(1.0, rdt), s_raw).astype(GA.dtype)
        u = jnp.where(tiny, 0.0, u)
        inv = inv + jnp.outer(u, u.conj()) / s
        inv_tt = jnp.where(tiny, 0.0, 1.0 / s)
        row_t = jnp.where(slot_valid, -u.conj() / s, 0.0).at[t].set(inv_tt)
        inv = inv.at[t, :].set(row_t)
        inv = inv.at[:, t].set(row_t.conj()).at[t, t].set(inv_tt)
        idx = idx.at[t].set(new)
        GAr = GAr.at[:, t].set(ga_col)
        GBc = GBc.at[:, t].set(gb_col)
        rhs = rhs.at[t].set(jax.lax.dynamic_index_in_dim(Ahv, new, 0, False))
        sel = sel.at[new].set(True)
        coef = inv @ rhs  # rhs is 0 on idle slots
        return idx, coef, inv, GAr, GBc, rhs, sel

    carry0 = (
        jnp.zeros((m,), jnp.int32),
        jnp.zeros((m,), GA.dtype),
        jnp.eye(m, dtype=GA.dtype),
        jnp.zeros((na, m), GA.dtype),
        jnp.zeros((nb, m), GB.dtype),
        jnp.zeros((m,), GA.dtype),
        jnp.zeros((n,), bool),
    )
    idx, coef, *_ = jax.lax.fori_loop(0, m, body, carry0)
    x = jnp.zeros((n,), GA.dtype).at[idx].add(coef)
    return OmpResult(x=x, support=idx)


@functools.partial(jax.jit, static_argnames=("m",))
def omp(A: jnp.ndarray, v: jnp.ndarray, m: int) -> OmpResult:
    """Single-vector Orthogonal Matching Pursuit with target sparsity m.

    Mirrors ``OMP.m:16-32`` (greedy argmax of |Aᴴr|, LS refit on the
    selected atoms, residual update) with static shapes: the selected-atom
    Gram is assembled by gather from the precomputed full Gram.
    """
    return omp_gram(A.conj().T @ A, A.conj().T @ v, m)


@functools.partial(jax.jit, static_argnames=("k",))
def omp_td(A: jnp.ndarray, B: jnp.ndarray, Y: jnp.ndarray, k: int) -> OmpResult:
    """Time-domain OMP over the implicit Kronecker dictionary — the
    "TD-OMP [11]" baseline of the reference's figure legends (Venugopal et
    al., wideband TD channel estimation; the reference repo itself ships
    only the saturating spx MMV-OMP, `plot_errorVSsnr.m:116-118`).

    Model: vec(Y) = kron(Bᵀ, A)·vec(S) with S (Gr, K).  The atoms are
    aᵢ·bⱼ outer products, so the dictionary Gram is
    ``kron(AᴴA, conj(B·Bᴴ))`` (row-major S flattening) and the
    correlations are ``vec(Aᴴ·Y·Bᴴ)`` — the kron is never materialized
    beyond the (Gr·K)² Gram of the SMALL factor Grams.

    Returns the (Gr, K) sparse estimate with exactly ≤k active entries.
    """
    Gr = A.shape[1]
    K = B.shape[0]
    GA = A.conj().T @ A  # (Gr, Gr)
    GB = jnp.conj(B @ B.conj().T)  # (K, K)
    C0 = A.conj().T @ Y @ B.conj().T  # (Gr, K)
    res = omp_gram_kron(GA, GB, C0, k)
    return OmpResult(x=res.x.reshape(Gr, K), support=res.support)


@functools.partial(jax.jit, static_argnames=("m",))
def omp_mmv(A: jnp.ndarray, V: jnp.ndarray, m: int) -> OmpResult:
    """Joint-sparsity (MMV) OMP: the ``spx.pursuit.joint`` analog.

    Atoms are scored by the l2 norm of the correlation row across all
    measurement vectors; the LS refit is joint over columns.
    A: (M, n), V: (M, T) → x: (n, T).
    """
    M, n = A.shape
    T = V.shape[1]
    AhA = A.conj().T @ A
    AhV = A.conj().T @ V  # (n, T)

    if m >= n:
        # The spx saturation regime (`plot_errorVSsnr.m:116-121` passes
        # numOfnz >= Gr): every atom enters the support, so the greedy loop
        # reduces to one full LS refit in a permuted order — solve it
        # directly (same X up to the scatter permutation).
        coef = _masked_ls(AhA, AhV, jnp.ones((n,), bool))
        # keep the documented (m,) support shape (clip-padded like the
        # greedy loop's saturated tail) for shape-stable consumers
        support = jnp.minimum(jnp.arange(m, dtype=jnp.int32), n - 1)
        return OmpResult(x=coef, support=support)

    def body(t, carry):
        idx, coef = carry
        corr = AhV - AhA[:, idx] @ coef  # (n, T)
        slot_valid = jnp.arange(m) < t
        sel_mask = jnp.zeros((n,), bool).at[jnp.where(slot_valid, idx, n)].set(
            True, mode="drop"
        )
        score = jnp.where(sel_mask, -jnp.inf, jnp.sum(jnp.abs(corr) ** 2, axis=1))
        new = jnp.argmax(score).astype(jnp.int32)
        idx = idx.at[t].set(new)
        active = jnp.arange(m) <= t
        Gsel = AhA[idx[:, None], idx[None, :]]
        coef = _masked_ls(Gsel, AhV[idx], active)
        return idx, coef

    idx0 = jnp.zeros((m,), jnp.int32)
    coef0 = jnp.zeros((m, T), A.dtype)
    idx, coef = jax.lax.fori_loop(0, m, body, (idx0, coef0))
    X = jnp.zeros((n, T), A.dtype).at[idx].add(coef)
    return OmpResult(x=X, support=idx)


@functools.partial(jax.jit, static_argnames=("m", "n_iter"))
def cosamp(A: jnp.ndarray, v: jnp.ndarray, m: int, n_iter: int = 10) -> jnp.ndarray:
    """CoSaMP with target sparsity m (capability parity with the toolbox's
    ``neural/connectivity/cosamp.m``; static-shape top-k throughout).
    """
    M, n = A.shape
    AhA = A.conj().T @ A
    Ahv = A.conj().T @ v

    def body(_, x):
        corr = Ahv - AhA @ x
        # candidate set: current support ∪ top-2m proxies → solve on top-3m mask
        proxy = jnp.abs(corr)
        cand = jnp.argsort(-(proxy + (jnp.abs(x) > 0) * (proxy.max() + 1.0)))[
            : 3 * m
        ]
        active = jnp.ones((3 * m,), bool)
        Gsel = AhA[cand[:, None], cand[None, :]]
        coef = _masked_ls(Gsel, Ahv[cand], active)
        full = jnp.zeros((n,), A.dtype).at[cand].add(coef)
        # prune to m largest
        keep = jnp.argsort(-jnp.abs(full))[:m]
        return jnp.zeros((n,), A.dtype).at[keep].set(full[keep])

    return jax.lax.fori_loop(0, n_iter, body, jnp.zeros((n,), A.dtype))
