"""The proposed joint low-rank + beamspace-sparse ADMM estimator.

Accelerator re-design of ``basic_system_functions/proposed_algorithm.m`` and
``proposed_algorithm_angles.m`` ("Algorithms 1–3" of the paper):

- the (N·M)² mask normal matrix K1 (``proposed_algorithm.m:14-20``) is
  diagonal ⇒ the X-update is an elementwise division by ``Ω + 2ρ``;
- the dictionary kron ``K2 = kron(B.', A)`` (``:22``) is never materialized:
  all products go through the vec identity (``K2·s ≡ vec(A·S·B)``,
  ``K2ᴴ·k ≡ vec(Aᴴ·K·Bᴴ)``, Gram ≡ ``(AᴴA)·S·(B·Bᴴ)``) — small dense
  matmuls that batch over Monte-Carlo realizations;
- the ``'std'`` branch's rectangular LU (``:29,53``) is replaced by the
  *exact* least-squares solve via factorized pseudo-inverses
  (``kron-pinv = kron of pinvs``): ``v = pinv(A)·K·pinv(B)``;
- solver state stays in matrix form; iterations run under ``lax.scan`` with
  static shapes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from jstsp19.solvers.lowrank import svt
from jstsp19.solvers.sparse import soft_threshold


class AdmmState(NamedTuple):
    """Full ADMM iterate — returned for warm restarts (the reference's GAMP
    ``state`` in/out pattern, ``BiGAMP.m:1-2,25-26`` / ``test/warmStart``)."""

    X: jnp.ndarray
    V1: jnp.ndarray
    V2: jnp.ndarray
    C: jnp.ndarray
    Y: jnp.ndarray
    S: jnp.ndarray  # thresholded sparse code (used in the X-update)
    v: jnp.ndarray  # pre-threshold code (steepest-descent iterate)
    # tracked-SVT carry (svt_method='tracked' only): the warm eigenbasis
    # and the global iteration count (rotation-schedule phase), so a
    # chunked resume is BIT-exact instead of restarting the basis at eye
    U: Optional[jnp.ndarray] = None
    it: Optional[jnp.ndarray] = None


class AdmmResult(NamedTuple):
    S: jnp.ndarray  # (Gr, K) beamspace estimate (post soft-threshold)
    Y: jnp.ndarray  # (N, M) completed low-rank observation estimate
    convergence: Optional[jnp.ndarray]  # (Imax, 3) residual log, or None
    state: Optional["AdmmState"] = None  # full final iterate (warm restart)


def _sq_spectral(X):
    n, m = X.shape[-2], X.shape[-1]
    G = X @ X.conj().T if n <= m else X.conj().T @ X
    return jnp.maximum(jnp.linalg.eigvalsh(G)[..., -1], 0.0)


def admm_hyperparams(Y_obs: jnp.ndarray, Zbar_ref: jnp.ndarray, top_k: int = 6):
    """Driver hyper-parameter recipe (``plot_errorVSsnr.m:127-130``).

    τ_Y = 1/‖Y‖²_F;  τ_S = 1/(2‖Z̄‖²_F)  (reference uses the ground-truth
    beamspace energy here);  ρ = sqrt(min(top-6 eig(YᴴY))·τ_Y) — MATLAB's
    ``eigs`` default returns the 6 *largest* eigenvalues, so "min" is the
    6th-largest, reproduced via full ``eigh`` of the small Gram.
    """
    tau_Y = 1.0 / jnp.sum(jnp.abs(Y_obs) ** 2)
    tau_S = 1.0 / (2.0 * jnp.sum(jnp.abs(Zbar_ref) ** 2))
    # a thin Gram has only min(N, M) eigenvalues; MATLAB eigs would reduce
    # k itself, while jit indexing would silently clamp ev[-top_k] to
    # ev[0] (the SMALLEST) — clamp explicitly instead
    top_k = min(top_k, min(Y_obs.shape))
    # Thin-side Gram: nonzero eigenvalues of YᴴY and YYᴴ coincide, and the
    # top-6 live in the rank ≤ min(N,M) part — an N×N eigh instead of M×M
    # (N=32 vs M=140 at the canonical config; also a far smaller XLA program).
    n, m = Y_obs.shape
    G = Y_obs @ Y_obs.conj().T if n <= m else Y_obs.conj().T @ Y_obs
    ev = jnp.linalg.eigvalsh(G)  # ascending
    min_top = ev[-top_k]
    rho = jnp.sqrt(jnp.maximum(min_top, 0.0) * tau_Y)
    return tau_Y, tau_S, rho


@functools.partial(
    jax.jit,
    static_argnames=(
        "Imax", "mode", "track_convergence", "conv_norm", "svt_method",
        "track_rounds", "track_precision",
    ),
)
def proposed_admm(
    subY: jnp.ndarray,
    Omega: jnp.ndarray,
    A: jnp.ndarray,
    B: jnp.ndarray,
    Imax: int,
    tau_Y,
    tau_S,
    rho,
    mode: str = "approximate",
    support_rank: Optional[jnp.ndarray] = None,
    support_base: int = 10,
    support_step: int = 5,
    track_convergence: bool = False,
    conv_norm: str = "spectral",
    init_state: Optional[AdmmState] = None,
    svt_method: str = "eigh",
    # one warm-started parallel-ordering round/iter is NMSE-identical to
    # eigh at the canonical config (tests/test_admm.py)
    track_rounds: int = 1,
    # matmul precision of the tracked chain's two matmuls (P = UᴴW and the
    # reconstruction): "highest" (full float32), "high" or "default" (the
    # backend's fastest float32 product; the harness default,
    # PointConfig.track_precision).  The rotations themselves are exact
    # elementwise ops, so no precision setting can corrupt the carried
    # basis U.
    track_precision: str = "highest",
) -> AdmmResult:
    """Joint matrix-completion + beamspace-sparse ADMM.

    Args:
      subY: (N, M) masked observation ``Ω ∘ (W_eᴴ R)``.
      Omega: (N, M) binary sampling mask.
      A: (N, Gr) receive-side dictionary ``W_eᴴ Dr``.
      B: (K, M) transmit/training dictionary (K = L·Gt blocks of
         ``Dtᴴ Psi_l``).
      mode: 'approximate' — one steepest-descent step on the normal
         equations per iteration (``proposed_algorithm.m:43-54``);
         'exact' — true least-squares solve via factorized pinv
         (replacing the reference's rectangular-LU branch).
      support_rank: optional (Gr, K) integer array giving each entry's rank
         in the oracle support order — enables the "Algorithm 3" angle-
         information schedule keeping ``min(base + step·(i+1), Gr·K)``
         strongest entries at iteration i
         (``proposed_algorithm_angles.m:36-43,68``).
      track_convergence: log (ε1, ε2, ε3) per iteration
         (``proposed_algorithm.m:67-69``); ε-norm selectable ('spectral'
         matches MATLAB ``norm``, 'fro' is cheaper).
      init_state: optional :class:`AdmmState` to warm-start from (resume /
         continuation across Imax chunks).
      svt_method: 'eigh' (XLA eigensolver), 'jacobi' (batched
         parallel-ordering Jacobi, ops/jacobi.py — eigh-free inner loop
         that compiles to pure matmul scans; ~1e-3-accurate shrinkage),
         or 'tracked' (eigh-free warm-started spectral tracking: the
         Gram eigenbasis is carried across ADMM iterations and refreshed
         with ``track_rounds`` Jacobi rotation rounds per iteration — the
         SVT inputs X − V1/ρ drift slowly once the ADMM settles, so a
         partial sweep per step keeps the basis converged at a fraction
         of eigh's cost; N > M inputs run on the transpose
         (SVT(Xᵀ)ᵀ ≡ SVT(X), ops/tracked.py), so the only shape
         requirement is an even thin dimension).

    Returns :class:`AdmmResult` (with the full final state for restarts).
    """
    N, M = subY.shape
    Gr = A.shape[1]
    K = B.shape[0]
    cdt = subY.dtype

    denom = (Omega + 2.0 * rho).astype(subY.real.dtype)

    if mode == "approximate":
        AhA = A.conj().T @ A  # (Gr, Gr)
        BBh = B @ B.conj().T  # (K, K)
        pinvA = pinvB = None
    elif mode == "exact":
        AhA = BBh = None
        pinvA = jnp.linalg.pinv(A)
        pinvB = jnp.linalg.pinv(B)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    total = Gr * K
    if support_rank is not None:
        support_rank = support_rank.reshape(Gr, K)

    def sqn(X):
        if conv_norm == "fro":
            return jnp.sum(jnp.abs(X) ** 2)
        return _sq_spectral(X)

    zeros_nm = jnp.zeros((N, M), cdt)

    State = AdmmState
    if init_state is not None:
        init = init_state
    else:
        init = State(
            X=zeros_nm,
            V1=zeros_nm,
            V2=zeros_nm,
            C=zeros_nm,
            Y=zeros_nm,
            S=jnp.zeros((Gr, K), cdt),
            v=jnp.zeros((Gr, K), cdt),
        )
    # global iteration offset: keeps the tracked rotation-schedule phase
    # (and the angles support schedule) continuous across chunked resumes
    it0 = jnp.asarray(
        init.it if init.it is not None else 0, jnp.int32
    )

    tracked = svt_method == "tracked"
    if tracked:
        # Shared warm-started eigh-free SVT machinery (ops/tracked.py):
        # elementwise Givens rotations + T-free P-form chain, thin-side
        # transpose for N > M.
        from jstsp19.ops.tracked import make_tracked_svt

        U0, _tracked_step = make_tracked_svt(
            N, M, cdt, track_rounds, track_precision
        )
        if init.U is not None:
            U0 = init.U  # resume the warm basis, not identity
    else:
        U0 = jnp.eye(N, dtype=cdt)  # unused carry placeholder
    init = init._replace(U=None, it=None)  # scan carries U separately
    if svt_method == "jacobi":
        # solver-shared sweep count (ops/jacobi.py) — same settings as the
        # mc_svt/mc_admm completion baselines
        from jstsp19.ops.jacobi import jacobi_svt_fn as svt_fn
    elif svt_method in ("eigh", "tracked"):
        svt_fn = svt
    else:
        raise ValueError(f"unknown svt_method {svt_method!r}")

    def body(carry, i):
        st, U = carry
        i = it0 + i  # global iteration (chunk-resume continuity)
        # -- sub 1: nuclear-norm prox ------------------------------------
        if tracked:
            Y, U = _tracked_step(st.X - st.V1 / rho, tau_Y / rho, U, i)
        else:
            Y = svt_fn(st.X - st.V1 / rho, tau_Y / rho)

        # -- sub 2: masked LS (diagonal solve) ---------------------------
        # A·S·B is recomputed rather than carried through the scan state:
        # two small matmuls against an extra (N, M) complex carry
        b = st.V1 + rho * Y + subY + st.V2 + rho * st.C + rho * (A @ st.S @ B)
        X = b / denom

        # -- sub 3: sparse code ------------------------------------------
        Kmat = X - st.V2 / rho - st.C
        if mode == "approximate":
            # one steepest-descent step on K2ᴴK2·v = K2ᴴk
            res = A.conj().T @ Kmat @ B.conj().T - AhA @ st.v @ BBh
            Rres = AhA @ res @ BBh
            num = jnp.sum(jnp.abs(res) ** 2)
            den = jnp.real(jnp.vdot(res, Rres))
            alpha = num / jnp.where(den > 0, den, 1.0)
            alpha = jnp.where(den > 0, alpha, 0.0)
            v = st.v + alpha.astype(subY.real.dtype) * res
            conv3 = jnp.sum(jnp.abs(v - st.v) ** 2) / jnp.maximum(
                jnp.sum(jnp.abs(st.v) ** 2), jnp.finfo(subY.real.dtype).tiny
            )
        else:
            v = pinvA @ Kmat @ pinvB
            conv3 = jnp.zeros((), subY.real.dtype)

        S = soft_threshold(v, tau_S / rho)
        if support_rank is not None:
            nnz_i = jnp.minimum(support_base + support_step * (i + 1), total)
            S = jnp.where(support_rank < nnz_i, S, 0.0)
        Xs = A @ S @ B

        # -- sub 4 + duals -----------------------------------------------
        C = rho / (rho + 1.0) * (X - Xs - st.V2 / rho)
        V1 = st.V1 + rho * (Y - X)
        V2 = st.V2 + rho * (C - X + Xs)

        if track_convergence:
            nx = jnp.maximum(sqn(X), jnp.finfo(subY.real.dtype).tiny)
            conv = jnp.stack([sqn(V1) / nx, sqn(V2) / nx, conv3])
        else:
            conv = jnp.zeros((0,), subY.real.dtype)
        return (State(X, V1, V2, C, Y, S, v), U), conv

    (final, Ufin), conv = jax.lax.scan(body, (init, U0), jnp.arange(Imax))
    final = final._replace(U=Ufin if tracked else None, it=it0 + Imax)
    return AdmmResult(
        S=final.S,
        Y=final.Y,
        convergence=conv if track_convergence else None,
        state=final,
    )


def support_rank_from_order(indx_S: jnp.ndarray, total: int) -> jnp.ndarray:
    """Rank (0 = strongest) of each flat S entry given the descending
    oracle order ``indx_S`` (``sort(abs(vec(Zbar)),'descend')``,
    ``plot_errorVSsnr.m:143``) — the Algorithm-3 support schedule of
    :func:`proposed_admm_angles`."""
    return jnp.zeros((total,), jnp.int32).at[indx_S].set(
        jnp.arange(total, dtype=jnp.int32)
    )


def proposed_admm_angles(
    subY, Omega, indx_S, A, B, Imax, tau_Y, tau_S, rho, mode="approximate", **kw
) -> AdmmResult:
    """"Algorithm 3": proposed ADMM with oracle angle (support) information.

    ``indx_S``: flat entry indices of S = (Gr, K) sorted by decreasing
    oracle magnitude (``sort(abs(vec(Zbar)),'descend')`` in
    ``plot_errorVSsnr.m:143``); the kept-support schedule grows as
    ``min(10+5·i, Gr·K)`` (``proposed_algorithm_angles.m:36``).
    """
    total = A.shape[1] * B.shape[0]
    rank = support_rank_from_order(indx_S, total)
    return proposed_admm(
        subY, Omega, A, B, Imax, tau_Y, tau_S, rho, mode=mode,
        support_rank=rank, **kw,
    )
