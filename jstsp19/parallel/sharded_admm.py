"""Multi-chip proposed-ADMM training step under ``shard_map``.

Sharding layout over the (dp, sp, tp) mesh (SURVEY.md §2.6, §5):

  dp — Monte-Carlo realization batch (embarrassingly parallel)
  sp — the training-frame axis T of the observation/state matrices
       (sequence-parallel analog): SVT's Gram ``X·Xᴴ`` and the dictionary
       correlation ``K·Bᴴ`` become local partial products + ``psum`` over sp
  tp — the beamspace grid axis Gr (tensor-parallel analog): the sparse code
       S/v lives row-sharded; ``A·S`` is a local slab product + ``psum``
       over tp, and ``Aᴴ·(·)`` lands back on the local rows with no
       collective

Per ADMM iteration the only cross-chip traffic is:
  psum_sp of an (N, N) Gram and an (N, K) correlation, and
  psum_tp of two (N, K) products and two scalars —
all tiny and ICI-friendly; every state matrix stays sharded in HBM.

This is the one-step "training step" the driver's ``dryrun_multichip``
compiles over an N-virtual-device mesh.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from jstsp19.solvers.sparse import soft_threshold


def _psum(x, axis):
    return jax.lax.psum(x, axis_name=axis)


def sharded_admm_step(
    mesh: Mesh,
    Imax: int = 5,
):
    """Build the pjit-ed multi-chip ADMM estimation step.

    Returns a compiled function
      f(subY, Omega, A, B, tau_Y, tau_S, rho, Zbar) -> (S, nmse)
    with shardings:
      subY, Omega: (Bmc, N, T)  P('dp', None, 'sp')
      A:           (N, Gr)      P(None, 'tp')
      B:           (K, T)       P(None, 'sp')
      tau_Y, tau_S, rho: (Bmc,) P('dp')
      Zbar:        (Bmc, Gr, K) P('dp', 'tp', None)
      S out:       (Bmc, Gr, K) P('dp', 'tp', None)
      nmse out:    (Bmc,)       P('dp')
    """

    def kernel(subY, Omega, A, B, tau_Y, tau_S, rho, Zbar):
        # local blocks: subY (b, N, Tl), A (N, Grl), B (K, Tl), Zbar (b, Grl, K)
        BBh = _psum(B @ B.conj().T, "sp")  # (K, K) replicated

        def one(subY1, Omega1, tY, tS, rh, Z1):
            N, Tl = subY1.shape
            Grl = A.shape[1]
            K = B.shape[0]
            cdt = subY1.dtype
            denom = Omega1 + 2.0 * rh

            def AS(S_loc):  # (Grl,K) -> (N,K) replicated over tp
                return _psum(A @ S_loc, "tp")

            def AhM(M):  # (N,K) -> (Grl,K) local rows of Aᴴ·M
                return A.conj().T @ M

            def svt_sp(Xl, tau):
                # SVT over the sp-sharded frame axis: Gram via psum_sp.
                G = _psum(Xl @ Xl.conj().T, "sp")  # (N, N)
                sig2, U = jnp.linalg.eigh(G)
                sig = jnp.sqrt(jnp.maximum(sig2, 0.0))
                f = jnp.where(
                    sig > 0,
                    jnp.maximum(sig - tau, 0.0) / jnp.where(sig > 0, sig, 1.0),
                    0.0,
                )
                return (U * f[None, :]) @ (U.conj().T @ Xl)

            zeros = jnp.zeros((N, Tl), cdt)
            state = dict(
                X=zeros, V1=zeros, V2=zeros, C=zeros,
                S=jnp.zeros((Grl, K), cdt), v=jnp.zeros((Grl, K), cdt),
            )

            def body(st, _):
                Y = svt_sp(st["X"] - st["V1"] / rh, tY / rh)
                ASB = AS(st["S"]) @ B  # (N, Tl)
                X = (st["V1"] + rh * Y + subY1 + st["V2"] + rh * st["C"] + rh * ASB) / denom
                Kmat = X - st["V2"] / rh - st["C"]
                M1 = _psum(Kmat @ B.conj().T, "sp")  # (N, K)
                res = AhM(M1) - AhM(AS(st["v"])) @ BBh  # (Grl, K)
                Rres = AhM(AS(res)) @ BBh
                num = _psum(jnp.sum(jnp.abs(res) ** 2), "tp")
                den = _psum(jnp.real(jnp.vdot(res, Rres)), "tp")
                alpha = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)
                v = st["v"] + alpha * res
                S = soft_threshold(v, tS / rh)
                Xs = AS(S) @ B
                C = rh / (rh + 1.0) * (X - Xs - st["V2"] / rh)
                V1 = st["V1"] + rh * (Y - X)
                V2 = st["V2"] + rh * (C - X + Xs)
                return dict(X=X, V1=V1, V2=V2, C=C, S=S, v=v), None

            st, _ = jax.lax.scan(body, state, None, length=Imax)
            err_num = _psum(jnp.sum(jnp.abs(st["S"] - Z1) ** 2), "tp")
            err_den = _psum(jnp.sum(jnp.abs(Z1) ** 2), "tp")
            return st["S"], err_num / err_den

        return jax.vmap(one)(subY, Omega, tau_Y, tau_S, rho, Zbar)

    sharded = shard_map(
        kernel,
        mesh=mesh,
        in_specs=(
            P("dp", None, "sp"),  # subY
            P("dp", None, "sp"),  # Omega
            P(None, "tp"),  # A
            P(None, "sp"),  # B
            P("dp"),  # tau_Y
            P("dp"),  # tau_S
            P("dp"),  # rho
            P("dp", "tp", None),  # Zbar
        ),
        out_specs=(P("dp", "tp", None), P("dp")),
        check_vma=False,
    )
    return jax.jit(sharded)


def reference_admm_batch(subY, Omega, A, B, Imax, tau_Y, tau_S, rho):
    """Unsharded single-device reference for correctness checks: the same
    math as :func:`jstsp19.solvers.admm.proposed_admm` vmapped, with
    per-sample hyperparameters."""
    from jstsp19.solvers.admm import proposed_admm

    def one(y, om, ty, ts, rh):
        return proposed_admm(y, om, A, B, Imax, ty, ts, rh).S

    return jax.vmap(one)(subY, Omega, tau_Y, tau_S, rho)
