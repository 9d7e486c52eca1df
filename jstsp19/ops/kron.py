"""Implicit Kronecker dictionary operator.

The reference materializes ``K2 = kron(B.', A)`` as an (N·M)×(Gr·K) dense
matrix (``proposed_algorithm.m:22``) — 4480×512 at the canonical config and
quadratically worse at large arrays.  This operator never materializes it:
by the vec identity ``kron(B.', A)·vec(S) = vec(A·S·B)``, the forward map,
its adjoint and both Grams are small dense matmuls:

    mv:    S (Gr, K)  ->  A S B                 (N, M)
    rmv:   Y (N, M)   ->  Aᴴ Y Bᴴ               (Gr, K)
    gram:  S          ->  (AᴴA) S (B Bᴴ)        (Gr, K)   [= K2ᴴK2 vec-form]
    gram_out: Y       ->  (A Aᴴ) Y (Bᴴ B)       (N, M)    [= K2 K2ᴴ vec-form]

The output-Gram eigenbasis also factorizes (kron of Hermitian eigenbases):
with ``A Aᴴ = Ua·diag(da)·Uaᴴ`` and ``Bᴴ B = Ub·diag(db)·Ubᴴ``,
``K2 K2ᴴ`` acts elementwise as ``outer(da, db)`` in the coordinates
``Ỹ = Uaᴴ Y Ub`` — which is exactly what the VAMP LMMSE stage needs
(``VampGlmEst.m:400-411``) without any 512×512 eigendecomposition.

Matrix-domain convention: solver state lives in matrix form throughout; no
vec()/reshape round-trips, no MATLAB column-major ordering to track.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from jstsp19.ops.base import LinOp


@dataclasses.dataclass(frozen=True)
class KronDictOp(LinOp):
    """``S ↦ A·S·B`` with A: (N, Gr), B: (K, M)."""

    A: jnp.ndarray
    B: jnp.ndarray

    @property
    def in_shape(self) -> Tuple[int, int]:
        return (self.A.shape[-1], self.B.shape[-2])

    @property
    def out_shape(self) -> Tuple[int, int]:
        return (self.A.shape[-2], self.B.shape[-1])

    def mv(self, S):
        return self.A @ S @ self.B

    def rmv(self, Y):
        return self.A.conj().T @ Y @ self.B.conj().T

    def sq_mv(self, S):
        return (jnp.abs(self.A) ** 2) @ S @ (jnp.abs(self.B) ** 2)

    def sq_rmv(self, Y):
        return (jnp.abs(self.A) ** 2).T @ Y @ (jnp.abs(self.B) ** 2).T

    # -- Gram maps (never materialize kron) --------------------------------
    def gram(self, S):
        """``K2ᴴK2`` in matrix form: (AᴴA)·S·(B·Bᴴ)."""
        return (self.A.conj().T @ self.A) @ S @ (self.B @ self.B.conj().T)

    def gram_out(self, Y):
        """``K2·K2ᴴ`` in matrix form: (A·Aᴴ)·Y·(Bᴴ·B)."""
        return (self.A @ self.A.conj().T) @ Y @ (self.B.conj().T @ self.B)

    # -- factorized eigenbasis of the output Gram --------------------------
    def gram_out_eig(self):
        """Eigen-factorization of ``K2·K2ᴴ``.

        Returns (Ua, Ub, d) with d = outer(da, db) of shape (N, M); the
        basis maps are :meth:`to_eigbasis` / :meth:`from_eigbasis`.
        """
        da, Ua = jnp.linalg.eigh(self.A @ self.A.conj().T)
        db, Ub = jnp.linalg.eigh(self.B.conj().T @ self.B)
        d = jnp.maximum(da[:, None], 0.0) * jnp.maximum(db[None, :], 0.0)
        return Ua, Ub, d

    def gram_in_eig(self):
        """Eigen-factorization of ``K2ᴴ·K2`` (input-domain Gram).

        Returns (Va, Vb, d) with d = outer(da, db) of shape (Gr, K):
        ``gram(S) = Va·(d ∘ (VaᴴS Vb))·Vbᴴ``.
        """
        da, Va = jnp.linalg.eigh(self.A.conj().T @ self.A)
        db, Vb = jnp.linalg.eigh(self.B @ self.B.conj().T)
        d = jnp.maximum(da[:, None], 0.0) * jnp.maximum(db[None, :], 0.0)
        return Va, Vb, d

    @staticmethod
    def to_eigbasis(Ua, Ub, Y):
        return Ua.conj().T @ Y @ Ub

    @staticmethod
    def from_eigbasis(Ua, Ub, Yt):
        return Ua @ Yt @ Ub.conj().T

    # -- exact pseudo-inverse (kron-pinv factorizes) -----------------------
    def pinv_rmv(self, Y, rcond=None):
        """``K2⁺·vec(Y)`` in matrix form: ``pinv(A)·Y·pinv(B)``.

        Exact because ``pinv(kron(P, Q)) = kron(pinv(P), pinv(Q))`` — this
        replaces the reference's rectangular-LU "solve"
        (``proposed_algorithm.m:29,53``) with the true least-squares
        solution at a fraction of the cost.
        """
        return jnp.linalg.pinv(self.A, rcond=rcond) @ Y @ jnp.linalg.pinv(
            self.B, rcond=rcond
        )

    def materialize(self) -> jnp.ndarray:
        """Dense ``kron(B.', A)`` — tests only; never call on the hot path."""
        return jnp.kron(self.B.T, self.A)


jax.tree_util.register_dataclass(KronDictOp, data_fields=["A", "B"], meta_fields=[])
