"""Masked / diagonal operators.

``MaskOp`` is the random-spatial-sampling measurement mask Omega ∘ (·); its
normal matrix is diagonal (the reference builds it as an (N·M)² kron sum,
``proposed_algorithm.m:14-20`` — here it is the mask itself).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from jstsp19.ops.base import LinOp


@dataclasses.dataclass(frozen=True)
class MaskOp(LinOp):
    """Elementwise 0/1 (or real-weighted) mask on matrices."""

    Omega: jnp.ndarray  # real (N, M)

    @property
    def in_shape(self):
        return self.Omega.shape

    @property
    def out_shape(self):
        return self.Omega.shape

    def mv(self, X):
        return self.Omega * X

    def rmv(self, Y):
        return self.Omega * Y  # real mask ⇒ self-adjoint

    def sq_mv(self, X):
        return self.Omega**2 * X

    def sq_rmv(self, Y):
        return self.Omega**2 * Y


jax.tree_util.register_dataclass(MaskOp, data_fields=["Omega"], meta_fields=[])


@dataclasses.dataclass(frozen=True)
class DiagOp(LinOp):
    """Diagonal operator on vectors (the ``LinTransDiag`` analog)."""

    d: jnp.ndarray

    @property
    def in_shape(self):
        return self.d.shape

    @property
    def out_shape(self):
        return self.d.shape

    def mv(self, x):
        return self.d * x

    def rmv(self, y):
        return jnp.conj(self.d) * y

    def sq_mv(self, x):
        return jnp.abs(self.d) ** 2 * x

    def sq_rmv(self, y):
        return jnp.abs(self.d) ** 2 * y


jax.tree_util.register_dataclass(DiagOp, data_fields=["d"], meta_fields=[])
