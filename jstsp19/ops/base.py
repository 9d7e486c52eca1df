"""Linear-operator protocol: explicit adjoint pairs.

The JAX analog of the reference's ``LinTrans`` class tree
(``MPbased_solvers/main/LinTrans.m:1-39``): every operator implements a
forward map ``mv`` and its exact adjoint ``rmv`` (verified by the
⟨Ax, y⟩ = ⟨x, Aᴴy⟩ contract test, mirroring ``test/testlintrans.m:28-42``),
plus a squared-magnitude pair ``sq_mv``/``sq_rmv`` used by message-passing
solvers for variance propagation (``LinTrans.m`` multSq/multSqTr — here the
exact |A|² product, not the Frobenius rank-1 approximation, since the
operators involved are small or structured).

Operators are frozen dataclasses registered as pytrees so they pass through
``jit``/``vmap`` transparently; array fields are leaves, everything else is
static metadata.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


def _register(cls, data_fields: Tuple[str, ...], meta_fields: Tuple[str, ...] = ()):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


class LinOp:
    """Adjoint-pair protocol.  Shapes are operator-specific (vector or
    matrix domain); ``in_shape``/``out_shape`` describe one unbatched input."""

    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]

    def mv(self, x: jnp.ndarray) -> jnp.ndarray:  # forward
        raise NotImplementedError

    def rmv(self, y: jnp.ndarray) -> jnp.ndarray:  # adjoint
        raise NotImplementedError

    def sq_mv(self, x: jnp.ndarray) -> jnp.ndarray:
        """Forward map of |A|² on nonnegative inputs (variance propagation)."""
        raise NotImplementedError

    def sq_rmv(self, y: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    @property
    def H(self) -> "AdjointOp":
        return AdjointOp(self)


@dataclasses.dataclass(frozen=True)
class MatrixOp(LinOp):
    """Dense matrix operator on vectors (batched along leading dims)."""

    A: jnp.ndarray  # (m, n)

    @property
    def in_shape(self):
        return (self.A.shape[-1],)

    @property
    def out_shape(self):
        return (self.A.shape[-2],)

    def mv(self, x):
        return jnp.einsum("...mn,...n->...m", self.A, x)

    def rmv(self, y):
        return jnp.einsum("...mn,...m->...n", self.A.conj(), y)

    def sq_mv(self, x):
        return jnp.einsum("...mn,...n->...m", jnp.abs(self.A) ** 2, x)

    def sq_rmv(self, y):
        return jnp.einsum("...mn,...m->...n", jnp.abs(self.A) ** 2, y)

    # -- eigenbasis protocol (one-sided analog of KronDictOp's) ------------
    def gram_in_eig(self):
        """Eigen-factorization of AᴴA; (V, None, d) with the same
        ``to_eigbasis``/``from_eigbasis`` call shape as KronDictOp so the
        VAMP-SLM LMMSE stage works on dense matrices too."""
        d, V = jnp.linalg.eigh(self.A.conj().T @ self.A)
        return V, None, jnp.maximum(d, 0.0)

    @staticmethod
    def to_eigbasis(V, _unused, x):
        return V.conj().T @ x

    @staticmethod
    def from_eigbasis(V, _unused, xt):
        return V @ xt


_register(MatrixOp, ("A",))


@dataclasses.dataclass(frozen=True)
class AdjointOp(LinOp):
    """Lazy adjoint of another operator."""

    base: LinOp

    @property
    def in_shape(self):
        return self.base.out_shape

    @property
    def out_shape(self):
        return self.base.in_shape

    def mv(self, x):
        return self.base.rmv(x)

    def rmv(self, y):
        return self.base.mv(y)

    def sq_mv(self, x):
        return self.base.sq_rmv(x)

    def sq_rmv(self, y):
        return self.base.sq_mv(y)


_register(AdjointOp, ("base",))


@dataclasses.dataclass(frozen=True)
class ScaledOp(LinOp):
    """``alpha · A`` (alpha complex scalar)."""

    base: LinOp
    alpha: jnp.ndarray

    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return self.base.out_shape

    def mv(self, x):
        return self.alpha * self.base.mv(x)

    def rmv(self, y):
        return jnp.conj(self.alpha) * self.base.rmv(y)

    def sq_mv(self, x):
        return jnp.abs(self.alpha) ** 2 * self.base.sq_mv(x)

    def sq_rmv(self, y):
        return jnp.abs(self.alpha) ** 2 * self.base.sq_rmv(y)


_register(ScaledOp, ("base", "alpha"))


@dataclasses.dataclass(frozen=True)
class ComposedOp(LinOp):
    """``outer ∘ inner`` (apply inner first) — the ``LinTransCompose`` analog."""

    outer: LinOp
    inner: LinOp

    @property
    def in_shape(self):
        return self.inner.in_shape

    @property
    def out_shape(self):
        return self.outer.out_shape

    def mv(self, x):
        return self.outer.mv(self.inner.mv(x))

    def rmv(self, y):
        return self.inner.rmv(self.outer.rmv(y))

    def sq_mv(self, x):
        return self.outer.sq_mv(self.inner.sq_mv(x))

    def sq_rmv(self, y):
        return self.inner.sq_rmv(self.outer.sq_rmv(y))


_register(ComposedOp, ("outer", "inner"))


@dataclasses.dataclass(frozen=True)
class ConcatOp(LinOp):
    """Vertical stack [A1; A2] on a shared input (the ``LinTransConcat``
    analog): mv returns a tuple of outputs, rmv sums the adjoints."""

    ops: Tuple[LinOp, ...]

    @property
    def in_shape(self):
        return self.ops[0].in_shape

    @property
    def out_shape(self):
        return tuple(op.out_shape for op in self.ops)

    def mv(self, x):
        return tuple(op.mv(x) for op in self.ops)

    def rmv(self, ys):
        out = self.ops[0].rmv(ys[0])
        for op, y in zip(self.ops[1:], ys[1:]):
            out = out + op.rmv(y)
        return out

    def sq_mv(self, x):
        return tuple(op.sq_mv(x) for op in self.ops)

    def sq_rmv(self, ys):
        out = self.ops[0].sq_rmv(ys[0])
        for op, y in zip(self.ops[1:], ys[1:]):
            out = out + op.sq_rmv(y)
        return out


_register(ConcatOp, ("ops",))


@dataclasses.dataclass(frozen=True)
class BlockDiagOp(LinOp):
    """Block-diagonal operator over a leading block axis (the
    ``BlkdiagLinTrans`` analog): per-block matrices applied batched."""

    A: jnp.ndarray  # (nblocks, m, n)

    @property
    def in_shape(self):
        return (self.A.shape[0], self.A.shape[2])

    @property
    def out_shape(self):
        return (self.A.shape[0], self.A.shape[1])

    def mv(self, x):
        return jnp.einsum("bmn,bn->bm", self.A, x)

    def rmv(self, y):
        return jnp.einsum("bmn,bm->bn", self.A.conj(), y)

    def sq_mv(self, x):
        return jnp.einsum("bmn,bn->bm", jnp.abs(self.A) ** 2, x)

    def sq_rmv(self, y):
        return jnp.einsum("bmn,bm->bn", jnp.abs(self.A) ** 2, y)


_register(BlockDiagOp, ("A",))
