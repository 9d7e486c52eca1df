"""Structured linear operators beyond the dense/Fourier families.

JAX analogs of the remaining ``LinTrans`` subclasses in the
reference toolbox (``MPbased_solvers/main/``):

  IdentityOp    — ``IdentityLinTrans.m``
  SubsetOp      — ``LinTransSubset.m`` (static row subsampling of a base op)
  CenterOp      — the mean-removal projector behind ``LinTransDemean.m`` /
                  ``LinTransDemeanRC.m`` (compose with any base op)
  TVOp          — ``LinTransTV.m`` (1-D first differences)
  HaarOp        — ``LinTransWavelet.m`` capability: orthonormal multi-level
                  Haar transform via lifting (no materialized matrix)
  random_unitary_op  — ``RandomUniTrans.m`` (Haar-random unitary)
  expander_graph_op  — ``ExpanderGraphLinTrans.m`` (sparse binary matrix)
  rbf_kernel_op      — ``KernelLinTrans.m`` (RBF Gram operator)

All follow the :class:`~jstsp19.ops.base.LinOp` adjoint-pair protocol
with exact ``sq_mv``/``sq_rmv`` variance maps (|A|² acting on nonnegative
inputs), so each drops into the GAMP/VAMP solvers directly.  Static
structure (sizes, index sets, level counts) lives in pytree meta fields so
every operator traces once under ``jit``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import LinOp, MatrixOp, _register


@dataclasses.dataclass(frozen=True)
class IdentityOp(LinOp):
    """Identity on length-``n`` vectors (``IdentityLinTrans.m``)."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return x

    def rmv(self, y):
        return y

    def sq_mv(self, x):
        return x

    def sq_rmv(self, y):
        return y


_register(IdentityOp, (), ("n",))


@dataclasses.dataclass(frozen=True)
class SubsetOp(LinOp):
    """Keep a static subset of the base operator's output rows
    (``LinTransSubset.m``): ``mv = (base·x)[idx]``; the adjoint scatters
    back into the kept rows and zero elsewhere.

    ``idx`` is a host-side numpy index tuple (static under jit) — the
    subset is part of the operator's structure, not traced data.
    """

    base: LinOp
    idx: Tuple[int, ...]

    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return (len(self.idx),)

    def _gather(self, y):
        return y[..., np.asarray(self.idx)]

    def _scatter(self, y):
        full = jnp.zeros(
            y.shape[:-1] + tuple(self.base.out_shape), dtype=y.dtype
        )
        # .add, not .set: the adjoint of a gather must ACCUMULATE when
        # idx repeats a row (LinTransSubset.m permits duplicates);
        # identical for unique idx
        return full.at[..., np.asarray(self.idx)].add(y)

    def mv(self, x):
        return self._gather(self.base.mv(x))

    def rmv(self, y):
        return self.base.rmv(self._scatter(y))

    def sq_mv(self, x):
        return self._gather(self.base.sq_mv(x))

    def sq_rmv(self, y):
        return self.base.sq_rmv(self._scatter(y))


_register(SubsetOp, ("base",), ("idx",))


@dataclasses.dataclass(frozen=True)
class CenterOp(LinOp):
    """Mean-removal projector ``P = I − 1·1ᵀ/n`` on length-``n`` vectors —
    the primitive behind ``LinTransDemean.m`` (compose as
    ``ComposedOp(CenterOp(m), base)`` to demean a base operator's output).

    Self-adjoint.  The exact variance map uses
    ``|P|²_{ij} = δ_ij·(1 − 2/n) + 1/n²``:
    ``sq_mv(x) = (1 − 2/n)·x + sum(x)/n²``.
    """

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return x - jnp.mean(x, axis=-1, keepdims=True)

    def rmv(self, y):
        return self.mv(y)

    def _sq(self, x):
        return (1.0 - 2.0 / self.n) * x + jnp.sum(
            x, axis=-1, keepdims=True
        ) / self.n**2

    def sq_mv(self, x):
        return self._sq(x)

    def sq_rmv(self, y):
        return self._sq(y)


_register(CenterOp, (), ("n",))


@dataclasses.dataclass(frozen=True)
class TVOp(LinOp):
    """1-D total-variation (first-difference) operator
    ``(Dx)_i = x_{i+1} − x_i`` ∈ R^{n−1} (``LinTransTV.m``)."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n - 1,)

    def mv(self, x):
        return x[..., 1:] - x[..., :-1]

    def rmv(self, y):
        # Dᵀy: (Dᵀy)_0 = −y_0, (Dᵀy)_i = y_{i−1} − y_i, (Dᵀy)_{n−1} = y_{n−2}
        zero = jnp.zeros_like(y[..., :1])
        pad_lo = jnp.concatenate([zero, y], axis=-1)
        pad_hi = jnp.concatenate([y, zero], axis=-1)
        return pad_lo - pad_hi

    def sq_mv(self, x):
        return x[..., 1:] + x[..., :-1]

    def sq_rmv(self, y):
        zero = jnp.zeros_like(y[..., :1])
        return jnp.concatenate([zero, y], axis=-1) + jnp.concatenate(
            [y, zero], axis=-1
        )


_register(TVOp, (), ("n",))


@dataclasses.dataclass(frozen=True)
class HaarOp(LinOp):
    """Orthonormal multi-level Haar wavelet transform on length-``n``
    vectors, n a power of two (the ``LinTransWavelet.m`` capability).

    Implemented by lifting — per level, approximation/detail pairs
    ``a = (e + o)/√2``, ``d = (e − o)/√2`` — so no n×n matrix is ever
    materialized and every step is a reshape + add (XLA-fusable).  The
    transform is orthonormal, so the adjoint is the inverse.  The exact
    variance maps run the same pyramid with the squared coefficients
    (each lifting butterfly becomes ``(e + o)/2`` for both outputs).

    Output layout: ``[approx(level L) | details(level L) | … | details(1)]``.
    """

    n: int
    levels: int

    def __post_init__(self):
        if self.n & (self.n - 1):
            raise ValueError("HaarOp requires power-of-two length")
        if not 1 <= self.levels <= int(np.log2(self.n)):
            raise ValueError("invalid level count")

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        inv_sqrt2 = 1.0 / np.sqrt(2.0)
        details = []
        a = x
        for _ in range(self.levels):
            e, o = a[..., 0::2], a[..., 1::2]
            details.append((e - o) * inv_sqrt2)
            a = (e + o) * inv_sqrt2
        return jnp.concatenate([a] + details[::-1], axis=-1)

    def rmv(self, y):
        inv_sqrt2 = 1.0 / np.sqrt(2.0)
        size = self.n >> self.levels
        a = y[..., :size]
        off = size
        for _ in range(self.levels):
            d = y[..., off : off + size]
            off += size
            e = (a + d) * inv_sqrt2
            o = (a - d) * inv_sqrt2
            a = jnp.stack([e, o], axis=-1).reshape(e.shape[:-1] + (2 * size,))
            size *= 2
        return a

    def sq_mv(self, x):
        details = []
        a = x
        for _ in range(self.levels):
            e, o = a[..., 0::2], a[..., 1::2]
            avg = (e + o) * 0.5
            details.append(avg)
            a = avg
        return jnp.concatenate([a] + details[::-1], axis=-1)

    def sq_rmv(self, y):
        size = self.n >> self.levels
        a = y[..., :size]
        off = size
        for _ in range(self.levels):
            d = y[..., off : off + size]
            off += size
            half = (a + d) * 0.5
            a = jnp.stack([half, half], axis=-1).reshape(
                half.shape[:-1] + (2 * size,)
            )
            size *= 2
        return a


_register(HaarOp, (), ("n", "levels"))


@dataclasses.dataclass(frozen=True)
class MedImageOp(LinOp):
    """Undersampled-k-space medical-imaging acquisition
    (``main/MedImageLinTrans.m``): ``z = M · F · Wᴴ · x`` where x are the
    2-D wavelet coefficients of an (ny, nx) image, Wᴴ is the multi-level
    2-D (Mallat/quadrant) Haar synthesis, F the orthonormal 2-D DFT, and M
    a static binary k-space subsampling mask.

    Differences from the reference, by design: the wavelet is the
    orthonormal Haar family (the reference defers to MATLAB's wavelet
    toolbox ``wfilters``); orthonormality makes the analysis operator the
    exact adjoint, so no filters are materialized.  The variance maps use
    the reference's uniform Frobenius approximation
    (``LinTrans.m`` default): every row of M·F·Wᴴ has unit norm, so
    ``|A|²·v ≈ sum(v)/N`` and ``|A|²ᵀ·v ≈ sum(v)/N``.

    ``mask_idx``: static flat indices (row-major over the (ny, nx) k-space
    plane) of the acquired samples.  Input/output are flattened vectors
    (LinTrans convention).
    """

    ny: int
    nx: int
    levels: int
    mask_idx: Tuple[int, ...]

    def __post_init__(self):
        if (self.ny & (self.ny - 1)) or (self.nx & (self.nx - 1)):
            raise ValueError("MedImageOp requires power-of-two image dims")
        max_lv = min(self.ny, self.nx).bit_length() - 1
        if not 1 <= self.levels <= max_lv:
            raise ValueError(
                f"levels must be in [1, {max_lv}] for a "
                f"{self.ny}x{self.nx} image, got {self.levels}"
            )

    @property
    def in_shape(self):
        return (self.ny * self.nx,)

    @property
    def out_shape(self):
        return (len(self.mask_idx),)

    # -- 2-D Mallat Haar (quadrant layout, orthonormal) --------------------
    def _synthesis(self, c):
        """Wavelet coefficients (…, ny, nx) → image."""
        inv_sqrt2 = 1.0 / np.sqrt(2.0)
        a = c
        for lev in reversed(range(self.levels)):
            h, w = self.ny >> lev, self.nx >> lev
            sub = a[..., :h, :w]
            hh, hw = h // 2, w // 2
            ll = sub[..., :hh, :hw]
            lh = sub[..., :hh, hw:w]
            hl = sub[..., hh:h, :hw]
            hd = sub[..., hh:h, hw:w]
            # inverse separable Haar: columns then rows
            top = jnp.stack(
                [(ll + lh) * inv_sqrt2, (ll - lh) * inv_sqrt2], axis=-1
            ).reshape(ll.shape[:-1] + (w,))
            bot = jnp.stack(
                [(hl + hd) * inv_sqrt2, (hl - hd) * inv_sqrt2], axis=-1
            ).reshape(hl.shape[:-1] + (w,))
            rec = jnp.stack([(top + bot) * inv_sqrt2,
                             (top - bot) * inv_sqrt2], axis=-2)
            rec = rec.reshape(rec.shape[:-3] + (h, w))
            a = a.at[..., :h, :w].set(rec)
        return a

    def _analysis(self, img):
        """Image → wavelet coefficients (the synthesis adjoint)."""
        inv_sqrt2 = 1.0 / np.sqrt(2.0)
        a = img
        for lev in range(self.levels):
            h, w = self.ny >> lev, self.nx >> lev
            sub = a[..., :h, :w]
            e_r, o_r = sub[..., 0::2, :], sub[..., 1::2, :]
            lo_r = (e_r + o_r) * inv_sqrt2
            hi_r = (e_r - o_r) * inv_sqrt2
            rows = jnp.concatenate([lo_r, hi_r], axis=-2)
            e_c, o_c = rows[..., :, 0::2], rows[..., :, 1::2]
            lo_c = (e_c + o_c) * inv_sqrt2
            hi_c = (e_c - o_c) * inv_sqrt2
            a = a.at[..., :h, :w].set(
                jnp.concatenate([lo_c, hi_c], axis=-1)
            )
        return a

    def mv(self, x):
        img = self._synthesis(
            x.reshape(x.shape[:-1] + (self.ny, self.nx)).astype(jnp.complex64)
        )
        k = jnp.fft.fft2(img, norm="ortho")
        return k.reshape(k.shape[:-2] + (-1,))[..., np.asarray(self.mask_idx)]

    def rmv(self, z):
        full = jnp.zeros(
            z.shape[:-1] + (self.ny * self.nx,), jnp.complex64
        ).at[..., np.asarray(self.mask_idx)].add(z)  # adjoint accumulates
        img = jnp.fft.ifft2(
            full.reshape(full.shape[:-1] + (self.ny, self.nx)), norm="ortho"
        )
        c = self._analysis(img)
        return c.reshape(c.shape[:-2] + (-1,))

    def sq_mv(self, v):
        s = jnp.sum(v, axis=-1, keepdims=True) / (self.ny * self.nx)
        return jnp.broadcast_to(s, v.shape[:-1] + (len(self.mask_idx),))

    def sq_rmv(self, v):
        s = jnp.sum(v, axis=-1, keepdims=True) / (self.ny * self.nx)
        return jnp.broadcast_to(s, v.shape[:-1] + (self.ny * self.nx,))


_register(MedImageOp, (), ("ny", "nx", "levels", "mask_idx"))


def random_unitary_op(key, n: int) -> MatrixOp:
    """Haar-random unitary as a dense operator (``RandomUniTrans.m``):
    QR of a complex Gaussian with the standard phase fix."""
    kr, ki = jax.random.split(key)
    G = jax.random.normal(kr, (n, n)) + 1j * jax.random.normal(ki, (n, n))
    Q, R = jnp.linalg.qr(G / np.sqrt(2.0))
    d = jnp.diagonal(R)
    return MatrixOp(Q * (d / jnp.abs(d)).conj())


def expander_graph_op(key, m: int, n: int, d: int) -> MatrixOp:
    """Sparse binary measurement matrix with ``d`` ones per column placed
    uniformly at random (``ExpanderGraphLinTrans.m``), scaled by 1/√d so
    columns have unit norm.  Dense storage — a small 0/1 matrix
    matmul instead of gather/scatter sparsity."""
    cols = jax.vmap(
        lambda k: jax.random.permutation(k, m)[:d]
    )(jax.random.split(key, n))
    A = jnp.zeros((m, n)).at[cols.T, jnp.arange(n)[None, :]].set(1.0)
    return MatrixOp(A / np.sqrt(d))


def rbf_kernel_op(X: jnp.ndarray, gamma: float = 1.0) -> MatrixOp:
    """RBF kernel Gram operator ``K_ij = exp(−gamma·‖x_i − x_j‖²)`` over the
    rows of X (``KernelLinTrans.m``)."""
    sq = jnp.sum(jnp.abs(X) ** 2, axis=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.real(X @ X.conj().T)
    return MatrixOp(jnp.exp(-gamma * jnp.maximum(d2, 0.0)))


# ---------------------------------------------------------------------------
# GAMP-core operator wrappers (round 2): mean removal, uniform variance,
# function-handle operators — `main/LinTransDemeanRC.m`, `main/UnifVarLinTrans.m`,
# `main/FxnhandleLinTrans.m`.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DemeanRCOp(LinOp):
    """Row+column mean-removal augmentation of a vector-domain operator.

    Given base A (m×n), builds the (m+2)×(n+2) operator of
    ``main/LinTransDemeanRC.m:1-40``:

        Ad = [A − gam·1ᵀ − 1·colᴴ     b12·gam    b13·1 ;
              b21·1ᵀ                  −b12·b21   0     ;
              b31·colᴴ                0          −b31·b13]

    with gam = A·1/n (row means), colᴴ = (1ᵀA/m − mu·1ᵀ) (column means after
    global-mean removal), so that for xd = [x; 1ᵀx/b12; colᴴx/b13],
    Ad·xd = [A·x; 0; 0].  The de-meaned core has exactly zero row/column
    means, which is what makes i.i.d.-style GAMP work on mean-heavy
    operators.  All four variance maps are exact expansions of |Ad|²
    (``LinTransDemeanRC.m:163-216``), not Frobenius approximations.

    Build with :func:`demean_rc` (precomputes gam/col/b-scalars).
    """

    base: LinOp
    gam: jnp.ndarray   # (m,) row means
    col: jnp.ndarray   # (n,) column means (conjugated convention of MATLAB col)
    b12: jnp.ndarray
    b21: jnp.ndarray
    b13: jnp.ndarray
    b31: jnp.ndarray

    @property
    def in_shape(self):
        return (self.base.in_shape[0] + 2,)

    @property
    def out_shape(self):
        return (self.base.out_shape[0] + 2,)

    def mv(self, xd):
        n = self.base.in_shape[0]
        x, xr, xc = xd[..., :n], xd[..., n], xd[..., n + 1]
        zr = self.b21 * (jnp.sum(x, -1) - self.b12 * xr)
        zc = self.b31 * (jnp.sum(self.col.conj() * x, -1) - self.b13 * xc)
        z = (
            self.base.mv(x)
            - self.gam * (zr / self.b21)[..., None]
            - (zc / self.b31)[..., None]
        )
        return jnp.concatenate([z, zr[..., None], zc[..., None]], axis=-1)

    def rmv(self, sd):
        m = self.base.out_shape[0]
        s, sr, sc = sd[..., :m], sd[..., m], sd[..., m + 1]
        xr = self.b12 * (jnp.sum(self.gam.conj() * s, -1) - self.b21 * sr)
        xc = self.b13 * (jnp.sum(s, -1) - self.b31 * sc)
        x = (
            self.base.rmv(s)
            - (xr / self.b12)[..., None]
            - self.col * (xc / self.b13)[..., None]
        )
        return jnp.concatenate([x, xr[..., None], xc[..., None]], axis=-1)

    def sq_mv(self, xd):
        n = self.base.in_shape[0]
        gam2 = jnp.abs(self.gam) ** 2
        col2 = jnp.abs(self.col) ** 2
        xv, xvr, xvc = xd[..., :n], xd[..., n], xd[..., n + 1]
        pvr = self.b21**2 * (jnp.sum(xv, -1) + self.b12**2 * xvr)
        pvc = self.b31**2 * (jnp.sum(col2 * xv, -1) + self.b13**2 * xvc)
        pv = (
            self.base.sq_mv(xv)
            - 2.0 * jnp.real(self.gam.conj() * self.base.mv(xv))
            - 2.0 * jnp.real(self.base.mv(self.col * xv))
            + 2.0 * jnp.real(self.gam * jnp.sum(self.col * xv, -1)[..., None])
            + (pvc / self.b31**2)[..., None]
            + gam2 * (pvr / self.b21**2)[..., None]
        )
        return jnp.concatenate(
            [jnp.maximum(jnp.real(pv), 0.0), pvr[..., None], pvc[..., None]],
            axis=-1,
        )

    def sq_rmv(self, sd):
        m = self.base.out_shape[0]
        gam2 = jnp.abs(self.gam) ** 2
        col2 = jnp.abs(self.col) ** 2
        sv, svr, svc = sd[..., :m], sd[..., m], sd[..., m + 1]
        rvr = self.b12**2 * (jnp.sum(gam2 * sv, -1) + self.b21**2 * svr)
        rvc = self.b13**2 * (jnp.sum(sv, -1) + self.b31**2 * svc)
        rv = (
            self.base.sq_rmv(sv)
            - 2.0 * jnp.real(self.col.conj() * self.base.rmv(sv))
            - 2.0 * jnp.real(self.base.rmv(self.gam * sv))
            + 2.0 * jnp.real(self.col * jnp.sum(self.gam * sv, -1)[..., None])
            + (rvr / self.b12**2)[..., None]
            + col2 * (rvc / self.b13**2)[..., None]
        )
        return jnp.concatenate(
            [jnp.maximum(jnp.real(rv), 0.0), rvr[..., None], rvc[..., None]],
            axis=-1,
        )

    # -- state expansion helpers (LinTransDemeanRC expandXhat/expandXvar) --
    def expand_xhat(self, x):
        xr = jnp.sum(x, -1, keepdims=True) / self.b12
        xc = jnp.sum(self.col.conj() * x, -1, keepdims=True) / self.b13
        return jnp.concatenate([x, xr, xc], axis=-1)

    def expand_xvar(self, xv):
        xvr = jnp.sum(xv, -1, keepdims=True) / self.b12**2
        xvc = jnp.sum(jnp.abs(self.col) ** 2 * xv, -1, keepdims=True) / self.b13**2
        return jnp.concatenate([xv, xvr, xvc], axis=-1)

    def expand_out(self, z, fill=0.0):
        pad = jnp.full(z.shape[:-1] + (2,), fill, z.dtype)
        return jnp.concatenate([z, pad], axis=-1)

    def contract(self, xd):
        return xd[..., : self.base.in_shape[0]]

    def contract_out(self, zd):
        return zd[..., : self.base.out_shape[0]]


_register(DemeanRCOp, ("base", "gam", "col", "b12", "b21", "b13", "b31"))


def demean_rc(base: LinOp) -> DemeanRCOp:
    """Build the row+column demeaned augmentation of a vector-domain op
    (``LinTransDemeanRC.m:80-98`` constructor math)."""
    (n,) = base.in_shape
    (m,) = base.out_shape
    ones_n = jnp.ones((n,), jnp.result_type(base.mv(jnp.zeros((n,)))))
    A1 = base.mv(ones_n)
    mu = jnp.sum(A1) / (m * n)
    col = base.rmv(jnp.ones((m,), A1.dtype)) / m - jnp.conj(mu) * ones_n
    gam = A1 / n
    gam2 = jnp.abs(gam) ** 2
    col2 = jnp.abs(col) ** 2
    fro2 = (
        jnp.sum(base.sq_mv(jnp.real(ones_n)))
        - 2.0
        * jnp.real(jnp.vdot(gam, A1) + jnp.sum(base.mv(col)))
        # cross term of the expansion is POSITIVE: +2Re<gam 1^T, 1 col^H>
        # = +2Re(sum(gam) sum(col)); it currently vanishes (sum(col) == 0
        # by construction) but the sign matters for any future col variant
        + 2.0 * jnp.real(jnp.sum(gam) * jnp.sum(col))
        + n * jnp.sum(gam2)
        + m * jnp.sum(col2)
    )
    fro2 = jnp.maximum(jnp.real(fro2), 1e-30)
    b12 = jnp.minimum(1.0, jnp.sqrt(fro2 / (n * jnp.maximum(jnp.sum(gam2), 1e-30))))
    b21 = jnp.sqrt(fro2 / (m * (n + b12**2)))
    b13 = jnp.sqrt(fro2 / (n * m))
    b31 = jnp.sqrt(fro2 / (m * (jnp.sum(col2) + b13**2)))
    return DemeanRCOp(base=base, gam=gam, col=col, b12=b12, b21=b21, b13=b13, b31=b31)


@dataclasses.dataclass(frozen=True)
class UnifVarOp(LinOp):
    """Uniform-variance wrapper (``main/UnifVarLinTrans.m``): the variance
    maps ``sq_mv``/``sq_rmv`` first replace the leading ``in_avg``/``out_avg``
    input entries by their mean, then replace the corresponding leading
    output entries by their mean — the ``GampOpt.uniformVariance`` mode.
    ``mv``/``rmv`` pass through unchanged.  Defaults average everything;
    the demeaned combination passes ``in_avg=n``/``out_avg=m`` to leave the
    two augmentation entries per side un-averaged
    (``gampEst.m:283-289``).
    """

    base: LinOp
    in_avg: int = -1   # -1 = all
    out_avg: int = -1

    @property
    def in_shape(self):
        return self.base.in_shape

    @property
    def out_shape(self):
        return self.base.out_shape

    def mv(self, x):
        return self.base.mv(x)

    def rmv(self, y):
        return self.base.rmv(y)

    def _avg(self, v, k):
        if k < 0 or k >= v.shape[-1]:
            return jnp.broadcast_to(jnp.mean(v, -1, keepdims=True), v.shape)
        head = jnp.mean(v[..., :k], -1, keepdims=True)
        return jnp.concatenate(
            [jnp.broadcast_to(head, v[..., :k].shape), v[..., k:]], axis=-1
        )

    def sq_mv(self, x):
        return self._avg(self.base.sq_mv(self._avg(x, self.in_avg)), self.out_avg)

    def sq_rmv(self, y):
        return self._avg(self.base.sq_rmv(self._avg(y, self.out_avg)), self.in_avg)


_register(UnifVarOp, ("base",), ("in_avg", "out_avg"))


@dataclasses.dataclass(frozen=True)
class FxnhandleOp(LinOp):
    """Operator from forward/adjoint callables (``main/FxnhandleLinTrans.m``)
    with the LinTrans base-class Frobenius rank-1 variance approximation
    (``main/LinTrans.m:30-39``): ``sq_mv(x) ≈ (‖A‖²_F/(m·n))·1·Σx``.

    Build with :func:`fxnhandle_op`, which estimates ‖A‖²_F by Gaussian
    probing when not supplied (the MATLAB class does the same).
    """

    mv_fn: object        # static callable
    rmv_fn: object
    shape_in: tuple
    shape_out: tuple
    fro2: jnp.ndarray

    @property
    def in_shape(self):
        return self.shape_in

    @property
    def out_shape(self):
        return self.shape_out

    def mv(self, x):
        return self.mv_fn(x)

    def rmv(self, y):
        return self.rmv_fn(y)

    def _numel(self, shape):
        k = 1
        for s in shape:
            k *= s
        return k

    def _sq(self, v, from_shape, to_shape):
        # Frobenius rank-1 variance approx, batched like every other op:
        # sum only over the operator's own trailing axes and broadcast
        # the scalar into (batch..., to_shape) — a global jnp.sum silently
        # collapsed leading batch dims (round 5)
        m, n = self._numel(self.shape_out), self._numel(self.shape_in)
        s = jnp.sum(v, axis=tuple(range(-len(from_shape), 0)))
        s = self.fro2 / (m * n) * s
        return jnp.broadcast_to(
            s[(...,) + (None,) * len(to_shape)],
            jnp.shape(s) + tuple(to_shape),
        )

    def sq_mv(self, x):
        return self._sq(x, self.shape_in, self.shape_out)

    def sq_rmv(self, y):
        return self._sq(y, self.shape_out, self.shape_in)


_register(FxnhandleOp, ("fro2",), ("mv_fn", "rmv_fn", "shape_in", "shape_out"))


def fxnhandle_op(mv_fn, rmv_fn, in_shape, out_shape, fro2=None, key=None,
                 n_probe: int = 8) -> FxnhandleOp:
    """Wrap callables as a LinOp; estimate ‖A‖²_F = E‖A·g‖² (g ~ CN(0,I))
    by probing when not given (``FxnhandleLinTrans.m`` / ``LinTrans.m``
    FrobNorm estimation)."""
    if fro2 is None:
        if key is None:
            key = jax.random.PRNGKey(0)
        kr, ki = jax.random.split(key)
        g = (
            jax.random.normal(kr, (n_probe,) + tuple(in_shape))
            + 1j * jax.random.normal(ki, (n_probe,) + tuple(in_shape))
        ) / np.sqrt(2.0)
        fro2 = jnp.mean(
            jax.vmap(lambda v: jnp.sum(jnp.abs(mv_fn(v)) ** 2))(g)
        )
    return FxnhandleOp(
        mv_fn=mv_fn, rmv_fn=rmv_fn, shape_in=tuple(in_shape),
        shape_out=tuple(out_shape), fro2=jnp.asarray(fro2),
    )


# ---------------------------------------------------------------------------
# main/ utility stragglers (round 5): genSparseMat + pcgHelper analogs.
# ---------------------------------------------------------------------------

def sparse_signed_op(key, nz: int, nx: int, d: int) -> MatrixOp:
    """Sparse signed measurement matrix of ``main/genSparseMat.m``: an
    ``nz × nx`` matrix with exactly ``d`` nonzeros per column at distinct
    uniform-random rows, each valued ``±√(nz/(d·nx))`` with a random sign
    (``genSparseMat.m:8-24`` — the reference's rejection loop over row
    indices becomes a per-column permutation prefix, its ``sign(rand-0.5)``
    a Rademacher draw).  Dense storage: a small ±pattern matmul instead
    of gather/scatter sparsity (same trade as
    :func:`expander_graph_op`)."""
    kp, ks = jax.random.split(key)
    rows = jax.vmap(lambda k: jax.random.permutation(k, nz)[:d])(
        jax.random.split(kp, nx)
    )
    signs = jax.random.rademacher(ks, (nx, d), jnp.float32)
    scale = np.sqrt(nz / (d * nx))
    A = jnp.zeros((nz, nx)).at[rows.T, jnp.arange(nx)[None, :]].set(
        signs.T * scale
    )
    return MatrixOp(A)


def genie_normal_matvec(A: LinOp, reg, support):
    """Matvec of ``(A_S·A_Sᴴ + reg·I)`` for an implicit operator and a
    support mask S (``main/pcgHelper.m:1-18``): the adjoint image is
    zeroed off-support before the forward map, so genie/oracle LMMSE
    systems can be solved matrix-free with conjugate gradients
    (reference usage: ``examples/sparseEstim/muGampExample.m:92-101``
    under MATLAB ``pcg``; here pair with
    ``jax.scipy.sparse.linalg.cg`` — the returned closure is jittable)."""

    def mv(x):
        r = A.rmv(x)
        r = jnp.where(support, r, jnp.zeros_like(r))
        return A.mv(r) + reg * x

    return mv
