"""Fast-transform operators: DFT, Walsh–Hadamard, Toeplitz.

JAX analogs of the reference's ``FourierLinTrans`` / ``FWHTLinTrans``
(MEX ``fastWHtrans.cpp``) / ``ToeplitzLinTrans``.  The WHT is a pure-XLA
radix-2 butterfly network (log2 N fused vector stages — no MEX needed; a C++
reference implementation for host-side verification lives in ``native/``),
sequency-ordered with 1/sqrt(N) scaling to match ``fastWHtrans.cpp:97-140``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.ops.base import LinOp


def _fwht_natural(x: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized fast Walsh–Hadamard transform, natural (Hadamard) order,
    along the last axis.  Pure butterflies: log2(N) reshape+add stages."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("FWHT length must be a power of two")
    lead = x.shape[:-1]
    h = 1
    y = x
    while h < n:
        y = y.reshape(*lead, n // (2 * h), 2, h)
        a = y[..., 0, :]
        b = y[..., 1, :]
        y = jnp.stack([a + b, a - b], axis=-2).reshape(*lead, n)
        h *= 2
    return y


@functools.lru_cache(maxsize=None)
def _sequency_perm(n: int) -> np.ndarray:
    """Permutation taking natural-order WHT output to sequency order
    (rows sorted by sign-change count, per Beauchamp / ``fastWHtrans.cpp``).

    natural_index = bit_reverse(binary_to_gray(sequency_index)).
    """
    p = n.bit_length() - 1
    k = np.arange(n)
    gray = k ^ (k >> 1)
    rev = np.zeros_like(k)
    t = gray.copy()
    for _ in range(p):
        rev = (rev << 1) | (t & 1)
        t >>= 1
    return rev


def fwht(x: jnp.ndarray, ordering: str = "sequency") -> jnp.ndarray:
    """Orthonormal fast Walsh–Hadamard transform along the last axis.

    ``ordering``: 'sequency' (reference ``fastWHtrans.cpp`` semantics) or
    'natural' (Sylvester/Hadamard order).  Self-inverse in either order.
    """
    n = x.shape[-1]
    y = _fwht_natural(x)
    if ordering == "sequency":
        y = y[..., jnp.asarray(_sequency_perm(n))]
    elif ordering != "natural":
        raise ValueError(f"unknown ordering {ordering!r}")
    return y / jnp.sqrt(n * 1.0)


def ifwht(y: jnp.ndarray, ordering: str = "sequency") -> jnp.ndarray:
    """Inverse orthonormal WHT (== forward, up to the sequency permutation)."""
    n = y.shape[-1]
    if ordering == "sequency":
        inv = np.argsort(_sequency_perm(n))
        y = y[..., jnp.asarray(inv)]
    return _fwht_natural(y) / jnp.sqrt(n * 1.0)


@dataclasses.dataclass(frozen=True)
class FWHTOp(LinOp):
    """Orthonormal Walsh–Hadamard operator on length-n vectors."""

    n: int
    ordering: str = "sequency"

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return fwht(x, self.ordering)

    def rmv(self, y):
        return ifwht(y, self.ordering)  # real orthonormal ⇒ adjoint = inverse

    def sq_mv(self, x):
        # |W|² = 1/n · ones — uniform mixing.
        return jnp.mean(x, axis=-1, keepdims=True) * jnp.ones_like(x)

    sq_rmv = sq_mv


jax.tree_util.register_dataclass(FWHTOp, data_fields=[], meta_fields=["n", "ordering"])


@dataclasses.dataclass(frozen=True)
class DFTOp(LinOp):
    """Unitary DFT on length-n vectors (``FourierLinTrans`` analog)."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return jnp.fft.fft(x, axis=-1) / jnp.sqrt(self.n * 1.0)

    def rmv(self, y):
        return jnp.fft.ifft(y, axis=-1) * jnp.sqrt(self.n * 1.0)

    def sq_mv(self, x):
        return jnp.mean(x, axis=-1, keepdims=True) * jnp.ones_like(x)

    sq_rmv = sq_mv


jax.tree_util.register_dataclass(DFTOp, data_fields=[], meta_fields=["n"])


@dataclasses.dataclass(frozen=True)
class ToeplitzOp(LinOp):
    """Toeplitz operator realized as FFT circular convolution
    (``ToeplitzLinTrans`` analog).

    ``col`` (m,) is the first column, ``row`` (n,) the first row
    (row[0] must equal col[0]).  Embeds into a circulant of length
    ``m + n - 1`` padded to the next power of two-free FFT length.
    """

    col: jnp.ndarray
    row: jnp.ndarray

    @property
    def in_shape(self):
        return (self.row.shape[-1],)

    @property
    def out_shape(self):
        return (self.col.shape[-1],)

    def _kernel_fft(self, L):
        m = self.col.shape[-1]
        # circulant first column: [col, reversed(row[1:])] zero-padded
        ker = jnp.concatenate(
            [
                self.col,
                jnp.zeros((L - m - (self.row.shape[-1] - 1),), self.col.dtype),
                self.row[1:][::-1],
            ]
        )
        return jnp.fft.fft(ker)

    def mv(self, x):
        m, n = self.col.shape[-1], self.row.shape[-1]
        L = m + n - 1
        xf = jnp.fft.fft(x, n=L, axis=-1)
        y = jnp.fft.ifft(xf * self._kernel_fft(L), axis=-1)[..., :m]
        return y

    def rmv(self, y):
        # Adjoint Toeplitz: first column = conj(row), first row = conj(col).
        m, n = self.col.shape[-1], self.row.shape[-1]
        L = m + n - 1
        ker = jnp.concatenate(
            [
                jnp.conj(self.row),
                jnp.zeros((L - n - (m - 1),), self.col.dtype),
                jnp.conj(self.col[1:][::-1]),
            ]
        )
        yf = jnp.fft.fft(y, n=L, axis=-1)
        return jnp.fft.ifft(yf * jnp.fft.fft(ker), axis=-1)[..., :n]

    def sq_mv(self, x):
        from jstsp19.ops.base import MatrixOp

        return MatrixOp(self.materialize()).sq_mv(x)

    def sq_rmv(self, y):
        from jstsp19.ops.base import MatrixOp

        return MatrixOp(self.materialize()).sq_rmv(y)

    def materialize(self):
        m, n = self.col.shape[-1], self.row.shape[-1]
        i = jnp.arange(m)[:, None]
        j = jnp.arange(n)[None, :]
        d = i - j
        vals = jnp.concatenate([self.row[1:][::-1], self.col])  # index d + (n-1)
        return vals[d + n - 1]


jax.tree_util.register_dataclass(
    ToeplitzOp, data_fields=["col", "row"], meta_fields=[]
)


# -- DCT (``DCTLinTrans`` analog) -------------------------------------------
#
# The classic complex-FFT factorization (even/odd interleave + quarter-sample
# phase twist), valid for any N.

def _dct_consts(n: int):
    """Quarter-sample twist and orthonormal scale as numpy literals (n is
    static under jit)."""
    k = np.arange(n)
    twist = np.exp(-1j * np.pi * k / (2 * n)).astype(np.complex64)
    scale = np.where(k == 0, 1.0 / np.sqrt(n), np.sqrt(2.0 / n)).astype(np.float32)
    return twist, scale


def dct(x: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal DCT-II along the last axis (real input)."""
    n = x.shape[-1]
    twist, scale = _dct_consts(n)
    v = jnp.concatenate([x[..., ::2], jnp.flip(x[..., 1::2], -1)], axis=-1)
    V = jnp.fft.fft(v.astype(jnp.complex64), axis=-1)
    y = jnp.real(twist * V)
    return y * scale


def idct(y: jnp.ndarray) -> jnp.ndarray:
    """Orthonormal DCT-III (inverse of :func:`dct`) along the last axis."""
    n = y.shape[-1]
    twist, scale = _dct_consts(n)
    w = y / scale
    w_nk = jnp.concatenate([w[..., :1] * 0, jnp.flip(w[..., 1:], -1)], axis=-1)
    V = twist.conj() * (w - 1j * w_nk)
    v = jnp.real(jnp.fft.ifft(V, axis=-1))
    half = (n + 1) // 2
    x = jnp.zeros_like(v)
    x = x.at[..., ::2].set(v[..., :half])
    x = x.at[..., 1::2].set(jnp.flip(v[..., half:], -1))
    return x


@dataclasses.dataclass(frozen=True)
class DCTOp(LinOp):
    """Orthonormal DCT-II operator on length-n real vectors
    (``main/DCTLinTrans.m`` analog).  Real orthonormal, so the adjoint is
    the inverse transform."""

    n: int

    @property
    def in_shape(self):
        return (self.n,)

    @property
    def out_shape(self):
        return (self.n,)

    def mv(self, x):
        return dct(x)

    def rmv(self, y):
        return idct(y)

    def sq_mv(self, x):
        # |C_kn|² ≈ uniform 1/n (exact for row 0; 2·cos² averages to 1/n)
        return jnp.mean(x, axis=-1, keepdims=True) * jnp.ones_like(x)

    sq_rmv = sq_mv


jax.tree_util.register_dataclass(DCTOp, data_fields=[], meta_fields=["n"])
