"""Training-frame generation.

The reference sounds the channel with per-antenna Hermitian-Toeplitz frames:
antenna k transmits ``Psi_i(:,:,k) = toeplitz(s_k)`` of a random symbol
sequence, and delay tap l sees row l of that Toeplitz matrix
(``hbf.m:12-20``, ``plot_errorVSsnr.m:61-67``).  Only the first L rows are
ever used, so here the (L, Nt, T) tap-view tensor is built directly — the
T×T Toeplitz matrices are never materialized.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from jstsp19.core.config import COMPLEX_DTYPE
from jstsp19.core import prng
from jstsp19.frontend.modulation import qam4_mod


def _toeplitz_rows(s: jnp.ndarray, L: int) -> jnp.ndarray:
    """First L rows of the Hermitian Toeplitz matrix with first column ``s``.

    Row l, column t:  s[l-t] if l >= t else conj(s[t-l])  (MATLAB
    single-argument complex ``toeplitz``).  s: (..., T) → (..., L, T).
    """
    T = s.shape[-1]
    l_idx = jnp.arange(L)[:, None]
    t_idx = jnp.arange(T)[None, :]
    d = l_idx - t_idx  # (L, T)
    gathered = jnp.take(s, jnp.abs(d), axis=-1)  # (..., L, T)
    return jnp.where(d >= 0, gathered, jnp.conj(gathered))


def qam4_training_frames(key: jax.Array, Nt: int, T: int, L: int) -> jnp.ndarray:
    """4-QAM Toeplitz training, per-tap view.

    Returns ``Psi`` of shape (L, Nt, T) with ``Psi[l] = Psi_bar(:,:,l)`` of the
    reference (``plot_errorVSsnr.m:63-67`` + ``hbf.m:14-17``).
    """
    s = qam4_mod(key, (Nt, T))  # symbol sequence per tx antenna
    rows = _toeplitz_rows(s, L)  # (Nt, L, T)
    return jnp.transpose(rows, (1, 0, 2)).astype(COMPLEX_DTYPE)


def gaussian_training_frames(key: jax.Array, Nt: int, T: int, L: int) -> jnp.ndarray:
    """Complex-Gaussian Toeplitz training (the
    ``wideband_hybBF_comm_system_training.m:19-22`` variant)."""
    s = prng.complex_normal(key, (Nt, T))
    rows = _toeplitz_rows(s, L)
    return jnp.transpose(rows, (1, 0, 2)).astype(COMPLEX_DTYPE)


def awgn(key: jax.Array, Nr: int, T: int, noise_var) -> jnp.ndarray:
    """Additive white circular Gaussian noise CN(0, noise_var) of shape (Nr, T)."""
    return prng.complex_normal(key, (Nr, T), var=noise_var)
