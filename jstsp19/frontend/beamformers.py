"""Analog combiner / beamformer factory.

The seven combiner families of the reference ``createBeamformer.m:4-31``,
constructed as closed-form phase matrices (no MATLAB `fft(eye(N))` detour —
the DFT combiner is written directly).

All return an (N, N) complex matrix with columns of norm 1 (scaled by
``1/sqrt(N)``); random flavors take a PRNG key.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from jstsp19.core.config import COMPLEX_DTYPE, REAL_DTYPE

_RAND_PS_GRID = 32  # `Gr = 32` inside the 'rand_ps' branch, createBeamformer.m:10
_ZC_ROOT = 11  # Zadoff-Chu root, createBeamformer.m:16


def _phase_matrix(omega_cols: jnp.ndarray, N: int) -> jnp.ndarray:
    """``B[n, c] = exp(-j·n·omega_cols[c]) / sqrt(N)``."""
    n = jnp.arange(N, dtype=REAL_DTYPE)[:, None]
    return (jnp.exp(-1j * n * omega_cols[None, :]) / jnp.sqrt(N * 1.0)).astype(
        COMPLEX_DTYPE
    )


def _quantized(N: int, bits: int) -> jnp.ndarray:
    """Phase-quantized combiner: per-column phase step from a 2^bits grid
    covering N columns (``createBeamformer.m:18-30``).

    The reference's ``vec(kron(ones(K,1), A))`` (A a row vector, K =
    ceil(N/2^bits), column-major vec) repeats each level K times
    CONSECUTIVELY — [0,0,…,1,1,…] — not cyclically; with K > 1 the first
    N entries then span only ~N/K distinct phases (round-5 parity fix:
    the cyclic ``arange(N) % levels`` form gave a different combiner for
    every N ≠ 2^bits, e.g. the capacity driver's Nr=128 block)."""
    levels = 2**bits
    K = -(-N // levels)  # ceil
    a = jnp.repeat(jnp.arange(levels, dtype=REAL_DTYPE), K)[:N]
    omega = 2.0 * jnp.pi / levels * a
    return _phase_matrix(omega, N)


def create_beamformer(
    N: int, kind: str = "ZC", key: Optional[jax.Array] = None
) -> jnp.ndarray:
    """Build an (N, N) analog combiner of the given family.

    kinds (matching ``createBeamformer.m``):
      'fft'          unitary DFT combiner
      'rand'         QPSK random (+1/-1/+j/-j entries)           [needs key]
      'rand_ps'      random 32-level phase shifters              [needs key]
      'ps'           uniform phase grid (same as DFT phases)
      'ZC'           Zadoff-Chu sequence bank, root R=11
      'quantized_4'  4-bit phase-quantized grid
      'quantized'    6-bit phase-quantized grid
    """
    if kind == "fft":
        n = jnp.arange(N, dtype=REAL_DTYPE)
        return _phase_matrix(2.0 * jnp.pi * n / N, N)
    if kind == "ps":
        n = jnp.arange(N, dtype=REAL_DTYPE)
        return _phase_matrix(2.0 * jnp.pi * n / N, N)
    if kind == "ZC":
        # B[n,c] = exp(-j·R·n·pi·(c+1)/N)/sqrt(N)  (createBeamformer.m:15-17)
        c = jnp.arange(1, N + 1, dtype=REAL_DTYPE)
        return _phase_matrix(_ZC_ROOT * jnp.pi * c / N, N)
    if kind == "quantized_4":
        return _quantized(N, 4)
    if kind == "quantized":
        return _quantized(N, 6)
    if kind == "rand":
        if key is None:
            raise ValueError("'rand' beamformer needs a PRNG key")
        alphabet = jnp.asarray([1.0, -1.0, 1.0j, -1.0j], COMPLEX_DTYPE)
        idx = jax.random.randint(key, (N, N), 0, 4)
        return alphabet[idx] / jnp.sqrt(N * 1.0)
    if kind == "rand_ps":
        if key is None:
            raise ValueError("'rand_ps' beamformer needs a PRNG key")
        g = jax.random.randint(key, (N,), 1, _RAND_PS_GRID + 1).astype(REAL_DTYPE)
        return _phase_matrix(2.0 * jnp.pi * g / _RAND_PS_GRID, N)
    raise ValueError(f"unknown beamformer kind {kind!r}")
