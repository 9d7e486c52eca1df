"""4-QAM (QPSK) modulation / demodulation (reference ``qam4mod.m``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.core.config import COMPLEX_DTYPE

# NOTE: module-level constants stay numpy — import must not touch a device.
_S = float(1.0 / np.sqrt(2.0))
QAM4_ALPHABET = np.asarray(
    [_S + 1j * _S, -_S + 1j * _S, _S - 1j * _S, -_S - 1j * _S], "complex64"
)


def qam4_mod(key: jax.Array, shape) -> jnp.ndarray:
    """Draw unit-energy 4-QAM symbols uniformly (``qam4mod.m:7-8``)."""
    idx = jax.random.randint(key, shape, 0, 4)
    return jnp.asarray(QAM4_ALPHABET)[idx]


def qam4_demod(y: jnp.ndarray) -> jnp.ndarray:
    """Quadrant slicer to the nearest unit-energy 4-QAM symbol
    (``qam4mod.m:13-32``)."""
    re = jnp.where(jnp.real(y) >= 0, _S, -_S)
    im = jnp.where(jnp.imag(y) >= 0, _S, -_S)
    return (re + 1j * im).astype(COMPLEX_DTYPE)
