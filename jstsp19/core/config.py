"""Typed configuration for the simulation system.

The reference carries its configuration as copy-pasted parameter blocks at the
top of every driver script (e.g. ``plot_errorVSsnr.m:7-25``).  Here each driver
is reproduced from one frozen dataclass so sweeps stay hashable / jit-static.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp


def matlab_round(x: float) -> int:
    """MATLAB ``round``: nearest integer, ties AWAY from zero — unlike
    Python's banker's rounding (``round(2.5) == 2`` vs MATLAB 3).  The
    difference is load-bearing at shipped sweep points (e.g. errorVSnrf's
    Mr=16/T=5: T/(Nr/Mr)=2.5 -> T_hbf 12 vs 8)."""
    import math

    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Static description of the wideband hybrid-beamforming sounding system.

    Mirrors the parameter block of ``plot_errorVSsnr.m:7-25`` in the reference,
    with names de-MATLAB-ified:

    - ``Nt`` / ``Nr``: transmit / receive antennas (ULA).
    - ``Mr_e``: wide analog combiner outputs available to the switch network.
    - ``Mr``: RF chains actually observed per training instant
      (random spatial sampling keeps a random ``Mr``-subset of the ``Mr_e``).
    - ``Gr`` / ``Gt``: beamspace dictionary grid sizes (DFT, typically = Nr/Nt).
    - ``L``: delay taps of the frequency-selective channel.
    - ``n_clusters`` / ``n_rays``: scattering geometry per tap.
    - ``T``: baseline training length; the proposed scheme uses ``T_prop=T*Nt``
      frames while the conventional HBF gets ``T_hbf=round(T/(Nr/Mr))*Nt`` to
      equalize the training budget (``plot_errorVSsnr.m:22-23``).
    """

    Nt: int = 4
    Nr: int = 32
    Mr_e: int = 32
    Mr: int = 4
    Gr: int = 32
    Gt: int = 4
    L: int = 4
    n_clusters: int = 2
    n_rays: int = 3
    T: int = 35
    beamformer: str = "ZC"
    # Solver knobs shared by the drivers.
    Imax: int = 100
    num_nonzero: int = 100  # `numOfnz = 5*20` in plot_errorVSsnr.m:20

    @property
    def Np(self) -> int:
        """Total propagation paths per tap."""
        return self.n_clusters * self.n_rays

    @property
    def T_prop(self) -> int:
        """Training frames for the proposed random-spatial-sampling receiver."""
        return self.T * self.Nt

    @property
    def T_hbf(self) -> int:
        """Fair-budget training frames for the conventional HBF receiver."""
        return matlab_round(self.T / (self.Nr / self.Mr)) * self.Nt

    @property
    def beamspace_shape(self) -> Tuple[int, int]:
        """Shape of the beamspace channel matrix Zbar (Gr, L*Gt)."""
        return (self.Gr, self.L * self.Gt)

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def canonical_system() -> SystemConfig:
    """The canonical errorVSsnr configuration (``plot_errorVSsnr.m:8-25``)."""
    return SystemConfig()


def snr_db_to_noise_var(snr_db) -> jnp.ndarray:
    """Noise variance for a given SNR in dB.

    The reference defines ``square_noise_variance = 10^(-SNR/10)``
    (``plot_errorVSsnr.m:49``) with unit-energy QPSK training symbols.
    """
    return jnp.asarray(10.0 ** (-jnp.asarray(snr_db) / 10.0))


# Default complex dtype policy: complex64 everywhere (complex128 requires
# x64 and is CPU-parity only).
COMPLEX_DTYPE = jnp.complex64
REAL_DTYPE = jnp.float32
