"""Hybrid-beamforming measurement models.

Conventional HBF (``hbf.m``): the analog combiner keeps its first Lr outputs.
Proposed HBF (``proposed_hbf.m``): a wide combiner exposes Lr_e outputs and a
random Lr-subset is observed per training instant (random spatial sampling),
expressed as a binary mask Omega applied to the combined frame.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from jstsp19.core.config import REAL_DTYPE, matlab_round
from jstsp19.frontend.beamformers import create_beamformer
from jstsp19.frontend.training import gaussian_training_frames, awgn


def received_frame(H: jnp.ndarray, Psi: jnp.ndarray, N: jnp.ndarray) -> jnp.ndarray:
    """Antenna-space received frame ``R = Σ_l H_l·Psi_l + N``.

    H: (L, Nr, Nt), Psi: (L, Nt, T), N: (Nr, T).  One batched einsum — the
    tap loop of ``hbf.m:14-20`` becomes a single contraction.
    """
    return jnp.einsum("lmn,lnt->mt", H, Psi) + N


def hbf(
    H: jnp.ndarray, N: jnp.ndarray, Psi: jnp.ndarray, Lr: int, W: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Conventional HBF observation.

    Returns (Y, W_c) with ``W_c = W[:, :Lr]`` and ``Y = W_c^H R``
    (``hbf.m:22-25``).
    """
    R = received_frame(H, Psi, N)
    W_c = W[:, :Lr]
    return W_c.conj().T @ R, W_c


def sample_omega(key: jax.Array, Lr_e: int, Lr: int, T: int) -> jnp.ndarray:
    """Random spatial-sampling mask: per training instant t, a uniformly
    random Lr-subset of the Lr_e combiner outputs (``proposed_hbf.m:36-41``).

    Returns a real (Lr_e, T) 0/1 mask.  Subsets are drawn without
    replacement via per-column random-key argsort (the jit-safe equivalent
    of ``randperm``).
    """
    scores = jax.random.uniform(key, (T, Lr_e))
    ranks = jnp.argsort(jnp.argsort(scores, axis=-1), axis=-1)
    mask = (ranks < Lr).astype(REAL_DTYPE)  # (T, Lr_e)
    return mask.T


class ProposedObservation(NamedTuple):
    Y: jnp.ndarray  # (Lr_e, T) masked observation  Omega ∘ (W_e^H R)
    Omega: jnp.ndarray  # (Lr_e, T) binary sampling mask
    W_e: jnp.ndarray  # (Nr, Lr_e) wide analog combiner
    Y_full: jnp.ndarray  # (Lr_e, T) unmasked combined frame (for oracles)


def proposed_hbf(
    key: jax.Array,
    H: jnp.ndarray,
    N: jnp.ndarray,
    Psi: jnp.ndarray,
    Lr_e: int,
    Lr: int,
    W: jnp.ndarray,
) -> ProposedObservation:
    """Proposed random-spatial-sampling HBF observation (``proposed_hbf.m``)."""
    R = received_frame(H, Psi, N)
    W_e = W[:, :Lr_e]
    Y_full = W_e.conj().T @ R
    T = R.shape[-1]
    Omega = sample_omega(key, Lr_e, Lr, T)
    return ProposedObservation(Y=Omega * Y_full, Omega=Omega, W_e=W_e, Y_full=Y_full)


def comm_system_training(
    key: jax.Array,
    H: jnp.ndarray,
    T: int,
    noise_var,
    sub_sampling_ratio: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, int, jnp.ndarray]:
    """The ``wideband_hybBF_comm_system_training.m`` wrapper: Gaussian
    Toeplitz training, FFT combiner over all Nr outputs, random spatial
    sampling at rate ``sub_sampling_ratio``.

    Returns (Y_proposed, Y_conventional, W, Omega, Lr, Psi) — ``Psi`` is
    the (L, Nt, T) training actually transmitted (the reference returns it
    as ``Psi_bar`` so drivers build B from the SAME frames,
    ``wideband_hybBF_comm_system_training.m:1,28-30``).
    """
    L, Nr, Nt = H.shape
    Lr = matlab_round(sub_sampling_ratio * Nr)
    k_train, k_noise, k_mask = jax.random.split(key, 3)
    Psi = gaussian_training_frames(k_train, Nt, T, L)
    # NOTE: the reference draws noise with std sqrt(noise_var/2) per
    # component *before* combining (`wideband_hybBF_comm_system_training.m:16`).
    N = awgn(k_noise, Nr, T, noise_var)
    W = create_beamformer(Nr, "fft")
    R = received_frame(H, Psi, N)
    Y_conv = W.conj().T @ R
    Omega = sample_omega(k_mask, Nr, Lr, T)
    return Omega * Y_conv, Y_conv, W, Omega, Lr, Psi
