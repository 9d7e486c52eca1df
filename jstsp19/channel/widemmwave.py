"""Frequency-selective (delay-tap) wideband mmWave MIMO channel generator.

Batched re-design of the reference generator
(``basic_system_functions/wideband_mmwave_channel.m:1-62``): the per-tap
cluster/ray synthesis is one batched einsum over a (L, n_clusters*n_rays)
grid of rays instead of nested scalar loops, so the whole channel (and any
vmapped batch of Monte-Carlo channels) is a handful of matmuls.

Deliberate deviations from the reference implementation (the *paper* model is
implemented, not the MATLAB quirks — see SURVEY.md §7.1 item 2):

- the reference accumulates the running per-cluster partial sum into each
  cluster slot (``wideband_mmwave_channel.m:24-30``), double-counting early
  rays; here every ray contributes exactly once with the standard
  ``1/sqrt(n_clusters·n_rays)`` normalization;
- the reference's "beamSquint" branch is byte-identical to the plain branch
  (``:25``) — only one branch exists here;
- the reference's inner products reuse tap-1 steering vectors for all taps
  (``Ar(:, index)`` vs ``Ar(:, index, l)``, ``:24``); here each tap uses its
  own ray geometry;
- the reference's truncated-Laplacian sampler
  (``genLaplacianSamples``, ``:56-62``) is not a valid inverse-CDF transform
  (its output is confined to a small negative arc); here a correct
  inverse-transform sampler for the truncated Laplacian power azimuth
  spectrum is used (mean AoA 0, configurable angular std).

``quirks=True`` reverses all three deviations and reproduces the reference
implementation's *actual* ensemble bit-for-bit in distribution (not in RNG
stream): the cosh sampler, the tap-1 steering reuse, and the per-cluster
partial-sum double count.  This is the parity mode used to compare NMSE
curves against the committed ``results/errorVSsnr*.fig`` artifacts, which
were generated by the quirky code, not the paper model.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from jstsp19.core.config import COMPLEX_DTYPE, REAL_DTYPE
from jstsp19.core import prng

# Carrier geometry of the reference (`wideband_mmwave_channel.m:44-49`):
# 90 GHz carrier, half-wavelength ULA spacing => k·d = pi.
KD = jnp.pi  # wavenumber * element spacing for lambda/2 ULA
DEFAULT_SIGMA_PHI_RAD = 50.0 * jnp.pi / 180.0


def ula_steering(phi: jnp.ndarray, M: int) -> jnp.ndarray:
    """Unnormalized ULA steering vector(s) ``exp(+j·k·d·sin(phi)·m)``
    — i.e. ``exp(-j·k·d·sin(phi0 − phi)·m)`` at the reference's mean AoA
    ``phi0 = 0``, whose sign flip the ``sin(-phi)`` below reproduces
    bit-for-bit (``wideband_mmwave_channel.m:42-52``; the quirks-mode
    angle marginal is asymmetric, so this sign IS observable — do not
    "fix" it to the more common ``exp(-j·…·sin(phi))`` convention).

    ``phi``: (...,) angles in radians.  Returns (..., M) complex.
    """
    m = jnp.arange(M, dtype=REAL_DTYPE)
    phase = KD * jnp.sin(-phi)[..., None] * m
    return jnp.exp(-1j * phase).astype(COMPLEX_DTYPE)


def truncated_laplacian(
    key: jax.Array, shape, sigma: float = DEFAULT_SIGMA_PHI_RAD
) -> jnp.ndarray:
    """Sample angles from a Laplacian PAS truncated to [-pi, pi].

    Proper inverse-CDF transform (cf. the reference's broken
    ``genLaplacianSamples``, ``wideband_mmwave_channel.m:56-62``): with
    u ~ U(-1/2, 1/2),

        phi = -(sigma/sqrt(2)) · sign(u) · log(1 − 2|u|·(1 − e^{−sqrt(2)·pi/sigma}))
    """
    u = jax.random.uniform(key, shape, REAL_DTYPE, -0.5, 0.5)
    b = sigma / jnp.sqrt(2.0)
    trunc = 1.0 - jnp.exp(-jnp.pi / b)
    return -b * jnp.sign(u) * jnp.log1p(-2.0 * jnp.abs(u) * trunc)


def quirk_laplacian(key: jax.Array, shape) -> jnp.ndarray:
    """The reference's ``genLaplacianSamples`` verbatim
    (``wideband_mmwave_channel.m:56-62``): with u ~ U(0,1) and
    sigma_phi = 50,

        beta = 1/(1 − e^{−sqrt(2)·pi/sigma_phi})
        x    = beta·(e^{−sqrt(2)·pi/sigma_phi} − cosh(u))

    This is NOT a valid inverse-CDF transform — the output is confined to
    ≈[−7.39, −1.00] rad — but it is the ensemble the committed reference
    artifacts were generated from, so the parity mode reproduces it.
    """
    u = jax.random.uniform(key, shape, REAL_DTYPE)
    sigma_phi = 50.0
    c = jnp.exp(-jnp.sqrt(2.0) * jnp.pi / sigma_phi)
    beta = 1.0 / (1.0 - c)
    return beta * (c - jnp.cosh(u))


def dft_dictionary(M: int, G: int) -> jnp.ndarray:
    """Beamspace DFT dictionary ``D[m,g] = exp(-j·2π·m·g/G)/sqrt(M)``.

    Matches ``wideband_mmwave_channel.m:9-10`` exactly.
    """
    m = jnp.arange(M, dtype=REAL_DTYPE)[:, None]
    g = jnp.arange(G, dtype=REAL_DTYPE)[None, :]
    return (jnp.exp(-2j * jnp.pi * m * g / G) / jnp.sqrt(M * 1.0)).astype(
        COMPLEX_DTYPE
    )


class Channel(NamedTuple):
    """A wideband channel realization.

    H:    (L, Mr, Mt)   delay-tap antenna-space channel
    Zbar: (Gr, L*Gt)    beamspace channel, taps concatenated column-wise
                        (reference layout ``reshape(Z, Gr, L*Gt)``,
                        ``wideband_mmwave_channel.m:38``)
    Ar:   (L, Np, Mr)   receive steering vectors per tap
    At:   (L, Np, Mt)   transmit steering vectors per tap
    Dr:   (Mr, Gr)      receive beamspace dictionary
    Dt:   (Mt, Gt)      transmit beamspace dictionary
    """

    H: jnp.ndarray
    Zbar: jnp.ndarray
    Ar: jnp.ndarray
    At: jnp.ndarray
    Dr: jnp.ndarray
    Dt: jnp.ndarray


def beamspace(H: jnp.ndarray, Dr: jnp.ndarray, Dt: jnp.ndarray) -> jnp.ndarray:
    """Per-tap beamspace projection ``Z_l = Dr^H H_l Dt`` flattened to
    (Gr, L*Gt) with taps concatenated along columns."""
    Z = jnp.einsum("mg,lmn,nh->lgh", Dr.conj(), H, Dt)
    L, Gr, Gt = Z.shape
    return jnp.transpose(Z, (1, 0, 2)).reshape(Gr, L * Gt)


def wideband_mmwave_channel(
    key: jax.Array,
    L: int,
    Mr: int,
    Mt: int,
    n_clusters: int,
    n_rays: int,
    Gr: int,
    Gt: int,
    sigma_phi: float = DEFAULT_SIGMA_PHI_RAD,
    quirks: bool = False,
) -> Channel:
    """Generate one wideband mmWave channel realization.

    Per tap l: ``H_l = sqrt(1/(n_clusters·n_rays)) Σ_p α_p a_r(φr_p) a_t(φt_p)^H``
    with α_p ~ CN(0,1) Rayleigh coefficients and truncated-Laplacian angles
    (reference: ``wideband_mmwave_channel.m:13-36``).

    ``quirks=True`` reproduces the reference implementation's ensemble
    instead of the paper model (see module docstring):

    1. angles drawn with :func:`quirk_laplacian` (the cosh sampler,
       ``wideband_mmwave_channel.m:56-62``);
    2. every tap's channel is built from **tap-1 steering vectors** —
       MATLAB's 2-subscript ``Ar(:, index)`` on the 3-D array linearly
       indexes page 1 (``:24``) — with fresh per-tap Rayleigh coefficients;
    3. the running per-cluster partial sum ``Hl`` is re-added once per
       cluster without reset (``:24-30``), so cluster c (1-based) rays carry
       weight ``n_clusters − c + 1``.

    Note: ``sigma_phi`` is deliberately IGNORED under ``quirks=True`` —
    the reference's sampler hard-codes ``sigma_phi = 50`` inside
    ``genLaplacianSamples`` (``wideband_mmwave_channel.m:59``), so the
    parity ensemble has no angular-spread knob to honor.
    """
    Np = n_clusters * n_rays
    k_coef, k_phir, k_phit = jax.random.split(key, 3)

    alpha = prng.complex_normal(k_coef, (L, Np))
    if quirks:
        phi_r = quirk_laplacian(k_phir, (L, Np))
        phi_t = quirk_laplacian(k_phit, (L, Np))
    else:
        phi_r = truncated_laplacian(k_phir, (L, Np), sigma_phi)
        phi_t = truncated_laplacian(k_phit, (L, Np), sigma_phi)

    Ar = ula_steering(phi_r, Mr)  # (L, Np, Mr)
    At = ula_steering(phi_t, Mt)  # (L, Np, Mt)

    if quirks:
        # Cluster double-count: ray p in 0-based cluster c contributes
        # (n_clusters - c) times (`wideband_mmwave_channel.m:24-30`).
        w = (n_clusters - jnp.arange(Np, dtype=REAL_DTYPE) // n_rays).astype(
            COMPLEX_DTYPE
        )
        # Tap-1 steering vectors for every tap (`:24`): only the Rayleigh
        # coefficients are redrawn per tap.
        H = jnp.einsum(
            "lp,pm,pn->lmn", alpha * w, Ar[0], At[0].conj()
        ) / jnp.sqrt(Np * 1.0)
    else:
        # H_l = (1/sqrt(Np)) Σ_p α_p · a_r ⊗ a_t^H — one batched einsum.
        H = jnp.einsum("lp,lpm,lpn->lmn", alpha, Ar, At.conj()) / jnp.sqrt(Np * 1.0)

    Dr = dft_dictionary(Mr, Gr)
    Dt = dft_dictionary(Mt, Gt)
    Zbar = beamspace(H, Dr, Dt)
    return Channel(H=H, Zbar=Zbar, Ar=Ar, At=At, Dr=Dr, Dt=Dt)


def taps_to_subcarriers(H: jnp.ndarray, K: int) -> jnp.ndarray:
    """Frequency response on K subcarriers: ``H_k = Σ_l H_l e^{−j2πkl/K}``.

    The delay-tap ↔ subcarrier view used by the OFDM-style configs
    (BASELINE.json configs with K subcarriers).  ``H``: (L, Mr, Mt) →
    (K, Mr, Mt) via a zero-padded FFT over the tap axis; for K < L the
    sum runs over ALL L taps (taps alias onto the K-point grid — folding
    the tap axis modulo K before the FFT, NOT truncating it)."""
    L = H.shape[0]
    if K >= L:
        Hp = jnp.concatenate(
            [H, jnp.zeros((K - L,) + H.shape[1:], H.dtype)], axis=0
        )
    else:
        # e^{-j2πkl/K} depends on l only through l mod K: fold taps
        pad = (-L) % K
        Hp = jnp.concatenate(
            [H, jnp.zeros((pad,) + H.shape[1:], H.dtype)], axis=0
        ).reshape(-1, K, *H.shape[1:]).sum(axis=0)
    return jnp.fft.fft(Hp, axis=0)


def channel_from_taps(H: jnp.ndarray, Gr: int, Gt: int) -> Channel:
    """Build a :class:`Channel` from externally supplied delay taps
    (the NYU-Wireless ingestion path, ``plot_errorVSsnr_nyuwireless.m:59-70``
    — taps come from a ray tracer instead of the synthetic generator).

    H: (L, Mr, Mt).  Steering-vector fields are not available for measured
    channels and are filled with empty placeholders.
    """
    L, Mr, Mt = H.shape
    Dr = dft_dictionary(Mr, Gr)
    Dt = dft_dictionary(Mt, Gt)
    Zbar = beamspace(H, Dr, Dt)
    empty_r = jnp.zeros((L, 0, Mr), H.dtype)
    empty_t = jnp.zeros((L, 0, Mt), H.dtype)
    return Channel(H=H, Zbar=Zbar, Ar=empty_r, At=empty_t, Dr=Dr, Dt=Dt)
