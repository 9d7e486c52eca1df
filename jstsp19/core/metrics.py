"""Error / capacity / energy-efficiency metrics.

NMSE convention: the reference computes ``norm(S-Zbar)^2/norm(Zbar)^2`` with
MATLAB's default matrix ``norm`` — the *spectral* norm (largest singular
value), e.g. ``plot_errorVSsnr.m:138``; the explicit Frobenius norm is only
used for the hyper-parameters (``plot_errorVSsnr.m:127-128``).  Both flavors
are provided; ``spectral`` is the default for curve parity.  Every driver
clamps the per-realization error at 1 (``plot_errorVSsnr.m:139-141``) —
reproduced in :func:`clamped_nmse`.
"""
from __future__ import annotations

import jax.numpy as jnp


def _sq_norm(X: jnp.ndarray, kind: str) -> jnp.ndarray:
    if kind == "fro":
        return jnp.sum(jnp.abs(X) ** 2, axis=(-2, -1))
    if kind == "spectral":
        # Largest singular value squared == largest eigenvalue of the Gram.
        # Use the thin side for the Hermitian eigensolve (smaller eigh).
        n, m = X.shape[-2], X.shape[-1]
        G = (
            X @ jnp.swapaxes(X.conj(), -2, -1)
            if n <= m
            else jnp.swapaxes(X.conj(), -2, -1) @ X
        )
        ev = jnp.linalg.eigvalsh(G)
        return jnp.maximum(ev[..., -1], 0.0)
    raise ValueError(f"unknown norm kind {kind!r}")


def nmse(est: jnp.ndarray, ref: jnp.ndarray, kind: str = "spectral") -> jnp.ndarray:
    """Normalized matrix error  ‖est−ref‖² / ‖ref‖²  (batched over leading dims)."""
    return _sq_norm(est - ref, kind) / _sq_norm(ref, kind)


def clamped_nmse(
    est: jnp.ndarray, ref: jnp.ndarray, kind: str = "spectral"
) -> jnp.ndarray:
    """NMSE clamped at 1, as in every reference driver (``plot_errorVSsnr.m:139``)."""
    return jnp.minimum(nmse(est, ref, kind), 1.0)


def spectral_efficiency(Y: jnp.ndarray, W: jnp.ndarray, noise_var, Nt: int) -> jnp.ndarray:
    """Achievable spectral efficiency (ASE) of a combined observation.

    ``C = log2 det(I + (1/(σ² Nt)) · W^H Y Y^H W)`` as in
    ``plot_capacity.m:44-64`` (per-Mr combiner W, noiseless observation Y).
    """
    M = W.shape[-1]
    G = jnp.swapaxes(W.conj(), -2, -1) @ Y
    K = G @ jnp.swapaxes(G.conj(), -2, -1)
    Imat = jnp.eye(M, dtype=K.dtype)
    sign, logdet = jnp.linalg.slogdet(Imat + K / (noise_var * Nt))
    return jnp.real(logdet) / jnp.log(2.0)


def achievable_rate(Zbar: jnp.ndarray, nmse_val, noise_var, Nr: int) -> jnp.ndarray:
    """Achievable-rate proxy of the frame-length rate driver:

    ``log2 real(det(I + (1/Nr)·Zbar·Zbarᴴ / (σ² + NMSE)))``
    (``plot_rateVSframelength.m:81,113,130,135``) — a deterministic function
    of the *unclamped* spectral NMSE, the true beamspace channel and σ².
    Computed via the Gram eigenvalues for numerical stability.
    """
    lam = jnp.maximum(
        jnp.linalg.eigvalsh(Zbar @ jnp.swapaxes(Zbar.conj(), -2, -1)).real, 0.0
    )
    return jnp.sum(jnp.log2(1.0 + lam / (Nr * (noise_var + nmse_val))), axis=-1)


# Power model of plot_ee.m:69-77 (Watts).
P_LNA = 0.02
P_PS = 0.015
P_ZC = 0.06
P_SW = 0.005


def power_proposed(Nr: int, Mr_e: int) -> float:
    """Power draw of the proposed random-spatial-sampling front end:
    ``Mr_e·Nr·P_lna + Mr_e·P_sw + Nr·(Mr_e+1)·P_ps`` (``plot_ee.m:77``)."""
    return Mr_e * Nr * P_LNA + Mr_e * P_SW + Nr * (Mr_e + 1) * P_PS


def power_digital_bf(Nr: int) -> float:
    """Fully-digital front end: ``Nr²·P_lna + Nr·(Nr+1)·P_zc``
    (``plot_ee.m:74``)."""
    return Nr * Nr * P_LNA + Nr * (Nr + 1) * P_ZC


def power_conventional_hbf(Nr: int, Mr: int, zc: bool = False) -> float:
    """Conventional HBF front end: ``Mr·Nr·P_lna + Nr·(Mr+1)·P_ps``
    (phase shifters, or the ZC network price when ``zc``)
    (``plot_ee.m:75-76``)."""
    return Mr * Nr * P_LNA + Nr * (Mr + 1) * (P_ZC if zc else P_PS)


def energy_efficiency(capacity_bits, power_watts) -> jnp.ndarray:
    """EE = capacity / power (bits/Joule), ``plot_ee.m:84-87``."""
    return jnp.asarray(capacity_bits) / power_watts
