"""Hyperspectral unmixing via bilinear AMP (the HUTAMP capability).

JAX counterpart of the reference's ``MPbased_solvers/HUTAMP/``
(``HUTAMP.m``, Vila-Schniter-Meola "Hyperspectral unmixing via turbo
bilinear approximate message passing"): given per-pixel spectra

    Y (N_pixels × T_bands) = S·A + W,

jointly estimate non-negative abundances S (N × R) whose rows sum to one
and non-negative endmember spectra A (R × T).  The bilinear core is
:func:`jstsp19.solvers.bigamp.bigamp` with truncated-Gaussian-mixture
(non-negative) priors on both factors; the sum-to-one constraint is
imposed with the standard augmentation trick — an extra pseudo-band
``delta·1`` appended to Y whose endmember column is pinned at ``delta`` —
rather than HUTAMP's dedicated message type (same fixed point, one code
path).  EM noise-variance refitting runs between restarts.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jstsp19.solvers.bigamp import bigamp
from jstsp19.solvers.estim import NNGMPrior


class HutampResult(NamedTuple):
    S: jnp.ndarray  # (N, R) abundances, rows ~ simplex
    A: jnp.ndarray  # (R, T) endmember spectra, non-negative
    Z: jnp.ndarray  # (N, T) reconstructed spectra


@functools.partial(jax.jit, static_argnames=("n_materials", "nit", "n_em"))
def hutamp(
    Y: jnp.ndarray,
    n_materials: int,
    key,
    noise_var=None,
    nit: int = 150,
    n_em: int = 3,
    step: float = 0.3,
    delta: float = 1.0,
) -> HutampResult:
    """Unmix ``Y ≈ S·A`` into R = ``n_materials`` non-negative factors.

    ``delta`` weights the sum-to-one pseudo-band (larger = harder
    constraint).  ``noise_var`` defaults to a 100:1 SNR guess and is
    EM-refit from the residual between restarts.

    Constraint handling note (round 5): the pseudo-band's endmember
    column is NOT pinned at delta — it carries the same free NN prior as
    the real bands — so during the bilinear fit the augmentation enforces
    only that abundance ROWS share a common sum (any constant c with
    a_col = delta/c fits the pseudo-band); the exact simplex projection
    happens in the post-hoc row renormalization below.  This is a
    deliberate softening of HUTAMP.m's pinned-column augmentation: a
    pinned column needs a per-column prior override that BiG-AMP's
    homogeneous prior interface here does not carry, and the
    equal-row-sum + renormalize combination recovers the same factors on
    the tested unmixing problems.
    """
    N, T = Y.shape
    R = n_materials
    y_energy = jnp.mean(Y**2)
    nv = y_energy / 101.0 if noise_var is None else jnp.asarray(noise_var)

    # augmented observation: the extra band forces S·(delta·1) ≈ delta·1
    Y_aug = jnp.concatenate([Y, jnp.full((N, 1), delta, Y.dtype)], axis=1)
    mask = jnp.ones(Y_aug.shape, jnp.float32)

    # abundances: dense mixture on [0,1]-scale values, mean 1/R
    prior_s = NNGMPrior(
        jnp.asarray([1.0]),
        jnp.asarray([1.0 / R]),
        jnp.asarray([1.0 / R]),
        p1=jnp.asarray(1.0 - 1e-6),
    )
    # endmember spectra: scaled to the data's per-band energy
    a_scale = jnp.sqrt(jnp.maximum(y_energy, 1e-12)) * jnp.sqrt(R * 1.0)
    prior_a = NNGMPrior(
        jnp.asarray([1.0]),
        jnp.asarray([1.0]) * a_scale,
        jnp.asarray([1.0]) * a_scale**2,
        p1=jnp.asarray(1.0 - 1e-6),
    )

    def em_round(carry, _):
        nv, k = carry
        res = bigamp(
            Y_aug, mask, R, prior_s, prior_a, nv, k, nit=nit, step=step
        )
        resid = Y_aug - res.Z
        nv_new = jnp.maximum(jnp.mean(resid**2), 1e-12)
        return (nv_new, jax.random.fold_in(k, 1)), (res.A, res.X)

    (nv, _), (S_all, A_all) = jax.lax.scan(
        em_round, (jnp.asarray(nv, jnp.float32), key), None, length=n_em
    )
    S, A = S_all[-1], A_all[-1]
    # drop the pseudo-band, clip negatives, renormalize rows to the simplex
    A = jnp.maximum(A[:, :T].real, 0.0)
    S = jnp.maximum(S.real, 0.0)
    rows = jnp.maximum(jnp.sum(S, axis=1, keepdims=True), 1e-12)
    S = S / rows
    return HutampResult(S=S, A=A, Z=S @ A)
