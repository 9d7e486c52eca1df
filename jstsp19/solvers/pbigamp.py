"""Parametric bilinear GAMP (P-BiG-AMP).

JAX counterpart of the reference's ``MPbased_solvers/PBiGAMP/``
(``PBiGAMP.m``, Parker & Schniter, "Parametric bilinear generalized
approximate message passing"): estimate two parameter vectors b (Nb,) and
c (Nc,) observed through the parametric bilinear measurement

    z_m = b^T · A[m] · c,       y ~ p(y | z),   m = 1..M,

where A is a known (M, Nb, Nc) measurement tensor.  This covers
self-calibration, blind deconvolution, joint channel/data estimation, and
matrix recovery from rank-one projections; plain BiG-AMP is the special
case A[m] = e_l e_k^T per observed entry.

The recursion is the scalar-(uniform-)variance simplification of the
paper's Table I — same regime as :mod:`jstsp19.solvers.bigamp` — so
every step is a dense einsum over the (M, Nb, Nc) tensor under
``lax.scan`` (matmul-shaped: the hot ops are two batched matvecs and two
matched filters per iteration).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class PBigAmpResult(NamedTuple):
    b: jnp.ndarray
    c: jnp.ndarray
    z: jnp.ndarray
    # final input-stage pseudo-data (Rb ≈ b + CN(0, rvar_b) etc.) — the
    # sufficient statistics the EM wrapper (EMPBiGAMP.m) consumes
    Rb: jnp.ndarray = None
    rvar_b: jnp.ndarray = None
    Rc: jnp.ndarray = None
    rvar_c: jnp.ndarray = None
    zvar: jnp.ndarray = None


@functools.partial(jax.jit, static_argnames=("nit",))
def pbigamp(
    y: jnp.ndarray,
    A: jnp.ndarray,
    prior_b,
    prior_c,
    noise_var,
    key,
    nit: int = 100,
    step: float = 0.5,
    var_floor: float = 1e-9,
    likelihood=None,
    init_b=None,
    init_c=None,
) -> PBigAmpResult:
    """Run P-BiG-AMP on ``y ≈ z + w`` with ``z_m = b^T A[m] c``.

    y: (M,); A: (M, Nb, Nc).  ``prior_b`` / ``prior_c`` are estimator
    modules from :mod:`jstsp19.solvers.estim`; ``likelihood`` optionally
    replaces the default AWGN output stage.  The bilinear scale ambiguity
    (b, c) ↦ (αb, c/α) is resolved only up to the priors' second moments —
    evaluate recovered z (ambiguity-free) or align factors before
    comparing.
    """
    M, Nb, Nc = A.shape
    cdt = jnp.result_type(y.dtype, A.dtype)
    rdt = jnp.float32

    A2 = jnp.abs(A) ** 2
    A2_sum = jnp.sum(A2, axis=(1, 2))  # (M,) ‖A[m]‖²_F
    A2_b = jnp.sum(A2, axis=2)  # (M, Nb) Σ_j |A_mij|²
    A2_c = jnp.sum(A2, axis=1)  # (M, Nc) Σ_i |A_mij|²

    kb, kc = jax.random.split(key)
    mb, vb0 = prior_b.init_moments()
    mc, vc0 = prior_c.init_moments()

    def _rand(k, n, m0, v0):
        """Draw from the prior's first two moments: mean + sqrt(var)·noise
        (keeps an informative mean — e.g. unity calibration gains — as the
        starting point instead of washing it out)."""
        if jnp.issubdtype(cdt, jnp.complexfloating):
            w = (
                jax.random.normal(k, (n,)) + 1j * jax.random.normal(jax.random.fold_in(k, 1), (n,))
            ).astype(cdt) * jnp.sqrt(v0 / 2)
        else:
            w = jax.random.normal(k, (n,)).astype(cdt) * jnp.sqrt(v0)
        return w + jnp.asarray(m0, cdt)

    bhat = init_b if init_b is not None else _rand(kb, Nb, mb, vb0)
    chat = init_c if init_c is not None else _rand(kc, Nc, mc, vc0)
    vb = jnp.asarray(vb0, rdt)
    vc = jnp.asarray(vc0, rdt)
    shat = jnp.zeros((M,), cdt)
    nv = jnp.asarray(noise_var, rdt)

    def body(carry, _):
        bhat, vb, chat, vc, shat = carry[:5]
        # forward derivatives of z_m in b and c
        za = jnp.einsum("mij,j->mi", A, chat)  # ∂z_m/∂b_i
        zc = jnp.einsum("mij,i->mj", A, bhat)  # ∂z_m/∂c_j
        zhat = jnp.einsum("mi,i->m", za, bhat)
        b2 = jnp.abs(bhat) ** 2
        c2 = jnp.abs(chat) ** 2

        # output linear stage.  Variances use |A|²-weighted magnitudes
        # (the GAMP sq_mv form) rather than the |∂z|² realizations — this
        # keeps the output and input stages consistent and the Onsager
        # corrections bounded; the realization form diverges (the classic
        # bilinear-AMP instability the paper counters with adaptive
        # damping).
        # the precomputed |A|^2 marginals give the same sums at a
        # factor Nb/Nc less work than full-tensor einsums (round 5)
        vp_bar = vb * (A2_c @ c2) + vc * (A2_b @ b2)
        vp = jnp.maximum(vp_bar + vb * vc * A2_sum, var_floor)
        phat = zhat - shat * vp_bar

        # output nonlinear stage
        if likelihood is not None:
            z0, vz = likelihood.estim(phat, vp)
        else:
            gain = vp / (vp + nv)
            z0 = phat + gain * (y - phat)
            vz = gain * nv
        shat_new = (z0 - phat) / vp
        vs = jnp.maximum((1.0 - vz / vp) / vp, var_floor)
        shat_new = step * shat_new + (1 - step) * shat

        # input linear stage, b side.  The denominator includes the
        # (c² + vc) uncertainty, so the Onsager multiplier 1 − on/den
        # stays in (0, 1].
        den_b = jnp.maximum(jnp.einsum("m,mij,j->i", vs, A2, c2 + vc), var_floor)
        rvar_b = 1.0 / den_b
        on_b = vc * jnp.einsum("m,mi->i", vs, A2_b)
        rb = bhat * (1.0 - on_b / den_b) + rvar_b * jnp.einsum(
            "m,mi->i", shat_new, za.conj()
        )
        # input linear stage, c side
        den_c = jnp.maximum(jnp.einsum("m,mij,i->j", vs, A2, b2 + vb), var_floor)
        rvar_c = 1.0 / den_c
        on_c = vb * jnp.einsum("m,mj->j", vs, A2_c)
        rc = chat * (1.0 - on_c / den_c) + rvar_c * jnp.einsum(
            "m,mj->j", shat_new, zc.conj()
        )

        # input nonlinear stage (means and scalar variances both damped)
        bn, vbn = prior_b.estim(rb, rvar_b)
        cn, vcn = prior_c.estim(rc, rvar_c)
        bn = step * bn + (1 - step) * bhat
        cn = step * cn + (1 - step) * chat
        vb_n = step * jnp.maximum(jnp.mean(vbn), var_floor) + (1 - step) * vb
        vc_n = step * jnp.maximum(jnp.mean(vcn), var_floor) + (1 - step) * vc
        return (bn, vb_n, cn, vc_n, shat_new, rb, rvar_b, rc, rvar_c, vz), None

    zvar0 = jnp.zeros((M,), rdt)
    (bhat, vb, chat, vc, shat, Rb, rvar_b, Rc, rvar_c, zvar), _ = jax.lax.scan(
        body,
        (
            bhat,
            vb,
            chat,
            vc,
            shat,
            bhat,
            jnp.ones((Nb,), rdt),
            chat,
            jnp.ones((Nc,), rdt),
            zvar0,
        ),
        None,
        length=nit,
    )
    z = jnp.einsum("mij,i,j->m", A, bhat, chat)
    return PBigAmpResult(
        b=bhat, c=chat, z=z, Rb=Rb, rvar_b=rvar_b, Rc=Rc, rvar_c=rvar_c,
        zvar=zvar,
    )


class EmPBigAmpResult(NamedTuple):
    b: jnp.ndarray
    c: jnp.ndarray
    z: jnp.ndarray
    noise_var: jnp.ndarray
    prior_c: object


def em_pbigamp(
    y,
    A,
    key,
    n_em: int = 8,
    nit: int = 100,
    step: float = 0.5,
    prior_b=None,
    b_mean: complex = 1.0,
    b_var: float = 0.1,
) -> EmPBigAmpResult:
    """EM-P-BiG-AMP (``PBiGAMP/EMPBiGAMP.m``): learns the AWGN noise
    variance, the sparse-c prior's activity/slab variance, and the b
    prior's variance around the P-BiG-AMP inner solver.

    Defaults match the reference's calibration setup: b ~ CN(b_mean, b_var)
    (e.g. unity-gain sensors) and c Bernoulli-Gaussian with EM-learned
    hyperparameters; the initial noise variance follows the 100:1 SNR rule
    of ``EMPBiGAMP.m:119-126``.
    """
    from jstsp19.solvers.em import _bernoulli_gauss_em_update
    from jstsp19.solvers.estim import CAwgnPrior, SparsePrior

    M = y.shape[0]
    Nc = A.shape[2]
    nv = jnp.sum(jnp.abs(y) ** 2) / (M * 101.0)
    if prior_b is None:
        prior_b = CAwgnPrior(jnp.asarray(b_mean), jnp.asarray(b_var))
    rho0 = 0.1
    prior_c = SparsePrior(
        CAwgnPrior(jnp.asarray(0.0 + 0j), jnp.mean(jnp.abs(y) ** 2)), rho0
    )
    res = None
    for i in range(n_em):
        res = pbigamp(
            y,
            A,
            prior_b,
            prior_c,
            nv,
            jax.random.fold_in(key, i),
            nit=nit,
            step=step,
            init_b=None if res is None else res.b,
            init_c=None if res is None else res.c,
        )
        # EM noise update (EMPBiGAMP noise_var learning): residual + zvar
        nv = jnp.maximum(
            jnp.mean(jnp.abs(y - res.z) ** 2) + jnp.mean(res.zvar), 1e-12
        )
        # EM of the sparse-c prior from the final pseudo-data
        prior_c = _bernoulli_gauss_em_update(prior_c, res.Rc, res.rvar_c)
        # EM of the b prior's variance (the EMPBiGAMP.m b-hyperparameter
        # learning the docstring advertises): posterior second moment of
        # (b - mean) from the final pseudo-data — round 5, previously the
        # (Rb, rvar_b) moments were plumbed through and then ignored
        bhat, bvar = prior_b.estim(res.Rb, res.rvar_b)
        var_new = jnp.maximum(
            jnp.mean(jnp.abs(bhat - prior_b.mean0) ** 2 + bvar), 1e-8
        )
        prior_b = CAwgnPrior(prior_b.mean0, var_new)
    return EmPBigAmpResult(
        b=res.b, c=res.c, z=res.z, noise_var=nv, prior_c=prior_c
    )
