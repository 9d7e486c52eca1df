"""Per-realization simulation pipeline.

One compiled function evaluates every requested estimator on one Monte-Carlo
channel realization; the runner vmaps it over a batch of realizations and
(optionally) shards that batch over a device mesh.  This is the batched
form of the reference's driver template (params → channel → conventional
HBF baselines → proposed HBF + ADMM → clamped NMSE), e.g.
``plot_errorVSsnr.m:48-167``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from jstsp19.channel import channel_from_taps, wideband_mmwave_channel
from jstsp19.core import prng
from jstsp19.core.config import matlab_round
from jstsp19.core.metrics import clamped_nmse, nmse
from jstsp19.frontend import (
    awgn,
    create_beamformer,
    hbf,
    proposed_hbf,
    qam4_training_frames,
)
from jstsp19.solvers import (
    admm_hyperparams,
    ls_estimate,
    mc_admm,
    mc_svt,
    omp_mmv,
    omp_td,
    proposed_admm,
    proposed_admm_angles,
    vamp_mmwave,
)


SVT_METHODS = ("eigh", "jacobi", "tracked")
# estimator families with an SVT inside their iteration loop
TRACKED_FAMILIES = ("proposed", "proposed_angles", "svt", "tssr", "mc_admm")
# Families whose per-realization result is not a continuous function of
# the products' rounding: TD-OMP's greedy atom choice and VAMP's iteration
# diverge from the full-precision result when products are rounded to TF32
# (DEFAULT precision on the H100; chip_smoke.py phase 3).  Each runs its
# whole realization, channel included, with full float32 products.
FULL_PRECISION_FAMILIES = ("vamp", "omp_td")


@dataclasses.dataclass(frozen=True)
class PointConfig:
    """Static configuration of one sweep point (hashable → jit-static).

    Defaults are the canonical ``plot_errorVSsnr.m:8-25`` block.
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
    Imax: int = 100
    num_nonzero: int = 100
    beamformer: str = "ZC"
    methods: Tuple[str, ...] = ("ls", "vamp", "omp_mmv", "proposed", "proposed_angles")
    admm_mode: str = "approximate"
    # 'eigh' | 'jacobi' (eigh-free inner loop, ops/jacobi.py) | 'tracked'
    svt_method: str = "eigh"
    track_rounds: int = 1  # Jacobi refresh rounds/iter for svt_method='tracked' (1 = eigh-identical here)
    # matmul precision of the tracked chain's two remaining matmuls.  The
    # chain tolerates a reduced-precision product because U is rotated
    # exactly (elementwise Givens updates) and P is recomputed fresh each
    # iteration, so matmul error does not accumulate; chip_smoke.py holds
    # the shipped setting to the eigh/'highest' reference per realization.
    track_precision: str = "default"
    vamp_nit: int = 100
    vamp_true_noise: bool = False  # reference passes sigma=1 (plot_errorVSsnr.m:100)
    # VAMP extrinsic damping.  0.85 is the reference's (vamp.m:12); on
    # ill-conditioned low-rank kron operators (e.g. the delays driver's
    # T_hbf < L·Gt) the 0.85 dynamics diverge to the NMSE clamp while 0.6
    # recovers — see tests/test_vamp_glm_se.py delays certification.
    vamp_damp: float = 0.85
    # Run VAMP on the reference's normal-equations form y=vec(Y·Bᴴ),
    # Phi=kron((B·Bᴴ).',A) (plot_errorVSsnr.m:79-80).  With the reference's
    # fixed wvar=1 the two forms are NOT equivalent (the Bᴴ-correlation
    # rescales signal vs assumed noise); the normal-equations form matches
    # the committed VAMP curves, the direct form diverges at high SNR.
    vamp_normal_eq: bool = True
    rho_scale: float = 1.0  # plot_errorVSzy.m uses rho/2 (:65)
    channel_quirks: bool = False  # reproduce the reference's broken ensemble

    def __post_init__(self):
        if self.svt_method not in SVT_METHODS:
            raise ValueError(
                f"unknown svt_method {self.svt_method!r}; one of {SVT_METHODS}"
            )

    @property
    def T_prop(self) -> int:
        return self.T * self.Nt

    @property
    def T_hbf(self) -> int:
        return matlab_round(self.T / (self.Nr / self.Mr)) * self.Nt


def fastest_point_config(method: str) -> PointConfig:
    """One estimator family at its fastest kernel configuration — the
    single source of truth for ``bench_all.py`` and the
    ``time_comparisons`` recipe: tracked SVT (``ops/tracked.py``) wherever
    an SVT sits inside the iteration loop, plain config otherwise."""
    return PointConfig(
        methods=(method,),
        svt_method="tracked" if method in TRACKED_FAMILIES else "eigh",
    )


def _dictionaries(ch, W_c, Psi):
    """A = W_cᴴ·Dr and the stacked per-tap B blocks ``Dtᴴ·Psi_l``
    (``plot_errorVSsnr.m:74-78``)."""
    A = W_c.conj().T @ ch.Dr
    B = jnp.einsum("gn,lnt->lgt", ch.Dt.conj().T, Psi)
    L, Gt, T = B.shape
    return A, B.reshape(L * Gt, T)


def _system_realization(key, pc: PointConfig, noise_var, H_ext=None):
    """Channel + training + noise + analog combiner for one realization —
    the frontend shared by every estimator branch
    (``plot_errorVSsnr.m:57-73``)."""
    k_ch, k_tr, k_n, k_bf = (
        prng.role_key(key, prng.ROLE_CHANNEL),
        prng.role_key(key, prng.ROLE_TRAINING),
        prng.role_key(key, prng.ROLE_NOISE),
        prng.role_key(key, prng.ROLE_BEAMFORMER),
    )
    if H_ext is not None:
        ch = channel_from_taps(H_ext, pc.Gr, pc.Gt)
    else:
        ch = wideband_mmwave_channel(
            k_ch, pc.L, pc.Nr, pc.Nt, pc.n_clusters, pc.n_rays, pc.Gr, pc.Gt,
            quirks=pc.channel_quirks,
        )
    Psi = qam4_training_frames(k_tr, pc.Nt, pc.T_prop, pc.L)
    N = awgn(k_n, pc.Nr, pc.T_prop, noise_var)
    W = create_beamformer(pc.Nr, pc.beamformer, key=k_bf)
    return ch, Psi, N, W


def _proposed_frontend(key, pc: PointConfig, noise_var, H_ext=None, sys_real=None):
    """Frontend of the proposed-HBF branch: system realization →
    random-spatial-sampling observation → dictionaries → driver
    hyper-parameters (``plot_errorVSsnr.m:125-130``).  ``sys_real``:
    optional precomputed ``(ch, Psi, N, W)``."""
    ch, Psi, N, W = sys_real or _system_realization(key, pc, noise_var, H_ext)
    obs = proposed_hbf(
        prng.role_key(key, prng.ROLE_MASK), ch.H, N, Psi, pc.Mr_e, pc.Mr, W
    )
    A_p, B_p = _dictionaries(ch, obs.W_e, Psi)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    rho = rho * pc.rho_scale
    return ch, obs, A_p, B_p, tau_Y, tau_S, rho


def realization_errors(
    key, pc: PointConfig, noise_var, H_ext=None, *, clamp=True, with_zbar=False
) -> Dict[str, jnp.ndarray]:
    """Evaluate all configured estimators on one channel realization.

    Returns {method: clamped spectral NMSE vs Zbar} (plus auxiliary
    outputs for special methods).  ``noise_var`` is a traced scalar so SNR
    sweeps share one compilation.  ``H_ext``: optional externally supplied
    delay taps (L, Nr, Nt) — e.g. NYU-Wireless ray-traced channels — that
    replace the synthetic generator for this realization.  ``clamp=False``
    returns the raw (unclamped) spectral NMSE — the rate driver's
    ``log2 det`` formula consumes it (``plot_rateVSframelength.m:81``);
    ``with_zbar`` additionally returns the true beamspace channel under the
    ``"Zbar"`` key for rate/oracle post-processing.
    ``FULL_PRECISION_FAMILIES`` run with 'highest' matmul precision.
    """
    full = tuple(m for m in pc.methods if m in FULL_PRECISION_FAMILIES)
    rest = tuple(m for m in pc.methods if m not in FULL_PRECISION_FAMILIES)
    out: Dict[str, jnp.ndarray] = {}
    if rest or with_zbar:
        out.update(_realization_errors(
            key, dataclasses.replace(pc, methods=rest), noise_var, H_ext,
            clamp, with_zbar,
        ))
    if full:
        with jax.default_matmul_precision("highest"):
            out.update(_realization_errors(
                key, dataclasses.replace(pc, methods=full), noise_var, H_ext,
                clamp, False,
            ))
    return out


def _realization_errors(key, pc: PointConfig, noise_var, H_ext, clamp, with_zbar):
    clamped = clamped_nmse if clamp else nmse
    out: Dict[str, jnp.ndarray] = {}
    ch, Psi, N, W = _system_realization(key, pc, noise_var, H_ext)

    conventional = {"ls", "vamp", "omp_mmv", "omp_td"} & set(pc.methods)
    if conventional:
        # Conventional branch under the fair training budget T_hbf
        # (`plot_errorVSsnr.m:73-78`).
        Th = pc.T_hbf
        Y_c, W_c = hbf(ch.H, N[:, :Th], Psi[:, :, :Th], pc.Nr, W)
        A_c, B_c = _dictionaries(ch, W_c, Psi[:, :, :Th])
        if "ls" in pc.methods:
            out["ls"] = clamped(ls_estimate(Y_c, A_c, B_c), ch.Zbar)
        if "vamp" in pc.methods:
            nv = noise_var if pc.vamp_true_noise else 1.0
            if pc.vamp_normal_eq:
                # vec(Y·Bᴴ) = vec(A·X·(B·Bᴴ)): the reference's Phi operator
                # in matrix form, still kron-free (plot_errorVSsnr.m:79-80).
                S_vamp = vamp_mmwave(
                    Y_c @ B_c.conj().T, A_c, B_c @ B_c.conj().T, nv,
                    pc.num_nonzero, nit=pc.vamp_nit, damp=pc.vamp_damp,
                )
            else:
                S_vamp = vamp_mmwave(
                    Y_c, A_c, B_c, nv, pc.num_nonzero, nit=pc.vamp_nit,
                    damp=pc.vamp_damp,
                )
            out["vamp"] = clamped(S_vamp, ch.Zbar)
        if "omp_mmv" in pc.methods:
            # spx joint OMP on Y·pinv(B) (`plot_errorVSsnr.m:116-118`).
            # The reference passes numOfnz=100 > Gr=32 atoms; spx saturates
            # at the atom count, making MMV-OMP == LS (their committed fig
            # curves are identical) — reproduced by clamping to Gr.
            V = Y_c @ jnp.linalg.pinv(B_c)
            S_omp = omp_mmv(A_c, V, min(pc.num_nonzero, pc.Gr)).x
            out["omp_mmv"] = clamped(S_omp, ch.Zbar)
        if "omp_td" in pc.methods:
            # the figure legends' non-saturating "TD-OMP [11]": single OMP
            # over the implicit kron dictionary with numOfnz atoms
            k = min(pc.num_nonzero, pc.Gr * pc.L * pc.Gt)
            S_td = omp_td(A_c, B_c, Y_c, k).x
            out["omp_td"] = clamped(S_td, ch.Zbar)

    proposed_like = {
        "proposed", "proposed_angles", "svt", "tssr", "mc_admm"
    } & set(pc.methods)
    if proposed_like:
        _, obs, A_p, B_p, tau_Y, tau_S, rho = _proposed_frontend(
            key, pc, noise_var, H_ext, sys_real=(ch, Psi, N, W)
        )
        if "proposed" in pc.methods:
            res = proposed_admm(
                obs.Y, obs.Omega, A_p, B_p, pc.Imax, tau_Y, tau_S, rho,
                mode=pc.admm_mode, svt_method=pc.svt_method,
                track_rounds=pc.track_rounds,
                track_precision=pc.track_precision,
            )
            out["proposed"] = clamped(res.S, ch.Zbar)
        if "svt" in pc.methods or "tssr" in pc.methods:
            # SVT matrix completion of the masked observation, then LS
            # de-mixing / joint OMP with 2·nnz atoms — the SVT/TSSR baselines
            # of the commented blocks `plot_errorVSsnr.m:148-163` (which feed
            # the ADMM's completed Y into mc_svt; here the actual masked
            # observation is completed, which is what SVT-MC is defined on).
            Y_svt = mc_svt(
                obs.Y, obs.Omega, pc.Imax, tau_Y, 0.1,
                # thread the configured inner SVT through so A/B runs
                # compare like with like
                svt_method=pc.svt_method,
                track_rounds=pc.track_rounds,
                track_precision=pc.track_precision,
            )
            if "svt" in pc.methods:
                S_svt = ls_estimate(Y_svt, A_p, B_p)
                out["svt"] = clamped(S_svt, ch.Zbar)
            if "tssr" in pc.methods:
                V = Y_svt @ jnp.linalg.pinv(B_p)
                S_tssr = omp_mmv(A_p, V, min(2 * pc.num_nonzero, pc.Gr)).x
                out["tssr"] = clamped(S_tssr, ch.Zbar)
        if "mc_admm" in pc.methods:
            # ADMM matrix completion of the masked observation
            # (``mc_admm.m``), then LS de-mixing
            X_mc, _ = mc_admm(
                obs.Y_full, obs.Y, obs.Omega, pc.Imax, tau_Y, rho,
                svt_method=pc.svt_method, track_rounds=pc.track_rounds,
                track_precision=pc.track_precision,
            )
            out["mc_admm"] = clamped(ls_estimate(X_mc, A_p, B_p), ch.Zbar)
        if "proposed_angles" in pc.methods:
            indx = jnp.argsort(-jnp.abs(ch.Zbar).reshape(-1))
            res_a = proposed_admm_angles(
                obs.Y, obs.Omega, indx, A_p, B_p, pc.Imax, tau_Y, tau_S, rho,
                mode=pc.admm_mode, svt_method=pc.svt_method,
                track_rounds=pc.track_rounds,
                track_precision=pc.track_precision,
            )
            out["proposed_angles"] = clamped(res_a.S, ch.Zbar)

    if with_zbar:
        out["Zbar"] = ch.Zbar
    return out

