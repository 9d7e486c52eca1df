"""End-to-end tests of the proposed ADMM estimator on the actual
measurement model (channel → proposed HBF → recovery)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.channel import wideband_mmwave_channel
from jstsp19.core.metrics import clamped_nmse
from jstsp19.frontend import (
    create_beamformer,
    qam4_training_frames,
    awgn,
    proposed_hbf,
)
from jstsp19.solvers import (
    proposed_admm,
    proposed_admm_angles,
    admm_hyperparams,
    ls_estimate,
)


def _setup(key, snr_db=10.0, Nt=4, Nr=16, Mr_e=16, Mr=4, L=2, T=20):
    Gr, Gt = Nr, Nt
    ch = wideband_mmwave_channel(key, L, Nr, Nt, 2, 3, Gr, Gt)
    T_prop = T * Nt
    noise_var = 10 ** (-snr_db / 10)
    Psi = qam4_training_frames(jax.random.fold_in(key, 1), Nt, T_prop, L)
    N = awgn(jax.random.fold_in(key, 2), Nr, T_prop, noise_var)
    W = create_beamformer(Nr, "ZC")
    obs = proposed_hbf(jax.random.fold_in(key, 3), ch.H, N, Psi, Mr_e, Mr, W)
    A = obs.W_e.conj().T @ ch.Dr  # (Mr_e, Gr)
    B = jnp.concatenate(
        [ch.Dt.conj().T @ Psi[l] for l in range(L)], axis=0
    )  # (L*Gt, T_prop)
    return ch, obs, A, B


# The exact LS solve needs a denser sampling mask to be well-posed — the
# reference exercises 'std' only at sub-sampling ratio 0.75
# (plot_errorVSsnr_approx.m:46), vs Mr/Mr_e = 1/8 for 'approximate'.
@pytest.mark.parametrize("mode,Mr", [("approximate", 4), ("exact", 12)])
def test_proposed_admm_beats_trivial(key, mode, Mr):
    ch, obs, A, B = _setup(key, snr_db=15.0, Mr=Mr)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    res = proposed_admm(obs.Y, obs.Omega, A, B, 50, tau_Y, tau_S, rho, mode=mode)
    err = float(clamped_nmse(res.S, ch.Zbar))
    assert err < 0.5, err
    # the completed observation Y should approximate the unmasked frame
    y_err = np.sum(np.abs(np.asarray(res.Y - obs.Y_full)) ** 2) / np.sum(
        np.abs(np.asarray(obs.Y_full)) ** 2
    )
    assert y_err < 0.5


def test_proposed_admm_angles_improves(key):
    ch, obs, A, B = _setup(key, snr_db=10.0)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    base = proposed_admm(obs.Y, obs.Omega, A, B, 50, tau_Y, tau_S, rho)
    indx = jnp.argsort(-jnp.abs(ch.Zbar).reshape(-1))
    ang = proposed_admm_angles(obs.Y, obs.Omega, indx, A, B, 50, tau_Y, tau_S, rho)
    e_base = float(clamped_nmse(base.S, ch.Zbar))
    e_ang = float(clamped_nmse(ang.S, ch.Zbar))
    assert e_ang <= e_base * 1.5  # oracle support should not hurt much
    assert e_ang < 0.5


def test_convergence_history_decreases(key):
    ch, obs, A, B = _setup(key, snr_db=10.0)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    res = proposed_admm(
        obs.Y, obs.Omega, A, B, 60, tau_Y, tau_S, rho,
        track_convergence=True, conv_norm="fro",
    )
    conv = np.asarray(res.convergence)
    assert conv.shape == (60, 3)
    # primal residual eps1 decays by orders of magnitude (reference
    # errorVSadmmiters behavior: 1.4e-2 -> ~1e-10 by iter 70)
    assert conv[-1, 0] < conv[5, 0]
    assert np.all(np.isfinite(conv))


def test_admm_vmaps(key):
    ch, obs, A, B = _setup(key, snr_db=10.0)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    Ys = jnp.stack([obs.Y, obs.Y])
    Oms = jnp.stack([obs.Omega, obs.Omega])
    f = jax.vmap(
        lambda y, om: proposed_admm(y, om, A, B, 10, tau_Y, tau_S, rho).S
    )
    out = f(Ys, Oms)
    assert out.shape == (2,) + ch.Zbar.shape
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(out[1]), atol=1e-5)


def test_ls_estimate_square_identity(key):
    # With invertible A (square) and fat B, LS recovers S from noiseless Y.
    k1, k2, k3 = jax.random.split(key, 3)
    A = jax.random.normal(k1, (8, 8)) + 1j * jax.random.normal(k1, (8, 8))
    S = jax.random.normal(k2, (8, 6)) + 1j * jax.random.normal(k2, (8, 6))
    B = jax.random.normal(k3, (6, 20)) + 1j * jax.random.normal(k3, (6, 20))
    Y = A @ S @ B
    np.testing.assert_allclose(
        np.asarray(ls_estimate(Y, A, B)), np.asarray(S), atol=1e-3
    )


def test_admm_hyperparams_match_reference_recipe(key):
    ch, obs, A, B = _setup(key)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    Y = np.asarray(obs.Y, dtype=np.complex128)
    np.testing.assert_allclose(float(tau_Y), 1 / np.linalg.norm(Y, "fro") ** 2, rtol=1e-4)
    np.testing.assert_allclose(
        float(tau_S), 1 / (2 * np.linalg.norm(np.asarray(ch.Zbar), "fro") ** 2), rtol=1e-4
    )
    ev = np.linalg.eigvalsh(Y.conj().T @ Y)
    ref_rho = np.sqrt(ev[-6] / np.linalg.norm(Y, "fro") ** 2)
    np.testing.assert_allclose(float(rho), ref_rho, rtol=1e-3)


def test_admm_warm_restart_continuation(key):
    # 60 iterations == 30 + 30-with-warm-start (the GAMP `state` warm-start
    # pattern, BiGAMP.m:1-2 / test/warmStart)
    ch, obs, A, B = _setup(key, snr_db=10.0)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    full = proposed_admm(obs.Y, obs.Omega, A, B, 60, tau_Y, tau_S, rho)
    half = proposed_admm(obs.Y, obs.Omega, A, B, 30, tau_Y, tau_S, rho)
    resumed = proposed_admm(
        obs.Y, obs.Omega, A, B, 30, tau_Y, tau_S, rho, init_state=half.state
    )
    np.testing.assert_allclose(
        np.asarray(resumed.S), np.asarray(full.S), atol=2e-5
    )


def test_admm_jacobi_svt_matches_eigh(key):
    ch, obs, A, B = _setup(key, snr_db=10.0)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    r_e = proposed_admm(obs.Y, obs.Omega, A, B, 50, tau_Y, tau_S, rho)
    r_j = proposed_admm(
        obs.Y, obs.Omega, A, B, 50, tau_Y, tau_S, rho, svt_method="jacobi"
    )
    e_e = float(clamped_nmse(r_e.S, ch.Zbar))
    e_j = float(clamped_nmse(r_j.S, ch.Zbar))
    assert abs(e_e - e_j) < 0.02, (e_e, e_j)


def test_tracked_svt_matches_eigh_end_to_end(key):
    """svt_method='tracked' (warm-started spectral tracking, 8 Jacobi
    rounds per iteration) must match the eigh-based ADMM's NMSE on the
    canonical configuration."""
    from jstsp19.harness.pipeline import PointConfig, realization_errors
    from jstsp19.core import prng as _prng

    keys = _prng.realization_keys(_prng.experiment_key(0), 0, 4)
    nv = jnp.asarray(1.0, jnp.float32)  # 0 dB
    res = {}
    for m_ in ("eigh", "tracked"):
        pc = PointConfig(methods=("proposed",), svt_method=m_)
        out = jax.vmap(lambda k: realization_errors(k, pc, nv))(keys)
        res[m_] = np.asarray(out["proposed"])
    np.testing.assert_allclose(res["tracked"], res["eigh"], atol=5e-3)


def test_tracked_svt_single_round_matches_eigh():
    """track_rounds=1 — the throughput setting — must stay
    per-realization-identical to eigh-SVT: the warm-started basis needs
    only one parallel-ordering rotation round per ADMM iteration at the
    canonical config (measured <= 8e-6 across SNR/quirks/angles)."""
    from jstsp19.harness.pipeline import PointConfig, realization_errors
    from jstsp19.core import prng as _prng

    keys = _prng.realization_keys(_prng.experiment_key(0), 0, 4)
    for snr_db in (-9.0, 9.0):
        nv = jnp.asarray(10 ** (-snr_db / 10), jnp.float32)
        res = {}
        for m_, tr in (("eigh", 8), ("tracked", 1)):
            pc = PointConfig(
                methods=("proposed", "proposed_angles"),
                svt_method=m_, track_rounds=tr,
            )
            res[m_] = jax.vmap(lambda k: realization_errors(k, pc, nv))(keys)
        for meth in ("proposed", "proposed_angles"):
            np.testing.assert_allclose(
                np.asarray(res["tracked"][meth]),
                np.asarray(res["eigh"][meth]),
                atol=1e-4,
            )


def test_tracked_svt_thin_side_flip_matches_eigh():
    """N > M observations (the nrf driver's T=5: 32×20) run the tracked
    chain on the transpose — SVT(Xᵀ)ᵀ == SVT(X) exactly — and must match
    the eigh-SVT solver per realization (round-4 fix; previously raised)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jstsp19.core import prng
    from jstsp19.harness.pipeline import PointConfig, realization_errors

    nv = jnp.asarray(10 ** (-5 / 10), jnp.float32)
    keys = prng.realization_keys(prng.experiment_key(0), 0, 4)
    outs = {}
    for svt in ("eigh", "tracked"):
        pc = PointConfig(Mr=16, T=5, methods=("proposed",), svt_method=svt)
        outs[svt] = np.asarray(
            jax.jit(jax.vmap(lambda k: realization_errors(k, pc, nv)))(keys)[
                "proposed"
            ]
        )
    np.testing.assert_allclose(outs["tracked"], outs["eigh"], atol=5e-4)


def test_admm_tracked_warm_restart_exact(key):
    """Chunked resume with svt_method='tracked' must be BIT-exact vs one
    run: the AdmmState now carries the warm eigenbasis U and the global
    iteration count (rotation-schedule phase) — round 5; previously the
    basis silently restarted at identity against a settled iterate."""
    ch, obs, A, B = _setup(key, snr_db=10.0)
    tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar)
    kw = dict(svt_method="tracked", track_precision="highest")
    full = proposed_admm(obs.Y, obs.Omega, A, B, 60, tau_Y, tau_S, rho, **kw)
    half = proposed_admm(obs.Y, obs.Omega, A, B, 30, tau_Y, tau_S, rho, **kw)
    assert half.state.U is not None
    assert int(half.state.it) == 30
    resumed = proposed_admm(
        obs.Y, obs.Omega, A, B, 30, tau_Y, tau_S, rho,
        init_state=half.state, **kw,
    )
    np.testing.assert_allclose(
        np.asarray(resumed.S), np.asarray(full.S), atol=1e-6
    )
