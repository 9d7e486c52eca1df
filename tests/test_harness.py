"""Harness tests: small MC counts, every experiment recipe smoke-tested."""
import numpy as np
import pytest

from jstsp19.harness import PointConfig, run_sweep, get_experiment
from jstsp19.harness.runner import run_point, default_mesh


def test_run_point_all_methods():
    pc = PointConfig(
        Nr=16, Mr_e=16, Gr=16, T=10, Imax=20, num_nonzero=20, vamp_nit=30,
        methods=("ls", "vamp", "omp_mmv", "proposed", "proposed_angles", "svt", "tssr"),
    )
    out = run_point(pc, 10 ** (-10 / 10), n_mc=2)
    assert set(out) == set(pc.methods)
    for m, v in out.items():
        assert v.shape == (2,)
        assert np.all(np.isfinite(v)), m
        assert np.all(v <= 1.0 + 1e-6), m


def test_run_point_sharded_over_mesh(devices):
    mesh = default_mesh()
    assert mesh is not None and mesh.devices.size == 8
    pc = PointConfig(Nr=16, Mr_e=16, Gr=16, T=5, Imax=10, num_nonzero=10,
                     vamp_nit=10, methods=("ls", "proposed"))
    out = run_point(pc, 0.1, n_mc=8, mesh=mesh)
    out_single = run_point(pc, 0.1, n_mc=8, mesh=None)
    # sharded and unsharded runs agree exactly (same keys, same math)
    np.testing.assert_allclose(out["proposed"], out_single["proposed"], rtol=1e-4)


def test_run_sweep_snr_curve_monotone_trend():
    pc = PointConfig(Nr=16, Mr_e=16, Gr=16, T=15, Imax=30, num_nonzero=20,
                     vamp_nit=30, methods=("ls", "proposed"))
    res = run_sweep(
        "mini_snr", "snr_db", [-10, 10],
        point_fn=lambda s: pc,
        noise_fn=lambda s: 10 ** (-s / 10),
        n_mc=4, verbose=False,
    )
    assert set(res.curves) == {"ls", "proposed"}
    # high SNR should not be worse than low SNR for the proposed estimator
    assert res.curves["proposed"][1] <= res.curves["proposed"][0] + 0.05
    js = res.to_json()
    assert "mini_snr" in js


@pytest.mark.parametrize(
    "name,kw",
    [
        ("error_vs_zy", dict(n_mc=2, Imax=10)),
        ("error_vs_admmiters", dict(n_mc=2, Imax=15)),
        ("capacity", dict(n_mc=4)),
        ("energy_efficiency", dict(n_mc=4)),
        ("rank_r", dict(n_mc=2, geometries=((32, 32, 4, 2, 3),))),
        ("channel_correlation", dict()),
        ("bar3_beamspace", dict()),
    ],
)
def test_special_experiments_smoke(name, kw):
    res = get_experiment(name)(**kw)
    assert res.curves
    for k, v in res.curves.items():
        assert np.all(np.isfinite(np.asarray(v, dtype=float))), (name, k)


def test_admmiters_residual_decays():
    res = get_experiment("error_vs_admmiters")(n_mc=2, Imax=40)
    eps1 = np.asarray(res.curves["eps1"])
    assert eps1[-1] < eps1[2]


def test_run_sweep_checkpoint_resume(tmp_path):
    import json as _json

    pc = PointConfig(Nr=16, Mr_e=16, Gr=16, T=5, Imax=5, num_nonzero=5,
                     methods=("proposed",))
    kw = dict(
        sweep_name="snr_db", sweep_values=[0, 10],
        point_fn=lambda s: pc, noise_fn=lambda s: 10 ** (-s / 10),
        n_mc=2, verbose=False, checkpoint_dir=str(tmp_path),
    )
    res1 = run_sweep("ckpt_test", **kw)
    # tamper with the journal: resumed run must read it instead of recomputing
    p = tmp_path / "ckpt_test.snr_db.0.json"
    _json.dump({"proposed": 0.123}, open(p, "w"))
    res2 = run_sweep("ckpt_test", **kw)
    assert res2.curves["proposed"][0] == 0.123
    assert res2.curves["proposed"][1] == res1.curves["proposed"][1]


def test_run_sweep_orbax_checkpoint_resume(tmp_path):
    """Orbax backend: per-realization arrays round-trip and resumed means
    are bit-exact."""
    pc = PointConfig(Nr=16, Mr_e=16, Gr=16, T=5, Imax=5, num_nonzero=5,
                     methods=("proposed",))
    kw = dict(
        sweep_name="snr_db", sweep_values=[0, 10],
        point_fn=lambda s: pc, noise_fn=lambda s: 10 ** (-s / 10),
        n_mc=2, verbose=False, checkpoint_dir=str(tmp_path),
        checkpoint_backend="orbax",
    )
    res1 = run_sweep("ockpt_test", **kw)
    assert (tmp_path / "ockpt_test.snr_db.0.orbax").exists()
    res2 = run_sweep("ockpt_test", **kw)  # fully from checkpoints
    assert res2.curves["proposed"] == res1.curves["proposed"]


def test_achievable_rate_closed_form():
    """achievable_rate matches the reference's log2-det formula
    (plot_rateVSframelength.m:81) — checked against a direct slogdet on a
    random Zbar, and analytically on a diagonal one."""
    import jax.numpy as jnp

    from jstsp19.core.metrics import achievable_rate

    rng = np.random.default_rng(0)
    Z = jnp.asarray(
        rng.standard_normal((8, 12)) + 1j * rng.standard_normal((8, 12)),
        jnp.complex64,
    )
    nv, nmse, Nr = 0.1, 0.02, 32
    direct = float(
        jnp.log(
            jnp.linalg.det(
                jnp.eye(8, dtype=jnp.complex64)
                + Z @ Z.conj().T / (Nr * (nv + nmse))
            ).real
        )
        / jnp.log(2.0)
    )
    ours = float(achievable_rate(Z, nmse, nv, Nr))
    assert abs(ours - direct) < 1e-3 * max(1.0, abs(direct))
    # diagonal case: sum of scalar capacities
    d = jnp.asarray([4.0, 1.0, 0.25])
    Zd = jnp.diag(jnp.sqrt(d)).astype(jnp.complex64)
    expect = float(jnp.sum(jnp.log2(1 + d / (Nr * (nv + nmse)))))
    assert abs(float(achievable_rate(Zd, nmse, nv, Nr)) - expect) < 1e-5


def test_rate_vs_framelength_increases_with_T():
    """More training → lower NMSE → higher achievable rate (and the
    proposed estimator's ASE must dominate raw LS at the T=15 point)."""
    res = get_experiment("rate_vs_framelength")(n_mc=4)
    prop = res.curves["proposed"]
    assert prop[-1] > prop[0]
    assert res.curves["proposed"][-1] >= res.curves["ls"][-1] - 1e-6


def test_rank_r_quirks_spectra_drop_at_marker():
    """Under the quirks ensemble the tap-1 steering reuse caps the stacked
    beamspace rank at Np, so the noiseless-observation singular values must
    vanish beyond min(Np, L*Nt) — the committed fig's rank markers
    (plot_rankR.m:59-61)."""
    res = get_experiment("rank_r_quirks")(
        n_mc=2, geometries=((32, 32, 4, 2, 3),)
    )
    for L, marker in ((1, 4), (4, 6), (8, 6)):
        sv = np.asarray(res.curves[f"Nr32_Mre32_Np6_L{L}"])
        assert sv[marker] < 1e-3 * sv[0], (L, sv[:10] / sv[0])
        assert sv[marker - 1] > 1e-3 * sv[0]


def test_fastest_point_config_kernel_choices():
    """bench_all and time_comparisons share one source of truth for each
    family's fastest kernel configuration."""
    from jstsp19.harness.pipeline import fastest_point_config

    for m in ("proposed", "proposed_angles", "svt", "tssr", "mc_admm"):
        assert fastest_point_config(m).svt_method == "tracked", m
    for m in ("ls", "vamp", "omp_mmv", "omp_td"):
        assert fastest_point_config(m).svt_method == "eigh", m
        assert fastest_point_config(m).methods == (m,)


def test_t_hbf_matlab_rounding():
    """MATLAB ``round`` ties go AWAY from zero; Python's banker's rounding
    broke the fair-training budget at shipped sweep points (round 5):
    errorVSnrf's Mr=16/T=5 has T/(Nr/Mr)=2.5 -> T_hbf must be 3*Nt=12
    (MATLAB round(2.5)=3), not 8; errorVSdelays' T=20 point likewise."""
    from jstsp19.core.config import matlab_round
    from jstsp19.harness.pipeline import PointConfig

    assert matlab_round(2.5) == 3
    assert matlab_round(-2.5) == -3
    assert matlab_round(0.625) == 1
    assert PointConfig(Mr=16, T=5).T_hbf == 12
    assert PointConfig(T=20).T_hbf == 12  # 20/8 = 2.5 -> 3 taps * Nt=4
    assert PointConfig().T_hbf == 16  # canonical 35/8 = 4.375 -> 4 * 4
