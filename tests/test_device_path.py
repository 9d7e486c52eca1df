"""The GPU path's guards and checks: compile-cache placement, the removed
'pallas' SVT route, the benchmarks' refusal to time a CPU by accident,
chip_smoke.py's helpers and its failure without a GPU, and the four-card
mc-mesh comparison rehearsed on virtual CPU devices.  Tests marked ``gpu``
run the card's own checks and skip here."""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from jstsp19.harness.pipeline import PointConfig, realization_errors
from jstsp19.harness.runner import run_point
from jstsp19.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", ["env_set", "env_unset", "opted_out"])
def test_compile_cache_enable(case, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, enable() keeps JAX's directory
    and sets none; unset, it uses the fixed repo cache; JSTSP19_NO_CACHE
    turns it off."""
    updates = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setattr(compile_cache, "REPO_CACHE", str(tmp_path / "repo_cache"))
    monkeypatch.delenv("JSTSP19_NO_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    if case == "env_set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env_cache"))
        assert compile_cache.enable() == str(tmp_path / "env_cache")
        assert "jax_compilation_cache_dir" not in updates
        assert updates["jax_persistent_cache_min_compile_time_secs"] == 0.0
    elif case == "env_unset":
        assert compile_cache.enable() == str(tmp_path / "repo_cache")
        assert updates["jax_compilation_cache_dir"] == str(tmp_path / "repo_cache")
        assert os.path.isdir(tmp_path / "repo_cache")
    else:
        monkeypatch.setenv("JSTSP19_NO_CACHE", "1")
        assert compile_cache.enable() is None
        assert updates == {}


def test_run_point_rejects_pallas():
    """The fused whole-solve kernel is gone: 'pallas' raises instead of falling
    back to another route."""
    with pytest.raises(ValueError, match="svt_method"):
        run_point(PointConfig(methods=("ls",), svt_method="pallas"), 1.0, 2)


def test_proposed_admm_rejects_pallas():
    from jstsp19.solvers.admm import proposed_admm

    z = jnp.zeros((4, 6), jnp.complex64)
    with pytest.raises(ValueError, match="svt_method"):
        proposed_admm(z, jnp.ones((4, 6)), jnp.eye(4, 3, dtype=jnp.complex64),
                      jnp.eye(2, 6, dtype=jnp.complex64), 2, 1.0, 1.0, 1.0,
                      svt_method="pallas")


def _run_chip_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """On the CPU, and in a directory holding only the script, chip_smoke
    exits non-zero and prints no ok line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _run_chip_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize(
    "got,ok",
    [
        ([0.100, 0.500, 1.0], True),     # identical
        ([0.1015, 0.509, 1.0], True),    # within atol + rtol * ref
        ([0.100, 0.530, 1.0], False),    # one realization 6% off
        ([0.100, 0.500, np.nan], False),  # non-finite
        ([0.100, 0.500], False),         # shape mismatch
    ],
)
def test_compare_tolerance(got, ok):
    ref = [0.100, 0.500, 1.0]
    res = chip_smoke.compare(got, ref, atol=1e-3, rtol=2e-2, mean_rtol=5e-2)
    assert res["ok"] is ok


def test_compare_mean_tolerance():
    """Every realization inside its bound, but a biased mean fails."""
    ref = np.full(100, 0.2)
    res = chip_smoke.compare(ref * 1.015, ref, atol=1e-3, rtol=2e-2,
                             mean_rtol=5e-3)
    assert res["worst"] <= 1.0 and not res["ok"]


@pytest.mark.parametrize("shift,ok", [(0.0, True), (0.05, False)])
def test_compare_mean_paired(shift, ok):
    """The chaotic-family check: scattered per-realization differences
    pass, a shift of the mean beyond three standard errors fails."""
    rng = np.random.default_rng(0)
    ref = rng.uniform(0.1, 0.3, 256)
    got = ref + rng.normal(0.0, 0.05, 256) * (rng.random(256) < 0.5) + shift
    res = chip_smoke.compare_mean(got, ref)
    assert res["ok"] is ok
    assert chip_smoke.compare_mean(ref, ref)["ok"]


def test_last_line_contract():
    devs = jax.devices()[:4]
    line = json.loads(chip_smoke.last_line(devs))
    assert line == {
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": 4,
        },
    }


@pytest.mark.parametrize("script", ["bench", "bench_all"])
def test_benchmarks_refuse_without_gpu(script):
    mod = __import__(script)
    with pytest.raises(SystemExit) as exc:
        mod.main([])
    assert "no GPU" in str(exc.value.code)


def test_require_gpu_passes_explicit_cpu():
    from jstsp19.utils.device import require_gpu

    rep = require_gpu(allow_cpu=True)
    assert rep["platform"] == "cpu" and rep["count"] == len(jax.devices())
    assert isinstance(rep["card"], str)


def test_four_card_check_on_virtual_cpu_devices():
    """chip_smoke --four's comparison, rehearsed on a 4-device CPU mesh."""
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:4]), ("mc",))
    pc = PointConfig(Nr=16, Mr_e=16, Gr=16, T=5, Imax=10, num_nonzero=10,
                     vamp_nit=10, methods=("ls", "proposed"))
    res = chip_smoke.four_card_check(mesh, n_mc=8, pc=pc)
    assert set(res) == {f"{m} ({p})" for m in ("ls", "proposed")
                        for p in ("default", "highest")}
    assert all(r["ok"] for r in res.values()), res


def test_mc_admm_family_matches_its_composition():
    """The pipeline's mc_admm family is mc_admm completion then LS
    de-mixing on the proposed frontend."""
    from jstsp19.core import prng
    from jstsp19.core.metrics import clamped_nmse
    from jstsp19.harness.pipeline import _proposed_frontend
    from jstsp19.solvers import ls_estimate
    from jstsp19.solvers.lowrank import mc_admm

    pc = PointConfig(Nr=16, Mr_e=16, Gr=16, T=5, Imax=10, methods=("mc_admm",),
                     svt_method="tracked")
    nv = jnp.asarray(0.1, jnp.float32)

    def manual(key):
        ch, obs, A, B, tau, _, rho = _proposed_frontend(key, pc, nv)
        X, _ = mc_admm(obs.Y_full, obs.Y, obs.Omega, pc.Imax, tau, rho,
                       svt_method="tracked", track_precision=pc.track_precision)
        return clamped_nmse(ls_estimate(X, A, B), ch.Zbar)

    keys = prng.realization_keys(prng.experiment_key(0), 0, 3)
    got = jax.jit(jax.vmap(lambda k: realization_errors(k, pc, nv)["mc_admm"]))(keys)
    want = jax.jit(jax.vmap(manual))(keys)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_gpu_highest_matmul_is_float32(gpu):
    """'highest' is a full float32 product on the card; DEFAULT's error is
    reported (TF32 shows as ~1e-3)."""
    errs = chip_smoke.matmul_precision_errors(gpu)
    for dt in ("float32", "complex64"):
        assert errs[dt]["highest"] < 1e-5, errs
        assert errs[dt]["default"] < 1e-2, errs


@pytest.mark.gpu
def test_gpu_batched_linalg_matches_numpy(gpu):
    errs = chip_smoke.batched_linalg_errors(gpu)
    assert errs["eigvals"] < 1e-4, errs
    assert errs["eigh_reconstruction"] < 1e-4, errs
    assert errs["pinv"] < 1e-3, errs
