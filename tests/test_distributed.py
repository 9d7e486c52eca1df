"""Multi-process distributed backend (SURVEY.md §2.6 "Communication
backend"; reference analog: the MATLAB PCT process pool behind
``plot_errorVSsnr_approx.m:41``'s ``parfor``).

Launches REAL ``jax.distributed`` processes (2 workers × 1 CPU device,
coordinator on localhost) through the same launcher/worker pair the
scaling artifact uses, and asserts the cross-process-aggregated NMSE is
identical to the single-process runner's.
"""
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.slow


def test_two_process_sweep_matches_single_process(tmp_path):
    from jstsp19.parallel.launch import launch

    out = tmp_path / "dist.json"
    launch(
        2,
        [
            "-m", "jstsp19.parallel.dist_worker",
            "--methods", "ls,proposed",
            "--imax", "10",
            "--n-mc", "8",
            "--noise-vars", "0.1,0.5",
            "--out", str(out),
        ],
        devices_per_process=2,  # process-spanning mesh with >1 local device
        timeout=280,
        cwd=REPO,
    )
    res = json.loads(out.read_text())
    assert res["num_processes"] == 2
    assert res["num_devices"] == 4

    # single-process oracle: identical keys -> identical realizations ->
    # the cross-process all-gather must reproduce the same means
    from jstsp19.harness.pipeline import PointConfig
    from jstsp19.harness.runner import run_point

    pc = PointConfig(methods=("ls", "proposed"), Imax=10, svt_method="tracked")
    for i, nv in enumerate([0.1, 0.5]):
        ref = run_point(pc, nv, 8, seed=0, sweep_index=i)
        for m in ("ls", "proposed"):
            assert np.isclose(
                res["curves"][m][i], float(np.mean(ref[m])), rtol=1e-4
            ), (m, i)


def test_hybrid_mesh_spans_processes(tmp_path):
    """SURVEY §7.8's 'mesh = (hosts x chips)': the (dp, sp, tp) sharded
    ADMM step runs over meshes whose axes SPAN process boundaries — both
    the production layout (dp across processes; solver collectives stay
    intra-process) and the stress layout (sp across processes; every
    ADMM iteration's Gram psum crosses Gloo) must match the unsharded
    single-device reference (asserted inside the workers, rc != 0 on
    failure)."""
    import json

    from jstsp19.parallel.launch import launch

    out = tmp_path / "hybrid.json"
    launch(
        2,
        ["-m", "jstsp19.parallel.dist_hybrid", "--out", str(out)],
        devices_per_process=2,
        timeout=280,
        cwd=REPO,
    )
    res = json.loads(out.read_text())
    assert res["ok"]
    assert res["dp_across_processes"]["max_abs_dS"] < 2e-4
    assert res["sp_across_processes"]["max_abs_dS"] < 2e-4
