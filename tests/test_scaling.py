from jstsp19.harness.pipeline import PointConfig
from jstsp19.parallel.scaling import scaling_benchmark


def test_scaling_benchmark_runs_on_virtual_mesh():
    pc = PointConfig(
        Nr=16, Mr_e=16, Gr=16, T=5, Imax=10, num_nonzero=10, methods=("proposed",)
    )
    res = scaling_benchmark(
        pc, per_device_batch=2, device_counts=[1, 2], reps=1
    )
    assert len(res["throughput"]) == 2
    assert all(t > 0 for t in res["throughput"])
    # on the virtual CPU mesh no efficiency figure is reported (the
    # devices share one host's cores) — a mechanism note replaces it
    assert "efficiency" not in res
    assert "note" in res
