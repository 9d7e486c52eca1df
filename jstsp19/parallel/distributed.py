"""Multi-process distributed backend (SURVEY.md §2.6 "Communication backend").

The reference's one real parallelism is a MATLAB PCT *process pool* —
``parfor`` over Monte-Carlo realizations (`plot_errorVSsnr_approx.m:41`)
with a shared-memory reduction (`mean(error_*)`).  The JAX analog is
``jax.distributed``: N Python processes, each owning its process-local
devices, joined into ONE SPMD program over a global device mesh.  Cross-
process reductions ride XLA collectives (Gloo between CPU processes).

This launcher is the CPU process-pool model: N local CPU processes on one
host (what the tests and the scaling artifact exercise).  On a GPU host
one process drives every card through the single-process ``mc`` mesh
(``harness.runner.default_mesh``); workers are never started several to a
card, since each JAX process reserves most of a card's memory.

Protocol: the launcher (``parallel/launch.py``) spawns N workers with
``JSTSP19_DIST_*`` env vars -> each worker calls :func:`initialize_from_env`
BEFORE any other JAX work -> all workers enter the same jitted computation
on a global ``mc`` mesh (:func:`distributed_run_point`) -> the replicated
output forces the cross-process all-gather -> process 0 writes artifacts.

Run a worker standalone under the launcher::

    python -m jstsp19.parallel.launch -n 2 -- \
        -m jstsp19.parallel.distributed --methods ls,proposed --out r.json
"""
from __future__ import annotations

import functools
import json
import os
import time
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# env-var protocol shared with parallel/launch.py
ENV_COORD = "JSTSP19_DIST_COORD"
ENV_NPROC = "JSTSP19_DIST_NPROC"
ENV_PID = "JSTSP19_DIST_PID"
ENV_LOCAL_DEVICES = "JSTSP19_DIST_LOCAL_DEVICES"
ENV_PIN = "JSTSP19_DIST_PIN"
ENV_PIN_CORES = "JSTSP19_DIST_PIN_CORES"


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: int = 1,
    platform: str = "cpu",
) -> None:
    """Join this process to the distributed system.

    Must run before any other JAX work (backend initialization fixes the
    platform).  ``platform='cpu'`` forces the host backend with
    ``local_device_count`` virtual devices per process.
    """
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", max(1, local_device_count))
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def initialize_from_env() -> int:
    """Worker-side entry: read the launcher's env protocol and join.

    Returns this worker's process id.  With ``JSTSP19_DIST_PIN=1`` the
    process additionally pins itself to an equal, disjoint slice of the
    host's cores (process_id-th of num_processes slices) so the host-
    scaling measurement partitions hardware instead of oversubscribing it.
    """
    coord = os.environ[ENV_COORD]
    nproc = int(os.environ[ENV_NPROC])
    pid = int(os.environ[ENV_PID])
    ndev = int(os.environ.get(ENV_LOCAL_DEVICES, "1"))
    if os.environ.get(ENV_PIN) and hasattr(os, "sched_setaffinity"):
        cores = sorted(os.sched_getaffinity(0))
        # JSTSP19_DIST_PIN_CORES fixes the per-process slice width (so a
        # 1-process baseline gets the same hardware as each of N workers
        # in a weak-scaling comparison); default = equal split.
        per = int(os.environ.get(ENV_PIN_CORES, "0")) or len(cores) // nproc
        if per >= 1 and pid * per < len(cores):
            os.sched_setaffinity(0, set(cores[pid * per : (pid + 1) * per]))
    initialize(coord, nproc, pid, local_device_count=ndev)
    return pid


def global_mc_mesh() -> Mesh:
    """One-axis ``mc`` mesh over ALL processes' devices (the distributed
    form of ``harness.runner.default_mesh``)."""
    return Mesh(np.array(jax.devices()), ("mc",))


def _global_key_data(root, sweep_index: int, n_mc: int, mesh: Mesh):
    """Sharded global array of raw PRNG key data for one sweep point.

    Keys are made on the host as uint32 key *data* (typed key arrays can't
    cross ``make_array_from_callback``) and re-wrapped inside jit; every
    process computes the same full table and contributes only the rows the
    callback asks for, so realization streams are identical to the single-
    process runner's regardless of process count or device order.
    """
    from jstsp19.core import prng

    keys = prng.realization_keys(root, sweep_index, n_mc)
    kd = np.asarray(jax.random.key_data(keys))
    sh = NamedSharding(mesh, P("mc"))
    return jax.make_array_from_callback(kd.shape, sh, lambda idx: kd[idx])


@functools.lru_cache(maxsize=None)
def _compiled_dist_point(pc, mesh: Mesh):
    """Jitted global-SPMD sweep point: (key_data, noise_var) ->
    {method: (n_mc,) errors}, output REPLICATED across processes — the
    replication is the cross-process all-gather that stands in for the
    reference's shared-memory ``parfor`` reduction."""
    from jstsp19.harness.pipeline import realization_errors

    repl = NamedSharding(mesh, P())

    @functools.partial(jax.jit, out_shardings=repl)
    def run(key_data, noise_var):
        keys = jax.random.wrap_key_data(key_data)
        return jax.vmap(lambda k: realization_errors(k, pc, noise_var))(keys)

    return run


def distributed_run_point(
    pc,
    noise_var: float,
    n_mc: int,
    seed: int = 0,
    sweep_index: int = 0,
    mesh: Optional[Mesh] = None,
) -> Dict[str, np.ndarray]:
    """Multi-process twin of ``harness.runner.run_point``: same keys, same
    per-realization pipeline, MC axis sharded over every device of every
    process.  All processes must call this collectively (SPMD); each
    returns the full per-realization error arrays."""
    from jstsp19.core import prng

    mesh = mesh or global_mc_mesh()
    n_dev = mesh.devices.size
    if n_mc % n_dev:
        raise ValueError(f"n_mc={n_mc} must divide over {n_dev} global devices")
    kd = _global_key_data(prng.experiment_key(seed), sweep_index, n_mc, mesh)
    out = _compiled_dist_point(pc, mesh)(kd, jnp.asarray(noise_var, jnp.float32))
    return {m: np.asarray(v) for m, v in out.items()}


def distributed_run_sweep(
    name: str,
    sweep_name: str,
    sweep_values: Sequence[float],
    point_fn,
    noise_fn,
    n_mc: int,
    seed: int = 0,
    mesh: Optional[Mesh] = None,
) -> Dict:
    """Collective sweep: every process walks the same sweep points; the
    aggregated curves come out identical on every process (process 0 is
    the conventional artifact writer)."""
    mesh = mesh or global_mc_mesh()
    t0 = time.time()
    curves: Dict[str, list] = {}
    for i, val in enumerate(sweep_values):
        out = distributed_run_point(
            point_fn(val), noise_fn(val), n_mc, seed=seed, sweep_index=i, mesh=mesh
        )
        for m, errs in out.items():
            curves.setdefault(m, []).append(float(np.mean(errs)))
    return {
        "experiment": name,
        "sweep": {sweep_name: [float(v) for v in sweep_values]},
        "n_mc": n_mc,
        "curves": curves,
        "seconds": time.time() - t0,
        "num_processes": jax.process_count(),
        "num_devices": len(jax.devices()),
    }


def _worker_main(argv=None) -> None:
    """Standalone worker: join via env protocol, run a (tiny) sweep, have
    process 0 write the JSON artifact.  Used by tests/test_distributed.py
    and tools/scaling_processes.py through the launcher."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--methods", default="ls,proposed")
    ap.add_argument("--imax", type=int, default=20)
    ap.add_argument("--n-mc", type=int, default=8)
    ap.add_argument("--noise-vars", default="0.1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=1, help="timed repeats of the sweep (post-warmup) for throughput")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    pid = initialize_from_env()
    from jstsp19.harness.pipeline import PointConfig

    mesh = global_mc_mesh()
    methods = tuple(args.methods.split(","))
    nvs = [float(v) for v in args.noise_vars.split(",")]

    def point_fn(_v):
        return PointConfig(methods=methods, Imax=args.imax, svt_method="tracked")

    res = distributed_run_sweep(
        "dist_worker", "noise_var", nvs, point_fn, lambda v: v,
        n_mc=args.n_mc, seed=args.seed, mesh=mesh,
    )
    if args.reps > 1:  # throughput: best sweep repeat after the compile pass
        best = float("inf")
        for _ in range(args.reps - 1):
            t0 = time.time()
            distributed_run_sweep(
                "dist_worker", "noise_var", nvs, point_fn, lambda v: v,
                n_mc=args.n_mc, seed=args.seed, mesh=mesh,
            )
            best = min(best, time.time() - t0)
        res["best_seconds"] = best
    else:
        # single pass: the only timing available includes the compile
        res["best_seconds"] = res["seconds"]
    res["throughput_est_per_s"] = args.n_mc * len(nvs) / res["best_seconds"]
    if pid == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    print(f"[dist worker {pid}] done: {res['curves']}", flush=True)


if __name__ == "__main__":
    _worker_main()
