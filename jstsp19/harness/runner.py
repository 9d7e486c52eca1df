"""Sweep runner: Monte-Carlo batches under jit/vmap, optionally sharded
over a device mesh.

The reference parallelizes with a MATLAB PCT ``parfor`` over realizations
(`plot_errorVSsnr_approx.m:41`); here one compiled executable evaluates the
whole realization batch (vmap), and the batch axis is sharded over the
``mc`` mesh axis with a NamedSharding so the same code runs 1-chip or
N-chip — reduction to the curve mean happens on device.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jstsp19.core import prng
from jstsp19.harness.pipeline import PointConfig, realization_errors


@dataclasses.dataclass
class SweepResult:
    name: str
    sweep_name: str
    sweep_values: List
    curves: Dict[str, List[float]]  # method -> mean metric per sweep point
    n_mc: int
    seconds: float
    extras: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "experiment": self.name,
                "sweep": {self.sweep_name: list(map(float, self.sweep_values))},
                "n_mc": self.n_mc,
                "curves": {k: list(map(float, v)) for k, v in self.curves.items()},
                "seconds": self.seconds,
                **{k: v for k, v in self.extras.items() if _jsonable(v)},
            },
            indent=2,
        )


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


@functools.lru_cache(maxsize=None)
def _compiled_point(pc: PointConfig, with_taps: bool = False):
    """Batched, jitted evaluation of one sweep point: (keys, noise_var) →
    {method: per-realization NMSE}.  ``with_taps``: the batch also maps
    over externally supplied channel taps (n_mc, L, Nr, Nt)."""

    if with_taps:

        @jax.jit
        def run(keys, noise_var, taps):
            return jax.vmap(
                lambda k, H: realization_errors(k, pc, noise_var, H_ext=H)
            )(keys, taps)

    else:

        @jax.jit
        def run(keys, noise_var):
            return jax.vmap(lambda k: realization_errors(k, pc, noise_var))(keys)

    return run


# process-wide multi-process mode: when set (by the CLI's --distributed
# worker path or any jax.distributed program), run_point routes through
# the cross-process SPMD runner and sweep-side writes are gated to
# process 0.
_DISTRIBUTED = {"mesh": None}


def set_distributed_mesh(mesh: Optional[Mesh]) -> None:
    """Route subsequent :func:`run_point` calls through the multi-process
    backend (``parallel/distributed.py``) on ``mesh`` (a global mesh over
    every process's devices); ``None`` restores single-process mode."""
    _DISTRIBUTED["mesh"] = mesh


def default_mesh(axis: str = "mc") -> Optional[Mesh]:
    devs = jax.devices()
    if len(devs) <= 1:
        return None
    return Mesh(np.array(devs), (axis,))


def run_point(
    pc: PointConfig,
    noise_var: float,
    n_mc: int,
    seed: int = 0,
    sweep_index: int = 0,
    mesh: Optional[Mesh] = None,
    taps=None,
) -> Dict[str, np.ndarray]:
    """Evaluate one sweep point over n_mc realizations (device-sharded).

    ``taps``: optional (n_mc, L, Nr, Nt) externally supplied channels
    (NYU-Wireless ingestion) replacing the synthetic generator."""
    dmesh = _DISTRIBUTED["mesh"]
    if dmesh is not None and mesh is None:
        if taps is None:
            from jstsp19.parallel.distributed import distributed_run_point

            return distributed_run_point(
                pc, noise_var, n_mc, seed=seed, sweep_index=sweep_index,
                mesh=dmesh,
            )
        # external taps have no cross-process path; every process computes
        # the full batch redundantly (correct output on process 0, no
        # speedup)
        print(
            "[runner] distributed mode: taps point runs redundantly "
            "per process",
            flush=True,
        )
    root = prng.experiment_key(seed)
    keys = prng.realization_keys(root, sweep_index, n_mc)
    if mesh is not None:
        n_dev = mesh.devices.size
        if n_mc % n_dev:
            raise ValueError(f"n_mc={n_mc} must divide over {n_dev} devices")
        sh = NamedSharding(mesh, P(mesh.axis_names[0]))
        keys = jax.device_put(keys, sh)
        if taps is not None:
            taps = jax.device_put(taps, NamedSharding(mesh, P(mesh.axis_names[0])))
    if taps is not None:
        if taps.shape[0] != n_mc:
            raise ValueError(f"taps batch {taps.shape[0]} != n_mc {n_mc}")
        out = _compiled_point(pc, True)(
            keys, jnp.asarray(noise_var, jnp.float32), taps
        )
    else:
        out = _compiled_point(pc)(keys, jnp.asarray(noise_var, jnp.float32))
    return {k: np.asarray(v) for k, v in out.items()}


# process-wide checkpoint defaults so the CLI can enable sweep resume
# without threading kwargs through every experiment recipe
_DEFAULT_CHECKPOINT = {"dir": None, "backend": "json"}


def set_default_checkpoint(directory: Optional[str], backend: str = "json") -> None:
    """Set the checkpoint directory/backend used by every subsequent
    :func:`run_sweep` call that doesn't pass its own."""
    if backend not in ("json", "orbax"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    _DEFAULT_CHECKPOINT["dir"] = directory
    _DEFAULT_CHECKPOINT["backend"] = backend


def _orbax_checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def run_sweep(
    name: str,
    sweep_name: str,
    sweep_values: Sequence,
    point_fn: Callable[[object], PointConfig],
    noise_fn: Callable[[object], float],
    n_mc: int = 8,
    seed: int = 0,
    mesh: Optional[Mesh] = None,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_backend: Optional[str] = None,
    taps=None,
) -> SweepResult:
    """Run a full sweep: for each sweep value, build the PointConfig, run the
    MC batch, and average each method's metric (the reference's
    ``mean(error_*)`` reduction, ``plot_errorVSsnr.m:170-178``).

    ``checkpoint_dir``: if given, per-point results are journaled there and
    completed points are skipped on re-run (sweep-level resume — the
    checkpoint/resume capability the reference lacks, SURVEY.md §5).
    ``checkpoint_backend``: ``"json"`` journals per-point means;
    ``"orbax"`` checkpoints the full per-realization error arrays through
    orbax (restores reproduce the means bit-exactly and keep the raw MC
    state for re-aggregation).
    """
    import os

    checkpoint_dir = checkpoint_dir or _DEFAULT_CHECKPOINT["dir"]
    backend = checkpoint_backend or _DEFAULT_CHECKPOINT["backend"]
    ckptr = _orbax_checkpointer() if (checkpoint_dir and backend == "orbax") else None
    # multi-process runs: every process computes the same sweep (SPMD),
    # but only process 0 journals checkpoints and prints progress.
    # Checkpoint READS stay on all processes (same filesystem, same files
    # → every process skips the same completed points, keeping the
    # collective call pattern aligned).
    primary = jax.process_index() == 0
    verbose = verbose and primary

    t0 = time.time()
    curves: Dict[str, List[float]] = {}
    raw: Dict[str, List[List[float]]] = {}
    for i, val in enumerate(sweep_values):
        stem = f"{name}.{sweep_name}.{i}"
        point = None
        if checkpoint_dir and backend == "json":
            ckpt = os.path.join(checkpoint_dir, stem + ".json")
            if os.path.exists(ckpt):
                with open(ckpt) as f:
                    point = json.load(f)
        elif ckptr is not None:
            ckpt = os.path.abspath(os.path.join(checkpoint_dir, stem + ".orbax"))
            if os.path.exists(ckpt):
                restored = ckptr.restore(ckpt)
                point = {m: float(np.mean(errs)) for m, errs in restored.items()}
        if point is None:
            pc = point_fn(val)
            nv = noise_fn(val)
            out = run_point(
                pc, nv, n_mc, seed=seed, sweep_index=i, mesh=mesh, taps=taps
            )
            point = {m: float(np.mean(errs)) for m, errs in out.items()}
            for m, errs in out.items():
                raw.setdefault(m, []).append(np.asarray(errs).tolist())
            if checkpoint_dir and primary:
                os.makedirs(checkpoint_dir, exist_ok=True)
                if ckptr is not None:
                    ckptr.save(
                        os.path.abspath(os.path.join(checkpoint_dir, stem + ".orbax")),
                        {m: np.asarray(errs) for m, errs in out.items()},
                    )
                    ckptr.wait_until_finished()
                else:
                    with open(os.path.join(checkpoint_dir, stem + ".json"), "w") as f:
                        json.dump(point, f)
        for m, mean_err in point.items():
            curves.setdefault(m, []).append(mean_err)
        if verbose:
            msg = ", ".join(f"{m}={point[m]:.4g}" for m in sorted(point))
            print(f"[{name}] {sweep_name}={val}: {msg}")
    res = SweepResult(
        name=name,
        sweep_name=sweep_name,
        sweep_values=list(sweep_values),
        curves=curves,
        n_mc=n_mc,
        seconds=time.time() - t0,
    )
    # per-realization errors (when every point ran fresh): the parity
    # campaign needs the distribution, not just the mean, to bracket the
    # reference's single-draw / low-MC artifacts (PARITY.md)
    if all(len(v) == len(sweep_values) for v in raw.values()) and raw:
        res.extras["raw"] = raw
    return res
