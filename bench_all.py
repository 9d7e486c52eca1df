"""Per-estimator batched GPU throughput — the ``plot_time_comparisions.m`` analog.

The reference tic/tocs every estimator once per realization at the canonical
errorVSsnr configuration (``plot_time_comparisions.m:78-121``: LS, single
kron-dictionary OMP, VAMP, CoSaMP, MMV-OMP, proposed, proposed+angles).  On
an accelerator the production metric is batched throughput, so this runs
each estimator family as one compiled batch of Monte-Carlo realizations
(channel + frontend + solver + NMSE, exactly the bench.py methodology) and
reports estimations/second per family.  It refuses to report without a GPU
unless ``--cpu`` is passed, and every row names its device.

Artifact: results/time_comparisons_batched.json; summary table on stderr.

Run:  python bench_all.py [--batch 256] [--cpu] [--methods m1,m2,...]
"""
import argparse
import json
import os
import sys
import time

import jax

from jstsp19.utils.compile_cache import enable as _enable_cache

METHODS = (
    "ls", "vamp", "omp_mmv", "omp_td", "svt", "tssr", "mc_admm",
    "proposed", "proposed_angles",
)
# conservative single-workstation MATLAB estimate at the flagship config
# (bench.py docstring) — the denominator of every vs_matlab ratio
MATLAB_EST_PER_SEC = 1.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--cpu", action="store_true",
                   help="time the CPU explicitly (otherwise a GPU is required)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--methods", default=",".join(METHODS))
    p.add_argument("--out", default="results/time_comparisons_batched.json")
    ns = p.parse_args(argv)
    if ns.cpu:
        jax.config.update("jax_platforms", "cpu")

    from jstsp19.utils.device import require_gpu

    dev = require_gpu(allow_cpu=ns.cpu)
    # persistent compilation cache (jstsp19/utils/compile_cache.py)
    _enable_cache()

    import jax.numpy as jnp

    from jstsp19.core import prng
    from jstsp19.harness.pipeline import (
        fastest_point_config, realization_errors,
    )

    noise_var = jnp.asarray(1.0, jnp.float32)  # SNR 0 dB, as bench.py
    # partial --methods runs merge into an existing artifact
    rows = {}
    if os.path.exists(ns.out):
        try:
            with open(ns.out) as f:
                rows = json.load(f).get("methods", {})
        except (json.JSONDecodeError, OSError):
            rows = {}
    for method in ns.methods.split(","):
        pc = fastest_point_config(method)

        def run_fn(keys, nv, pc=pc, method=method):
            return jax.vmap(
                lambda k: realization_errors(k, pc, nv)
            )(keys)[method]

        run = jax.jit(run_fn)

        keys = prng.realization_keys(prng.experiment_key(0), 0, ns.batch)
        t0 = time.time()
        nmse0 = float(jnp.mean(jax.block_until_ready(run(keys, noise_var))))
        t_first = time.time() - t0
        best = float("inf")
        for r in range(ns.reps):
            keys_r = prng.realization_keys(prng.experiment_key(r + 1), 0, ns.batch)
            t1 = time.time()
            jax.block_until_ready(run(keys_r, noise_var))
            best = min(best, time.time() - t1)
        est_per_sec = ns.batch / best
        rows[method] = dict(
            est_per_sec=round(est_per_sec, 1),
            vs_matlab=round(est_per_sec / MATLAB_EST_PER_SEC, 1),
            best_batch_seconds=round(best, 4),
            first_incl_compile_s=round(t_first, 2),
            mean_nmse_0db=round(nmse0, 5),
            # per-row provenance: partial --methods runs merge into the
            # artifact, so the batch/device a row was measured at lives on
            # the row itself (top-level fields describe the LAST run only)
            batch=ns.batch,
            device=dev,
        )
        print(
            f"[bench_all] {method:16s} {est_per_sec:9.1f} est/s "
            f"(best {best:.3f}s/b{ns.batch}, first {t_first:.1f}s, "
            f"NMSE@0dB {nmse0:.4f}) platform={dev['platform']} "
            f"device={dev['kind']} count={dev['count']} card={dev['card']!r}",
            file=sys.stderr, flush=True,
        )
        payload = dict(
            batch=ns.batch,
            reps=ns.reps,
            device=dev,
            config="canonical errorVSsnr (Imax=100, paper-model ensemble, "
                   "0 dB); every SVT-bearing family (proposed*, svt, tssr, "
                   "mc_admm) runs svt_method='tracked' (ops/tracked.py)",
            matlab_reference_est_per_sec=MATLAB_EST_PER_SEC,
            note="batched throughput: one compiled batch per family "
                 "(channel+frontend+solver+NMSE), best of reps, "
                 "block_until_ready in the timed section",
            methods=rows,
        )
        with open(ns.out, "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps({"artifact": ns.out, "methods": len(rows), "device": dev}))


if __name__ == "__main__":
    main()
