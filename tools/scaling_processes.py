"""Multi-process host-scaling measurement (the headline scaling artifact).

Weak scaling of the jax.distributed backend on this host: N worker
processes, each pinned to the SAME number of physical cores and given the
same per-process Monte-Carlo batch, run the flagship proposed-ADMM sweep
point collectively.  Efficiency = per-process throughput at N processes /
per-process throughput at 1 process (ideal 1.0) — this isolates the cost
of cross-process orchestration (coordinator, Gloo all-gather of the
sharded error vector) from core oversubscription, which the pinning
removes by construction.

Reference analog: MATLAB PCT ``parfor`` pool scaling
(`plot_errorVSsnr_approx.m:41`); BASELINE.md's >80%-efficiency target.

Usage: ``python tools/scaling_processes.py [--out results/scaling_processes.json]``
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO) if REPO not in sys.path else None

from jstsp19.parallel.distributed import ENV_PIN_CORES  # noqa: E402
from jstsp19.parallel.launch import launch  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(REPO, "results", "scaling_processes.json"))
    ap.add_argument("--per-proc-mc", type=int, default=24)
    ap.add_argument("--imax", type=int, default=50)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--max-procs", type=int, default=0, help="0 = as many as cores allow")
    args = ap.parse_args(argv)

    n_cores = len(os.sched_getaffinity(0))
    max_procs = args.max_procs or n_cores
    counts = [n for n in (1, 2, 4, 8) if n <= max_procs]
    cores_per_proc = max(1, n_cores // counts[-1])

    rows = []
    for nproc in counts:
        n_mc = args.per_proc_mc * nproc
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "point.json")
            launch(
                nproc,
                [
                    "-m", "jstsp19.parallel.dist_worker",
                    "--methods", "proposed",
                    "--imax", str(args.imax),
                    "--n-mc", str(n_mc),
                    "--noise-vars", "0.1",
                    "--reps", str(args.reps),
                    "--out", out,
                ],
                devices_per_process=1,
                pin_cores=True,
                env_extra={ENV_PIN_CORES: str(cores_per_proc)},
                timeout=1800,
                cwd=REPO,
            )
            with open(out) as f:
                res = json.load(f)
        thr = res["throughput_est_per_s"]
        rows.append(
            {
                "num_processes": nproc,
                "n_mc": n_mc,
                "best_seconds": res["best_seconds"],
                "throughput_est_per_s": thr,
                "per_process_est_per_s": thr / nproc,
                "nmse_proposed": res["curves"]["proposed"][0],
            }
        )
        print(f"nproc={nproc}: {thr:.2f} est/s ({thr / nproc:.2f}/proc)", flush=True)

    base = rows[0]["per_process_est_per_s"]
    for r in rows:
        r["efficiency_vs_1proc"] = r["per_process_est_per_s"] / base
    result = {
        "mode": "weak scaling, fixed per-process batch, disjoint core pinning",
        "host_cores": n_cores,
        "cores_per_process": cores_per_proc,
        "per_process_mc": args.per_proc_mc,
        "imax": args.imax,
        "estimator": "proposed (tracked SVT)",
        "backend": "jax.distributed + Gloo cross-process collectives (CPU hosts)",
        "rows": rows,
        "note": (
            "Each process is pinned to a disjoint slice of "
            f"{cores_per_proc} core(s), so the efficiency column measures "
            "multi-process orchestration cost (coordinator + cross-process "
            "all-gather), not core contention. NMSE at every process count "
            "is identical to the single-process runner (tests/"
            "test_distributed.py asserts this)."
        ),
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {args.out}")
    for r in rows:
        print(
            f"  N={r['num_processes']}: eff={r['efficiency_vs_1proc']:.3f} "
            f"({r['per_process_est_per_s']:.2f} est/s/proc)"
        )


if __name__ == "__main__":
    main()
