"""Command-line entry: run experiment recipes.

Usage:
  python -m jstsp19 list
  python -m jstsp19 run error_vs_snr --n-mc 64 --seed 0 --out results
  python -m jstsp19 run all --n-mc 16
  python -m jstsp19 demo            # list the worked demos
  python -m jstsp19 demo snipe      # run one (the GUI/ analog:
                                        # an interactive demo launcher)
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="jstsp19")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list experiment recipes")
    demop = sub.add_parser(
        "demo",
        help="list / run the worked solver demos (examples/) — the "
        "capability analog of the reference's GUI demo launcher",
    )
    demop.add_argument("name", nargs="?", default=None)
    demop.add_argument("--accelerator", action="store_true",
                       help="run on JAX's default accelerator (default: CPU)")
    panelp = sub.add_parser(
        "panel",
        help="interactive parameter panel: pick a sweep point config, edit "
        "its fields, run a Monte-Carlo batch and print/plot the NMSE — the "
        "interactive analog of the reference's GUI/ parameter forms",
    )
    panelp.add_argument("--cpu", action="store_true")
    panelp.add_argument(
        "--set", action="append", default=[], metavar="FIELD=VALUE",
        help="non-interactive field override (repeatable); with --batch, "
        "skips all prompts",
    )
    panelp.add_argument("--batch", action="store_true",
                        help="no prompts: defaults + --set overrides only")
    panelp.add_argument("--n-mc", type=int, default=16)
    panelp.add_argument("--snr-db", type=float, default=0.0)
    panelp.add_argument("--out", default=None,
                        help="optional PNG path for the per-realization histogram")
    runp = sub.add_parser("run", help="run an experiment recipe")
    runp.add_argument("experiment")
    runp.add_argument("--n-mc", type=int, default=8)
    runp.add_argument("--seed", type=int, default=0)
    runp.add_argument("--out", default="results")
    runp.add_argument("--no-plot", action="store_true")
    runp.add_argument("--cpu", action="store_true", help="force the CPU backend")
    runp.add_argument(
        "--checkpoint-dir",
        default=None,
        help="journal per-point results here and resume completed points",
    )
    runp.add_argument(
        "--checkpoint-backend",
        default="json",
        choices=("json", "orbax"),
        help="json = per-point means; orbax = full per-realization arrays",
    )
    runp.add_argument(
        "--mat-path",
        default=None,
        help="NYU-Wireless channel .mat for error_vs_snr_nyuwireless",
    )
    runp.add_argument(
        "--methods",
        default=None,
        help="comma-separated estimator subset (e.g. proposed,vamp,omp_td) "
        "for recipes that accept it",
    )
    runp.add_argument(
        "--distributed",
        type=int,
        default=0,
        metavar="N",
        help="run the sweep over N jax.distributed processes on this host "
        "(CPU workers; the MC axis is sharded across process boundaries "
        "and process 0 writes the artifacts). On a GPU host, run without "
        "it: one process drives every card through the mc mesh.",
    )
    runp.add_argument(
        "--devices-per-process",
        type=int,
        default=1,
        help="virtual CPU devices per distributed worker (with --distributed)",
    )
    runp.add_argument(
        "--dist-timeout",
        type=float,
        default=None,
        metavar="SECONDS",
        help="per-worker wall-clock limit for --distributed runs "
        "(default: no limit — sweeps can run long)",
    )
    args = parser.parse_args(argv)

    if args.cmd == "run":
        import os as _os

        from jstsp19.parallel.distributed import ENV_PID

        if ENV_PID in _os.environ:
            # we are a distributed worker: join the SPMD program before any
            # other JAX work and route run_point through the global mesh
            from jstsp19.harness.runner import set_distributed_mesh
            from jstsp19.parallel.distributed import (
                global_mc_mesh,
                initialize_from_env,
            )

            initialize_from_env()
            set_distributed_mesh(global_mc_mesh())
            args.cpu = False  # platform already forced by initialize
        elif args.distributed > 0:
            # we are the launcher: spawn N workers running this same
            # command (minus the launcher flags) under the env protocol
            from jstsp19.parallel.launch import launch

            n_dev = args.distributed * args.devices_per_process
            if args.n_mc % n_dev:
                print(
                    f"--n-mc {args.n_mc} must be divisible by the "
                    f"{n_dev} global devices ({args.distributed} processes "
                    f"x {args.devices_per_process} devices); try "
                    f"--n-mc {((args.n_mc + n_dev - 1) // n_dev) * n_dev}",
                    file=sys.stderr,
                )
                return 1
            raw = list(sys.argv[1:] if argv is None else argv)
            for flag in ("--distributed", "--devices-per-process",
                         "--dist-timeout"):
                while flag in raw:
                    i = raw.index(flag)
                    del raw[i : i + 2]
            results = launch(
                args.distributed,
                ["-m", "jstsp19", *raw],
                devices_per_process=args.devices_per_process,
                timeout=args.dist_timeout,
            )
            sys.stdout.write(results[0].stdout)
            return 0

    if args.cmd == "list":
        from jstsp19.harness import EXPERIMENTS

        for name, fn in sorted(EXPERIMENTS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:28s} {doc}")
        return 0

    if args.cmd == "demo":
        # GUI-analog demo launcher (reference `GUI/` capability: browse and
        # launch per-solver demos). Demos live in examples/ as standalone
        # scripts; each takes --cpu.
        import os
        import subprocess

        ex_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "examples",
        )
        demos = sorted(
            f[:-3] for f in os.listdir(ex_dir)
            if f.endswith(".py") and not f.startswith("_")
        )
        if args.name is None:
            print("worked demos (run: python -m jstsp19 demo <name>):")
            for d in demos:
                with open(os.path.join(ex_dir, f"{d}.py")) as fh:
                    first = fh.readline().strip().strip('"').rstrip(".")
                print(f"  {d:26s} {first}")
            return 0
        if args.name not in demos:
            print(f"unknown demo {args.name!r}; run `demo` to list",
                  file=sys.stderr)
            return 1
        cmd = [sys.executable, os.path.join(ex_dir, f"{args.name}.py")]
        if args.accelerator and args.name == "large_array_sharded":
            # virtual 8-device mesh exists only on the CPU platform
            print("note: large_array_sharded is CPU-only (virtual mesh); "
                  "ignoring --accelerator", file=sys.stderr)
        if not args.accelerator:
            cmd.append("--cpu")
        return subprocess.run(cmd).returncode

    if getattr(args, "cpu", False):
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.cmd == "panel":
        return _panel(args)

    from jstsp19.harness import EXPERIMENTS
    from jstsp19.harness.artifacts import save_result

    if args.checkpoint_dir:
        from jstsp19.harness.runner import set_default_checkpoint

        set_default_checkpoint(args.checkpoint_dir, args.checkpoint_backend)

    names = (
        sorted(EXPERIMENTS) if args.experiment == "all" else [args.experiment]
    )
    for name in names:
        if name not in EXPERIMENTS:
            print(f"unknown experiment {name!r}; try `list`", file=sys.stderr)
            return 1
        kwargs = {"n_mc": args.n_mc, "seed": args.seed}
        if args.mat_path and name == "error_vs_snr_nyuwireless":
            kwargs["mat_path"] = args.mat_path
        if args.methods:
            import inspect

            if "methods" in inspect.signature(EXPERIMENTS[name]).parameters:
                kwargs["methods"] = tuple(
                    m.strip() for m in args.methods.split(",") if m.strip()
                )
            else:
                print(
                    f"[{name}] --methods not supported by this recipe; ignored",
                    file=sys.stderr,
                )
        res = EXPERIMENTS[name](**kwargs)
        import jax

        if jax.process_index() == 0:
            path = save_result(res, args.out, plot=not args.no_plot)
            print(f"[{name}] wrote {path} ({res.seconds:.1f}s)")
    return 0


def _panel(args) -> int:
    """Interactive parameter panel (the reference ``GUI/`` capability:
    browse fields, edit values, launch, view results).  Prompts for each
    PointConfig field with its default prefilled; ``--set field=value``
    overrides; ``--batch`` skips prompting entirely (scriptable/testable).
    """
    import dataclasses

    import numpy as np

    from jstsp19.harness.pipeline import PointConfig
    from jstsp19.harness.runner import run_point

    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k.strip()] = v.strip()

    values = {}
    print("sweep-point configuration (enter to keep the default):")
    for f in dataclasses.fields(PointConfig):
        default = f.default
        if f.name in overrides:
            raw = overrides[f.name]
        elif args.batch:
            raw = ""
        else:
            try:
                raw = input(f"  {f.name} [{default!r}]: ").strip()
            except EOFError:
                raw = ""
        if not raw:
            continue
        if f.name == "methods":
            values[f.name] = tuple(m.strip() for m in raw.split(",") if m.strip())
        elif isinstance(default, bool):
            values[f.name] = raw.lower() in ("1", "true", "yes", "y")
        elif isinstance(default, int):
            values[f.name] = int(raw)
        elif isinstance(default, float):
            values[f.name] = float(raw)
        else:
            values[f.name] = raw
    pc = PointConfig(**values)
    nv = float(10 ** (-args.snr_db / 10))
    print(f"running n_mc={args.n_mc} @ {args.snr_db:+.1f} dB: {pc}")
    out = run_point(pc, nv, args.n_mc)
    for m in sorted(out):
        e = np.asarray(out[m])
        print(
            f"  {m:16s} mean NMSE {e.mean():.5g}   "
            f"[q5 {np.quantile(e, 0.05):.3g}, q95 {np.quantile(e, 0.95):.3g}]"
        )
    if args.out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        for m in sorted(out):
            ax.hist(np.log10(np.maximum(np.asarray(out[m]), 1e-12)),
                    bins=24, alpha=0.5, label=m)
        ax.set_xlabel("log10 NMSE")
        ax.set_ylabel("realizations")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.out, dpi=120)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `... list | head`
        sys.exit(0)
