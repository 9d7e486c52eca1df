"""Multi-process launcher for the jax.distributed backend.

The host-side analog of starting the reference's MATLAB PCT pool
(``parpool`` before `plot_errorVSsnr_approx.m:41`'s ``parfor``): spawn N
worker processes on this host, hand each its rank and the coordinator
address through the ``JSTSP19_DIST_*`` env protocol, and wait.  Workers
call ``jstsp19.parallel.distributed.initialize_from_env()`` first
thing, then run the SAME SPMD program (collective sweep) — across several
hosts the identical workers are started by the cluster scheduler instead of
this launcher, with nothing else changed.  Workers are CPU processes: on a
GPU host one process drives every card (``harness.runner.default_mesh``),
and workers are never started several to a card.

CLI (everything after ``--`` is passed to ``python`` of each worker)::

    python -m jstsp19.parallel.launch -n 2 -d 1 -- \
        -m jstsp19.parallel.distributed --methods ls --out out.json
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

from jstsp19.parallel.distributed import (
    ENV_COORD,
    ENV_LOCAL_DEVICES,
    ENV_NPROC,
    ENV_PID,
    ENV_PIN,
)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(
    num_processes: int,
    python_args: Sequence[str],
    devices_per_process: int = 1,
    pin_cores: bool = False,
    env_extra: Optional[Dict[str, str]] = None,
    timeout: Optional[float] = 600,
    cwd: Optional[str] = None,
) -> List[subprocess.CompletedProcess]:
    """Spawn ``num_processes`` workers of ``python <python_args...>`` and
    wait for all; raises RuntimeError if any worker fails.

    ``pin_cores=True`` gives each worker a disjoint 1/N slice of the
    host's cores (see ``initialize_from_env``) so N-process throughput
    measures orchestration cost, not core oversubscription.
    """
    port = free_port()
    env_base = dict(os.environ)
    # workers size their device count via jax_num_cpu_devices; an inherited
    # --xla_force_host_platform_device_count (e.g. from tests/conftest.py)
    # would conflict with it
    xla_flags = " ".join(
        f
        for f in env_base.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    if xla_flags:
        env_base["XLA_FLAGS"] = xla_flags
    else:
        env_base.pop("XLA_FLAGS", None)
    env_base.update(env_extra or {})
    procs, spools = [], []
    for pid in range(num_processes):
        env = dict(
            env_base,
            **{
                ENV_COORD: f"127.0.0.1:{port}",
                ENV_NPROC: str(num_processes),
                ENV_PID: str(pid),
                ENV_LOCAL_DEVICES: str(devices_per_process),
            },
        )
        if pin_cores:
            env[ENV_PIN] = "1"
        # spool worker output to a temp FILE, not a pipe: a worker that
        # fills a 64 KB pipe while the launcher waits on an earlier
        # worker would block mid-collective and deadlock the SPMD program
        spool = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
        spools.append(spool)
        procs.append(
            subprocess.Popen(
                [sys.executable, *python_args],
                env=env,
                cwd=cwd,
                stdout=spool,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    done, failed = [], []
    for pid, p in enumerate(procs):
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for pid, (p, spool) in enumerate(zip(procs, spools)):
        spool.seek(0)
        out = spool.read()
        spool.close()
        done.append(subprocess.CompletedProcess(p.args, p.returncode, out, None))
        if p.returncode != 0:
            failed.append((pid, p.returncode, out))
    if failed:
        msgs = "\n".join(
            f"--- worker {pid} rc={rc} ---\n{out[-4000:]}" for pid, rc, out in failed
        )
        raise RuntimeError(f"{len(failed)} worker(s) failed:\n{msgs}")
    return done


def main(argv=None) -> None:
    import argparse

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, worker_args = argv[:split], argv[split + 1 :]
    else:
        worker_args = []
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("-d", "--devices-per-process", type=int, default=1)
    ap.add_argument("--pin", action="store_true", help="pin each worker to a disjoint core slice")
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args(argv)
    if not worker_args:
        ap.error("no worker command; pass it after `--`")
    results = launch(
        args.num_processes,
        worker_args,
        devices_per_process=args.devices_per_process,
        pin_cores=args.pin,
        timeout=args.timeout,
    )
    for i, r in enumerate(results):
        sys.stdout.write(f"===== worker {i} =====\n{r.stdout}")


if __name__ == "__main__":
    main()
