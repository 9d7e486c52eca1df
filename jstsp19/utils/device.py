"""Which device a measurement ran on.

Every timing this repository prints names its device: JAX's platform,
``device_kind`` and device count, and, on an NVIDIA card, the card's name
and power limit as ``nvidia-smi`` reports them (a card set below its
maximum power limit runs slower under load).
"""
from __future__ import annotations

import subprocess
from typing import Dict


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` (one card per ``;``),
    or ``"nvidia-smi unavailable"``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def device_report() -> Dict[str, object]:
    """Platform, kind and count of JAX's devices, plus the card line."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "card": card_info(),
    }


def require_gpu(allow_cpu: bool) -> Dict[str, object]:
    """The device report, or SystemExit unless JAX runs on a GPU.  A
    benchmark that finds no GPU refuses to report instead of timing the
    CPU; ``allow_cpu`` (an explicit ``--cpu``) is the only way past."""
    rep = device_report()
    if rep["platform"] != "gpu" and not allow_cpu:
        raise SystemExit(
            f"no GPU: JAX runs on {rep['platform']!r} ({rep['kind']}); "
            "pass --cpu to time the CPU explicitly"
        )
    return rep
