"""Smoke run of the Monte-Carlo estimation pipeline on one GPU.

    python chip_smoke.py [--out DIR]     # one card
    python chip_smoke.py --four          # the mc mesh over four cards

One process opens the card once and runs these phases at the canonical
errorVSsnr geometry (``PointConfig`` defaults: Nt=4, Nr=32, Gr=32, Mr_e=32,
Mr=4, L=4, T=35, Imax=100):

1. device: fail unless JAX's first device is a GPU; print the card's name
   and power limit (``nvidia-smi``), device kind and count, JAX version and
   ``XLA_FLAGS``;
2. main path: ``python -m jstsp19 run error_vs_snr --n-mc 256`` in-process,
   twice (compile + run, then steady); every curve must be finite.  Prints
   smoke timings (not benchmark numbers), the compiled memory analysis of
   one family and the device's peak memory;
3. correctness: for all nine estimator families, the per-realization NMSE
   of the path as shipped (``fastest_point_config``: tracked SVT at
   ``track_precision='default'``, VAMP and TD-OMP at 'highest', every
   other product at DEFAULT precision) against the plain reference (same
   keys, eigh SVT, every product at 'highest'), n_mc=256 at 0 dB and
   20 dB; the reference on the GPU against the same function on the CPU
   (16 realizations; VAMP, chaotic at 100 iterations, per realization at
   10 and by its mean at 100); the matmul precision DEFAULT gives on this
   card; and smoke timings of the two XLA routes of the proposed ADMM
   solve (tracked and eigh);
4. entry point: ``__graft_entry__.entry()`` compiled and run on the card.

``--four`` runs only ``run_point`` on the ``mc`` mesh over four cards at
n_mc=1024 and compares it per realization with the same keys on one card
(VAMP by its mean), at the shipped precision and at 'highest'.

The last line of standard output is the JSON object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``
(N = devices the run used); it is printed only when every phase passed.
Without a GPU, or without the repository beside this file, the script
exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SNRS_DB = (0, 20)
N_MC = 256
N_CPU = 16
N_MC_FOUR = 1024
FAMILIES = (
    "ls", "vamp", "omp_mmv", "omp_td",
    "svt", "tssr", "mc_admm", "proposed", "proposed_angles",
)

# Tolerances on per-realization NMSE (NMSE is clamped to [0, 1]).  A
# realization passes when |got - ref| <= atol + rtol * ref; a family passes
# when every realization does and the means differ by at most
# mean_rtol * mean(ref).
#
# Shipped path vs plain reference.  Two differences are allowed: the
# tracked SVT follows eigh's basis with one rotation round per iteration
# (on the CPU, where DEFAULT is full float32, it agrees with eigh to ~1e-4
# per realization), and DEFAULT-precision products (TF32 on this card:
# 10-bit mantissa, relative rounding ~5e-4 per product) against 'highest'.
# 2% of the reference NMSE is far below the spacing of the curves users
# read (a 3 dB SNR step moves NMSE by ~30-50%), and the 1e-3 floor covers
# realizations whose error is already near zero, where precision loss
# shows first.  The means must agree to 0.5%.
SHIPPED_TOL = dict(atol=1e-3, rtol=2e-2, mean_rtol=5e-3)
# The same function ('highest', eigh) on the GPU and on the CPU: only the
# libraries differ (cuSOLVER/cuBLAS vs LAPACK/Eigen), both at full float32
# precision; 100 ADMM iterations may amplify rounding differences, so the
# per-realization bound is 1e-4 + 1e-3 relative, means within 1e-3.
CPU_TOL = dict(atol=1e-4, rtol=1e-3, mean_rtol=1e-3)
# Four cards vs one card: the same program on the same keys; only the
# per-device batch differs (256 vs 1024).  With every product at 'highest'
# the two must agree to float32 rounding (MESH_TOL).  At the shipped
# DEFAULT precision cuBLAS may pick another TF32 kernel for the other batch
# size, so the TF32 rounding itself differs (first four-card run on the
# H100: up to 1.5e-3 per realization in the DEFAULT-precision families,
# VAMP at 'highest' bit-identical); that comparison is held to SHIPPED_TOL,
# the bound on TF32 rounding above.
MESH_TOL = dict(atol=1e-5, rtol=1e-4, mean_rtol=1e-5)
# VAMP's 100-iteration float32 trajectory is chaotic at this geometry:
# measured on the CPU at 'highest', a 1e-6 relative change of the noise
# variance moves per-realization NMSE by up to 0.2 at 40 and 100
# iterations (the 64-realization mean by 1-3%), but by at most 9e-7 at 10
# iterations.  No two float32 implementations agree per realization
# there, so VAMP is compared per realization at VAMP_NIT_SHORT iterations,
# where its map is still continuous, with the tolerances above; at the
# shipped 100 iterations it is held to its mean: the paired difference
# must lie within MEAN_Z standard errors of zero.
VAMP_NIT_SHORT = 10
MEAN_Z = 3.0


def compare(got, ref, *, atol, rtol, mean_rtol) -> dict:
    """Per-realization and mean agreement of two NMSE arrays (see the
    tolerances above).  ``ok`` is False for non-finite values or a shape
    mismatch."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return dict(ok=False, max_abs=np.inf, worst=np.inf, mean_rel=np.inf)
    if not (np.all(np.isfinite(got)) and np.all(np.isfinite(ref))):
        return dict(ok=False, max_abs=np.inf, worst=np.inf, mean_rel=np.inf)
    diff = np.abs(got - ref)
    # worst: largest diff as a fraction of its allowance (<= 1 passes)
    worst = float(np.max(diff / (atol + rtol * np.abs(ref))))
    mean_ref = float(np.mean(ref))
    mean_rel = abs(float(np.mean(got)) - mean_ref) / max(mean_ref, 1e-30)
    return dict(
        ok=bool(worst <= 1.0 and mean_rel <= mean_rtol),
        max_abs=float(np.max(diff)), worst=worst, mean_rel=mean_rel,
    )


def compare_mean(got, ref, *, z=MEAN_Z) -> dict:
    """Paired mean test for a chaotic family: ``|mean(got - ref)|`` within
    ``z`` standard errors of the paired differences."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape or got.size < 2 or not (
            np.all(np.isfinite(got)) and np.all(np.isfinite(ref))):
        return dict(ok=False, max_abs=np.inf, worst=np.inf, mean_rel=np.inf)
    d = got - ref
    se = float(np.std(d, ddof=1) / np.sqrt(d.size))
    bias = abs(float(np.mean(d)))
    return dict(
        ok=bool(bias <= z * se), max_abs=float(np.max(np.abs(d))),
        worst=bias / (z * se) if se > 0 else (np.inf if bias > 0 else 0.0),
        mean_rel=bias / max(float(np.mean(ref)), 1e-30),
    )


def last_line(devices) -> str:
    """The contract's last line for a run that used ``devices``."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def _report(label: str, res: dict) -> str:
    return (
        f"  {label:34s} {'ok ' if res['ok'] else 'BAD'} "
        f"max|d|={res['max_abs']:.3e} worst/tol={res['worst']:.3f} "
        f"mean_rel={res['mean_rel']:.3e}"
    )


# -- device checks (also run by the gpu-marked tests) ------------------------

def matmul_precision_errors(device, n: int = 512) -> dict:
    """Max relative error of a float32 and a complex64 matmul on ``device``
    at DEFAULT and at 'highest' precision, against float64 NumPy.  A
    DEFAULT error near 1e-3 means the card rounds float32 products to
    TF32."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    b = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    out = {}
    for name, (x, y) in {
        "float32": (a.real, b.real), "complex64": (a, b),
    }.items():
        exact = x @ y
        dt = np.float32 if name == "float32" else np.complex64
        xd = jax.device_put(x.astype(dt), device)
        yd = jax.device_put(y.astype(dt), device)
        out[name] = {}
        for prec in ("default", "highest"):
            f = jax.jit(lambda p, q, prec=prec: jnp.matmul(p, q, precision=prec))
            got = np.asarray(f(xd, yd)).astype(np.complex128)
            out[name][prec] = float(np.max(np.abs(got - exact)) / np.max(np.abs(exact)))
    return out


def batched_linalg_errors(device, batch: int = 256) -> dict:
    """Batched complex64 ``eigh`` (32x32 Hermitian Grams, the SVT's shape)
    and ``pinv`` (16x140, the TSSR de-mixing shape) on ``device`` against
    float64 NumPy: relative errors of eigenvalues, of the eigh
    reconstruction, and of the pseudo-inverse."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.standard_normal((batch, 32, 140)) + 1j * rng.standard_normal((batch, 32, 140))
    g = x @ np.conj(np.swapaxes(x, -1, -2))
    b = rng.standard_normal((batch, 16, 140)) + 1j * rng.standard_normal((batch, 16, 140))
    gd = jax.device_put(g.astype(np.complex64), device)
    bd = jax.device_put(b.astype(np.complex64), device)
    with jax.default_matmul_precision("highest"):
        w, v = jax.jit(jnp.linalg.eigh)(gd)
        rec = jax.jit(lambda w, v: (v * w[..., None, :]) @ jnp.conj(jnp.swapaxes(v, -1, -2)))(w, v)
        p = jax.jit(jnp.linalg.pinv)(bd)
    w_ref = np.linalg.eigvalsh(g)
    p_ref = np.linalg.pinv(b)
    scale = np.max(np.abs(w_ref), axis=-1)
    return {
        "eigvals": float(np.max(np.abs(np.asarray(w) - w_ref).max(-1) / scale)),
        "eigh_reconstruction": float(
            np.max(np.abs(np.asarray(rec) - g).max((-1, -2)) / scale)
        ),
        "pinv": float(
            np.max(np.abs(np.asarray(p) - p_ref).max((-1, -2))
                   / np.abs(p_ref).max((-1, -2)))
        ),
    }


# -- phases ------------------------------------------------------------------

def phase_device(four: bool):
    import jax

    from jstsp19.utils.device import card_info

    devs = jax.devices()
    card = card_info()
    print(card, flush=True)
    print(
        f"[device] card={card!r} platform={devs[0].platform} "
        f"kind={devs[0].device_kind!r} count={len(devs)} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
        flush=True,
    )
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform!r}")
    if four and len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX sees {len(devs)}")
    return devs


def phase_main_path(out_dir: str) -> None:
    import jax

    from jstsp19.__main__ import main as cli_main
    from jstsp19.core import prng
    from jstsp19.harness.pipeline import PointConfig
    from jstsp19.harness.runner import _compiled_point

    argv = ["run", "error_vs_snr", "--n-mc", str(N_MC), "--no-plot",
            "--out", out_dir]
    walls = []
    for _ in range(2):  # compile + run, then the steady run
        t0 = time.time()
        if cli_main(argv) != 0:
            raise RuntimeError("error_vs_snr run failed")
        walls.append(time.time() - t0)
    with open(os.path.join(out_dir, "error_vs_snr.json")) as f:
        res = json.load(f)
    curves = res["curves"]
    n_pts = len(res["sweep"]["snr_db"])
    want = set(PointConfig().methods)
    if set(curves) != want:
        raise RuntimeError(f"curves {sorted(curves)} != {sorted(want)}")
    for m, v in curves.items():
        if len(v) != n_pts or not np.all(np.isfinite(v)):
            raise RuntimeError(f"curve {m} not finite / wrong length: {v}")
    print(
        f"[main] error_vs_snr n_mc={N_MC} x {n_pts} SNR points, "
        f"{len(curves)} families: finite. smoke timing (not a benchmark): "
        f"first run {walls[0]:.2f} s (compile + run), steady {walls[1]:.2f} s, "
        f"compile ~{walls[0] - walls[1]:.2f} s",
        flush=True,
    )
    print("[main] NMSE at 0 dB: " + ", ".join(
        f"{m}={curves[m][res['sweep']['snr_db'].index(0.0)]:.4f}"
        for m in sorted(curves)), flush=True)
    pc = PointConfig()
    keys = prng.realization_keys(prng.experiment_key(0), 0, N_MC)
    compiled = _compiled_point(pc).lower(keys, np.float32(1.0)).compile()
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    print(f"[main] memory_analysis (5 default families, n_mc={N_MC}): " + ", ".join(
        f"{k}={getattr(ma, k, 'n/a')}" for k in fields), flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[main] peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')}",
          flush=True)


def _point(pc, nv, keys):
    from jstsp19.harness.runner import _compiled_point

    out = _compiled_point(pc)(keys, np.float32(nv))
    return {m: np.asarray(v) for m, v in out.items()}


def _configs(ref: bool):
    """The PointConfigs of phase 3, shipped or reference.
    ``realization_errors`` evaluates each family independently from the
    same key, so one config per SVT route gives the same per-family NMSE
    as ``fastest_point_config``'s one-family configs (and compiles three
    programs instead of eighteen).  The last config is VAMP cut to
    ``VAMP_NIT_SHORT`` iterations (see the tolerances above)."""
    import dataclasses

    from jstsp19.harness.pipeline import (
        TRACKED_FAMILIES, PointConfig, fastest_point_config,
    )

    short = PointConfig(methods=("vamp",), vamp_nit=VAMP_NIT_SHORT)
    if ref:
        return [PointConfig(methods=FAMILIES, svt_method="eigh"), short]
    groups = (tuple(m for m in FAMILIES if m in TRACKED_FAMILIES),
              tuple(m for m in FAMILIES if m not in TRACKED_FAMILIES))
    return [dataclasses.replace(fastest_point_config(g[0]), methods=g)
            for g in groups] + [short]


def _errors(ref: bool, keys, nv: float) -> dict:
    """Per-realization NMSE of every family on ``keys`` (plus "vamp_short");
    the reference runs every product at 'highest'."""
    import contextlib

    import jax

    out = {}
    ctx = jax.default_matmul_precision("highest") if ref else contextlib.nullcontext()
    with ctx:
        *full, short = _configs(ref)
        for pc in full:
            out.update(_point(pc, nv, keys))
        out["vamp_short"] = _point(short, nv, keys)["vamp"]
    return out


def checks(got: dict, ref: dict, tol: dict):
    """(label, comparison) per family: per realization, except VAMP at its
    full iteration count, which is held to its mean."""
    for m in FAMILIES:
        if m == "vamp":
            yield "vamp (100 it, mean)", compare_mean(got[m], ref[m])
            yield f"vamp ({VAMP_NIT_SHORT} it)", compare(
                got["vamp_short"], ref["vamp_short"], **tol)
        else:
            yield m, compare(got[m], ref[m], **tol)


def time_svt_routes(n_mc: int = N_MC, reps: int = 5) -> dict:
    """Smoke timings of the proposed ADMM solve alone (frontend excluded)
    through its two XLA routes, at the shipped precision."""
    import jax

    from jstsp19.core import prng
    from jstsp19.harness.pipeline import PointConfig, _proposed_frontend
    from jstsp19.solvers import proposed_admm

    pc = PointConfig()
    keys = prng.realization_keys(prng.experiment_key(1), 0, n_mc)

    def problem(k):
        _, obs, A, B, tY, tS, rho = _proposed_frontend(k, pc, 1.0)
        return obs.Y, obs.Omega, A, B, tY, tS, rho

    prob = jax.block_until_ready(jax.jit(jax.vmap(problem))(keys))
    out = {}
    for route in ("tracked", "eigh"):
        solve = jax.jit(jax.vmap(
            lambda y, om, a, b, ty, ts, r, route=route: proposed_admm(
                y, om, a, b, pc.Imax, ty, ts, r, svt_method=route,
                track_precision=pc.track_precision,
            ).S
        ))
        jax.block_until_ready(solve(*prob))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(solve(*prob))
            ts.append(time.perf_counter() - t0)
        out[route] = float(np.median(ts))
    return out


def phase_correctness() -> None:
    import jax

    from jstsp19.core import prng

    cpu = jax.devices("cpu")[0]
    failures = []
    for i, snr in enumerate(SNRS_DB):
        nv = 10.0 ** (-snr / 10)
        keys = prng.realization_keys(prng.experiment_key(0), 100 + i, N_MC)
        shipped = _errors(False, keys, nv)
        ref = _errors(True, keys, nv)
        with jax.default_device(cpu):
            ref_cpu = _errors(True, jax.device_put(keys[:N_CPU], cpu), nv)
        ref_16 = {m: v[:N_CPU] for m, v in ref.items()}
        print(f"[correct] {snr} dB: shipped vs eigh/'highest' reference "
              f"(n_mc={N_MC}); reference on the GPU vs the CPU (n_mc={N_CPU})",
              flush=True)
        for kind, got, want, tol in (
            ("shipped", shipped, ref, SHIPPED_TOL),
            ("gpu-vs-cpu", ref_16, ref_cpu, CPU_TOL),
        ):
            for m, res in checks(got, want, tol):
                label = f"{m} {kind}"
                print(_report(label, res), flush=True)
                if not res["ok"]:
                    failures.append(f"{label} @ {snr} dB")
    print(f"[correct] matmul precision on this card (max rel error vs "
          f"float64): {matmul_precision_errors(jax.devices()[0])}", flush=True)
    print(f"[correct] batched linalg on this card: "
          f"{batched_linalg_errors(jax.devices()[0])}", flush=True)
    t = time_svt_routes()
    print(
        "[correct] smoke timing (not a benchmark), proposed ADMM solve only, "
        f"n_mc={N_MC}, Imax=100: " + ", ".join(
            f"{r} {s * 1e3:.2f} ms/batch ({N_MC / s:.0f} est/s)"
            for r, s in t.items()),
        flush=True,
    )
    if failures:
        raise RuntimeError(f"correctness failed: {failures}")


def phase_entry() -> None:
    import jax

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    S = np.asarray(jax.block_until_ready(jax.jit(fn)(*args)))
    if S.shape != (32, 16) or not np.all(np.isfinite(S)):
        raise RuntimeError(f"entry() S shape {S.shape}, finite={np.isfinite(S).all()}")
    print(f"[entry] __graft_entry__.entry(): S{S.shape} {S.dtype} finite",
          flush=True)


def four_card_check(mesh, n_mc: int = N_MC_FOUR, pc=None) -> dict:
    """``run_point`` on ``mesh`` against the same keys on one device, at the
    shipped precision and with every product at 'highest'; returns the
    comparison per family and precision (VAMP, chaotic at 100 iterations,
    by its mean)."""
    import contextlib

    import jax

    from jstsp19.harness.pipeline import PointConfig
    from jstsp19.harness.runner import run_point

    pc = pc or PointConfig()
    out = {}
    for prec, tol in (("default", SHIPPED_TOL), ("highest", MESH_TOL)):
        ctx = (jax.default_matmul_precision("highest") if prec == "highest"
               else contextlib.nullcontext())
        with ctx:  # 0 dB
            sharded = run_point(pc, 1.0, n_mc, seed=0, mesh=mesh)
            single = run_point(pc, 1.0, n_mc, seed=0, mesh=None)
        for m in pc.methods:
            out[f"{m} ({prec})"] = (
                compare_mean(sharded[m], single[m]) if m == "vamp"
                else compare(sharded[m], single[m], **tol))
    return out


def phase_four(devices):
    from jstsp19.harness.runner import default_mesh

    mesh = default_mesh()
    if mesh is None or mesh.devices.size != 4:
        raise RuntimeError(f"want an mc mesh over 4 cards, got {mesh}")
    t0 = time.time()
    res = four_card_check(mesh)
    print(f"[four] run_point on the mc mesh over {mesh.devices.size} cards vs "
          f"one card, n_mc={N_MC_FOUR}, 0 dB, shipped precision and "
          f"'highest' ({time.time() - t0:.1f} s incl. compile):", flush=True)
    for m, r in res.items():
        print(_report(m, r), flush=True)
    if not all(r["ok"] for r in res.values()):
        raise RuntimeError("four-card run disagrees with one card")
    return list(mesh.devices.flat)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the mc mesh over four cards vs one card")
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"),
                    help="directory for the main path's artifacts")
    ns = ap.parse_args(argv)
    # phase 3 runs the reference on the CPU backend too; the GPU stays
    # first, so a machine without one still fails the device check
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    from jstsp19.utils.compile_cache import enable

    enable()
    devs = phase_device(ns.four)
    if ns.four:
        used = phase_four(devs)
    else:
        os.makedirs(ns.out, exist_ok=True)
        phase_main_path(ns.out)
        phase_correctness()
        phase_entry()
        used = devs[:1]
    print(last_line(used), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
