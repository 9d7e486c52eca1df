"""NMSE parity campaign vs the reference's committed .fig artifacts.

Two studies (see PARITY.md):

``families`` — run the five remaining NMSE sweep families
  (delays / paths / framelength / nt / nrf) under the reference-quirks
  channel ensemble at reference MC depth, with per-realization raw errors
  for bracketing statistics.  Artifacts: results/<family>_quirks.json.

``closure`` — constructive closure of the smooth low-floor reference figs
  (errorVSsnr.fig, errorVStraining_*.fig, errorVSdelays.fig, ...), which
  PARITY.md shows cannot come from the committed random-spatial-sampling
  driver: sweep the `wideband_hybBF_comm_system_training` frontend
  (T ∈ {10..90}, subSamplingRatio ∈ {0.75, 1.0}) with the approx-driver
  hyper-parameters (plot_errorVSsnr_approx.m:50-53) over SNR, all methods.
  Artifact: results/parity_closure.json.

Run:  python tools/parity_campaign.py families [n_mc]
      python tools/parity_campaign.py closure  [n_mc]
(CPU: pins the CPU platform when run as a script.)
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FAMILIES = (
    "error_vs_delays",
    "error_vs_paths",
    "error_vs_framelength",
    "error_vs_nt",
    "error_vs_nrf",
)


def run_families(n_mc=64, seed=0):
    from jstsp19.harness import EXPERIMENTS

    for fam in FAMILIES:
        t0 = time.time()
        res = EXPERIMENTS[fam](n_mc=n_mc, seed=seed, channel_quirks=True)
        out = os.path.join(REPO, "results", f"{fam}_quirks.json")
        payload = json.loads(res.to_json())
        payload["channel_quirks"] = True
        with open(out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[families] {fam}: {time.time()-t0:.0f}s -> {out}", flush=True)


def _closure_realization(key, noise_var, *, T, ratio, Imax, quirks,
                         L=4, n_rays=3):
    """All estimators on the `comm_system_training` frontend (the
    plot_errorVSsnr_approx.m pipeline, extended with the conventional
    baselines the out-of-repo figs carry)."""
    from jstsp19.channel import wideband_mmwave_channel
    from jstsp19.core import prng
    from jstsp19.core.metrics import clamped_nmse
    from jstsp19.frontend import comm_system_training
    from jstsp19.solvers import (
        ls_estimate,
        mc_svt,
        omp_mmv,
        omp_td,
        proposed_admm,
        vamp_mmwave,
    )

    Nt, Nr = 4, 32
    ch = wideband_mmwave_channel(
        prng.role_key(key, prng.ROLE_CHANNEL), L, Nr, Nt, 2, n_rays, Nr, Nt,
        quirks=quirks,
    )
    Yp, Yc, W, Omega, Lr, Psi = comm_system_training(
        key, ch.H, T, noise_var, ratio
    )
    A = W.conj().T @ ch.Dr
    B = jnp.einsum("gn,lnt->lgt", ch.Dt.conj().T, Psi).reshape(L * Nt, T)
    # approx-driver hyper-parameters (plot_errorVSsnr_approx.m:50-53)
    tau_X = 1.0 / jnp.sum(jnp.abs(Yp) ** 2)
    tau_S = tau_X / 2.0
    ev = jnp.linalg.eigvalsh(Yp @ Yp.conj().T)
    rho = jnp.sqrt(jnp.maximum(ev[-6], 0.0) * (tau_X + tau_S) / 2.0)
    out = {}
    res = proposed_admm(Yp, Omega, A, B, Imax, tau_X, tau_S, rho, mode="exact")
    out["proposed"] = clamped_nmse(ls_estimate(res.Y, A, B), ch.Zbar)
    out["ls"] = clamped_nmse(ls_estimate(Yc, A, B), ch.Zbar)
    S_vamp = vamp_mmwave(Yc @ B.conj().T, A, B @ B.conj().T, 1.0, 100, nit=100)
    out["vamp"] = clamped_nmse(S_vamp, ch.Zbar)
    V = Yc @ jnp.linalg.pinv(B)
    out["omp_mmv"] = clamped_nmse(omp_mmv(A, V, Nr).x, ch.Zbar)
    # the fig legends' non-saturating TD-OMP [11], numOfnz=100 atoms
    out["omp_td"] = clamped_nmse(omp_td(A, B, Yc, 100).x, ch.Zbar)
    Y_svt = mc_svt(Yp, Omega, Imax, tau_X, 0.1)
    Vs = Y_svt @ jnp.linalg.pinv(B)
    out["tssr"] = clamped_nmse(omp_mmv(A, Vs, Nr).x, ch.Zbar)
    return out


def run_closure(n_mc=32, seed=0, Imax=100):
    import functools

    from jstsp19.core import prng

    snrs = list(range(-15, 16, 5))
    results = []
    for quirks in (False, True):
        for ratio in (0.75, 1.0):
            for T in (10, 30, 50, 70, 90):
                t0 = time.time()
                run = jax.jit(
                    jax.vmap(
                        functools.partial(
                            _closure_realization, T=T, ratio=ratio,
                            Imax=Imax, quirks=quirks,
                        ),
                        in_axes=(0, None),
                    )
                )
                curves = {}
                rawq = {}
                for i, s in enumerate(snrs):
                    keys = prng.realization_keys(
                        prng.experiment_key(seed), i, n_mc
                    )
                    out = run(keys, jnp.asarray(10 ** (-s / 10), jnp.float32))
                    for m, errs in out.items():
                        e = np.asarray(errs)
                        curves.setdefault(m, []).append(float(e.mean()))
                        rawq.setdefault(m, []).append(
                            [float(np.quantile(e, q)) for q in (0.05, 0.5, 0.95)]
                        )
                results.append(
                    dict(
                        quirks=quirks, ratio=ratio, T=T, Imax=Imax,
                        snr_db=snrs, n_mc=n_mc, curves=curves,
                        quantiles_5_50_95=rawq,
                    )
                )
                print(
                    f"[closure] quirks={quirks} ratio={ratio} T={T}: "
                    f"{time.time()-t0:.0f}s proposed@+15="
                    f"{curves['proposed'][-1]:.2e}",
                    flush=True,
                )
                with open(
                    os.path.join(REPO, "results", "parity_closure.json"), "w"
                ) as f:
                    json.dump(results, f, indent=1)


def run_closure_sweeps(n_mc=32, seed=0, Imax=100):
    """Delays-like and paths-like sweeps on the T=70/0.75 frontend — do the
    out-of-repo errorVSdelays.fig (x=1,3,5,7,9; Proposed ~1e-3) and
    errorVSspatialpaths.fig (x=2·rays; Proposed ~2e-3) values come from
    THIS frontend at their drivers' SNR of −5 dB?"""
    import functools

    from jstsp19.core import prng

    nv = 10 ** (5 / 10) * 0.1  # −5 dB
    results = []
    for tag, axis, values, fixed in (
        ("delays_like", "L", [1, 3, 5, 7, 9], {}),
        ("paths_like", "n_rays", [1, 3, 6, 9, 12], {}),
    ):
        for quirks in (False, True):
            curves = {}
            for i, v in enumerate(values):
                run = jax.jit(
                    jax.vmap(
                        functools.partial(
                            _closure_realization, T=70, ratio=0.75,
                            Imax=Imax, quirks=quirks, **{axis: v}, **fixed,
                        ),
                        in_axes=(0, None),
                    )
                )
                keys = prng.realization_keys(prng.experiment_key(seed), i, n_mc)
                out = run(keys, jnp.asarray(10 ** (5 / 10 - 1), jnp.float32))
                for m, errs in out.items():
                    curves.setdefault(m, []).append(float(np.mean(np.asarray(errs))))
                print(f"[closure-{tag}] quirks={quirks} {axis}={v}: "
                      + ", ".join(f"{m}={curves[m][-1]:.3g}" for m in sorted(curves)),
                      flush=True)
            results.append(dict(tag=tag, quirks=quirks, axis=axis,
                                values=values, snr_db=-5, T=70, ratio=0.75,
                                Imax=Imax, n_mc=n_mc, curves=curves))
            with open(os.path.join(REPO, "results", "parity_closure_sweeps.json"), "w") as f:
                json.dump(results, f, indent=1)


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else "families"
    n_mc = int(sys.argv[2]) if len(sys.argv) > 2 else None
    if cmd == "families":
        run_families(n_mc=n_mc or 64)
    elif cmd == "closure":
        run_closure(n_mc=n_mc or 32)
    elif cmd == "closure_sweeps":
        run_closure_sweeps(n_mc=n_mc or 32)
    else:
        raise SystemExit(f"unknown subcommand {cmd!r}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")  # a CPU tool
    main()
