"""Fingerprint search for ``errorVSdelays.fig``'s Proposed curve.

PARITY.md round 3 closed every camera-ready fig except the delays fig's
Proposed dip (5e-4..1.3e-3 over L = 1,3,5,7,9): TSSR/VAMP/TD-OMP all match
the ``comm_system_training`` (approx-driver) frontend at T=70, but Proposed
sat 2-5 dB above, and two single-recipe probes (T=70 fixed; T=10·L) failed
differently.  Since the baselines pin the *frontend*, the residual handle
must be the ADMM configuration itself — so this runs the same systematic
grid that cracked errorVSsnr.fig (VERDICT r3 next-step #2):

    T recipe   ∈ {5·idx, 10·L, 50, 70, 90}      (idx = position of L in the sweep)
    SNR        ∈ {−5, 0, +5, +15} dB            (traced — shared compile)
    ratio      ∈ {0.75, 1.0}                    (subSamplingRatio)
    hyperparams∈ {approx, canonical}            (plot_errorVSsnr_approx.m:50-53
                                                 vs plot_errorVSsnr.m:127-130)
    L          ∈ {1, 3, 5, 7, 9}, quirks ensemble, n_mc ≥ 16

Artifact: results/delays_fingerprint.json — every config's mean Proposed
NMSE per L plus its mean log10-distance to the fig curve, ranked.

Run:  python tools/delays_fingerprint.py [n_mc]
(CPU; hours-scale at n_mc=16 — run in background.)
"""
import functools
import itertools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# errorVSdelays.fig Proposed, x = 1,3,5,7,9 (BASELINE.md:16)
FIG_L = [1, 3, 5, 7, 9]
FIG_PROPOSED = [0.001237, 0.0006206, 0.0005246, 0.0006092, 0.001315]

T_RECIPES = {
    "5idx": lambda L, idx: 5 * (idx + 1),   # committed driver: T = 5·l_indx
    "10L": lambda L, idx: 10 * L,
    "T40": lambda L, idx: 40,
    "T50": lambda L, idx: 50,
    "T60": lambda L, idx: 60,
    "T70": lambda L, idx: 70,
    "T90": lambda L, idx: 90,
}
DEFAULT_RECIPES = ["5idx", "10L", "T50", "T70", "T90"]
SNRS = [-5, 0, 5, 15]
RATIOS = [0.75, 1.0]
HYPERS = ["approx", "canonical"]


def _realization(key, noise_var, *, T, ratio, L, hyper, Imax=100):
    from jstsp19.channel import wideband_mmwave_channel
    from jstsp19.core import prng
    from jstsp19.core.metrics import clamped_nmse
    from jstsp19.frontend import comm_system_training
    from jstsp19.solvers import admm_hyperparams, ls_estimate, proposed_admm

    Nt, Nr = 4, 32
    ch = wideband_mmwave_channel(
        prng.role_key(key, prng.ROLE_CHANNEL), L, Nr, Nt, 2, 3, Nr, Nt,
        quirks=True,
    )
    Yp, Yc, W, Omega, Lr, Psi = comm_system_training(
        key, ch.H, T, noise_var, ratio
    )
    A = W.conj().T @ ch.Dr
    B = jnp.einsum("gn,lnt->lgt", ch.Dt.conj().T, Psi).reshape(L * Nt, T)
    if hyper == "approx":
        # plot_errorVSsnr_approx.m:50-53
        tau_X = 1.0 / jnp.sum(jnp.abs(Yp) ** 2)
        tau_S = tau_X / 2.0
        ev = jnp.linalg.eigvalsh(Yp @ Yp.conj().T)
        rho = jnp.sqrt(jnp.maximum(ev[-6], 0.0) * (tau_X + tau_S) / 2.0)
    else:
        # canonical driver recipe (plot_errorVSsnr.m:127-130), oracle Zbar
        tau_X, tau_S, rho = admm_hyperparams(Yp, ch.Zbar)
    res = proposed_admm(Yp, Omega, A, B, Imax, tau_X, tau_S, rho, mode="exact")
    return clamped_nmse(ls_estimate(res.Y, A, B), ch.Zbar)


def main(n_mc=16, seed=0, recipes=None, snrs=None, ratios=None,
         hypers=None, out_name="delays_fingerprint.json"):
    from jstsp19.core import prng

    global SNRS
    SNRS = snrs or SNRS
    recipes = recipes or DEFAULT_RECIPES
    ratios = ratios or RATIOS
    hypers = hypers or HYPERS
    out_path = os.path.join(REPO, "results", out_name)
    results = []
    t_all = time.time()
    for recipe, ratio, hyper in itertools.product(recipes, ratios, hypers):
        curve = {s: [] for s in SNRS}
        t0 = time.time()
        for idx, L in enumerate(FIG_L):
            T = T_RECIPES[recipe](L, idx)
            run = jax.jit(
                jax.vmap(
                    functools.partial(
                        _realization, T=T, ratio=ratio, L=L, hyper=hyper
                    ),
                    in_axes=(0, None),
                )
            )
            for s in SNRS:
                # collision-free (L, SNR) -> sweep-index fold; the stride
                # stays 10 for <=10 SNRs so the committed grid artifacts
                # remain reproducible
                stride = max(10, len(SNRS))
                keys = prng.realization_keys(
                    prng.experiment_key(seed),
                    idx * stride + SNRS.index(s), n_mc,
                )
                errs = run(keys, jnp.asarray(10 ** (-s / 10), jnp.float32))
                curve[s].append(float(np.mean(np.asarray(errs))))
        for s in SNRS:
            dist = float(
                np.mean(np.abs(np.log10(np.asarray(curve[s]))
                               - np.log10(np.asarray(FIG_PROPOSED))))
            )
            results.append(
                dict(recipe=recipe, ratio=ratio, hyper=hyper, snr_db=s,
                     L=FIG_L, proposed=curve[s], log10_dist=round(dist, 4))
            )
        results.sort(key=lambda r: r["log10_dist"])
        with open(out_path, "w") as f:
            json.dump(
                dict(fig_proposed=FIG_PROPOSED, n_mc=n_mc, seed=seed,
                     quirks=True, results=results), f, indent=1,
            )
        best = results[0]
        print(
            f"[fingerprint] {recipe}/r{ratio}/{hyper}: {time.time()-t0:.0f}s; "
            f"best so far {best['recipe']}/r{best['ratio']}/{best['hyper']}"
            f"@{best['snr_db']}dB dist={best['log10_dist']:.3f} "
            f"curve={['%.2e' % v for v in best['proposed']]}",
            flush=True,
        )
    print(f"[fingerprint] total {time.time()-t_all:.0f}s -> {out_path}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")  # a CPU tool
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("n_mc", nargs="?", type=int, default=16)
    ap.add_argument("--recipes", default=None,
                    help="comma list from " + ",".join(T_RECIPES))
    ap.add_argument("--snrs", default=None, help="comma list of dB values")
    ap.add_argument("--ratios", default=None)
    ap.add_argument("--hypers", default=None)
    ap.add_argument("--out", default="delays_fingerprint.json")
    a = ap.parse_args()
    main(
        n_mc=a.n_mc,
        recipes=a.recipes.split(",") if a.recipes else None,
        snrs=[float(x) for x in a.snrs.split(",")] if a.snrs else None,
        ratios=[float(x) for x in a.ratios.split(",")] if a.ratios else None,
        hypers=a.hypers.split(",") if a.hypers else None,
        out_name=a.out,
    )
