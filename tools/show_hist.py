"""GAMP iteration-history visualizer — the ``main/gampShowHist.m`` analog.

Renders the decimated per-iteration histories returned by
``gamp_est(..., GampOptions(save_hist=True))`` as a three-panel figure:

  1. reconstruction MSE per iteration — ‖xhat−x‖²/nx (and the output-space
     ‖zhat−z‖²/nz when the truth is known), gampShowHist.m's top panel;
  2. adaptive-step trajectory — step, step_max, and the accept/reject
     markers (``pass``), gampShowHist.m's middle panel;
  3. cost/residual trajectory — the Bethe/LS ``val`` objective and the
     normalized residual.

As a CLI it runs the sparse-AWGN demo problem (the reference's suggested
usage, ``gampShowHist.m:9-16``: run ``sparseAWGN``, then show the history)
and writes a committed PNG:

    python tools/show_hist.py [--out results/gamp_hist_demo.png]

``plot_gamp_history(hist, x_true=..., out_path=...)`` is importable for any
other run's history pytree.
"""
import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def plot_gamp_history(hist, x_true=None, z_true=None, out_path="gamp_hist.png",
                      title="GAMP iteration history", hist_intvl=1):
    """Render a gamp_est history dict (see module docstring).  ``hist``
    fields used: xhat, zhat, step, step_max (optional), passed, val, resid
    — each with a leading iteration axis.  For decimated histories pass
    the run's ``GampOptions.hist_intvl`` so the x-axis carries the TRUE
    iteration numbers (entries are iterations intvl, 2·intvl, …)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_kept = np.asarray(hist["xhat"]).shape[0]
    it = hist_intvl * np.arange(1, n_kept + 1)
    fig, axes = plt.subplots(3, 1, figsize=(6.5, 8.0), sharex=True)

    ax = axes[0]
    if x_true is not None:
        xh = np.asarray(hist["xhat"])
        mse_x = np.mean(
            np.abs(xh - np.asarray(x_true)[None]) ** 2,
            axis=tuple(range(1, xh.ndim)),
        )
        ax.semilogy(it, np.maximum(mse_x, 1e-30), marker=".", label="‖xhat−x‖²/nx")
    if z_true is not None and "zhat" in hist:
        zh = np.asarray(hist["zhat"])
        mse_z = np.mean(
            np.abs(zh - np.asarray(z_true)[None]) ** 2,
            axis=tuple(range(1, zh.ndim)),
        )
        ax.semilogy(it, np.maximum(mse_z, 1e-30), marker=".", label="‖zhat−z‖²/nz")
    if x_true is None and z_true is None:
        # no truth: show the iterate movement instead
        xh = np.asarray(hist["xhat"])
        dx = np.mean(np.abs(np.diff(xh, axis=0)) ** 2,
                     axis=tuple(range(1, xh.ndim)))
        ax.semilogy(it[1:], np.maximum(dx, 1e-30), marker=".",
                    label="‖Δxhat‖²/nx")
    ax.set_ylabel("MSE")
    ax.grid(True, which="both", alpha=0.4)
    ax.legend(fontsize=8)
    ax.set_title(title)

    ax = axes[1]
    step = np.asarray(hist["step"])
    ax.plot(it, step, marker=".", label="step")
    if "step_max" in hist:
        ax.plot(it, np.asarray(hist["step_max"]), ls="--", label="step_max")
    if "passed" in hist:
        passed = np.asarray(hist["passed"]).astype(bool)
        # post-convergence frozen iterations are not step rejections
        stopped = np.asarray(
            hist.get("stopped", np.zeros_like(passed))
        ).astype(bool)
        rej = ~passed & ~stopped
        ax.plot(it[rej], step[rej], "x", color="tab:red",
                label="rejected", ms=5)
    ax.set_ylabel("adaptive step")
    ax.grid(True, alpha=0.4)
    ax.legend(fontsize=8)

    ax = axes[2]
    if "val" in hist:
        val = np.asarray(hist["val"], float)
        val[~np.isfinite(val)] = np.nan
        ax.plot(it, val, marker=".", label="val (cost)")
    if "resid" in hist:
        ax2 = ax.twinx()
        ax2.semilogy(it, np.maximum(np.asarray(hist["resid"], float), 1e-30),
                     color="tab:green", alpha=0.7, label="residual")
        ax2.set_ylabel("residual", color="tab:green")
    ax.set_ylabel("cost")
    ax.set_xlabel("iteration")
    ax.grid(True, alpha=0.4)
    ax.legend(fontsize=8, loc="upper right")

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def _demo_history(seed=0, n=256, m=128, k=16, wvar=1e-4):
    """The sparseAWGN demo problem of ``gampShowHist.m:9-16``."""
    from jstsp19.ops import MatrixOp
    from jstsp19.solvers import AwgnPrior, CAwgnLikelihood, SparsePrior
    from jstsp19.solvers.gamp_full import GampOptions, gamp_est

    rng = np.random.default_rng(seed)
    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(m), jnp.float32)
    x = np.zeros(n)
    x[rng.choice(n, k, False)] = rng.standard_normal(k)
    z = np.asarray(A) @ x
    y = jnp.asarray(z + np.sqrt(wvar) * rng.standard_normal(m), jnp.float32)
    prior = SparsePrior(base=AwgnPrior(mean0=0.0, var0=1.0), p1=k / n)
    like = CAwgnLikelihood(y=y, wvar=wvar)
    fin, _, hist = gamp_est(
        prior, like, MatrixOp(A), GampOptions(nit=60, save_hist=True)
    )
    return hist, x, z


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "results", "gamp_hist_demo.png"))
    ns = p.parse_args()
    hist, x, z = _demo_history()
    path = plot_gamp_history(
        hist, x_true=x, z_true=z, out_path=ns.out,
        title="GAMP history — sparse-AWGN demo (gampShowHist analog)",
    )
    print(f"[show_hist] wrote {path}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")  # a CPU tool
    main()
