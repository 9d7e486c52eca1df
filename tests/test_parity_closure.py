"""Regression tests for the round-3 constructive parity closure.

PARITY.md: the reference's camera-ready figs (`errorVSsnr.fig`,
`errorVStraining_dbf.fig`, `errorVSspatialpaths.fig`, ...) come from the
`wideband_hybBF_comm_system_training` frontend (T=70, subSamplingRatio
0.75 / 1.0), NOT from the committed sweep drivers.  These tests pin the
reproduction so a frontend/solver regression that breaks the closure
fails the suite.
"""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, "tools")

from jstsp19.core import prng  # noqa: E402
from parity_campaign import _closure_realization  # noqa: E402

N_MC = 16


def _run(noise_var, **cfg):
    fn = jax.jit(
        jax.vmap(
            functools.partial(_closure_realization, **cfg), in_axes=(0, None)
        )
    )
    keys = prng.realization_keys(prng.experiment_key(0), 0, N_MC)
    out = fn(keys, jnp.asarray(noise_var, jnp.float32))
    return {m: np.asarray(v) for m, v in out.items()}


def test_errorVSsnr_fig_floor_reproduced():
    """fig(2) Proposed @ +15 dB = 1.44e-4; the quirks/0.75/T=70 frontend
    must land within 0.35 decades (PARITY.md closure table)."""
    out = _run(10 ** (-1.5), T=70, ratio=0.75, Imax=100, quirks=True)
    m = out["proposed"].mean()
    assert abs(np.log10(m) - np.log10(1.44e-4)) < 0.35, m


def test_training_dbf_identity_and_value():
    """errorVStraining_dbf.fig shows Proposed == TSSR numerically; at
    subSamplingRatio 1.0 (fully observed) proposed/TSSR/LS collapse to the
    same estimator, and the T=30/+15 dB value matches the fig's 2.56e-3."""
    out = _run(10 ** (-1.5), T=30, ratio=1.0, Imax=100, quirks=False)
    np.testing.assert_allclose(out["proposed"], out["ls"], rtol=1e-3)
    np.testing.assert_allclose(out["tssr"], out["ls"], rtol=1e-3)
    m = out["proposed"].mean()
    assert abs(np.log10(m) - np.log10(2.56e-3)) < 0.35, m


def test_td_omp_floor_reproduced():
    """fig(2) TD-OMP @ +15 dB = 0.0267 with its characteristic
    model-mismatch floor; omp_td (numOfnz=100 atoms over the kron
    dictionary) must land within 0.2 decades."""
    out = _run(10 ** (-1.5), T=70, ratio=0.75, Imax=100, quirks=True)
    m = out["omp_td"].mean()
    assert abs(np.log10(m) - np.log10(0.0267)) < 0.2, m


def test_delays_fingerprint_winner_pinned():
    """errorVSdelays.fig Proposed: the round-4 fingerprint winner
    (T=90, subSamplingRatio=1.0, approx hyperparams, +5 dB — PARITY.md,
    `results/delays_fingerprint_refine.json`) must keep reproducing the
    fig's U-shaped dip at L=1..7 within ~1 dB of its round-4 distances
    (measured at n_mc=16: 0.02/0.11/0.09/0.06 decades vs the fig's
    1.24e-3/6.2e-4/5.2e-4/6.1e-4; threshold 0.22 decades = current max
    + 1 dB drift allowance).  Keys replicate tools/delays_fingerprint.py's
    (L-index, SNR-index) fold so the pinned values are the artifact's."""
    from delays_fingerprint import _realization as fp_realization

    fig = {1: 1.237e-3, 3: 6.206e-4, 5: 5.246e-4, 7: 6.092e-4}
    for idx, L in enumerate([1, 3, 5, 7]):
        fn = jax.jit(
            jax.vmap(
                functools.partial(
                    fp_realization, T=90, ratio=1.0, L=L, hyper="approx"
                ),
                in_axes=(0, None),
            )
        )
        keys = prng.realization_keys(prng.experiment_key(0), idx * 10 + 2, N_MC)
        m = np.asarray(fn(keys, jnp.asarray(10 ** (-0.5), jnp.float32))).mean()
        assert abs(np.log10(m) - np.log10(fig[L])) < 0.22, (L, m)


def test_delays_L9_endpoint_probe_pinned():
    """The L=9 endpoint of errorVSdelays.fig (1.315e-3) is matched by the
    SAME winner member at +3 dB (`results/delays_L9_probe.json`: 1.28e-3
    at n_mc=48; 1.257e-3 at this test's n_mc=16, 0.019 decades off)."""
    from delays_fingerprint import _realization as fp_realization

    fn = jax.jit(
        jax.vmap(
            functools.partial(
                fp_realization, T=90, ratio=1.0, L=9, hyper="approx"
            ),
            in_axes=(0, None),
        )
    )
    keys = prng.realization_keys(prng.experiment_key(0), 4 * 10 + 2, N_MC)
    m = np.asarray(fn(keys, jnp.asarray(10 ** (-0.3), jnp.float32))).mean()
    assert abs(np.log10(m) - np.log10(1.315e-3)) < 0.15, m


def test_spatialpaths_fig_reproduced():
    """errorVSspatialpaths.fig: Proposed ~0.0016, TSSR ~0.115 at
    rays=3 (x=6); the quirks/0.75/T=70 frontend at −5 dB matches both."""
    out = _run(10 ** 0.5 * 0.1, T=70, ratio=0.75, Imax=100, quirks=True,
               n_rays=3)
    mp = out["proposed"].mean()
    mt = out["tssr"].mean()
    assert abs(np.log10(mp) - np.log10(1.8e-3)) < 0.4, mp
    assert abs(np.log10(mt) - np.log10(0.115)) < 0.25, mt
