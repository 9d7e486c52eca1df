"""NYU-Wireless ingestion end-to-end: synthesize the documented .mat
format (``Hf{...}`` cell array, ``plot_errorVSsnr_nyuwireless.m:6``),
load it, and run the full sweep recipe on the ingested channels."""
import numpy as np
import pytest

scipy_io = pytest.importorskip("scipy.io")

from jstsp19.channel.nyu import load_nyu_taps, normalize_taps


def _write_mat(path, n_real=4, L=3, Nr=16, Nt=4, seed=0):
    rng = np.random.default_rng(seed)
    Hf = np.empty((n_real, L), dtype=object)
    for i in range(n_real):
        for l in range(L):
            Hf[i, l] = (
                rng.normal(size=(Nr, Nt)) + 1j * rng.normal(size=(Nr, Nt))
            ).astype(np.complex64)
    scipy_io.savemat(path, {"Hf": Hf})


def test_load_nyu_taps_and_normalize(tmp_path):
    p = str(tmp_path / "nyu.mat")
    _write_mat(p)
    taps = load_nyu_taps(p)
    assert taps.shape == (4, 3, 16, 4)
    normed = normalize_taps(taps)
    # each tap scaled to sqrt(Nr*Nt) Frobenius norm
    fro = np.sqrt(np.sum(np.abs(np.asarray(normed)) ** 2, axis=(-2, -1)))
    np.testing.assert_allclose(fro, np.sqrt(16 * 4), rtol=1e-5)
    # missing / unset paths return None
    assert load_nyu_taps(None) is None
    assert load_nyu_taps(str(tmp_path / "absent.mat")) is None


def test_nyuwireless_sweep_on_ingested_channels(tmp_path):
    from jstsp19.harness import EXPERIMENTS

    p = str(tmp_path / "nyu.mat")
    _write_mat(p, n_real=2, L=3, Nr=16, Nt=4)
    res = EXPERIMENTS["error_vs_snr_nyuwireless"](
        n_mc=2, mat_path=p, T=8, Imax=10, num_nonzero=10, vamp_nit=20
    )
    assert res.n_mc == 2
    for m, curve in res.curves.items():
        assert len(curve) == 11
        assert np.all(np.isfinite(np.asarray(curve, dtype=float))), m
        assert np.all(np.asarray(curve) <= 1.0 + 1e-6)
