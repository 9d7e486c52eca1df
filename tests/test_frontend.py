import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.channel import wideband_mmwave_channel
from jstsp19.frontend import (
    create_beamformer,
    qam4_mod,
    qam4_demod,
    optimum_uniform_quantizer,
    qam4_training_frames,
    awgn,
    received_frame,
    hbf,
    proposed_hbf,
    sample_omega,
    comm_system_training,
)


ALL_KINDS = ["fft", "ps", "ZC", "quantized_4", "quantized", "rand", "rand_ps"]


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_beamformer_column_norms(kind, key):
    W = create_beamformer(16, kind, key=key)
    assert W.shape == (16, 16)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(W), axis=0), 1.0, atol=1e-5
    )


def test_fft_beamformer_unitary():
    W = create_beamformer(8, "fft")
    np.testing.assert_allclose(
        np.asarray(W.conj().T @ W), np.eye(8), atol=1e-5
    )


def test_zc_constant_modulus():
    W = create_beamformer(32, "ZC")
    np.testing.assert_allclose(np.abs(np.asarray(W)), 1 / np.sqrt(32), atol=1e-6)


def test_qam4_roundtrip(key):
    s = qam4_mod(key, (1000,))
    np.testing.assert_allclose(np.abs(np.asarray(s)), 1.0, atol=1e-6)
    # demod of noiseless symbols is identity
    np.testing.assert_allclose(np.asarray(qam4_demod(s)), np.asarray(s), atol=1e-6)
    # all four quadrants hit
    assert len(np.unique(np.asarray(s).round(3))) == 4


def test_quantizer_basic(key):
    x = jax.random.normal(key, (4096,)) + 1j * jax.random.normal(
        jax.random.fold_in(key, 1), (4096,)
    )
    q, up, down = optimum_uniform_quantizer(x, 4)
    # quantized value lies strictly inside its cell
    assert np.all(np.real(np.asarray(down)) <= np.real(np.asarray(q)))
    assert np.all(np.real(np.asarray(q)) <= np.real(np.asarray(up)))
    # 4-bit quantization error is small relative to signal power
    err = np.mean(np.abs(np.asarray(q - x)) ** 2) / np.mean(np.abs(np.asarray(x)) ** 2)
    assert err < 0.02


def test_training_frames_toeplitz_structure(key):
    Psi = qam4_training_frames(key, Nt=3, T=10, L=4)
    assert Psi.shape == (4, 3, 10)
    p = np.asarray(Psi)
    # Hermitian-Toeplitz row relation: Psi[l, k, t] == Psi[l+1, k, t+1]
    np.testing.assert_allclose(p[0, :, :-1], p[1, :, 1:], atol=1e-6)
    # row 0 is the symbol sequence conjugated off-diagonal: |symbols| = 1
    np.testing.assert_allclose(np.abs(p), 1.0, atol=1e-6)


def test_sample_omega_exact_rowcount(key):
    Om = sample_omega(key, Lr_e=32, Lr=4, T=50)
    assert Om.shape == (32, 50)
    np.testing.assert_array_equal(np.asarray(Om.sum(0)), 4.0)
    assert set(np.unique(np.asarray(Om))) <= {0.0, 1.0}
    # different columns differ (random subsets)
    assert not np.all(np.asarray(Om[:, 0]) == np.asarray(Om[:, 1:]).T)


def test_received_frame_matches_loop(key):
    ch = wideband_mmwave_channel(key, 3, 8, 4, 1, 2, 8, 4)
    Psi = qam4_training_frames(jax.random.fold_in(key, 1), 4, 12, 3)
    N = awgn(jax.random.fold_in(key, 2), 8, 12, 0.1)
    R = received_frame(ch.H, Psi, N)
    ref = np.asarray(N, dtype=np.complex128)
    for l in range(3):
        ref += np.asarray(ch.H[l]) @ np.asarray(Psi[l])
    np.testing.assert_allclose(np.asarray(R), ref, atol=1e-4)


def test_hbf_and_proposed_hbf(key):
    ch = wideband_mmwave_channel(key, 2, 16, 4, 1, 2, 16, 4)
    Psi = qam4_training_frames(jax.random.fold_in(key, 1), 4, 20, 2)
    N = awgn(jax.random.fold_in(key, 2), 16, 20, 0.01)
    W = create_beamformer(16, "ZC")
    Y, W_c = hbf(ch.H, N, Psi, Lr=16, W=W)
    assert Y.shape == (16, 20)

    obs = proposed_hbf(jax.random.fold_in(key, 3), ch.H, N, Psi, Lr_e=16, Lr=4, W=W)
    assert obs.Y.shape == (16, 20)
    # masked observation is exactly Omega * full
    np.testing.assert_allclose(
        np.asarray(obs.Y), np.asarray(obs.Omega * obs.Y_full), atol=1e-6
    )
    # 4 live rows per instant
    np.testing.assert_array_equal(np.asarray((np.abs(np.asarray(obs.Y)) > 0).sum(0)), 4)


def test_comm_system_training(key):
    ch = wideband_mmwave_channel(key, 2, 16, 4, 1, 2, 16, 4)
    Yp, Yc, W, Om, Lr, Psi = comm_system_training(
        key, ch.H, T=24, noise_var=0.1, sub_sampling_ratio=0.75
    )
    assert Lr == 12
    assert Yp.shape == (16, 24)
    np.testing.assert_allclose(np.asarray(Yp), np.asarray(Om * Yc), atol=1e-6)
    # the returned training frames are the ones actually transmitted:
    # rebuilding the noiseless frame from Psi must match Yc up to the noise
    assert Psi.shape == (2, 4, 24)


def test_quantized_beamformer_repeats_levels_consecutively():
    """createBeamformer.m:18-30: A = vec(kron(ones(K,1), [0:2^Nq-1])) with
    column-major vec repeats each phase level K times CONSECUTIVELY.  At
    N=32 with 4 bits (levels=16, K=2) the first columns must pair up —
    [0,0,1,1,...] — not cycle [0,1,...,15,0,...] (round-5 parity fix)."""
    W = create_beamformer(32, "quantized_4")
    ph = np.angle(np.asarray(W)[1, :])  # row 1 phase = -omega_c
    np.testing.assert_allclose(ph[0], ph[1], atol=1e-6)   # level 0 twice
    np.testing.assert_allclose(ph[2], ph[3], atol=1e-6)   # level 1 twice
    assert abs(ph[1] - ph[2]) > 1e-3                       # then it advances
    # 6-bit at N=128: K=2 — 64 distinct phases, each twice
    W6 = create_beamformer(128, "quantized")
    ph6 = np.asarray(jnp.angle(W6[1, :]))
    assert len(np.unique(np.round(ph6, 5))) == 64
