import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jstsp19.channel import (
    wideband_mmwave_channel,
    dft_dictionary,
    ula_steering,
    truncated_laplacian,
    beamspace,
    taps_to_subcarriers,
)


def test_dft_dictionary_matches_closed_form():
    D = dft_dictionary(8, 16)
    m, g = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    ref = np.exp(-1j * 2 * np.pi * m * g / 16) / np.sqrt(8)
    np.testing.assert_allclose(np.asarray(D), ref, atol=1e-6)


def test_dft_dictionary_square_is_unitary():
    D = dft_dictionary(16, 16)
    np.testing.assert_allclose(
        np.asarray(D.conj().T @ D), np.eye(16), atol=1e-5
    )


def test_ula_steering_shape_and_modulus():
    phi = jnp.asarray([0.0, 0.3, -0.7])
    a = ula_steering(phi, 32)
    assert a.shape == (3, 32)
    np.testing.assert_allclose(np.abs(np.asarray(a)), 1.0, atol=1e-6)
    # phi=0 -> all-ones steering vector
    np.testing.assert_allclose(np.asarray(a[0]), np.ones(32), atol=1e-6)


def test_truncated_laplacian_range_and_spread(key):
    x = truncated_laplacian(key, (20000,))
    xn = np.asarray(x)
    assert np.all(np.abs(xn) <= np.pi + 1e-6)
    # symmetric about zero, std below the untruncated sigma
    assert abs(xn.mean()) < 0.05
    assert 0.1 < xn.std() < 50 * np.pi / 180


def test_channel_shapes(key):
    ch = wideband_mmwave_channel(key, L=4, Mr=32, Mt=4, n_clusters=2, n_rays=3, Gr=32, Gt=4)
    assert ch.H.shape == (4, 32, 4)
    assert ch.Zbar.shape == (32, 16)
    assert ch.Ar.shape == (4, 6, 32)
    assert ch.Dr.shape == (32, 32)


def test_channel_energy_normalization(key):
    # E[|H|^2_F] = Mr*Mt per tap under the 1/sqrt(Np) normalization
    keys = jax.random.split(key, 200)
    chans = jax.vmap(
        lambda k: wideband_mmwave_channel(k, 2, 16, 4, 2, 3, 16, 4).H
    )(keys)
    energy = np.mean(np.sum(np.abs(np.asarray(chans)) ** 2, axis=(2, 3)))
    assert 0.7 * 16 * 4 < energy < 1.3 * 16 * 4


def test_beamspace_roundtrip_square_grids(key):
    # With Gr=Mr, Gt=Mt the DFT dictionaries are unitary: Dr Zl Dt^H == Hl.
    ch = wideband_mmwave_channel(key, L=3, Mr=8, Mt=8, n_clusters=1, n_rays=2, Gr=8, Gt=8)
    Z = ch.Zbar.reshape(8, 3, 8).transpose(1, 0, 2)  # (L, Gr, Gt)
    H_rec = jnp.einsum("mg,lgh,nh->lmn", ch.Dr, Z, ch.Dt.conj())
    np.testing.assert_allclose(np.asarray(H_rec), np.asarray(ch.H), atol=1e-4)


def test_beamspace_layout_matches_matlab_reshape(key):
    # Zbar[:, l*Gt + j] must equal (Dr^H H_l Dt)[:, j]  (MATLAB reshape semantics)
    ch = wideband_mmwave_channel(key, L=2, Mr=8, Mt=4, n_clusters=1, n_rays=2, Gr=8, Gt=4)
    for l in range(2):
        Zl = ch.Dr.conj().T @ ch.H[l] @ ch.Dt
        np.testing.assert_allclose(
            np.asarray(ch.Zbar[:, l * 4 : (l + 1) * 4]), np.asarray(Zl), atol=1e-5
        )


def test_taps_to_subcarriers(key):
    ch = wideband_mmwave_channel(key, L=4, Mr=8, Mt=4, n_clusters=1, n_rays=2, Gr=8, Gt=4)
    Hk = taps_to_subcarriers(ch.H, K=16)
    assert Hk.shape == (16, 8, 4)
    # k=0 subcarrier is the sum of taps
    np.testing.assert_allclose(
        np.asarray(Hk[0]), np.asarray(ch.H.sum(0)), atol=1e-4
    )


def test_channel_jits_and_vmaps(key):
    f = jax.jit(
        jax.vmap(lambda k: wideband_mmwave_channel(k, 2, 8, 4, 1, 2, 8, 4).Zbar)
    )
    out = f(jax.random.split(key, 5))
    assert out.shape == (5, 8, 8)
    assert jnp.all(jnp.isfinite(out.real))


# ---------------------------------------------------------------------------
# Reference-quirks parity mode (wideband_mmwave_channel.m:24-30,56-62)
# ---------------------------------------------------------------------------

def test_quirk_laplacian_matches_matlab_formula(key):
    from jstsp19.channel.widemmwave import quirk_laplacian

    x = np.asarray(quirk_laplacian(key, (20000,)))
    # x = beta*(exp(-sqrt(2)pi/50) - cosh(u)), u~U(0,1):
    # range is [beta*(c - cosh(1)), beta*(c - 1)] ~= [-7.39, -1.00]
    c = np.exp(-np.sqrt(2) * np.pi / 50)
    beta = 1 / (1 - c)
    lo, hi = beta * (c - np.cosh(1.0)), beta * (c - 1.0)
    assert x.min() >= lo - 1e-3 and x.max() <= hi + 1e-3
    # cosh is monotone on (0,1) so quantiles map through; check the median
    med_expected = beta * (c - np.cosh(0.5))
    assert abs(np.median(x) - med_expected) < 0.1


def test_channel_quirks_tap1_steering_reuse(key):
    # Every tap's H_l must lie in span(Ar[0]) x span(At[0]) (the MATLAB
    # 2-subscript Ar(:, index) linear-indexing quirk, :24).
    ch = wideband_mmwave_channel(
        key, L=4, Mr=32, Mt=8, n_clusters=2, n_rays=3, Gr=32, Gt=8, quirks=True
    )
    Ar0 = np.asarray(ch.Ar[0]).T  # (Mr, Np)
    P = Ar0 @ np.linalg.pinv(Ar0)  # projector onto col span
    for l in range(4):
        Hl = np.asarray(ch.H[l])
        resid = np.linalg.norm(Hl - P @ Hl) / np.linalg.norm(Hl)
        assert resid < 1e-5, f"tap {l} leaves tap-1 column span: {resid}"


def test_channel_quirks_low_rank_stacked(key):
    # Shared steering across taps caps the stacked beamspace rank at Np
    # (vs min(Gr, L*Gt) for the paper model).
    ch = wideband_mmwave_channel(
        key, L=4, Mr=32, Mt=4, n_clusters=2, n_rays=3, Gr=32, Gt=4, quirks=True
    )
    s = np.linalg.svd(np.asarray(ch.Zbar), compute_uv=False)
    assert (s > 1e-5 * s[0]).sum() <= 6


def test_channel_quirks_cluster_double_count_energy(key):
    # Cluster weights (C-c+1) raise per-entry energy by sum(w^2)/Np:
    # C=2, R=3 -> (4*3 + 1*3)/6 = 2.5x the paper model's 1.0.
    keys = jax.random.split(key, 300)
    Hq = jax.vmap(
        lambda k: wideband_mmwave_channel(
            k, 2, 16, 4, 2, 3, 16, 4, quirks=True
        ).H
    )(keys)
    e = float(jnp.mean(jnp.abs(Hq) ** 2))
    assert 2.0 < e < 3.0, e


def test_channel_quirks_jits_and_vmaps(key):
    f = jax.jit(
        jax.vmap(
            lambda k: wideband_mmwave_channel(
                k, 2, 8, 4, 2, 2, 8, 4, quirks=True
            ).Zbar
        )
    )
    out = f(jax.random.split(key, 5))
    assert out.shape == (5, 8, 8)
    assert jnp.all(jnp.isfinite(out.real))


def test_taps_to_subcarriers_aliases_instead_of_truncating(key):
    """H_k = sum over ALL L taps of H_l e^{-j2pi k l/K}: for K < L the
    taps alias onto the K-point grid (l mod K); they are not dropped."""
    from jstsp19.channel import taps_to_subcarriers

    H = jax.random.normal(key, (4, 3, 2)) + 1j * jax.random.normal(
        jax.random.fold_in(key, 1), (4, 3, 2)
    )
    K = 2
    out = np.asarray(taps_to_subcarriers(H, K))
    l = np.arange(4)
    for k in range(K):
        ref = np.tensordot(
            np.exp(-2j * np.pi * k * l / K), np.asarray(H), axes=(0, 0)
        )
        np.testing.assert_allclose(out[k], ref, rtol=1e-5, atol=1e-6)
