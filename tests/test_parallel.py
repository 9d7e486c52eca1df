"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.channel import wideband_mmwave_channel
from jstsp19.core import prng
from jstsp19.frontend import (
    awgn,
    create_beamformer,
    proposed_hbf,
    qam4_training_frames,
)
from jstsp19.parallel import make_mesh, mesh_shape_for, sharded_admm_step
from jstsp19.parallel.sharded_admm import reference_admm_batch
from jstsp19.solvers import admm_hyperparams


def test_mesh_shape_factoring():
    assert mesh_shape_for(1) == (1, 1, 1)
    assert mesh_shape_for(2) == (1, 1, 2)
    assert mesh_shape_for(4) == (1, 2, 2)
    assert mesh_shape_for(8) == (2, 2, 2)


def test_sharded_admm_matches_unsharded():
    mesh = make_mesh(8)
    n_batch = 4  # dp=2 shards x 2 local
    keys = jax.random.split(jax.random.key(1), n_batch)
    Nt, Nr, Mr_e, Mr, L, T = 2, 8, 8, 2, 2, 8

    # one shared channel's operators, per-sample masks/noise
    ch = wideband_mmwave_channel(jax.random.key(42), L, Nr, Nt, 1, 2, Nr, Nt)
    Psi = qam4_training_frames(jax.random.key(43), Nt, T, L)
    W = create_beamformer(Nr, "ZC")
    A = W[:, :Mr_e].conj().T @ ch.Dr
    B = jnp.einsum("gn,lnt->lgt", ch.Dt.conj().T, Psi).reshape(L * Nt, T)

    def gen(key):
        N = awgn(prng.role_key(key, prng.ROLE_NOISE), Nr, T, 0.1)
        obs = proposed_hbf(prng.role_key(key, prng.ROLE_MASK), ch.H, N, Psi, Mr_e, Mr, W)
        tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar, top_k=4)
        return obs.Y, obs.Omega, tau_Y, tau_S, rho

    Y, Om, tY, tS, rho = jax.vmap(gen)(keys)
    Zbar = jnp.broadcast_to(ch.Zbar, (n_batch,) + ch.Zbar.shape)

    Imax = 8
    step = sharded_admm_step(mesh, Imax=Imax)
    S_sh, nmse = step(Y, Om, A, B, tY, tS, rho, Zbar)

    S_ref = reference_admm_batch(Y, Om, A, B, Imax, tY, tS, rho)
    np.testing.assert_allclose(np.asarray(S_sh), np.asarray(S_ref), atol=2e-4)
    assert nmse.shape == (n_batch,)
    assert np.all(np.isfinite(np.asarray(nmse)))


def test_sharded_admm_runs_one_full_step_tiny():
    # the dryrun_multichip path: mesh over all 8 virtual devices
    mesh = make_mesh(8)
    step = sharded_admm_step(mesh, Imax=2)
    n_batch, Nr, T, Gr, K = 2, 8, 8, 8, 4
    Y = jnp.ones((n_batch, Nr, T), jnp.complex64)
    Om = jnp.ones((n_batch, Nr, T), jnp.float32)
    A = jnp.eye(Nr, Gr, dtype=jnp.complex64)
    B = jnp.ones((K, T), jnp.complex64) * 0.1
    ones = jnp.ones((n_batch,))
    Zbar = jnp.ones((n_batch, Gr, K), jnp.complex64)
    S, nmse = step(Y, Om, A, B, ones * 0.1, ones * 0.1, ones * 0.5, Zbar)
    assert S.shape == (n_batch, Gr, K)
    assert np.all(np.isfinite(np.asarray(nmse)))
