"""Golden-value regression: pinned PRNG keys → pinned outputs.

The reference pins MATLAB RNG state files (``VAMP/random_state.mat``,
``test/warmStart/random_state.mat``) so demos are bit-reproducible; here the
threefry key stream plays that role.  These values were produced by the
framework at commit time on the CPU backend — any unintentional numeric
drift in the channel generator, measurement model, or solvers trips them.
Tolerances allow backend/fast-math jitter but not algorithmic change.
"""
import jax
import jax.numpy as jnp
import numpy as np

from jstsp19.core import prng
from jstsp19.harness.pipeline import PointConfig, realization_errors


GOLDEN = {
    # seed 0, canonical config, SNR 0 dB (noise_var = 1.0)
    "ls": 1.0,
    "omp_mmv": 1.0,
    "proposed": 0.20721,
    "proposed_angles": 0.14287,
    # vamp on the reference's normal-equations form (vamp_normal_eq=True,
    # plot_errorVSsnr.m:79-80); round-3 value after the keep-best +
    # difference-form stability fix (solvers/vamp.py) — was 0.26318 in
    # round 2 (last-iterate), 0.21392 on the direct model.
    "vamp": 0.16993,
}


def test_golden_canonical_realization():
    pc = PointConfig(
        methods=("ls", "vamp", "omp_mmv", "proposed", "proposed_angles")
    )
    key = prng.realization_keys(prng.experiment_key(0), 0, 1)[0]
    out = jax.jit(lambda k, v: realization_errors(k, pc, v))(
        key, jnp.asarray(1.0, jnp.float32)
    )
    for m, ref in GOLDEN.items():
        np.testing.assert_allclose(
            float(out[m]), ref, rtol=2e-2, err_msg=f"golden drift in {m}"
        )


def test_golden_channel_moments():
    ch_fn = jax.jit(
        lambda k: __import__("jstsp19.channel", fromlist=["x"]).wideband_mmwave_channel(
            k, 4, 32, 4, 2, 3, 32, 4
        ).Zbar
    )
    Z = ch_fn(prng.experiment_key(42))
    e = float(jnp.sum(jnp.abs(Z) ** 2))
    # pinned total beamspace energy for this key
    np.testing.assert_allclose(e, 501.597, rtol=1e-3)
