"""End-to-end wideband mmWave channel estimation demo.

Generates one channel realization at the canonical errorVSsnr configuration,
sounds it through the random-spatial-sampling hybrid receiver, and recovers
the beamspace channel with LS / VAMP / MMV-OMP / the proposed ADMM
(the `plot_errorVSsnr.m` pipeline as a minimal script).

Run: python examples/channel_estimation.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from jstsp19.core import prng
from jstsp19.harness.pipeline import PointConfig, realization_errors


def main():
    pc = PointConfig(
        methods=("ls", "vamp", "omp_mmv", "proposed", "proposed_angles")
    )
    snr_db = 10.0
    key = prng.experiment_key(0)
    run = jax.jit(lambda k, nv: realization_errors(k, pc, nv))
    errs = run(key, jnp.asarray(10 ** (-snr_db / 10), jnp.float32))
    print(f"SNR = {snr_db} dB (Nt={pc.Nt}, Nr={pc.Nr}, Mr={pc.Mr}/{pc.Mr_e}, T={pc.T})")
    for m, e in sorted(errs.items()):
        print(f"  {m:18s} NMSE = {float(e):.4f}")


if __name__ == "__main__":
    main()
