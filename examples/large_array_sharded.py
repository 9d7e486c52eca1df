"""Large-array OFDM capacity/EE on a sharded device mesh.

BASELINE.json config 5: the Nr=128 / Mr_e=64 receive geometry
(``plot_capacity.m:175-187``) with K=64 subcarriers, Monte-Carlo
realizations sharded over a ``(dp, sp)`` mesh — realizations over ``dp``,
the subcarrier axis over ``sp`` (the sequence-parallel analog).  The same
code runs on a real pod slice; here it uses 8 virtual CPU devices.

Run: python examples/large_array_sharded.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# The virtual 8-device mesh only exists on the CPU platform: this demo is
# CPU-only regardless of flags.
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jstsp19.channel import taps_to_subcarriers, wideband_mmwave_channel
from jstsp19.core import prng
from jstsp19.core.metrics import power_conventional_hbf, power_proposed


def main():
    Nt, Nr, Mr_e, Mr = 16, 128, 64, 16
    L, K = 8, 64
    n_mc = 8
    snr_db = 10.0
    nv = 10 ** (-snr_db / 10)

    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devs, ("dp", "sp"))

    def realization(key):
        ch = wideband_mmwave_channel(
            prng.role_key(key, prng.ROLE_CHANNEL), L, Nr, Nt, 2, 3, Nr, Nt
        )
        Hk = taps_to_subcarriers(ch.H, K)  # (K, Nr, Nt)
        # wide combiner: random Mr_e-subset of a quantized-phase bank,
        # keep Mr outputs (plot_capacity.m:63-64)
        W = jnp.exp(
            2j
            * jnp.pi
            * jnp.round(
                jax.random.uniform(
                    prng.role_key(key, prng.ROLE_BEAMFORMER), (Nr, Mr_e)
                )
                * 64
            )
            / 64
        ) / np.sqrt(Nr)
        Wm = W[:, :Mr]
        # per-subcarrier ASE: log2 det(I + 1/(sigma^2 Nt) W^H Hk Hk^H W)
        G = jnp.einsum("nm,knt->kmt", Wm.conj(), Hk)  # (K, Mr, Nt)
        Gram = jnp.einsum("kmt,kpt->kmp", G, G.conj())
        eye = jnp.eye(Mr, dtype=Gram.dtype)
        cap_k = jnp.linalg.slogdet(eye + Gram / (nv * Nt))[1] / np.log(2.0)
        return cap_k.real  # (K,)

    run = jax.jit(jax.vmap(realization))
    keys = prng.realization_keys(prng.experiment_key(0), 0, n_mc)
    sh = NamedSharding(mesh, P("dp"))
    keys = jax.device_put(keys, sh)
    cap = run(keys)  # (n_mc, K) — sharded (dp, sp) by propagation
    cap = jax.device_put(cap, NamedSharding(mesh, P("dp", "sp")))
    mean_cap = float(jnp.mean(cap))
    ee = mean_cap / power_proposed(Nr, Mr_e)
    ee_conv = mean_cap / power_conventional_hbf(Nr, Mr)
    print(
        f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}, "
        f"Nr={Nr} Mr_e={Mr_e} Mr={Mr} K={K} n_mc={n_mc} @ {snr_db:.0f} dB"
    )
    print(f"mean ASE over {K} subcarriers: {mean_cap:.2f} bits/s/Hz")
    print(f"EE (proposed wide-combiner power model): {ee:.2f} bits/Joule")
    print(f"EE (conventional HBF power model):      {ee_conv:.2f} bits/Joule")
    spec = np.asarray(jnp.mean(cap, axis=0))
    print(
        "subcarrier ASE spectrum: "
        f"min {spec.min():.2f} / median {np.median(spec):.2f} / max {spec.max():.2f}"
    )


if __name__ == "__main__":
    main()
