"""Hybrid (hosts × chips) mesh over the multi-process backend.

SURVEY §7.8's build-plan line — ``jax.distributed.initialize, mesh =
(hosts × chips)`` — realized and tested on real process boundaries: the
(dp, sp, tp) sharded ADMM step (``parallel/sharded_admm.py``) runs over
a mesh whose axes SPAN processes, in the two layouts that matter:

* ``dp`` across processes (the production pod layout: per-iteration
  solver collectives stay intra-process/ICI, only the final reduction
  crosses the process/DCN boundary), and
* ``sp`` across processes (the stress layout: every ADMM iteration's
  Gram/correlation ``psum`` crosses the process boundary through Gloo —
  the worst-case traffic SURVEY §2.6 warns to keep off DCN, exercised
  here for correctness).

Both layouts must reproduce the unsharded single-device reference batch
exactly (each process checks its addressable shards).  Run under the
launcher::

    python -m jstsp19.parallel.launch -n 2 -d 2 -- \
        -m jstsp19.parallel.dist_hybrid --out hybrid.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _host_problem(sp: int, dp: int):
    """Deterministic tiny problem, identical in every process (same keys;
    dryrun_multichip's shapes)."""
    import jax
    import jax.numpy as jnp

    from jstsp19.channel import wideband_mmwave_channel
    from jstsp19.core import prng
    from jstsp19.frontend import (
        awgn,
        create_beamformer,
        proposed_hbf,
        qam4_training_frames,
    )
    from jstsp19.solvers import admm_hyperparams

    Nt, Nr = 2, 8
    Mr_e, Mr, L = 8, 2, 2
    T = 4 * sp
    n_batch = 2 * dp
    ch = wideband_mmwave_channel(jax.random.key(7), L, Nr, Nt, 1, 2, Nr, Nt)
    Psi = qam4_training_frames(jax.random.key(8), Nt, T, L)
    W = create_beamformer(Nr, "ZC")
    A = W[:, :Mr_e].conj().T @ ch.Dr
    B = jnp.einsum("gn,lnt->lgt", ch.Dt.conj().T, Psi).reshape(L * Nt, T)

    def gen(key):
        N = awgn(prng.role_key(key, prng.ROLE_NOISE), Nr, T, 0.1)
        obs = proposed_hbf(
            prng.role_key(key, prng.ROLE_MASK), ch.H, N, Psi, Mr_e, Mr, W
        )
        tau_Y, tau_S, rho = admm_hyperparams(obs.Y, ch.Zbar, top_k=2)
        return obs.Y, obs.Omega, tau_Y, tau_S, rho

    keys = jax.random.split(jax.random.key(9), n_batch)
    Y, Om, tY, tS, rho = jax.vmap(gen)(keys)
    Zb = jnp.broadcast_to(ch.Zbar, (n_batch,) + ch.Zbar.shape)
    return tuple(
        np.asarray(v) for v in (Y, Om, A, B, tY, tS, rho, Zb)
    )


def run_layout(mesh, host_arrays, Imax: int = 3):
    """Run the sharded ADMM step over ``mesh`` (axes may span processes)
    and check every addressable output shard against the single-device
    reference batch.  Returns (max |ΔS|, global mean nmse)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jstsp19.parallel.sharded_admm import (
        reference_admm_batch,
        sharded_admm_step,
    )

    Yh, Omh, Ah, Bh, tYh, tSh, rhoh, Zbh = host_arrays
    specs = (
        P("dp", None, "sp"),
        P("dp", None, "sp"),
        P(None, "tp"),
        P(None, "sp"),
        P("dp"),
        P("dp"),
        P("dp"),
        P("dp", "tp", None),
    )

    def glob(h, spec):
        return jax.make_array_from_callback(
            h.shape, NamedSharding(mesh, spec), lambda idx: h[idx]
        )

    args = tuple(glob(h, s) for h, s in zip(host_arrays, specs))
    step = sharded_admm_step(mesh, Imax=Imax)
    S, nmse = step(*args)

    # single-device oracle (local compute, identical on every process)
    S_ref = np.asarray(
        reference_admm_batch(
            jnp.asarray(Yh), jnp.asarray(Omh), jnp.asarray(Ah),
            jnp.asarray(Bh), Imax, jnp.asarray(tYh), jnp.asarray(tSh),
            jnp.asarray(rhoh),
        )
    )
    max_ds = 0.0
    for shard in S.addressable_shards:
        max_ds = max(
            max_ds,
            float(np.max(np.abs(np.asarray(shard.data) - S_ref[shard.index]))),
        )
    # cross-process replication of the dp-sharded nmse (the final DCN
    # reduction of the production layout)
    repl = jax.jit(jnp.mean, out_shardings=NamedSharding(mesh, P()))(nmse)
    return max_ds, float(np.asarray(repl))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--imax", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from jstsp19.parallel.distributed import initialize_from_env

    pid = initialize_from_env()
    import jax
    from jax.sharding import Mesh

    nproc = jax.process_count()
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    local = len(devs) // nproc
    results = {}

    # layout A — dp across processes, tp inside (production pod layout)
    mesh_a = Mesh(np.array(devs).reshape(nproc, 1, local), ("dp", "sp", "tp"))
    host = _host_problem(sp=1, dp=nproc)
    ds_a, nm_a = run_layout(mesh_a, host, Imax=args.imax)
    results["dp_across_processes"] = dict(
        mesh=[nproc, 1, local], max_abs_dS=ds_a, mean_nmse=nm_a
    )

    # layout B — sp across processes (every ADMM iteration's Gram psum
    # crosses the process boundary), dp inside each process's devices
    grid_b = np.array(devs).reshape(nproc, local).transpose(1, 0)[:, :, None]
    mesh_b = Mesh(grid_b, ("dp", "sp", "tp"))
    host_b = _host_problem(sp=nproc, dp=local)
    ds_b, nm_b = run_layout(mesh_b, host_b, Imax=args.imax)
    results["sp_across_processes"] = dict(
        mesh=list(mesh_b.devices.shape), max_abs_dS=ds_b, mean_nmse=nm_b
    )

    ok = ds_a < 2e-4 and ds_b < 2e-4
    results["ok"] = ok
    print(f"[hybrid {pid}] {results}", flush=True)
    if pid == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
