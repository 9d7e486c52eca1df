"""Ring collectives (parallel/ring.py) on the 8-virtual-device mesh:
ppermute ring reduction must equal psum, and the pipelined map must equal
the all-gather-then-map result."""
import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jstsp19.parallel.ring import (
    mc_mean_ring,
    ring_allreduce_mean,
    ring_pipeline_map,
)


def _mesh(n=8):
    return Mesh(np.asarray(jax.devices()[:n]), ("mc",))


def test_ring_allreduce_matches_psum():
    mesh = _mesh()
    x = jax.random.normal(jax.random.key(0), (8, 16))
    x = jax.device_put(x, NamedSharding(mesh, P("mc")))

    @jax.jit
    @jax.tree_util.Partial(
        shard_map, mesh=mesh, in_specs=P("mc"), out_specs=P("mc")
    )
    def via_ring(x):
        return ring_allreduce_mean(x, "mc")

    @jax.jit
    @jax.tree_util.Partial(
        shard_map, mesh=mesh, in_specs=P("mc"), out_specs=P("mc")
    )
    def via_psum(x):
        return jax.lax.psum(x, "mc") / jax.lax.axis_size("mc")

    np.testing.assert_allclose(
        np.asarray(via_ring(x)), np.asarray(via_psum(x)), rtol=1e-6
    )


def test_ring_pipeline_map_equals_allgather_map():
    mesh = _mesh()
    x = jax.random.normal(jax.random.key(1), (8, 4))
    xs = jax.device_put(x, NamedSharding(mesh, P("mc")))
    f = lambda s: jnp.sum(s**2) + 3.0

    @jax.jit
    @jax.tree_util.Partial(
        shard_map, mesh=mesh, in_specs=P("mc"), out_specs=P("mc", None)
    )
    def pipelined(xl):
        return ring_pipeline_map(f, xl[0], "mc")[None]

    got = np.asarray(pipelined(xs))  # (8 devices, 8 origins)
    want = np.asarray(jax.vmap(f)(x))  # (8,)
    for d in range(8):
        np.testing.assert_allclose(got[d], want, rtol=1e-6)


def test_mc_mean_ring_full_batch():
    mesh = _mesh()
    errs = jax.random.uniform(jax.random.key(2), (32, 5))
    sh = jax.device_put(
        errs.reshape(8, 4, 5), NamedSharding(mesh, P("mc"))
    )

    @jax.jit
    @jax.tree_util.Partial(
        shard_map, mesh=mesh, in_specs=P("mc"), out_specs=P("mc", None)
    )
    def mean_ring(e):
        return mc_mean_ring(e[0], "mc")[None]

    got = np.asarray(mean_ring(sh))
    want = np.asarray(jnp.mean(errs, axis=0))
    for d in range(8):
        np.testing.assert_allclose(got[d], want, rtol=1e-5)
