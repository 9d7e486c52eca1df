"""jstsp19 — a JAX/XLA framework for wideband
mmWave MIMO channel estimation via random spatial sampling.

Re-designed from scratch with the capabilities of the reference MATLAB suite
(vlaxose/jstsp19: E. Vlachos, G. C. Alexandropoulos, J. Thompson, "Wideband
MIMO Channel Estimation for Hybrid Beamforming Millimeter Wave Systems via
Random Spatial Sampling", IEEE JSTSP 13(5), 2019), but idiomatic JAX:

- everything is batched (`vmap` over Monte-Carlo realizations) and compiled
  (`jit` + `lax.fori_loop` solver iterations, static shapes throughout);
- the beamspace kron operator is never materialized (vec(A·S·B) identity);
- SVD shrinkage runs through Hermitian `eigh` of the small Gram;
- multi-device scaling is expressed with `jax.sharding.Mesh` + `shard_map`
  (dp = Monte-Carlo, sp = training frames, tp = beamspace grid) with XLA
  collectives, not host-side process pools.

Layer map (mirrors SURVEY.md §7):
  core/      typed configs, PRNG plumbing, metrics, dtype policy
  channel/   wideband frequency-selective mmWave channel generator
  frontend/  beamformers, 4-QAM, quantizer, training frames, HBF measurement
  ops/       linear-operator library (adjoint pairs, implicit kron, FFT/WHT)
  solvers/   SVT / ADMM family / OMP family / CoSaMP / LS / VAMP-GLM / GAMP
  harness/   the 14 experiment drivers as typed recipes + sweep runner
  parallel/  mesh construction, sharded solvers, scaling benchmarks
"""

__version__ = "0.1.0"

from jstsp19.core.config import (  # noqa: F401
    SystemConfig,
    canonical_system,
)
