"""Compressed-sensing MRI reconstruction with GAMP — the ``MRI/`` family.

The reference's medical-imaging application acquires undersampled,
noise-free k-space data of a wavelet-sparse image through
``Z = M·F·Wᴴ·X`` (``main/MedImageLinTrans.m``).  Here the same operator
(``ops/structured.py::MedImageOp``: binary k-space mask ∘ orthonormal 2-D
DFT ∘ multi-level 2-D Haar synthesis) reconstructs a synthetic
piecewise-constant phantom from a fraction of k-space via GAMP with a
spike-slab wavelet prior, vs the naive zero-filled inverse FFT.

Run: python examples/cs_mri.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from jstsp19.ops import MedImageOp
from jstsp19.solvers import CAwgnLikelihood, CAwgnPrior, SparsePrior
from jstsp19.solvers.gamp_full import GampOptions, gamp_est


def _phantom(ny, nx, rng):
    """Piecewise-constant blocks — sparse under the Haar basis."""
    img = np.zeros((ny, nx))
    for _ in range(6):
        y0, x0 = rng.integers(0, ny - 8, 2)
        h, w = rng.integers(4, ny // 3, 2)
        img[y0:y0 + h, x0:x0 + w] += rng.uniform(0.3, 1.0)
    return img


def main():
    rng = np.random.default_rng(2)
    ny = nx = 32
    n = ny * nx
    levels = 3
    frac = 0.35  # 35% of k-space acquired

    img = _phantom(ny, nx, rng)
    # variable-density mask: always keep the low-frequency square
    keep = set()
    for i in range(ny):
        for j in range(nx):
            fy = min(i, ny - i)
            fx = min(j, nx - j)
            if fy <= 2 and fx <= 2:
                keep.add(i * nx + j)
    rest = [k for k in range(n) if k not in keep]
    keep |= set(rng.choice(rest, int(frac * n) - len(keep), False).tolist())
    idx = tuple(sorted(keep))

    op = MedImageOp(ny, nx, levels, idx)
    c_true = op._analysis(jnp.asarray(img, jnp.complex64))
    y = op.mv(c_true.reshape(-1))

    k_sparsity = float(jnp.mean(jnp.abs(c_true) > 1e-3))
    prior = SparsePrior(
        base=CAwgnPrior(mean0=jnp.asarray(0.0 + 0.0j), var0=jnp.asarray(1.0)),
        p1=max(k_sparsity, 0.02),
    )
    fin, _, _ = gamp_est(
        prior, CAwgnLikelihood(y=y, wvar=jnp.asarray(1e-6)), op,
        GampOptions(nit=80, pvar_min=1e-8),
    )
    rec = op._synthesis(fin.xhat.reshape(ny, nx)).real

    # zero-filled baseline: scatter the acquired k-space, inverse FFT
    full = jnp.zeros((n,), jnp.complex64).at[np.asarray(idx)].set(y)
    zf = jnp.fft.ifft2(full.reshape(ny, nx), norm="ortho").real

    def nmse_db(x):
        e = float(np.sum((np.asarray(x) - img) ** 2) / np.sum(img**2))
        return 10 * np.log10(max(e, 1e-30))

    print(f"{ny}x{nx} phantom, {len(idx)}/{n} k-space samples "
          f"({100 * len(idx) / n:.0f}%), Haar levels={levels}, "
          f"wavelet density={k_sparsity:.2f}")
    print(f"GAMP + MedImageOp reconstruction: {nmse_db(rec):7.1f} dB NMSE")
    print(f"zero-filled IFFT baseline:        {nmse_db(np.asarray(zf)):7.1f} dB NMSE")


if __name__ == "__main__":
    main()
