"""Frozen copy of ``er3t_tpu_torch/pre/cld.py:257-316`` (``_maps_to_3d``,
``cld_gen_cop``, at 33c2d55), kept for the benchmark's inputs and its plain
reference; do not edit.  ``Cloud3D`` and ``_regular_grid`` are the frozen
copies of :mod:`.cld`.
"""

from __future__ import annotations

import numpy as np

from .cld import Cloud3D, _regular_grid

__all__ = ['cld_gen_cop']


def _maps_to_3d(x, y, dx, dy, cot2d, cer2d, cth2d, cgt2d, dz=0.1, qe=2.0):
    """Common 2D->3D stacking for cld_gen_cop / cld_sat.

    COT-conserving: each pixel's optical thickness is distributed over the
    layers by their EXACT geometric overlap with [cth-cgt, cth], so
    sum_k(ext_k * dz) == cot for every cloudy pixel regardless of how the
    slab aligns with the layer grid.  (A layer-center membership test both
    dropped sub-layer clouds entirely — a 50 m slab between two layer
    centers — and scaled COT by n_layers*dz/cgt when cgt was not a layer
    multiple.)  Pixels with non-finite cth/cgt are treated as clear."""
    cloudy = cot2d > 0
    finite = np.isfinite(cth2d) & np.isfinite(cgt2d)
    cloudy = cloudy & finite
    tops = cth2d[cloudy]
    cth_max = float(tops.max()) if tops.size else 1.0
    cth_max = max(cth_max, dz)
    nz = max(int(np.ceil(cth_max / dz - 1e-9)), 1)
    z_edges = np.arange(nz + 1) * dz
    alt = 0.5 * (z_edges[1:] + z_edges[:-1])
    thick = np.full(nz, dz)

    nx, ny = cot2d.shape
    ext = np.zeros((nx, ny, nz))
    cer = np.zeros((nx, ny, nz))
    cot2d = np.where(cloudy, cot2d, 0.0)     # NaN-safe outside clouds
    cer2d = np.where(cloudy, cer2d, 0.0)
    cth = np.where(finite, cth2d, 0.0)
    cbh = np.clip(cth - np.where(finite, cgt2d, 0.0), 0.0, None)
    # degenerate (zero/negative) geometric thickness: one dz-thin slab
    # below cloud top so the retrieved COT is not silently dropped
    cbh = np.where(cloudy & (cth - cbh <= 0),
                   np.clip(cth - dz, 0.0, None), cbh)
    geom = np.maximum(cth - cbh, 1e-12)          # total geometric extent
    for k, (z0, z1) in enumerate(zip(z_edges[:-1], z_edges[1:])):
        overlap = np.clip(np.minimum(z1, cth) - np.maximum(z0, cbh),
                          0.0, None)
        w = np.where(cloudy, overlap / geom, 0.0)   # sums to 1 over k
        ext[..., k] = cot2d * w / (dz * 1000.0)     # 1/m
        cer[..., k] = np.where(w > 0, cer2d, 0.0)
    return Cloud3D(x=x, y=y, dx=dx, dy=dy, altitude=alt, thickness=thick,
                   extinction=ext, cer=cer)


def cld_gen_cop(cot_2d, cer_2d, cth_2d, cgt_2d=None, dx=0.25, dy=0.25,
                dz=0.1) -> Cloud3D:
    """3D cloud from 2D retrieval maps (cloud optical property generator).

    ``cth_2d`` cloud-top height [km], ``cgt_2d`` geometric thickness [km]
    (default: 1 km capped at cth).  Extinction = cot / cgt within
    [cth-cgt, cth] (reference semantics: cld_gen.py:703-..., cld_sat.py:219-245).
    """
    cot_2d = np.asarray(cot_2d, dtype=np.float64)
    cer_2d = np.asarray(cer_2d, dtype=np.float64)
    cth_2d = np.asarray(cth_2d, dtype=np.float64)
    if cgt_2d is None:
        cgt_2d = np.minimum(1.0, cth_2d)
    cgt_2d = np.asarray(cgt_2d, dtype=np.float64)
    nx, ny = cot_2d.shape
    x, y = _regular_grid(nx, ny, dx, dy)
    return _maps_to_3d(x, y, dx, dy, cot_2d, cer_2d, cth_2d, cgt_2d, dz=dz)
