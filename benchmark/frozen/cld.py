"""Frozen copy of ``er3t_tpu_torch/pre/cld.py:36-64, 171-176, 190-255`` (``Cloud3D``,
``_regular_grid``, ``cld_gen_hem``), kept for the benchmark's inputs and its plain
reference; do not edit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ['Cloud3D', 'cld_gen_hem']


@dataclasses.dataclass
class Cloud3D:
    """A 3D cloudy region on a regular grid, (Nx, Ny, Nz) arrays."""
    x: np.ndarray               # (Nx,) km, cell centres
    y: np.ndarray               # (Ny,) km
    dx: float                   # km
    dy: float                   # km
    altitude: np.ndarray        # (Nz,) km, layer centres
    thickness: np.ndarray       # (Nz,) km
    extinction: np.ndarray      # (Nx, Ny, Nz) 1/m
    cer: np.ndarray             # (Nx, Ny, Nz) um (0 where clear)
    temperature: np.ndarray | None = None  # (Nx, Ny, Nz) K

    @property
    def nx(self) -> int:
        return self.x.size

    @property
    def ny(self) -> int:
        return self.y.size

    @property
    def nz(self) -> int:
        return self.altitude.size

    @property
    def cot(self) -> np.ndarray:
        """(Nx, Ny, Nz) per-cell optical thickness."""
        return self.extinction * self.thickness[None, None, :] * 1000.0


def _regular_grid(nx, ny, dx, dy):
    x = (np.arange(nx) + 0.5) * dx
    y = (np.arange(ny) + 0.5) * dy
    return x, y


def cld_gen_hem(nx=100, ny=100, nz=20, dx=0.1, dy=0.1, dz=0.1,
                cloud_frac_tgt=0.2, radii=(1.0,), weights=None,
                w2h_ratio=1.0, min_dist=0.0, cot_scale=20.0, cer0=10.0,
                cloud_base=0.5, seed=0, max_attempts=20000) -> Cloud3D:
    """Synthetic scene of hemispherical clouds (reference: cld_gen.py:180-469).

    Hemispheres with radii drawn from ``radii`` (probabilities ``weights``)
    are placed by rejection sampling until the 2D cloud fraction reaches
    ``cloud_frac_tgt``, keeping ``min_dist`` [km] between cloud edges.
    Each cloud is a vertically-erected hemisphere (width/height ratio
    ``w2h_ratio``) of uniform extinction set by ``cot_scale`` (the optical
    thickness through a cloud of 1 km geometric depth).
    """
    rng = np.random.default_rng(seed)
    x, y = _regular_grid(nx, ny, dx, dy)
    z_edges = cloud_base + np.arange(nz + 1) * dz
    alt = 0.5 * (z_edges[1:] + z_edges[:-1])
    thick = np.full(nz, dz)

    radii = np.asarray(radii, dtype=np.float64)
    if weights is None:
        weights = np.full(radii.size, 1.0 / radii.size)
    weights = np.asarray(weights) / np.sum(weights)

    xx, yy = np.meshgrid(x, y, indexing='ij')
    mask2d = np.zeros((nx, ny), dtype=bool)
    placed: list[tuple[float, float, float]] = []
    lx, ly = nx * dx, ny * dy

    attempts = 0
    while mask2d.mean() < cloud_frac_tgt and attempts < max_attempts:
        attempts += 1
        r = float(rng.choice(radii, p=weights))
        cx, cy = rng.uniform(0, lx), rng.uniform(0, ly)
        ok = True
        for px, py, pr in placed:
            ddx = min(abs(cx - px), lx - abs(cx - px))
            ddy = min(abs(cy - py), ly - abs(cy - py))
            if np.hypot(ddx, ddy) < (r + pr + min_dist):
                ok = False
                break
        if not ok:
            continue
        placed.append((cx, cy, r))
        ddx = np.minimum(np.abs(xx - cx), lx - np.abs(xx - cx))
        ddy = np.minimum(np.abs(yy - cy), ly - np.abs(yy - cy))
        mask2d |= (ddx ** 2 + ddy ** 2) <= r ** 2

    ext = np.zeros((nx, ny, nz))
    cer = np.zeros((nx, ny, nz))
    ext0 = cot_scale / 1000.0  # 1/m for a 1-km cloud
    for cx, cy, r in placed:
        h = r / w2h_ratio
        ddx = np.minimum(np.abs(xx - cx), lx - np.abs(xx - cx))
        ddy = np.minimum(np.abs(yy - cy), ly - np.abs(yy - cy))
        rho2 = (ddx ** 2 + ddy ** 2) / r ** 2
        for k, zc in enumerate(alt):
            zr = (zc - cloud_base) / h
            if zr < 0 or zr > 1:
                continue
            inside = rho2 + zr ** 2 <= 1.0
            ext[inside, k] = ext0
            cer[inside, k] = cer0
    return Cloud3D(x=x, y=y, dx=dx, dy=dy, altitude=alt, thickness=thick,
                   extinction=ext, cer=cer)
