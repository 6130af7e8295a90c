"""3D cloud-field construction (NumPy copy of ``er3t_tpu/pre/cld.py``:
``cal_ext`` and ``Cloud3D`` :32-97, ``_regular_grid``, ``cld_gen_hom``,
``cld_gen_hem``, ``_maps_to_3d`` and ``cld_gen_cop`` :178-323).  The
reference's netCDF-backed ``cld_les`` and ``cld_sat`` are not copied yet
(ROADMAP A13).  Every builder returns a :class:`Cloud3D` of (Nx, Ny, Nz)
NumPy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..physics.constants import RHO_WATER
from ..util.grid import downscale_3d

__all__ = ['Cloud3D', 'cld_gen_hom', 'cld_gen_hem', 'cld_gen_cop',
           'cal_ext']


def cal_ext(cot, cer, dz_km=1.0, qe=2.0):
    """Extinction [1/m] from optical thickness + effective radius [um].

    Petty (2006) eq. 7.70/7.86 chain, as in the reference
    (er3t/util/util.py:1104-1131): lwp = 2/3 * cot * cer / 1000 [g/m^2].
    """
    lwp = 2.0 / 3000.0 * cot * cer          # g/m^2
    lwc = lwp / (dz_km * 1000.0)            # g/m^3
    return 0.75 * qe * lwc / cer * 1.0e3 / RHO_WATER * 1000.0


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

    @property
    def cot_2d(self) -> np.ndarray:
        return self.cot.sum(axis=-1)

    @property
    def cloud_mask_2d(self) -> np.ndarray:
        return self.cot_2d > 0.0

    def coarsen(self, factors) -> 'Cloud3D':
        """Block-average by (fx, fy, fz) (reference: cld_les.py:286-331)."""
        fx, fy, fz = factors
        nx, ny, nz = self.nx // fx, self.ny // fy, self.nz // fz
        if self.nx % fx or self.ny % fy or self.nz % fz:
            raise ValueError('grid not divisible by coarsening factors')
        ext = downscale_3d(self.extinction, (nx, ny, nz))
        cer = downscale_3d(self.cer, (nx, ny, nz))
        tmp = None if self.temperature is None else downscale_3d(self.temperature, (nx, ny, nz))
        alt = self.altitude[:nz * fz].reshape(nz, fz).mean(axis=1)
        thick = self.thickness[:nz * fz].reshape(nz, fz).sum(axis=1)
        return Cloud3D(
            x=self.x[:nx * fx].reshape(nx, fx).mean(axis=1),
            y=self.y[:ny * fy].reshape(ny, fy).mean(axis=1),
            dx=self.dx * fx, dy=self.dy * fy,
            altitude=alt, thickness=thick,
            extinction=ext, cer=cer, temperature=tmp)


def _regular_grid(nx, ny, dx, dy):
    x = (np.arange(nx) + 0.5) * dx
    y = (np.arange(ny) + 0.5) * dy
    return x, y


def cld_gen_hom(nx=2, ny=2, nz=1, dx=1.0, dy=1.0, cot0=10.0, cer0=10.0,
                cloud_base=1.0, cloud_top=2.0) -> Cloud3D:
    """Homogeneous box cloud with total optical thickness ``cot0``."""
    x, y = _regular_grid(nx, ny, dx, dy)
    edges = np.linspace(cloud_base, cloud_top, nz + 1)
    alt = 0.5 * (edges[1:] + edges[:-1])
    thick = np.diff(edges)
    ext = np.full((nx, ny, nz), cot0 / (cloud_top - cloud_base) / 1000.0)
    cer = np.full((nx, ny, nz), cer0)
    return Cloud3D(x=x, y=y, dx=dx, dy=dy, altitude=alt, thickness=thick,
                   extinction=ext, cer=cer)


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
