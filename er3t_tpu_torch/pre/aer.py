"""Aerosol layers (NumPy copy of ``er3t_tpu/pre/aer.py:11-55``: ``Aerosol1D``,
``Aerosol3D`` and ``aer_gen``).  The reference's netCDF-backed ``aer_les``
and ``aer_lasso`` are not copied yet (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ['Aerosol1D', 'Aerosol3D', 'aer_gen']


@dataclasses.dataclass
class Aerosol1D:
    """Homogeneous aerosol layer between ``z_bottom`` and ``z_top`` [km]."""
    aod: float
    ssa: float = 0.9
    asy: float = 0.7
    z_bottom: float = 0.0
    z_top: float = 2.0

    def extinction_profile(self, z_lay: np.ndarray, dz_lay: np.ndarray) -> np.ndarray:
        """(Nz,) extinction [1/m] on an atmosphere layer grid."""
        inside = (z_lay >= self.z_bottom) & (z_lay <= self.z_top)
        depth_km = max(self.z_top - self.z_bottom, 1e-6)
        ext = np.where(inside, self.aod / (depth_km * 1000.0), 0.0)
        return ext


@dataclasses.dataclass
class Aerosol3D:
    """Aerosol on the 3D cloud grid: (Nx, Ny, Nz) extinction [1/m]."""
    extinction: np.ndarray
    ssa: float = 0.9
    asy: float = 0.7


def aer_gen(aod, ssa=0.9, asy=0.7, z_bottom=0.0, z_top=2.0,
            aod_2d=None, nz=None) -> Aerosol1D | Aerosol3D:
    """Build an aerosol layer; with ``aod_2d`` returns a 3D map extrusion."""
    if aod_2d is None:
        return Aerosol1D(aod=float(aod), ssa=ssa, asy=asy,
                         z_bottom=z_bottom, z_top=z_top)
    aod_2d = np.asarray(aod_2d, dtype=np.float64)
    nz = nz or 1
    depth_km = max(z_top - z_bottom, 1e-6)
    ext = np.repeat(aod_2d[..., None] / (depth_km * 1000.0), nz, axis=-1)
    return Aerosol3D(extinction=ext, ssa=ssa, asy=asy)
