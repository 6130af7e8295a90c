"""Aerosol layers (NumPy copy of ``er3t_tpu/pre/aer.py:11-87``: ``Aerosol1D``,
``Aerosol3D``, ``aer_gen``, and the LES loaders ``aer_les`` and
``aer_lasso``, which read the snapshot through the port's ``cld_les``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ['Aerosol1D', 'Aerosol3D', 'aer_gen', 'aer_les', 'aer_lasso']


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


def aer_les(fname_nc, ssa=0.9, asy=0.7, coarsen=(1, 1, 1), q_factor=2.0,
            index_t=0, ext_scale=1.0) -> Aerosol3D:
    """LES (SAM netCDF) snapshot -> 3D aerosol constituent.

    Reference role: ``er3t.pre.aer.aer_les`` (aer_les.py:110-170), whose
    extinction pipeline is byte-identical to ``cld_les``'s (it reads
    QC/REL/NC and applies 0.75*Q*LWC/CER) — here the LES ingestion is shared
    with :func:`er3t_tpu_torch.pre.cld.cld_les` and the field is wrapped as an
    :class:`Aerosol3D` with user-set single-scattering albedo / asymmetry
    (and an optional extinction scale to convert the water-tracer field into
    an aerosol loading proxy).  The returned grid matches the LES cloud grid
    so it can be passed through ``solve(aer_3ds=[...])`` alongside the
    matching ``cld_les`` cloud.
    """
    from .cld import cld_les
    c = cld_les(fname_nc, coarsen=coarsen, q_factor=q_factor, index_t=index_t)
    ext = np.asarray(c.extinction, dtype=np.float64) * float(ext_scale)
    return Aerosol3D(extinction=ext, ssa=float(ssa), asy=float(asy))


def aer_lasso(fname_nc, ssa=0.9, asy=0.7, coarsen=(1, 1, 1), q_factor=2.0,
              index_t=0, ext_scale=1.0) -> Aerosol3D:
    """LASSO aerosol ingestion.

    The upstream ``aer_lasso`` (er3t/pre/aer/aer_lasso.py, marked "planned
    to be overwritten") is an exact duplicate of ``aer_les`` with a
    different ID; this keeps the same equivalence.
    """
    return aer_les(fname_nc, ssa=ssa, asy=asy, coarsen=coarsen,
                   q_factor=q_factor, index_t=index_t, ext_scale=ext_scale)
