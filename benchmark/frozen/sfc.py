"""Frozen copy of ``er3t_tpu_torch/pre/sfc.py:18, 23-51`` (``Surface``,
``sfc_lambertian``), kept for the benchmark's inputs and its plain
reference; do not edit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SFC_LAMBERTIAN = 1


@dataclasses.dataclass
class Surface:
    """2D surface map: per-pixel BRDF type and parameters.

    ``jsfc`` (Nx, Ny) int type codes; ``psfc`` (Nx, Ny, 5) parameters.
    A uniform surface is represented with Nx=Ny=1 (the scene builder
    broadcasts it).
    """
    jsfc: np.ndarray
    psfc: np.ndarray

    @property
    def nx(self) -> int:
        return self.jsfc.shape[0]

    @property
    def ny(self) -> int:
        return self.jsfc.shape[1]


def sfc_lambertian(albedo) -> Surface:
    """Uniform or 2D Lambertian surface from a scalar / (Nx, Ny) albedo."""
    alb = np.atleast_2d(np.asarray(albedo, dtype=np.float64))
    alb = np.clip(alb, 0.0, 1.0)
    nx, ny = alb.shape
    jsfc = np.full((nx, ny), SFC_LAMBERTIAN, dtype=np.int32)
    psfc = np.zeros((nx, ny, 5), dtype=np.float64)
    psfc[..., 0] = alb
    return Surface(jsfc=jsfc, psfc=psfc)
