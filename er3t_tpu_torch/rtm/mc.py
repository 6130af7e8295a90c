"""Solver configuration, tallies and sensor geometry (port of
``er3t_tpu/rtm/mc.py:53-285``).

``SolverConfig`` keeps the reference's fields, defaults and frozen-dataclass
form, so one set of keyword arguments configures both packages; only the
profiling knob ``ablate`` is left out.  The field docs are abridged here —
the reference module carries the full notes.  The event-marching
``transport`` of the reference is not ported yet (ROADMAP A11): flux
targets run the flight engine, and ``flux_engine='marching'`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ['SolverConfig', 'Tallies']


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (hashable)."""
    target: str = 'radiance'           # 'radiance' | 'flux' | 'heating_rate'
    batch: int = 1 << 17               # photon lanes
    sensor_zenith: float = 0.0         # deg
    sensor_azimuth: float = 0.0        # deg
    flux_per_column: bool = False      # tally fluxes per (x, y) column
    max_events: int = 0                # step cap; 0 -> (n // batch + 2) * 400
    rr_wmin: float = 0.1               # Russian-roulette threshold
    rr_value: float = 0.0              # >0: sensor-importance roulette
    n_scat_max: int = 2000
    p3d_order: int = 0                 # >0: partial-3D column pinning
    pathlength: bool = False           # mean pathlength tally (Rad_mplen)
    sensor_type: str = 'satellite'     # 'satellite' | 'camera'
    use_pallas: bool = False           # accepted for parity with the
    #                                     reference; the port's phase-pair
    #                                     lookup is exact f32 either way
    cf_dtau: float = 0.0               # >0: collision forcing threshold
    flux_engine: str = 'flight'        # 'flight' ('marching': ROADMAP A11)
    flux_kcross: int = 4               # per-column flux crossing clamp:
    #                                     at most this many level crossings
    #                                     per flight (0: no clamp)
    tile_size: int = 0                 # >0: per-tile scattering majorants
    split_wmax: float = 0.0            # >0: weight-window splitting
    cam_xpos: float = 0.5              # camera position, domain fractions
    cam_ypos: float = 0.5
    cam_zloc: float = 0.0              # camera altitude [m]
    cam_phi: float = 0.0               # Z-Y-Z Euler camera pointing [deg]
    cam_the: float = 0.0
    cam_psi: float = 0.0
    cam_qmax: float = 89.0             # fisheye half-angle [deg]
    cam_npix: int = 64                 # image is (cam_npix, cam_npix)
    cam_rmin: float = 50.0             # point-estimator distance clamp [m]
    cam_apsize: float = 0.0            # aperture radius [m]
    qmc_launch: bool = False           # stratified-jitter launch
    launch_coherent: bool = False      # stratified launch, linear cell map
    cam_importance_sigma: float = 0.0  # camera importance-sampled launch
    drain_compact: bool = True         # compact survivors into B/8, B/64
    #                                     batches once the budget is launched
    sort_every: int = 0                # >0: periodic lane re-sort


class Tallies(NamedTuple):
    """Raw transport tallies, in photon-weight units (torch tensors)."""
    rad: torch.Tensor             # (Nxr, Nyr, Ng), or (Nxr, Nyr, 1) with rad_w;
    #                               (Nx, Ny) satellite, (npix, npix) camera
    flux: torch.Tensor            # (Nxf, Nyf, Nz+1, 3, Ng) level crossings,
    #                               channels (down-direct, down-diffuse, up);
    #                               (..., 1) with flux_w; zeros for radiance
    n_launched: torch.Tensor      # () int64
    n_steps: torch.Tensor         # () int64 loop steps
    rad_plen: torch.Tensor        # (Nxr, Nyr, Ng) pathlength-weighted image
    #                               with cfg.pathlength, else a 0-d zero
    lane_iters: torch.Tensor      # () float64 sum over steps of batch width
    absorbed: torch.Tensor        # (Nz, Ng) direct absorbed-energy tally of
    #                               domain-average flux runs (MCARaTS
    #                               Flx_mhrt), else (1, 1) zeros


def _sensor_dir(cfg: SolverConfig):
    """Unit vector of radiation travelling TOWARD the sensor (upward)."""
    th = np.deg2rad(cfg.sensor_zenith)
    # sensor azimuth: position angle of the sensor from the target
    # (0 = north = +y), so travel direction components:
    ph = np.deg2rad(270.0 - cfg.sensor_azimuth)
    mu_s = float(np.cos(th))
    sx = float(np.sin(th) * np.cos(ph))
    sy = float(np.sin(th) * np.sin(ph))
    return sx, sy, mu_s
