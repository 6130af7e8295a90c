"""High-level solver of the port — the front door (counterpart of
``er3t_tpu/rtm/solver.py``).

:func:`solve` builds a scene on the given device, runs ``n_run`` independent
transport passes split into chunks, and reduces the tallies to physical
radiance with the mean and std over runs (the reference's MC-noise
protocol).  This slice runs satellite radiance with the 3D solver and
correlated g-points; every other option raises ``NotImplementedError``
naming its ROADMAP item.

Unlike the reference, a chunk that fails is not retried or skipped: the
error propagates, so a fault on the card is never turned into a photon
deficit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import out
from .mc import SolverConfig
from .mc_flight import check_supported, run_transport_flight
from .scene import build_scene

__all__ = ['solve', 'Result']


@dataclasses.dataclass
class Result:
    """Physical outputs with per-run statistics (the reference's
    ``Result`` fields; ``runs`` holds every run's fields with
    ``mode='all'``)."""
    target: str
    data: dict                  # mean fields
    std: dict                   # std fields
    toa: float
    n_photon: float
    n_run: int
    n_photon_effective: float = 0.0   # photons launched over all runs
    runs: list = dataclasses.field(default_factory=list)

    def __getitem__(self, k):
        return self.data[k]


def _single_run(scene, static, cfg, n_photon, seed, device, chunk=4_000_000,
                rad_w=None):
    """One independent pass, split into chunks of at most ``chunk`` photons
    (chunks differ only by seed, ``seed + 7919 * i`` as in the reference).
    Returns the summed (Nx, Ny, Ng_r) tally on the host and the launched
    count."""
    rad = None
    n_total = 0
    remaining = int(n_photon)
    i = 0
    while remaining > 0:
        n_c = min(remaining, chunk)
        tal = run_transport_flight(scene, static, cfg, n_c, seed + 7919 * i,
                                   device, rad_w=rad_w)
        rad = tal.rad if rad is None else rad + tal.rad
        n_total += int(tal.n_launched)
        remaining -= n_c
        i += 1
    return rad.cpu().numpy(), n_total


def solve(atm=None, abs_coef=None, cld=None, pha=None, aer_1ds=(), aer_3ds=(),
          surface=0.03, target='radiance', solver='3d', p3d_order=1,
          solar_zenith_angle=30.0, solar_azimuth_angle=0.0,
          sensor_zenith_angle=0.0, sensor_azimuth_angle=0.0,
          sensor_type='satellite', camera=None,
          photons=1e6, n_run=3, date=None, seed=0, batch=None,
          spectral='correlated', flux_per_column=None, chunk=4_000_000,
          forward_trunc_deg=None, tile_size=0, flux_engine='flight',
          flux_kcross=4, cf_dtau=0.0, pathlength=False, split_wmax=0.0,
          rr_wmin=0.1, n_scat_max=2000, mesh=None, diffusion=0,
          qmc_launch=False, pfpeak=None, mode='mean', *, device='cuda'):
    """Run a radiance simulation on ``device`` (the card unless the caller
    asks for the CPU); parameters as the reference's ``solve``
    (``er3t_tpu/rtm/solver.py:223``).  ``batch``
    defaults to 2^17 lanes on a GPU and 2^14 on the CPU;
    ``flux_per_column`` has no effect on radiance, as in the reference.
    Returns a :class:`Result` with ``rad`` (Nx, Ny) and ``rad_std``."""
    if mode not in ('mean', 'all'):
        raise ValueError(f"mode must be 'mean' or 'all'; got {mode!r}")
    if atm is None or abs_coef is None:
        raise ValueError('atm and abs_coef are required')
    target = {'f': 'flux', 'flux': 'flux', 'irradiance': 'flux',
              'rad': 'radiance', 'radiance': 'radiance',
              'hr': 'heating_rate', 'heating rate': 'heating_rate',
              'heating_rate': 'heating_rate'}[target.lower()]
    solver = solver.lower()
    if solver not in ('3d', 'p3d', 'ipa', '1d'):
        raise ValueError(f"solver must be '3d', 'p3d' or 'ipa'; got {solver!r}")
    ipa = solver in ('ipa', '1d')
    if camera:
        sensor_type = 'camera'
    device = torch.device(device)
    if batch is None:
        batch = 1 << 17 if device.type == 'cuda' else 1 << 14
    cfg = SolverConfig(
        target='radiance' if target == 'radiance' else 'flux',
        batch=int(batch),
        sensor_zenith=float(sensor_zenith_angle),
        sensor_azimuth=float(sensor_azimuth_angle),
        tile_size=int(tile_size),
        p3d_order=int(p3d_order) if solver == 'p3d' else 0,
        cf_dtau=float(cf_dtau), pathlength=bool(pathlength),
        sensor_type=sensor_type, flux_engine=flux_engine,
        flux_kcross=int(flux_kcross), split_wmax=float(split_wmax),
        rr_wmin=float(rr_wmin), n_scat_max=int(n_scat_max),
        qmc_launch=bool(qmc_launch))
    check_supported(cfg, ipa)
    for bad, msg in (
            (spectral != 'correlated',
             f'spectral={spectral!r}: the independent-g protocol is ROADMAP A9'),
            (mesh is not None, 'multi-device runs (mesh=) are ROADMAP A12'),
            (diffusion > 0, 'diffusion smoothing is ROADMAP A9')):
        if bad:
            raise NotImplementedError('er3t_tpu_torch solve: ' + msg)

    scene, static = build_scene(
        atm, abs_coef, cld=cld, pha=pha, aer_1ds=aer_1ds, aer_3ds=aer_3ds,
        surface=surface, solar_zenith_angle=solar_zenith_angle,
        solar_azimuth_angle=solar_azimuth_angle, ipa=ipa,
        forward_trunc_deg=forward_trunc_deg, pfpeak=pfpeak, device=device)

    mu0 = float(np.cos(np.deg2rad(solar_zenith_angle)))
    # image deposits are contracted over g in the step (rad_w)
    rad_w = out.spectral_factors(abs_coef, date=date, nz_out=1)[0][0]
    per_run = []
    n_eff = 0
    for r in range(n_run):
        rad_t, n_l = _single_run(scene, static, cfg, int(photons),
                                 seed + 1000003 * r, device, chunk=chunk,
                                 rad_w=rad_w)
        n_eff += n_l
        per_run.append(out.reduce_radiance(rad_t, n_l, abs_coef, mu0,
                                           date=date, precontracted=True))

    keys = [k for k in per_run[0] if k != 'toa']
    data = {k: np.mean([p[k] for p in per_run], axis=0) for k in keys}
    std = {k + '_std': np.std([p[k] for p in per_run], axis=0) for k in keys}
    return Result(target=target, data=data, std=std, toa=per_run[0]['toa'],
                  n_photon=photons, n_run=n_run, n_photon_effective=n_eff,
                  runs=(per_run if mode == 'all' else []))
