"""High-level solver of the port — the front door (counterpart of
``er3t_tpu/rtm/solver.py``).

:func:`solve` builds a scene on the given device, runs ``n_run`` independent
transport passes split into chunks, and reduces the tallies to physical
radiance, fluxes or heating rates with the mean and std over runs (the
reference's MC-noise protocol).  It runs radiance toward a satellite or a
fisheye camera (with the mean pathlength ``plen`` if asked), flux and
heating rate, with the 3D, partial-3D and IPA solvers of the flight engine
and its variance knobs, flux and heating rate also with the event-marching
engine (``flux_engine='marching'``, :func:`~.mc.run_transport`), with
correlated g-points or the reference's independent per-g protocol
(``spectral='independent'``: one pass per g-point, the budget split by
:func:`distribute_photon`), and smooths the mean fields with
``diffusion``; :class:`Result` saves to and loads from the reference's HDF5
layout (``h5py``, imported only there).  With ``mesh=`` (a
:class:`~er3t_tpu_torch.dist.mesh.Mesh`) every pass runs on its ranks:
x-slab decomposed with photon migration where the mesh's 'x' axis is
longer than 1, photon-parallel otherwise.  The quasi-radiance target
(MCARaTS ``Wld_mtarget=3``) is :func:`~.quasi.quasi_radiance`.

Unlike the reference, a chunk that fails is not retried or skipped: the
error propagates, so a fault on the card is never turned into a photon
deficit.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..dist.decomp import transport_decomp
from ..dist.photon import transport_photon_parallel
from ..util import trace
from . import out
from .mc import SolverConfig, run_transport
from .mc_flight import run_transport_flight
from .scene import build_scene

__all__ = ['solve', 'Result', 'distribute_photon', 'g_slice']


def distribute_photon(n_photon, weights, base_ratio=0.05):
    """Photon split over g-points by k-distribution weight with a floor,
    at least one photon each when ``n_photon`` >= the g count (copy of
    ``er3t_tpu/rtm/solver.py:29-51``, integer for integer)."""
    weights = np.asarray(weights, dtype=np.float64)
    nd = weights.size
    dist = (n_photon * (1 - base_ratio) * weights).astype(np.int64) \
        + int(n_photon * base_ratio / nd)
    if n_photon >= nd:
        # the truncated floor can leave a weak g-point with no photon (a
        # pass with no estimate): give each at least one, taken from the
        # heaviest bins
        while (dist == 0).any():
            dist[dist == 0] = 1
            excess = int(dist.sum() - n_photon)
            for _ in range(max(excess, 0)):
                dist[np.argmax(dist)] -= 1
    diff = int(n_photon - dist.sum())
    if diff >= 0:
        dist[np.argmin(weights)] += diff
    else:
        dist[np.argmax(weights)] += diff
    return dist


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

    def save_h5(self, fname, compression='gzip'):
        """Write the reference's HDF5 layout (``er3t_tpu/rtm/solver.py:
        80-106``): a dataset per mean and std field at the root, each run's
        fields in a ``run_NN`` group, and the scalars as attributes; either
        package loads the other's files."""
        import h5py
        with h5py.File(fname, 'w') as f:
            for fields in (self.data, self.std):
                _write_fields(f, fields, compression)
            for r, fields in enumerate(self.runs):
                _write_fields(f.create_group(f'run_{r:02d}'), fields,
                              compression)
            f.attrs['target'] = self.target
            f.attrs['toa'] = self.toa
            f.attrs['n_photon'] = self.n_photon
            f.attrs['n_run'] = self.n_run
            f.attrs['n_photon_effective'] = self.n_photon_effective

    @classmethod
    def load_h5(cls, fname):
        """Read a file of :meth:`save_h5` (either package's)."""
        import h5py
        with h5py.File(fname, 'r') as f:
            data = {k: f[k][...] for k in f
                    if not k.endswith('_std') and not k.startswith('run_')}
            std = {k: f[k][...] for k in f if k.endswith('_std')}
            runs = [{k: f[name][k][...] for k in f[name]}
                    for name in sorted(f) if name.startswith('run_')]
            return cls(target=str(f.attrs['target']), data=data, std=std,
                       toa=float(f.attrs['toa']),
                       n_photon=float(f.attrs['n_photon']),
                       n_run=int(f.attrs['n_run']),
                       n_photon_effective=float(
                           f.attrs.get('n_photon_effective', 0.0)),
                       runs=runs)


def _write_fields(group, fields, compression):
    """One dataset per field: compressed arrays, plain scalars."""
    for k, v in fields.items():
        arr = np.asarray(v)
        if arr.ndim > 0:
            group.create_dataset(k, data=arr, compression=compression)
        else:
            group[k] = arr


def _single_run(scene, static, cfg, n_photon, seed, device, chunk=4_000_000,
                flux_w=None, rad_w=None, mesh=None):
    """One independent pass, split into chunks of at most ``chunk`` photons
    (chunks differ only by seed, ``seed + 7919 * i`` as in the reference),
    on the flight engine for radiance or ``flux_engine='flight'``, else on
    the marching engine; with ``mesh``, on its ranks (reference
    :150-172): decomposed where its 'x' axis is longer than 1, else
    photon-parallel.  Returns the summed image, flux, absorbed and
    pathlength-weighted image tallies on the host and the launched
    count."""
    use_flight = cfg.target == 'radiance' or cfg.flux_engine == 'flight'
    sums = None
    n_total = 0
    remaining = int(n_photon)
    i = 0
    while remaining > 0:
        n_c = min(remaining, chunk)
        with trace.span('solve.flight'):
            if mesh is not None:
                dist_run = (transport_decomp if mesh.shape['x'] > 1
                            else transport_photon_parallel)
                tal = dist_run(scene, static, cfg, n_c, mesh,
                               seed=seed + 7919 * i, flux_w=flux_w,
                               rad_w=rad_w)
            elif use_flight:
                tal = run_transport_flight(scene, static, cfg, n_c,
                                           seed + 7919 * i, device,
                                           flux_w=flux_w, rad_w=rad_w)
            else:
                tal = run_transport(scene, static, cfg, n_c, seed + 7919 * i,
                                    device)
        parts = (tal.rad, tal.flux, tal.absorbed, tal.rad_plen)
        sums = parts if sums is None else [a + b for a, b in zip(sums, parts)]
        n_total += int(tal.n_launched)
        remaining -= n_c
        i += 1
    with trace.span('solve.to_host'):
        rad, flux, absorbed, rad_pl = (t.cpu().numpy() for t in sums)
    return rad, flux, absorbed, rad_pl, n_total


def _plen_ratio(rad, rad_pl, w):
    """Mean pathlength per pixel: the weight-contracted pathlength tally
    over the contracted image, 0 where the image is 0 (reference
    :392-397)."""
    with np.errstate(invalid='ignore', divide='ignore'):
        return np.where(rad @ w > 0, (rad_pl @ w) / np.maximum(rad @ w, 1e-30),
                        0.0)


def _reduce_image(rad_t, n_l, abs_coef, mu0, static, cfg, date,
                  precontracted):
    """The satellite or the camera reduction of a raw image."""
    if cfg.sensor_type != 'camera':
        return out.reduce_radiance(rad_t, n_l, abs_coef, mu0, date=date,
                                   precontracted=precontracted)
    red = out.reduce_camera_radiance(
        rad_t, n_l, abs_coef, mu0,
        domain_area_m2=(static.nx * static.dx) * (static.ny * static.dy),
        qmax_deg=cfg.cam_qmax, date=date, precontracted=precontracted)
    red.pop('solid_angle', None)
    return red


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
    """Run a simulation on ``device`` (the card unless the caller asks for
    the CPU); parameters as the reference's ``solve``
    (``er3t_tpu/rtm/solver.py:223``).  ``batch`` defaults to 2^17 lanes on
    a GPU and 2^14 on the CPU.  Returns a :class:`Result`: radiance has
    ``rad`` (Nx, Ny); flux and heating rate have ``f_down_direct``,
    ``f_down_diffuse``, ``f_down`` and ``f_up`` (Nxf, Nyf, Nz+1), and
    heating rate also ``hr`` (Nz,) [K/day]; each with its ``_std``.
    ``flux_per_column`` defaults to per-column tallies on 3D scenes, except
    for heating rate, whose direct absorbed-energy tally is domain-average
    (reference :301-304).  ``camera``: a dict of ``xpos``, ``ypos``,
    ``zloc``, ``phi``, ``the``, ``psi``, ``qmax``, ``npix`` and ``apsize``
    (any subset; the rest default as in the reference) selects the fisheye
    camera, whose ``rad`` is (npix, npix) with NaN outside the fisheye
    circle; ``pathlength`` adds ``plen`` to radiance results.  ``mesh``:
    a mesh of ``er3t_tpu_torch.dist.mesh.make_mesh`` on whose ranks every
    pass runs (each rank takes a copy of the scene on its device)."""
    with trace.span('solve', request=True):
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
            raise ValueError(
                f"solver must be '3d', 'p3d' or 'ipa'; got {solver!r}")
        ipa = solver in ('ipa', '1d')
        cam = dict(xpos=0.5, ypos=0.5, zloc=0.0, phi=0.0, the=0.0, psi=0.0,
                   qmax=89.0, npix=64, apsize=0.0)
        if camera:
            unknown = set(camera) - set(cam)
            if unknown:
                raise ValueError(
                    f'unknown camera parameter(s) {sorted(unknown)}; '
                    f'valid keys: {sorted(cam)}')
            cam.update(camera)
            sensor_type = 'camera'
        device = torch.device(device)
        if batch is None:
            batch = 1 << 17 if device.type == 'cuda' else 1 << 14
        cfg = SolverConfig(
            target='radiance' if target == 'radiance' else 'flux',
            batch=int(batch),
            sensor_zenith=float(sensor_zenith_angle),
            sensor_azimuth=float(sensor_azimuth_angle),
            flux_per_column=bool(flux_per_column),
            tile_size=int(tile_size),
            p3d_order=int(p3d_order) if solver == 'p3d' else 0,
            cf_dtau=float(cf_dtau), pathlength=bool(pathlength),
            sensor_type=sensor_type, flux_engine=flux_engine,
            flux_kcross=int(flux_kcross), split_wmax=float(split_wmax),
            rr_wmin=float(rr_wmin), n_scat_max=int(n_scat_max),
            cam_xpos=float(cam['xpos']), cam_ypos=float(cam['ypos']),
            cam_zloc=float(cam['zloc']), cam_phi=float(cam['phi']),
            cam_the=float(cam['the']), cam_psi=float(cam['psi']),
            cam_qmax=float(cam['qmax']), cam_npix=int(cam['npix']),
            cam_apsize=float(cam['apsize']),
            qmc_launch=bool(qmc_launch))
        if spectral not in ('correlated', 'independent'):
            raise ValueError(spectral)

        with trace.span('solve.scene'):
            scene, static = build_scene(
                atm, abs_coef, cld=cld, pha=pha, aer_1ds=aer_1ds,
                aer_3ds=aer_3ds, surface=surface,
                solar_zenith_angle=solar_zenith_angle,
                solar_azimuth_angle=solar_azimuth_angle, ipa=ipa,
                forward_trunc_deg=forward_trunc_deg, pfpeak=pfpeak,
                device=device)
        if flux_per_column is None:
            cfg = dataclasses.replace(
                cfg,
                flux_per_column=static.has_3d and target != 'heating_rate')

        mu0 = float(np.cos(np.deg2rad(solar_zenith_angle)))
        # image deposits and the flight engine's clamped per-column
        # crossings are contracted over g in the step (rad_w, flux_w),
        # exactly equal to the contraction after; not the image of a
        # pathlength run, whose ratio needs every g (reference :344-356)
        rad_w = flux_w = None
        if target == 'radiance':
            if not pathlength:
                rad_w = out.spectral_factors(abs_coef, date=date,
                                             nz_out=1)[0][0]
        elif (cfg.flux_per_column and cfg.flux_kcross > 0
              and flux_engine == 'flight'):
            flux_w = out.spectral_factors(abs_coef, date=date,
                                          nz_out=static.nz + 1)[0]
        if qmc_launch and target != 'radiance' and flux_engine == 'marching':
            warnings.warn('qmc_launch only affects the flight kernel; '
                          "flux_engine='marching' launches uniformly",
                          stacklevel=2)
        per_run = []
        n_eff = 0
        for r in range(n_run):
            if spectral == 'independent':
                red, n_l = _independent_g_run(
                    scene, static, cfg, abs_coef, target, int(photons), mu0,
                    date, seed + 1000 * r, device, chunk=chunk, mesh=mesh)
                n_eff += n_l
                per_run.append(red)
                continue
            rad_t, flux_t, absd, rad_pl, n_l = _single_run(
                scene, static, cfg, int(photons), seed + 1000003 * r, device,
                chunk=chunk, flux_w=flux_w, rad_w=rad_w, mesh=mesh)
            n_eff += n_l
            with trace.span('solve.reduce'):
                if target == 'radiance':
                    red = _reduce_image(rad_t, n_l, abs_coef, mu0, static,
                                        cfg, date,
                                        precontracted=rad_w is not None)
                    if pathlength:
                        red['plen'] = _plen_ratio(rad_t, rad_pl,
                                                  abs_coef.weight)
                else:
                    red = out.reduce_flux(flux_t, n_l, abs_coef, mu0,
                                          date=date,
                                          precontracted=flux_w is not None)
                    if target == 'heating_rate' and absd.size > 1:
                        # the direct absorbed-energy tally where the run
                        # kept one (domain-average tallies)
                        red['hr'] = out.heating_rate_from_absorbed(
                            absd, n_l, abs_coef, mu0, atm, date=date)
            per_run.append(red)
        with trace.span('solve.reduce'):
            if target == 'heating_rate':
                # net-flux differencing where there is no direct tally
                # (per-column tallies, the marching engine, the independent
                # protocol), per run, so that hr_std and the runs of
                # mode='all' carry it (reference :408-414)
                for p in per_run:
                    if 'hr' not in p:
                        p['hr'] = out.heating_rate(p, atm)

            keys = [k for k in per_run[0] if k != 'toa']
            data = {k: np.mean([p[k] for p in per_run], axis=0)
                    for k in keys}
            std = {k + '_std': np.std([p[k] for p in per_run], axis=0)
                   for k in keys}
            if diffusion > 0:
                # numerical-diffusion smoothing of the mean per-column
                # fields only (MCARaTS Flx_diff0/1, Rad_difr0/1; reference
                # :421-427)
                for k in list(data):
                    arr = np.asarray(data[k])
                    if arr.ndim >= 2 and arr.shape[0] > 1 \
                            and arr.shape[1] > 1:
                        data[k] = out.smooth_diffusion(arr, diffusion)
        return Result(target=target, data=data, std=std,
                      toa=per_run[0]['toa'], n_photon=photons, n_run=n_run,
                      n_photon_effective=n_eff,
                      runs=(per_run if mode == 'all' else []))


def g_slice(scene, static, g):
    """The one-g-point scene of g-point ``g``: ``kabs`` (Nz, Ng) cut to its
    column g, made contiguous (a column of a row-major tensor is a strided
    view), and ``ng`` = 1, so the flight kernel keeps (2, B) ``labs``."""
    return (scene._replace(kabs=scene.kabs[:, g:g + 1].contiguous()),
            dataclasses.replace(static, ng=1))


def _independent_g_run(scene, static, cfg, abs_coef, target, n_photon, mu0,
                       date, seed, device, chunk=4_000_000, mesh=None):
    """The reference's per-g protocol (``er3t_tpu/rtm/solver.py:434-505``):
    one pass per g-point, ``seed + g``, with ``distribute_photon``'s share
    of the budget; each pass runs ng = 1 and contracts in the step with
    unit weights (not the image of a pathlength run); its tallies, over its
    own launched count, are gathered in f64 into (Nxr, Nyr, Ng) images
    and (Nxf, Nyf, Nlev, 3, Ng) fluxes and reduced as one launched photon,
    the camera's with the camera reduction.  Returns the reduced fields
    and the photons launched."""
    ng = abs_coef.ng
    dist = distribute_photon(n_photon, abs_coef.weight)
    if (dist <= 0).any():
        raise ValueError(
            f'independent-protocol runs need photons >= ng ({ng}) so every '
            f'g-point gets a non-empty pass; got {n_photon}')
    # unit-weight contraction in the step: exact for ng = 1
    rad_w1 = (np.ones(1, np.float32)
              if target == 'radiance' and not cfg.pathlength else None)
    flux_w1 = (np.ones((static.nz + 1, 1), np.float32)
               if target != 'radiance' and cfg.flux_per_column
               and cfg.flux_kcross > 0 and cfg.flux_engine == 'flight'
               else None)
    acc_rad = acc_flux = acc_pl = None
    n_total = 0
    for g in range(ng):
        scene_g, static_g = g_slice(scene, static, g)
        rad_t, flux_t, _, rad_pl, n_l = _single_run(
            scene_g, static_g, cfg, int(dist[g]), seed + g, device,
            chunk=chunk, flux_w=flux_w1, rad_w=rad_w1, mesh=mesh)
        n_total += n_l
        wsc = 1.0 / max(n_l, 1)
        if acc_rad is None:
            acc_rad = np.zeros(rad_t.shape[:2] + (ng,), np.float64)
            acc_flux = np.zeros(flux_t.shape[:4] + (ng,), np.float64)
        acc_rad[..., g] = rad_t[..., 0] * wsc
        acc_flux[..., g] = flux_t[..., 0] * wsc
        if cfg.pathlength and target == 'radiance':
            if acc_pl is None:
                acc_pl = np.zeros_like(acc_rad)
            acc_pl[..., g] = rad_pl[..., 0] * wsc
    with trace.span('solve.reduce'):
        if target == 'radiance':
            red = _reduce_image(acc_rad, 1, abs_coef, mu0, static, cfg, date,
                                precontracted=False)
            if cfg.pathlength:
                red['plen'] = _plen_ratio(acc_rad, acc_pl, abs_coef.weight)
            return red, n_total
        return (out.reduce_flux(acc_flux, 1, abs_coef, mu0, date=date),
                n_total)
