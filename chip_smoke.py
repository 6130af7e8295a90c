#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (er3t_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py                 # needs one CUDA card; ~12 min
    python chip_smoke.py --profile       # also a torch.profiler window

Phases (any failure raises and the exit code is non-zero):

1. card name and power limit (nvidia-smi), torch/CUDA versions; exits
   non-zero before any work when no CUDA device is visible;
2. builds the hand-written kernels of er3t_tpu_torch/csrc with nvcc, one
   nvcc per source, all started together;
3. kernel phase: the launch floor (the empty kernel), then the phase-pair
   kernel against its plain PyTorch version on the card, bitwise, on the
   bench scene's tables and on a 20-row table at B = 2^17, at a ragged
   B = 100003 and on lane arrays one element off 16-byte alignment;
4. main path: the bench scene of bench.py (480x480 Mie broken cloud, 16
   g-points, 25-deg truncation) built from er3t_tpu_torch.pre and run
   through the port's build_scene and run_transport_flight with the
   production config (batch 2^17, tile_size 16, qmc_launch, n_scat_max 600,
   rad_w); a warm-up run whose phase-pair inputs are captured and
   re-checked bitwise, then a timed run of 4e6 photons with every launch
   count set to 0 just before; phase_pair must have launched once per
   flight step, and its domain-mean radiance must lie within
   max(1 %, 4 sigma) of the JAX reference below;
5. front door: solve(target='radiance', ...) on the same scene;
5b. independent g-points: solve(spectral='independent', qmc_launch=False,
   photons=2e6, n_run=2, mode='all'), the protocol of bench.py's noise
   phase, one pass per g-point: phase_pair must have launched once per
   step of the 32 passes, the domain-mean radiance must lie within
   max(1 %, 4 sigma) of the JAX reference below (both estimators are
   unbiased for the same field), and diffusion smoothing of the image must
   keep its total to 1e-9; prints each run's wall, steps and photons/s,
   and the per-pixel variance per photon over that of phase 5's
   correlated runs (a two-run estimate);
4b. flux path, on the same scene: (a) run_transport_flight with per-column
   flux tallies, the crossing-count clamp flux_kcross=4 and the in-step
   contraction flux_w, a warm-up run and then a timed run of 4e6 photons
   with every launch count set to 0 just before; phase_pair must have
   launched once per flight step, the TOA down-direct flux must equal
   toa * mu0 in every column (it is deterministic), and the domain means
   of the surface f_down and the TOA f_up must lie within max(1 %, 4
   sigma) of the JAX reference below; (b) solve(target='heating_rate', ...)
   (domain-average tallies and the direct absorbed-energy tally), 1e6
   photons x 2 runs: hr finite and >= 0, its column integral within 5 % of
   the same runs' net-flux convergence, and within max(2 %, 4 sigma) of
   the JAX reference below;
7. the other solvers, sensors and knobs of the flight engine, on the same
   scene, each run with every launch count set to 0 just before it and
   phase_pair launched once per flight step of it, its wall, steps and
   photons/s printed: (a) solve(solver='ipa') and solve(solver='p3d',
   p3d_order=1), one run of 2e6 photons, domain means against the JAX
   references below; IPA flux (run_transport_flight, per-column tallies,
   flux_kcross=4, flux_w, 2e6 photons): TOA down-direct = toa * mu0 in every
   column, surface f_down and TOA f_up against the JAX references; (b) the
   ground all-sky camera (solve's default dict, rad_w) and an airborne
   down-looking camera with a 50 m aperture and pathlength=True (per-g
   image), one run of 2e6 photons each: the NaN mask is
   reduce_camera_radiance's, the mean over the finite pixels (and the
   airborne camera's mean pathlength) against the JAX references, and
   phase_pair bitwise against its plain version on inputs captured from
   the airborne run; (c) run_transport_flight with the production config
   and, one run of 2e6 photons each, cf_dtau=0.5, split_wmax=0.5,
   rr_value=0.1, sort_every=8 with launch_coherent, and none of them (the
   steps and rate the knobs are read against): each is unbiased, so each
   domain mean must lie within max(1 %, 4 sigma) of the radiance
   reference;
8. the event-marching engine and the quasi renderer, on the same scene
   (batch 2^17, n_scat_max=600, 1e6 photons a pass), each path with every
   launch count set to 0 just before it, phase_pair launched once per
   marching step and no pass ended at its step cap (steps printed against
   it): (a) mc.run_transport, flux with domain-average tallies (after a
   warm-up run): TOA down-direct = toa * mu0, surface f_down and TOA f_up
   against MARCH_FLUX_REF_RUNS; (b) nadir radiance: the domain mean
   against MARCH_RAD_REF_RUNS, phase_pair bitwise against its plain
   version on inputs captured from the run's steps (lanes on the TMS rows
   among them); (c) solve(target='heating_rate', flux_engine='marching'),
   2 runs, mode='all': hr finite with hr_std and per-run hr, the column-
   absorbed power against MARCH_HR_REF_RUNS within max(2 %, 4 sigma);
   (d) quasi_radiance for the ground all-sky and the airborne camera, 128
   x 128 pixels, 512 steps: the NaN count, the g-weighted mean over the
   finite pixels and the 16 block means within 1e-4 of QUASI_REF, the
   worst of them named when it fails; its wall printed;
9. multi-device transport (er3t_tpu_torch.dist) on the same scene and
   production config, four ranks on this one card, each path with every
   launch count set to 0 just before it, phase_pair launched once per
   flight step of every rank, its wall, steps per rank, rounds and
   photons/s printed: (a) transport_photon_parallel on make_mesh(4,
   decomp=1), 1e6 photons: the budget exactly, the domain mean against the
   radiance reference; (b) transport_decomp on make_mesh(4, decomp=4), 120
   columns a slab, 1e6 photons: the budget exactly, rounds below the cap,
   the domain mean against the radiance reference, the lanes shipped per
   superstep, those held back by the window or the receiver, and the wall
   in migration (pack, exchange, unpack) against the wall in flight steps;
   phase_pair bitwise against its plain version on inputs captured from
   its slab steps; (c) decomposed per-column flux (flux_kcross=4,
   flux_w), 1e6 photons: TOA down-direct = toa * mu0 in every column of
   every slab, surface f_down and TOA f_up against the flux reference;
   (d) solve(target='radiance', mesh=make_mesh(4, decomp=4), photons=1e6,
   n_run=1) against the radiance reference; (e) a process group of one
   (init_distributed with NCCL on a free localhost port) and a
   photon-parallel run of 1e6 photons through its all_reduce: the budget
   exactly, the mean against the radiance reference; the group destroyed
   after;
10. the application layer (er3t_tpu_torch.apps and the file-backed
   loaders), each path with every launch count set to 0 just before it,
   phase_pair launched once per flight step of it and held bitwise against
   its plain version on inputs captured from the path's steps (each phase
   table it ran), its wall, steps and photons/s printed: (a) example case
   05 on a file-backed scene: a SAM LES snapshot (480 x 480 columns of 0.1
   km, a deck from 0.5 to 2.5 km; chip_smoke_files, seed 0) and a 16-g
   database written by gen_abs_16g_h5 as a text tree (the card machine has
   no h5py), read by cld_les, aer_les and abs_16g_from_txt (synthetic
   False), then solve(..., aer_3ds=[aer_les(...)], photons=2e6, n_run=2)
   with the bench geometry: the domain mean against APPS_LES_REF_RUNS;
   (b) gen_bispectral_lookup_table at its defaults (25 COT x 11 CER IPA
   columns, 650 and 1600 nm, 2e6 photons each): the table mean and its
   four quadrant means of each band against APPS_LUT_REF_RUNS,
   retrieve_cot_cer on three interior nodes returns them exactly; then
   func_ref_vs_cot at its 31 nodes, 5e5 photons (projects/05): its mean
   against APPS_CURVE_REF_RUNS, rising from COT 1 in means of five nodes;
   (c) spectral_flux at 650, 762 and 860 nm, 1e6 photons each, clear sky,
   surface 0.2: TOA down-direct = toa * mu0, the surface f_down within 3 %
   and the TOA f_up within 6 % of spec_flx(..., n_streams=8) (the 1D
   solver is deterministic);
11. the satellite layer, projects/03's AHI-to-flux pipeline at its
   defaults: a Himawari AHI CLP L2 granule (the JAXA P-Tree full disk at
   0.05 deg, 2401 x 2401, classic netCDF; chip_smoke_files, seed 0) read
   by sat.ahi.ahi_l2 over 120-122 E, 15-17 N and gridded to 48 x 48,
   cld_sat (0.5 km columns, tops 2 km, 1 km thick, 0.5 km layers): the
   gridded COT's sum and cloud fraction and the extinction's sum equal the
   JAX package's on the same file exactly (SAT_EXACT); then solve(target=
   'flux', flux_per_column=True, 1e6 photons, one run) at 532 nm for the
   3D and the IPA solver at solve's card defaults, each with every launch
   count set to 0 just before it, phase_pair launched once per flight
   step and held bitwise against its plain version on inputs captured
   from the path's steps: TOA down-direct = toa * mu0 in every column, the
   domain means of the surface f_down and the TOA f_up and the mean f_down
   along the flight track at the level nearest 5 km against
   SAT_REF_RUNS; the wall of the files apart from the solves, and each
   solve's wall, steps, passes at the step cap, lanes in flight and
   photons/s printed;
12. the last host-side modules: (a) the native C++ solver
   (native/mc_ref.cpp through er3t_tpu_torch.native, built by g++ into
   build/er3t_tpu_torch/; its build wall and OpenMP threads printed) on
   the scene of tests/test_cross_native.py built on the card, 1e6
   photons for flux and for radiance, against the flight engine's flux
   (domain average) and nadir radiance and the marching engine's flux,
   1e6 each: every pair of flux tallies within 5 % at each level (down-
   direct and up) and 8 % for the surface down-diffuse, the radiance's
   domain mean within 4 % and its cloudy and clear halves within 6 %
   (the reference test's bounds), each relative difference printed;
   (b) examples/00_er3t_tpu_torch.py's cases 01 (clear-sky flux) and 06
   (200 x 200 hemispherical-cloud nadir radiance, 5-deg truncation) at
   their defaults (1e6 photons, 3 runs) through the script's own case
   functions, its images to chiprun_out/phase12/, each with every launch
   count set to 0 just before it, phase_pair launched once per flight
   step and held bitwise against its plain version on inputs captured
   from the path's steps: case 01's TOA down-direct = toa * mu0 to 1e-5,
   its surface f_down and TOA f_up, and case 06's domain mean, against
   EXAMPLES_REF_RUNS within max(1 %, 4 sigma); walls, steps, passes at
   the step cap and lanes in flight printed; (c) vis: the comparison
   page of case 06's image (one panel from a tensor on the card) holds
   the image's 2 x 2 block means; the cases' PNGs are written and
   checked non-empty where matplotlib is installed, and where it is not
   (the card machine) the PNG writers are never called;
13. the measurement entry points: (a) bench_torch.main (the port of
   bench.py) on the bench scene at a cut budget: a 1e5 warm-up, one 2e6
   probe, three fixed chunks of 4e6 and 2 + 2 noise repeats of 1e6 (the
   correlated runs, then 16 per-g passes a run of the reference's
   independent protocol), with every launch count set to 0 just before
   it and phase_pair launched once per flight step of all its runs and
   held bitwise against its plain version on inputs captured from them:
   its JSON line (printed as it prints it) has bench.py's keys for the
   branch it took (BENCH_KEYS), and the domain mean of all its
   production-config runs lies within max(1 %, 4 sigma) of the radiance
   reference; (b) SolverConfig.ablate: 40 pinned steps (max_events) of
   2^30 photons at 2^17 lanes under the production config with rad_w, for
   each of full, phase, vox, deposit and vox,phase,deposit, each with
   every launch count set to 0 just before it: phase_pair launched once a
   step (held bitwise on captured steps), and not at all under 'phase';
   every image finite; ms per step printed;
6. probe phase: every probe kernel (take_reps, gather_row_sum, take2d,
   smem_stage, the bf16 phase pair) against its plain version, bitwise,
   at the TPU probe scripts' shapes and at a ragged B = 100003, timed
   beside it, and on the paths of the kernels' width and alignment
   dispatch: take_reps windows at the wrap of a table at widths 1 and 3,
   gather_row_sum on a ragged width (99) and on a table view one float
   off 16-byte alignment, take2d on every path of its dispatch
   (take2d_cases); then the probe path, the gather probes
   (python -m er3t_tpu_torch.probes.gather_probe all), with every launch
   count set to 0 just before: each probe kernel must have launched, and
   the shared memory ceiling must be the card's opt-in limit, exactly;
   their JSON lines are printed and stored under "probes".  It runs after
   the main path because the main path's host-bound loop runs slower in a
   process that has just run the probes.

Times are device times from CUDA events, amortised over 100 back-to-back
calls (gather_probe.device_ms).  Beside each kernel's time stand its plain
version's, the launch floor's, the time of one PyTorch call that computes
the same function where there is one (library_ms, timed here only), and
its bound: the larger of the bytes it must move (inputs read once, outputs
written once; of a gathered table, the elements this run's indices touch)
over 3.35 TB/s and its float operations over 67 TFLOP/s.

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}; every measured number also goes to
build/chip_smoke.json (phase 8 under "march" and "quasi", phase 9 under
"dist", phase 10 under "apps", phase 11 under "sat", phase 12 under
"scripts", phase 13 under "bench"; the input files of phases 10 and 11 go
to build/phase10/ and build/phase11/).  With --profile, 20 radiance steps
and 20 flux steps are profiled (keys "profile" and "profile_flux").
"""

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import bench_torch
import chip_smoke_files
from er3t_tpu_torch import _build, native, vis
from er3t_tpu_torch.apps.lut import (func_ref_vs_cot,
                                     gen_bispectral_lookup_table,
                                     retrieve_cot_cer)
from er3t_tpu_torch.apps.spectral import spec_flx, spectral_flux
from er3t_tpu_torch.dist.mesh import init_distributed, make_mesh
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.abs_16g_db import abs_16g_from_txt
from er3t_tpu_torch.pre.abs_gen import gen_abs_16g_h5
from er3t_tpu_torch.pre.aer import aer_les
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hom, cld_les, cld_sat
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.probes import gather, gather_probe
from er3t_tpu_torch.probes.gather_probe import card_line, device_ms
from er3t_tpu_torch.rtm import mc, mc_flight, solver
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import (reduce_camera_radiance, reduce_flux,
                                    reduce_radiance, smooth_diffusion,
                                    spectral_factors)
from er3t_tpu_torch.rtm.phase_pair import phase_pair, phase_pair_ref
from er3t_tpu_torch.rtm.quasi import quasi_radiance
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.rtm.solver import solve
from er3t_tpu_torch.sat.ahi import ahi_l2

# Domain-mean radiance [W/m^2/nm/sr] of the bench scene under the production
# config, computed by the JAX package (er3t_tpu 0.1.0, JAX 0.9.0) on the CPU
# with use_pallas=False, batch 2^15, eight seeds of 4e6 photons each:
REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, bench
from er3t_tpu.rtm.mc import SolverConfig
from er3t_tpu.rtm.mc_flight import run_transport_flight
from er3t_tpu.rtm.out import spectral_factors, reduce_radiance
ab, scene, st = bench.build()
cfg = SolverConfig(target='radiance', batch=1 << 15, n_scat_max=600,
                   tile_size=16, use_pallas=False, qmc_launch=True)
rad_w = spectral_factors(ab, nz_out=1)[0][0]
mu0 = float(np.cos(np.deg2rad(30.0)))
for seed in range(8):
    tal = run_transport_flight(scene, st, cfg, 4_000_000, seed=seed,
                               rad_w=rad_w)
    print(seed, reduce_radiance(np.asarray(tal.rad), int(tal.n_launched), ab,
                                mu0, precontracted=True)['rad'].mean())
EOF"""
REF_RUN_MEANS = (0.05493439733982086, 0.054785072803497314,
                 0.054783232510089874, 0.05488882213830948,
                 0.05493566393852234, 0.05492399260401726,
                 0.054780151695013046, 0.05498918890953064)
REF_PHOTONS = 4_000_000

# Domain means [W/m^2/nm] of the surface f_down and the TOA f_up of the
# bench scene with per-column tallies, flux_kcross=4 and flux_w, computed
# by the JAX package on the CPU (use_pallas=False, batch 2^15), one pair
# per seed of 1e6 photons:
FLUX_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, bench
from er3t_tpu.rtm.mc import SolverConfig
from er3t_tpu.rtm.mc_flight import run_transport_flight
from er3t_tpu.rtm.out import spectral_factors, reduce_flux
ab, scene, st = bench.build()
cfg = SolverConfig(target='flux', batch=1 << 15, n_scat_max=600,
                   tile_size=16, use_pallas=False, qmc_launch=True,
                   flux_per_column=True, flux_kcross=4)
flux_w = spectral_factors(ab, nz_out=st.nz + 1)[0]
mu0 = float(np.cos(np.deg2rad(30.0)))
for seed in range(8):
    tal = run_transport_flight(scene, st, cfg, 1_000_000, seed=seed,
                               flux_w=flux_w)
    f = reduce_flux(np.asarray(tal.flux), int(tal.n_launched), ab, mu0,
                    precontracted=True)
    print(seed, f['f_down'][:, :, 0].mean(), f['f_up'][:, :, -1].mean())
EOF"""
FLUX_REF_RUNS = ((1.1787493, 0.2126157),
                 (1.1787493, 0.21251403),
                 (1.1796414, 0.21164083),
                 (1.1788455, 0.21243094),
                 (1.1795588, 0.21169919),
                 (1.1799792, 0.21142687),
                 (1.178889, 0.21243855),
                 (1.179327, 0.21210864))
FLUX_REF_PHOTONS = 1_000_000

# Column-absorbed power [W/m^2/nm] of solve(target='heating_rate') on the
# bench scene (domain-average tallies, direct absorbed-energy tally),
# computed by the JAX package on the CPU (batch 2^15), one per run of 1e6
# photons:
HR_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.rtm.solver import solve
levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
atm = atm_atmmod(levels)
ab = abs_synthetic(650.0, atm)
cld = cld_gen_hem(nx=480, ny=480, nz=4, dx=0.1, dy=0.1, dz=0.5,
                  cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                  cot_scale=15.0, cloud_base=0.5, seed=7)
res = solve(atm=atm, abs_coef=ab, cld=cld, pha=pha_mie_wc(650.0),
            surface=0.03, solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
            forward_trunc_deg=25.0, target='heating_rate', photons=1e6,
            n_run=8, batch=1 << 15, tile_size=16, qmc_launch=True,
            n_scat_max=600, seed=0, mode='all')
heat = atm.lay.pressure * 100.0 / (287.0 * atm.lay.temperature) * 1004.0 \\
    * atm.lay.thickness * 1000.0
for r in res.runs:
    print(float(np.sum(r['hr'] / 86400.0 * heat)))
EOF"""
HR_REF_RUNS = (0.02967642165666477,
               0.029681022627743085,
               0.029669266275767152,
               0.029648136216414926,
               0.029660190419398165,
               0.029700160538058684,
               0.029724452824110445,
               0.029721125940496265)
HR_REF_PHOTONS = 1_000_000

# Phase 7 through the front door: per run of 1e6 photons, the domain-mean
# radiance of IPA and of partial 3D (order 1), the mean over the finite
# pixels of the ground all-sky camera (solve's default dict) and of the
# airborne down-looking camera with an aperture and pathlength, and that
# camera's mean pathlength over pixels with a tally; the JAX package on the
# CPU (use_pallas=False, batch 2^15):
MODES_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.rtm.solver import solve
levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
atm = atm_atmmod(levels)
ab = abs_synthetic(650.0, atm)
cld = cld_gen_hem(nx=480, ny=480, nz=4, dx=0.1, dy=0.1, dz=0.5,
                  cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                  cot_scale=15.0, cloud_base=0.5, seed=7)
kw = dict(atm=atm, abs_coef=ab, cld=cld, pha=pha_mie_wc(650.0),
          surface=0.03, solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
          forward_trunc_deg=25.0, target='radiance', photons=1e6, n_run=4,
          batch=1 << 15, tile_size=16, qmc_launch=True, n_scat_max=600,
          seed=0, mode='all')
air = dict(zloc=8000.0, the=180.0, qmax=60.0, npix=64, apsize=50.0)
for name, extra in (('ipa', dict(solver='ipa')),
                    ('p3d', dict(solver='p3d', p3d_order=1)),
                    ('camera', dict(sensor_type='camera')),
                    ('camera_air', dict(camera=air, pathlength=True))):
    for r in solve(**kw, **extra).runs:
        plen = r.get('plen', np.zeros(1))
        print(name, float(np.nanmean(r['rad'])),
              float(plen[plen > 0].mean()) if (plen > 0).any() else 0.0)
EOF"""
MODES_REF_RUNS = {     # per run: (mean radiance, mean pathlength [m])
    'ipa': ((0.06927789002656937, 0.0), (0.0690339133143425, 0.0),
            (0.06896418333053589, 0.0), (0.06887272745370865, 0.0)),
    'p3d': ((0.07222498208284378, 0.0), (0.07210193574428558, 0.0),
            (0.07211039960384369, 0.0), (0.07216016948223114, 0.0)),
    'camera': ((0.017507478885760354, 0.0), (0.017104320761002247, 0.0),
               (0.017157568659033517, 0.0), (0.01801203185555233, 0.0)),
    'camera_air': ((0.05499704595583791, 34784.71713647215),
                   (0.05615859906025672, 34857.61376241776),
                   (0.057914764535777125, 35142.85007092319),
                   (0.05637038252701924, 35000.58027528278))}
MODES_REF_PHOTONS = 1_000_000

# Phase 7, IPA flux: the domain means of the surface f_down and the TOA f_up
# with per-column tallies, flux_kcross=4 and flux_w on the IPA scene (the
# bench scene's static with ipa=True), the JAX package on the CPU
# (use_pallas=False, batch 2^15), one pair per seed of 1e6 photons:
IPA_FLUX_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import dataclasses
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, bench
from er3t_tpu.rtm.mc import SolverConfig
from er3t_tpu.rtm.mc_flight import run_transport_flight
from er3t_tpu.rtm.out import spectral_factors, reduce_flux
ab, scene, st = bench.build()
st = dataclasses.replace(st, ipa=True)
cfg = SolverConfig(target='flux', batch=1 << 15, n_scat_max=600,
                   tile_size=16, use_pallas=False, qmc_launch=True,
                   flux_per_column=True, flux_kcross=4)
flux_w = spectral_factors(ab, nz_out=st.nz + 1)[0]
mu0 = float(np.cos(np.deg2rad(30.0)))
for seed in range(4):
    tal = run_transport_flight(scene, st, cfg, 1_000_000, seed=seed,
                               flux_w=flux_w)
    f = reduce_flux(np.asarray(tal.flux), int(tal.n_launched), ab, mu0,
                    precontracted=True)
    print(seed, f['f_down'][:, :, 0].mean(), f['f_up'][:, :, -1].mean())
EOF"""
IPA_FLUX_REF_RUNS = ((1.1676496, 0.22425501),
                     (1.1676725, 0.22420432),
                     (1.1676785, 0.22413625),
                     (1.1678519, 0.22400805))
IPA_FLUX_REF_PHOTONS = 1_000_000

# Phase 8, the event-marching engine on the bench scene (batch 2^17, the
# chip run's batch, so the default step cap is the same, 2268 steps for 1e6
# photons), the JAX package on the CPU: per seed of 1e6 photons, the domain
# means of the surface f_down and the TOA f_up (domain-average tallies),
# the steps and the cap:
MARCH_FLUX_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, bench
from er3t_tpu.rtm.mc import SolverConfig, run_transport
from er3t_tpu.rtm.out import reduce_flux
ab, scene, st = bench.build()
cfg = SolverConfig(target='flux', batch=1 << 17, n_scat_max=600)
cap = int(np.ceil(1_000_000 / cfg.batch + 1) * 4 * (st.nz + 40))
mu0 = float(np.cos(np.deg2rad(30.0)))
for seed in range(4):
    tal = run_transport(scene, st, cfg, 1_000_000, seed=seed)
    f = reduce_flux(np.asarray(tal.flux), int(tal.n_launched), ab, mu0)
    print(seed, f['f_down'][:, :, 0].mean(), f['f_up'][:, :, -1].mean(),
          int(tal.n_steps), cap, flush=True)
EOF"""
MARCH_FLUX_REF_RUNS = ((1.1847152869615953, 0.21220463376321377),
                       (1.1855916079418027, 0.21126055263495644),
                       (1.18531439193566, 0.21137238143706083),
                       (1.1844998449645614, 0.212214525811758))
MARCH_REF_STEPS = (968, 1025, 949, 1192)        # of 2268, in both commands
# ... and the nadir radiance's domain mean, per seed of 1e6 photons (the
# same seeds; the steps are the flux runs'):
MARCH_RAD_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, bench
from er3t_tpu.rtm.mc import SolverConfig, run_transport
from er3t_tpu.rtm.out import reduce_radiance
ab, scene, st = bench.build()
cfg = SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600)
cap = int(np.ceil(1_000_000 / cfg.batch + 1) * 4 * (st.nz + 40))
mu0 = float(np.cos(np.deg2rad(30.0)))
for seed in range(4):
    tal = run_transport(scene, st, cfg, 1_000_000, seed=seed)
    print(seed, reduce_radiance(np.asarray(tal.rad), int(tal.n_launched), ab,
                                mu0)['rad'].mean(), int(tal.n_steps), cap,
          flush=True)
EOF"""
MARCH_RAD_REF_RUNS = (0.05507169406503296, 0.05472919302347306,
                      0.054722368193741, 0.05515733452651616)
# ... and the column-absorbed power of solve(target='heating_rate',
# flux_engine='marching') on HR_REF_COMMAND's scene (the flux-divergence
# heating rate), one per run of 1e6 photons:
MARCH_HR_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.rtm.solver import solve
levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
atm = atm_atmmod(levels)
ab = abs_synthetic(650.0, atm)
cld = cld_gen_hem(nx=480, ny=480, nz=4, dx=0.1, dy=0.1, dz=0.5,
                  cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                  cot_scale=15.0, cloud_base=0.5, seed=7)
res = solve(atm=atm, abs_coef=ab, cld=cld, pha=pha_mie_wc(650.0),
            surface=0.03, solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
            forward_trunc_deg=25.0, target='heating_rate',
            flux_engine='marching', photons=1e6, n_run=4, batch=1 << 17,
            n_scat_max=600, seed=0, mode='all')
heat = atm.lay.pressure * 100.0 / (287.0 * atm.lay.temperature) * 1004.0 \\
    * atm.lay.thickness * 1000.0
for r in res.runs:
    print(float(np.sum(r['hr'] / 86400.0 * heat)), flush=True)
EOF"""
MARCH_HR_REF_RUNS = (0.02387652126699913, 0.024062298594827558,
                     0.02393851871618846, 0.02392769474335754)
MARCH_REF_PHOTONS = 1_000_000

# Phase 8 (d), quasi-radiance of the bench scene (deterministic) for the
# ground all-sky camera (solve's default dict) and the airborne down-looking
# one, 128 x 128 pixels, 512 steps, by the JAX package on the CPU: the NaN
# count, the g-weighted mean over the finite pixels and the means of the
# 4 x 4 blocks of 32 x 32 pixels (quasi_summary):
QUASI_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, bench
from er3t_tpu.rtm.mc import SolverConfig
from er3t_tpu.rtm.quasi import quasi_radiance
ab, scene, st = bench.build()
for name, cam in (('camera', dict(cam_npix=128)),
                  ('camera_air', dict(cam_npix=128, cam_zloc=8000.0,
                                      cam_the=180.0, cam_qmax=60.0))):
    img = np.asarray(quasi_radiance(scene, st, SolverConfig(
        sensor_type='camera', **cam), n_steps=512)) @ ab.weight
    blocks = img.reshape(4, 32, 4, 32).transpose(0, 2, 1, 3).reshape(16, -1)
    print(name, int(np.isnan(img).sum()), float(np.nanmean(img)),
          [float(v) for v in np.nanmean(blocks, axis=1)])
EOF"""
QUASI_REF = {   # camera: (NaN count, mean over finite pixels, 16 block means)
    'camera': (3492, 0.009028928621928107, (
        0.010117707866822898, 0.005561632098292719, 0.00700380431031483,
        0.00546062216013816, 0.005577021379833097, 0.0039589372517372465,
        0.006617031426850973, 0.01472790666359827, 0.006441888519822246,
        0.004859743140536395, 0.00620680928039738, 0.014698073942355776,
        0.007767876472125135, 0.010117251060053711, 0.020450122921873332,
        0.02277594872645146)),
    'camera_air': (3492, 0.01189888087050357, (
        0.0068070139505528125, 0.007967116024840418, 0.006986347361594927,
        0.007936937873541496, 0.01936939441059506, 0.012746279994438964,
        0.009785910103655607, 0.00819124199596701, 0.017704373530432985,
        0.01137159375035117, 0.012615537136434415, 0.007314561982653792,
        0.012990124851116733, 0.01847228045050337, 0.014552781710481681,
        0.0077786930705455015))}
QUASI_CAMERAS = {'camera': {}, 'camera_air': dict(cam_zloc=8000.0,
                                                  cam_the=180.0,
                                                  cam_qmax=60.0)}
QUASI_NPIX = 128
QUASI_STEPS = 512
QUASI_RTOL = 1e-4

# Phase 10 (a), example case 05 on a file-backed scene: the SAM LES
# snapshot of chip_smoke_files (seed 0) through cld_les and aer_les, the
# gases from the 16-g database that gen_abs_16g_h5 writes as a text tree,
# nadir radiance; the domain mean per seed of 2e6 photons, the JAX package
# on the CPU (solve's CPU batch, 2^14):
APPS_LES_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import os
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, chip_smoke_files as F
from er3t_tpu.pre.abs_16g_db import abs_16g_from_txt
from er3t_tpu.pre.abs_gen import gen_abs_16g_h5
from er3t_tpu.pre.aer import aer_les
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.cld import cld_les
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.rtm.solver import solve
os.makedirs('build/phase10_ref', exist_ok=True)
les = F.write_les_snapshot('build/phase10_ref/les.nc', seed=0)
db = F.write_abs_16g_txt('build/phase10_ref/abs_16g', [650.0], gen_abs_16g_h5)
atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                 np.arange(3.0, 20.1, 1.0)]))
ab = abs_16g_from_txt(650.0, atm, fdir_k=db)
cld = cld_les(les, coarsen=F.LES_COARSEN)
aer = aer_les(les, ssa=0.9, asy=0.7, coarsen=F.LES_COARSEN, ext_scale=0.1)
for seed in range(4):
    res = solve(atm=atm, abs_coef=ab, cld=cld, pha=pha_mie_wc(650.0),
                aer_3ds=[aer], surface=0.03, target='radiance',
                solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
                forward_trunc_deg=5.0, photons=2e6, n_run=1, seed=seed)
    print(seed, ab.synthetic, float(res['rad'].mean()))
EOF"""
APPS_LES_REF_RUNS = (0.04482940956950188, 0.04484552890062332,
                     0.044589173048734665, 0.0447765551507473)
APPS_LES_REF_PHOTONS = 2_000_000

# Phase 10 (b), the bispectral LUT at its defaults (25 COT x 11 CER IPA
# columns, 650 and 1600 nm, 2e6 photons each) and the 31-node reflectance
# curve of projects/05 (5e5 photons), on the 1-km atmosphere of
# tests/test_apps.py, the JAX package on the CPU: per seed, the table
# mean and its four quadrant means (chip_smoke_files.lut_summary) of
# ref_vis and of ref_nir, the curve's mean, whether it rises from COT 1
# in means of five nodes (chip_smoke_files.curve_rises) and whether it
# rises at every node from COT 1:
APPS_LUT_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, chip_smoke_files as F
from er3t_tpu.apps.lut import func_ref_vs_cot, gen_bispectral_lookup_table
from er3t_tpu.pre.atm import atm_atmmod
atm = atm_atmmod(np.linspace(0, 20, 21))
for seed in range(4):
    lut = gen_bispectral_lookup_table(atm, seed=seed)
    curve = func_ref_vs_cot(atm, photons=5e5, seed=seed)
    print(seed, F.lut_summary(lut['ref_vis']), F.lut_summary(lut['ref_nir']),
          float(curve.ref.mean()), F.curve_rises(curve.cot, curve.ref),
          bool(np.all(np.diff(curve.ref[curve.cot >= 1.0]) > 0)))
EOF"""
APPS_LUT_REF_RUNS = (   # per seed: lut_summary of ref_vis, of ref_nir
    ((0.3253124902062601, 0.07793275137720639, 0.07234408457567881,
      0.5972534564012126, 0.5946260973498837),
     (0.18662798284361798, 0.05057484814768136, 0.04105053461373672,
      0.3805371528183081, 0.28851495622774537)),
    ((0.32373579283688203, 0.07641271305599927, 0.0749761911009546,
      0.5959238273237588, 0.588119723715032),
     (0.18484079313238375, 0.051928337484447945, 0.04136410684644864,
      0.3813627368987736, 0.27723372976479543)),
    ((0.32655475343974777, 0.07799685558354925, 0.07017190795839856,
      0.6090056030918175, 0.588487083675117),
     (0.18523024558641318, 0.05013342803084706, 0.041188744889230036,
      0.3803650969920981, 0.2827392458104424)),
    ((0.3209740296993475, 0.07455138027462971, 0.07333902591637775,
      0.597911284507727, 0.5772700222796424),
     (0.18787181172726247, 0.05017653149863935, 0.04458496728233251,
      0.38670670421160014, 0.28350121985860827)))
APPS_LUT_REF_PHOTONS = 2_000_000
APPS_CURVE_REF_RUNS = (0.32411842098478577, 0.3378288177822685,
                       0.32921166655214573, 0.3316645079779635)
APPS_CURVE_PHOTONS = 500_000

# Phase 11, projects/03's pipeline on the granule of chip_smoke_files
# (seed 0): the gridded COT's sum and cloud fraction and cld_sat's
# extinction sum, exact; then per seed and solver, 1e6 photons at the
# card's batch (2^17, so that the step cap is the card's), the domain means
# of the surface f_down and the TOA f_up and the track mean of f_down at
# the level nearest 5 km, the JAX package on the CPU (run here as four
# processes, one a seed, each writing its own copy of the granule):
SAT_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - <<'EOF'     # from the repository root
import os
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, chip_smoke_files as F
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.cld import cld_sat
from er3t_tpu.pre.pha import pha_mie_wc
from er3t_tpu.rtm.solver import solve
from er3t_tpu.sat.ahi import ahi_l2
os.makedirs('build/phase11_ref', exist_ok=True)
fn = F.write_ahi_clp('build/phase11_ref/ahi_clp.nc', seed=0)
obj = ahi_l2([fn], extent=F.AHI_EXTENT, nx=F.AHI_NX, ny=F.AHI_NX)
cot = obj.data['cot_2d']['data']
cer = np.where(cot > 0, obj.data['cer_2d']['data'], 0.0)
cld = cld_sat(cot_2d=cot, cer_2d=cer, dx=0.5, dy=0.5, cth=2.0, cgt=1.0, dz=0.5)
print(repr(float(cot.sum())), repr(float((cot > 0).mean())),
      repr(float(cld.extinction.sum())))
atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                 np.arange(3.0, 20.1, 1.0)]))
ab, pha = abs_synthetic(532.0, atm), pha_mie_wc(532.0)
iz = int(np.argmin(np.abs(atm.lev.altitude - 5.0)))
fx, fy = F.flight_track(F.AHI_NX)
for seed in range(4):
    for mode in ('3d', 'ipa'):
        res = solve(atm=atm, abs_coef=ab, cld=cld, pha=pha, surface=0.06,
                    target='flux', solver=mode, flux_per_column=True,
                    solar_zenith_angle=25.0, solar_azimuth_angle=45.0,
                    photons=1e6, n_run=1, seed=seed, batch=1 << 17)
        print(seed, mode, float(res['f_down'][..., 0].mean()),
              float(res['f_up'][..., -1].mean()),
              float(res['f_down'][fx, fy, iz].mean()))
EOF"""
SAT_EXACT = (3513.659921463579, 0.2578125, 7.027319842927158)
SAT_REF_RUNS = {   # per seed: (surface f_down, TOA f_up, track f_down 5 km)
    '3d': ((1.5016597509384155, 0.2620587944984436, 1.6480093002319336),
           (1.500654697418213, 0.2630981206893921, 1.640225887298584),
           (1.5014007091522217, 0.2622109353542328, 1.6695709228515625),
           (1.501814365386963, 0.26211029291152954, 1.6302685737609863)),
    'ipa': ((1.4956820011138916, 0.26786285638809204, 1.6484405994415283),
            (1.495429515838623, 0.2680395841598511, 1.638514757156372),
            (1.4955613613128662, 0.2679417133331299, 1.634265422821045),
            (1.4961552619934082, 0.2674108147621155, 1.635565996170044))}
SAT_REF_PHOTONS = 1_000_000

# Phase 12 (b), examples/00_er3t_tpu.py's own case functions 01 and 06 at
# their defaults (1e6 photons, n_run=3) on the CPU at the card's batch
# (2^17, so that the step cap is the card's), each run's values kept
# (mode='all'); its PNGs go to build/phase12_ref/, not to examples/output/
# (run here as two processes, one a case; about a minute each):
EXAMPLES_REF_COMMAND = """\
JAX_PLATFORMS=cpu python - 01 <<'EOF'   # from the repository root; 01 or 06
import importlib.util, os, sys
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np
spec = importlib.util.spec_from_file_location('ex00', 'examples/00_er3t_tpu.py')
ex = importlib.util.module_from_spec(spec); spec.loader.exec_module(ex)
ex.OUT = 'build/phase12_ref'; os.makedirs(ex.OUT, exist_ok=True)
plain = ex.solver.solve
def solve(**kw):
    res = plain(**kw, batch=1 << 17, mode='all')
    for r in res.runs:
        if 'rad' in r:
            print(sys.argv[1], repr(float(np.mean(r['rad']))))
        else:
            print(sys.argv[1], repr(float(np.squeeze(r['f_down'])[0])),
                  repr(float(np.squeeze(r['f_up'])[-1])))
    return res
ex.solver.solve = solve
ex.EXAMPLES[sys.argv[1]](1e6)
EOF"""
EXAMPLES_REF_RUNS = {
    '01': ((1.3276996392460836, 0.07229093356799132),   # (surface f_down,
           (1.3279793427507776, 0.07203604245124098),   #  TOA f_up) a run
           (1.3276744561461649, 0.07242377593260166)),
    '06': ((0.05653087794780731,), (0.05634588003158569,),   # domain-mean
           (0.05631595477461815,))}                          # radiance a run
EXAMPLES_REF_PHOTONS = 1_000_000

PP_SOURCE = 'er3t_tpu_torch/csrc/phase_pair.cu'
PP_REPLACES = 'er3t_tpu/rtm/pallas_phase.py:123'
GP_SOURCE = 'er3t_tpu_torch/csrc/gather_probe.cu'
# the kernels of the probe path: name -> (source, TPU kernels replaced)
PROBE_KERNELS = {
    'phase_pair_bf16': (PP_SOURCE, 'scripts/tpu_gather_probe3.py:144, '
                                   'scripts/tpu_gather_probe3b.py:131'),
    'take_reps': (GP_SOURCE, 'scripts/tpu_gather_probe.py:115'),
    'gather_row_sum': (GP_SOURCE, 'scripts/tpu_gather_probe.py:152, '
                                  'scripts/tpu_gather_probe.py:185'),
    'take2d': (GP_SOURCE, 'scripts/tpu_gather_probe2.py:63, '
                          'scripts/tpu_gather_probe3.py:58, '
                          'scripts/tpu_gather_probe3b.py:58'),
    'smem_stage': (GP_SOURCE, 'scripts/tpu_gather_probe.py:215'),
}
PROBE_WRAPPERS = (gather.take_reps, gather.gather_row_sum, gather.take2d,
                  gather.smem_stage)
OUT_JSON = os.path.join('build', 'chip_smoke.json')
BATCH = 1 << 17                  # photon lanes of the production config
RAGGED = 100_003                 # a lane count no block size divides
PHOTONS = 4_000_000              # photons of the timed main-path run
WARM_PHOTONS = 100_000           # photons of the warm-up run
SOLVE_PHOTONS = 1_000_000        # photons per run of the front door
INDEP_PHOTONS = 2_000_000        # photons per run of the independent-g solve
FLUX_PHOTONS = 4_000_000         # photons of the timed flux-path run
HR_PHOTONS = 1_000_000           # photons per run of the heating-rate solve
MODES_PHOTONS = 2_000_000        # photons per run of each phase-7 path
MODES_RUNS = 1                   # runs of phase 7's solves: one, so that
                                 # the script keeps its time limit with
                                 # phase 10 (a pass's drain tail, not its
                                 # photons, sets its wall)
MARCH_PHOTONS = 1_000_000        # photons per run of each phase-8 path
DIST_RANKS = 4                   # phase 9: ranks, all on this card
DIST_PHOTONS = 1_000_000         # photons of phase 9 (a) and (b)
DIST_FLUX_PHOTONS = 1_000_000    # photons of phase 9 (c)
DIST_SOLVE_PHOTONS = 1_000_000   # photons of phase 9 (d) and (e)
APPS_LES_PHOTONS = 2_000_000     # phase 10 (a): photons per run, 2 runs
APPS_LUT_PHOTONS = 2_000_000     # phase 10 (b): per wavelength (the default)
APPS_FLUX_PHOTONS = 1_000_000    # phase 10 (c): per wavelength
APPS_FLUX_WAVELENGTHS = (650.0, 762.0, 860.0)
APPS_LES_SHAPE = chip_smoke_files.LES_SHAPE
APPS_LUT_PICKS = ((8, 15, 21), (2, 5, 8))   # interior (COT, CER) nodes
SAT_PHOTONS = 1_000_000          # phase 11: per solve, one run a solver
SAT_NX = chip_smoke_files.AHI_NX   # phase 11: the grid of the AHI extent
SAT_WAVELENGTH = 532.0           # phase 11: projects/03's defaults
SAT_SZA, SAT_SAA, SAT_ALT_KM = 25.0, 45.0, 5.0
EXAMPLE_00 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'examples', '00_er3t_tpu_torch.py')
EXAMPLES_PHOTONS = 1e6           # phase 12 (b): example 00's --photons default
EXAMPLES_OUT = os.path.join('chiprun_out', 'phase12')   # its images and page
NATIVE_PHOTONS = 1_000_000       # phase 12 (a): per run of each solver
HTML_MAX_PX = 100                # phase 12 (c): the page block-averages 2 x 2
AIR_CAMERA = dict(zloc=8000.0, the=180.0, qmax=60.0, npix=64, apsize=50.0)
# phase 7 (c): split_wmax 0.5 (the reference's tests' value): the
# production config's weights stay at or below 1, so a window of 2 would
# split no lane
KNOBS = {'cf_dtau': dict(cf_dtau=0.5), 'split_wmax': dict(split_wmax=0.5),
         'rr_value': dict(rr_value=0.1),
         'sort_coherent': dict(sort_every=8, launch_coherent=True),
         'production': {}}
# the keys of bench.py's printed line (bench.py:234-268) in its two
# branches: the noise phase ran; the run was degraded (the noise phase
# skipped).  tests/test_torch_bench.py reads them from bench.py's source.
_BENCH_OUT = ('unit', 'photons_per_sec', 'g_samples_per_sec', 'healthy',
              'probe_rate', 'chunk_rates', 'median', 'median_all_chunks',
              'best', 'slow_chunks', 'vs_baseline_all')
BENCH_KEYS = {
    'noise': _BENCH_OUT + ('metric', 'value', 'vs_baseline',
                           'noise_var_ratio_indep_over_corr',
                           'pixel_std_at_budget'),
    'degraded': _BENCH_OUT + ('degraded', 'metric', 'value', 'vs_baseline'),
}
# phase 13 (a): bench_torch.main's budgets, cut: three fixed chunks
# (max_chunks, the chunk's bounds at the chunk, a target far above the
# chunks' wall) and 2 + 2 noise repeats
BENCH_BUDGET = dict(warmup=100_000, probe=2_000_000, chunk=4_000_000,
                    chunk_min=4_000_000, chunk_max=4_000_000,
                    target_seconds=3600.0, max_chunks=3, repeats=2,
                    n_noise=1_000_000, n_ind=1_000_000)
ABLATE_STEPS = 40                # phase 13 (b): pinned steps a config
ABLATIONS = {'full': '', 'phase': 'phase', 'vox': 'vox',
             'deposit': 'deposit', 'floor': 'vox,phase,deposit'}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, HBM3
F32_FLOPS = 67e12                # H100 SXM data sheet, f32 outside the
                                 # tensor cores


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def build_bench_scene(device):
    """The bench.py scene (bench.py:66-81) through the port
    (bench_torch.scene_inputs)."""
    atm, ab, kw = bench_torch.scene_inputs()
    scene, st = build_scene(atm, ab, **kw, device=device)
    return atm, ab, kw, scene, st


def compare(got, ref):
    """Kernel output vs plain output (tensors or tuples of them):
    (max |diff|, bitwise equal)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    return err, all(torch.equal(g, r) for g, r in zip(got, ref))


def launch_counts():
    return {'phase_pair': phase_pair.launches,
            'phase_pair_bf16': phase_pair.launches_bf16,
            **{f.__name__: f.launches for f in PROBE_WRAPPERS}}


def reset_counts():
    phase_pair.launches = phase_pair.launches_bf16 = 0
    for f in PROBE_WRAPPERS:
        f.launches = 0


# ---- what each kernel must move: (bytes, float operations) ----

def _touched(flat):
    """Distinct table elements named by a tensor of flat offsets."""
    return int(torch.unique(flat).numel())


def pair_cost(apf, row_e, mu, u, pt_p, pt_mu):
    """16 B in and 8 B out per lane, and the table entries it reads; the
    bins as phase_pair_ref computes them."""
    n_m, n_u = pt_p.shape[1], pt_mu.shape[1]
    ib = torch.clamp((((mu + 1.0) * 0.5) * (n_m - 1) + 0.5).to(torch.int32),
                     0, n_m - 1)
    iu = torch.clamp((u * (n_u - 1) + 0.5).to(torch.int32), 0, n_u - 1)
    ev = torch.clamp(row_e, 0, pt_p.shape[0] - 1).long() * n_m + ib
    sm = torch.clamp(apf, 0, pt_mu.shape[0] - 1).long() * n_u + iu
    b = apf.numel()
    return (24 * b + pt_p.element_size() * (_touched(ev) + _touched(sm)),
            6 * b)


def take_reps_cost(idx, tab, reps):
    rows, width = tab.shape
    flat = torch.cat([torch.remainder(idx.long() + r, rows) * width
                      + min(r, width - 1) for r in range(reps)])
    return 8 * idx.numel() + 4 * _touched(flat), idx.numel() * reps


def row_sum_cost(idx, tab):
    rows = _touched(torch.clamp(idx, 0, tab.shape[0] - 1))
    return 8 * idx.numel() + 4 * rows * tab.shape[1], idx.numel() * tab.shape[1]


def take2d_cost(idx, tab, mode):
    rows, cols = tab.shape
    if mode == 'rows':
        n_out = idx.numel() * cols
        flat = torch.clamp(idx.reshape(-1), 0, rows - 1).long()
        return 4 * idx.numel() + 4 * n_out + 4 * _touched(flat) * cols, 0
    j = torch.arange(idx.shape[1], device=idx.device)
    i = torch.arange(idx.shape[0], device=idx.device)[:, None]
    flat = (torch.clamp(idx, 0, rows - 1).long() * cols + j if mode == 'axis0'
            else i * cols + torch.clamp(idx, 0, cols - 1).long())
    return 8 * idx.numel() + 4 * _touched(flat), 0


def stage_cost(tab):
    """K5's work is staging the whole table: every byte read once."""
    return 4 * tab.numel() + 4, 1


def take2d_library(idx, tab, mode):
    """One PyTorch call for take2d: advanced indexing or torch.gather."""
    i64 = idx.long()
    if mode == 'rows':
        i64 = i64.reshape(-1)
        return lambda: tab[i64]
    return lambda: torch.gather(tab, 0 if mode == 'axis0' else 1, i64)


def take_reps_library(idx, tab, reps):
    """One PyTorch call for take_reps on a one-column table: an embedding
    bag of each lane's wrapped (B, reps) window, built outside the timed
    call."""
    win = torch.remainder(idx.long()[:, None]
                          + torch.arange(reps, device=idx.device), tab.shape[0])
    return lambda: F.embedding_bag(win, tab, mode='sum')


def row_sum_library(idx, tab):
    """One PyTorch call for gather_row_sum: an embedding bag of one row."""
    i64 = idx.long().reshape(-1, 1)
    return lambda: F.embedding_bag(i64, tab, mode='sum')


def against_ref(what, got, runs, ref_photons, photons, rel):
    """Check ``got`` (a mean over ``photons`` photons in all) against the
    mean of the JAX reference's per-run values ``runs`` (``ref_photons``
    each): within max(rel, 4 sigma), sigma from the runs' spread scaled to
    both photon counts."""
    ref = float(np.mean(runs))
    sd = float(np.std(runs, ddof=1))
    sigma = float(np.hypot(sd * np.sqrt(ref_photons / photons),
                           sd / np.sqrt(len(runs))))
    tol = max(rel * abs(ref), 4 * sigma)
    check(abs(got - ref) <= tol, f'{what} {got:.6g} is not within {tol:.3g} '
                                 f'of the JAX reference {ref:.6g}')
    return dict(value=got, ref=ref, tol=tol, rel_diff=got / ref - 1)


def bound(cost):
    """(bound_ms, bound_by) of (bytes, ops)."""
    nbytes, ops = cost
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_b, t_o), 'bytes' if t_b >= t_o else 'operations'


def time_case(c, floor_ms):
    """Times of a kernel case: kernel, plain version, library call, and
    its bound from this run's inputs."""
    nbytes, ops = c['cost']()
    bound_ms, bound_by = bound((nbytes, ops))
    lib = c.get('library')
    return dict(case=c['case'], ms=device_ms(c['kern']),
                plain_ms=device_ms(c['plain']),
                library_ms=device_ms(lib) if lib is not None else None,
                floor_ms=floor_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, ops=ops)


def take2d_cases():
    """take2d cases of phase 6: (PERF.md row, mode, table, indices, index
    range, table offset, index offset).  An offset makes a view that many
    elements into its allocation, so off 16-byte alignment; a range past
    the table's axis tests the clamp.  With the probe shapes they run every
    path of gather.take2d_vec (rows and axis1 with one and four outputs a
    chunk, axis0 with one) on ragged row counts, ragged widths and rows
    wider than a block."""
    return (
        ('K7', 'axis0', (1280, 128), (1280, 128), (0, 1280), 0, 0),
        ('K6', 'axis1', (2048, 1024), (2048, 128), (0, 1024), 0, 0),
        (None, 'rows', (4096, 128), (2048,), (0, 4096), 0, 0),
        (None, 'rows', (4096, 8), (RAGGED,), (0, 4096), 0, 0),
        (None, 'axis0', (4096, 8), (RAGGED, 8), (0, 4096), 0, 0),
        (None, 'axis1', (RAGGED, 16), (RAGGED, 8), (0, 16), 0, 0),
        (None, 'rows', (4096, 128), (4099,), (-3, 4099), 1, 0),
        (None, 'rows', (4096, 99), (4099,), (-3, 4099), 0, 0),
        (None, 'rows', (512, 2052), (1031,), (-3, 515), 0, 0),
        (None, 'axis0', (4096, 99), (4099, 99), (-3, 4099), 0, 0),
        (None, 'axis0', (4096, 8), (4099, 8), (-3, 4099), 0, 1),
        (None, 'axis0', (4096, 8), (4099, 8), (-3, 4099), 1, 0),
        (None, 'axis1', (1031, 2048), (1031, 8), (-3, 2051), 0, 0),
        (None, 'axis1', (1031, 2048), (1031, 7), (-3, 2051), 0, 0),
        (None, 'axis1', (2048, 1024), (2048, 128), (-3, 1027), 1, 0),
        (None, 'axis1', (2048, 1024), (2048, 128), (-3, 1027), 0, 1),
        (None, 'axis1', (2048, 1024), (2048, 127), (-3, 1027), 0, 0),
        (None, 'axis1', (4099, 99), (4099, 99), (-3, 102), 0, 0),
        (None, 'axis1', (257, 4096), (257, 2050), (-3, 4099), 0, 0))


def probe_kernel_cases(rng, dev, gen):
    """Cases of every probe kernel at the TPU probe scripts' shapes (B =
    2^17 lanes) and at a ragged B = 100003.  A case that stands for a TPU
    kernel of the PERF.md table carries its ``row`` (K2-K7; K8 runs K7's
    kernels at K7's shapes), its cost and its library call, and is timed;
    the first such case of each kernel is the kernel's entry in the
    kernels line."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    cases = []

    def add(kernel, case, fn, ref, *a, row=None, cost=None, library=None):
        cases.append(dict(kernel=kernel, case=case, row=row,
                          kern=lambda: fn(*a), plain=lambda: ref(*a),
                          cost=row and (lambda: cost(*a)),
                          library=row and library and library(*a)))

    for row, (b, rows, reps) in zip(('K2', None, None),
                                    ((BATCH, 61440, 4), (BATCH, 1 << 20, 1),
                                     (RAGGED, 61440, 4))):
        add('take_reps', f'{rows}x1_reps{reps}_B{b}', gather.take_reps,
            gather.take_reps_ref, randint(rows, b), randn(rows, 1), reps,
            row=row, cost=take_reps_cost, library=take_reps_library)
    # windows at the wrap: every lane's index is -12 .. -1, so (floor
    # modulo) its window starts within 12 rows of the table's end, and
    # those that start in the last 4 rows wrap to row 0
    for width in (1, 3):
        add('take_reps', f'61443x{width}_reps5_at_wrap_B{BATCH}',
            gather.take_reps, gather.take_reps_ref,
            randint(12, BATCH) - 12, randn(61443, width), 5)
    for row, (b, rows, width, offset) in zip(
            ('K3', 'K4', None, None, None), (
                (BATCH, 921600, 2, 0), (BATCH, 512, 128, 0),
                (RAGGED, 921600, 5, 0),
                (BATCH, 4096, 99, 0),       # ragged width: scalar, 8 lanes
                (BATCH, 512, 128, 1))):     # misaligned table: scalar loads
        tab = randn(rows * width + offset)[offset:].view(rows, width)
        add('gather_row_sum', f'{rows}x{width}_B{b}'
            + (f'_offset{offset}' if offset else ''), gather.gather_row_sum,
            gather.gather_row_sum_ref, randint(rows, b), tab, row=row,
            cost=row_sum_cost, library=row_sum_library)
    for row, mode, tab, idx, (lo, hi), t_off, i_off in take2d_cases():
        t = randn(math.prod(tab) + t_off)[t_off:].view(tab)
        i = torch.randint(lo, hi, (math.prod(idx) + i_off,), generator=gen,
                          device=dev, dtype=torch.int32)[i_off:].view(idx)
        add('take2d', f'{mode}_tab{tab}_idx{idx}'.replace(' ', '')
            + (f'_range{lo},{hi}' if lo else '')
            + (f'_taboffset{t_off}' if t_off else '')
            + (f'_idxoffset{i_off}' if i_off else ''),
            gather.take2d, gather.take2d_ref, i, t, mode, row=row,
            cost=take2d_cost, library=take2d_library)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for row, n in zip(('K5', None), (limit // 4, 12345)):
        add('smem_stage', f'n{n}', gather.smem_stage, gather.smem_stage_ref,
            randn(n), row=row, cost=stage_cost,
            library=lambda tab: lambda: tab[0] + tab[-1])
    pt_p = randn(40, 4096).to(torch.bfloat16)
    pt_mu = randn(20, 8192).to(torch.bfloat16)
    for row, b in zip(('K7_pair', None), (BATCH, RAGGED)):
        add('phase_pair_bf16', f'bf16_40x4096_20x8192_B{b}', phase_pair,
            phase_pair_ref, *lane_inputs(rng, b, pt_p, pt_mu, dev), row=row,
            cost=pair_cost)
    return cases


def lane_inputs(rng, b, pt_p, pt_mu, dev, offset=0):
    """Random lanes of the phase pair; ``offset`` > 0 returns views that
    start that many elements into their allocation (off 16-byte
    alignment for offsets that are not multiples of 4)."""
    npf = pt_mu.shape[0]
    n = b + offset
    apf = rng.integers(0, npf, n).astype(np.int32)
    first = rng.integers(0, 2, n).astype(bool)
    row_e = (apf + np.where(first, npf, 0)).astype(np.int32)
    mu = rng.uniform(-1, 1, n).astype(np.float32)
    u = rng.uniform(1e-7, 1 - 1e-7, n).astype(np.float32)
    return [torch.from_numpy(a).to(dev)[offset:] for a in (apf, row_e, mu, u)] \
        + [pt_p, pt_mu]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random inputs and of the runs')
    ap.add_argument('--profile', action='store_true',
                    help='profile 20 flight steps with torch.profiler')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible; the port has no CPU '
              'fallback for this run', file=sys.stderr)
        return 2
    return run(args, torch.device('cuda', 0))


PHASES = ('solve', 'independent', 'flux', 'modes', 'march', 'dist', 'apps',
          'sat', 'scripts', 'bench', 'probes')


def run(args, dev, phases=PHASES):
    """The smoke run (see the module docstring).  Phases 1-4 always run;
    ``phases`` names the others to run (5, 5b, 4b, 7-13 and 6, in the
    order of PHASES), all of them by default.  The tests rehearse them a
    few at a time; 'independent' needs 'solve'."""
    phases = set(phases)
    check(phases <= set(PHASES), f'unknown phases {phases - set(PHASES)}')
    check('solve' in phases or 'independent' not in phases,
          "phase 'independent' needs phase 'solve'")
    # f32 matmuls and convolutions in full f32 (the absorption matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    # ---- 1. card ----
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f'# torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
    log(f'# device {kind} x{torch.cuda.device_count()}')
    report.update(card=card, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build ----
    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    report['build_s'] = time.perf_counter() - t0
    report['nvcc_s'] = dict(_build.build_seconds)
    log(f'# built {", ".join(p.name for p in libs.values())} in '
        f'{report["build_s"]:.2f} s (nvcc {report["nvcc_s"]})')
    for stem in libs:
        for line in _build.build_log.get(stem, '').splitlines():
            if 'Compiling entry' in line or 'registers' in line \
                    or 'spill' in line:
                log(f'#   ptxas {stem}:', line.strip())

    # ---- scene ----
    t0 = time.perf_counter()
    atm, ab, scene_kw, scene, st = build_bench_scene(dev)
    report['scene_build_s'] = time.perf_counter() - t0
    log(f'# bench scene {st.nx}x{st.ny}x{st.nz} ng={st.ng} '
        f'pt_p{tuple(scene.pt_p.shape)} pt_mu{tuple(scene.pt_mu.shape)} '
        f'built in {report["scene_build_s"]:.1f} s')

    # ---- 3. kernel phase ----
    floor_ms = device_ms(lambda: gather.noop(dev))
    report['floor_ms'] = floor_ms
    log(f'# launch floor (empty kernel, one 256-thread block): '
        f'{floor_ms * 1e3:.3f} us')
    rng = np.random.default_rng(args.seed)
    big_p = torch.from_numpy(
        (rng.normal(size=(40, 2048)) * 10).astype(np.float32)).to(dev)
    big_mu = torch.from_numpy(
        rng.uniform(-1, 1, (20, 2048)).astype(np.float32)).to(dev)
    max_err = 0.0
    kt = {}
    for name, a, timed in (
            ('bench_tables', lane_inputs(rng, BATCH, scene.pt_p,
                                         scene.pt_mu, dev), True),
            ('20_rows', lane_inputs(rng, BATCH, big_p, big_mu, dev), True),
            (f'20_rows_ragged_B{RAGGED}',
             lane_inputs(rng, RAGGED, big_p, big_mu, dev), False),
            ('20_rows_misaligned',
             lane_inputs(rng, BATCH - 1, big_p, big_mu, dev, offset=1),
             False)):
        err, same = compare(phase_pair(*a), phase_pair_ref(*a))
        max_err = max(max_err, err)
        check(same, f'phase_pair kernel != plain on {name}: max |diff| {err}')
        if timed:
            kt[name] = time_case(dict(
                case=name, kern=lambda: phase_pair(*a),
                plain=lambda: phase_pair_ref(*a),
                cost=lambda: pair_cost(*a)), floor_ms)
        log(f'# phase_pair {name}: bitwise equal; {kt.get(name, "")}')
    report['phase_pair'] = kt
    # the timed case of each TPU kernel of the PERF.md table
    rows = {'K1': dict(kernel='phase_pair', **kt['bench_tables'])}

    # ---- 4. main path ----
    cfg = SolverConfig(target='radiance', batch=BATCH, n_scat_max=600,
                       tile_size=16, use_pallas=True, qmc_launch=True)
    factors, toa = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]
    mu0 = float(np.cos(np.deg2rad(30.0)))

    # warm-up run; capture the phase-pair inputs of some of its steps
    captured = []
    plain_pair = mc_flight.phase_pair

    def capture(*a):
        if len(captured) < 4 and phase_pair.launches % 40 == 0:
            captured.append([t.clone() for t in a])
        return plain_pair(*a)
    mc_flight.phase_pair = capture
    try:
        t0 = time.perf_counter()
        warm = mc_flight.run_transport_flight(scene, st, cfg, WARM_PHOTONS,
                                              args.seed + 1, dev, rad_w=rad_w)
        torch.cuda.synchronize()
        report['warmup_s'] = time.perf_counter() - t0
    finally:
        mc_flight.phase_pair = plain_pair
    check(int(warm.n_launched) == WARM_PHOTONS, 'warm-up launched count')
    for i, a in enumerate(captured):
        err, same = compare(phase_pair(*a), phase_pair_ref(*a))
        max_err = max(max_err, err)
        check(same, f'phase_pair kernel != plain on captured flight inputs '
              f'#{i}: max |diff| {err}')
    log(f'# warm-up {WARM_PHOTONS:.0e} photons {report["warmup_s"]:.2f} s; '
        f'kernel bitwise equal on {len(captured)} captured flight steps '
        f'(B={[int(a[0].shape[0]) for a in captured]})')

    n_ph = PHOTONS
    stats = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tal = mc_flight.run_transport_flight(scene, st, cfg, n_ph, args.seed + 2,
                                         dev, rad_w=rad_w, stats=stats)
    img = tal.rad.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = phase_pair.launches
    main_counts = launch_counts()
    steps = int(tal.n_steps)
    n_l = int(tal.n_launched)
    check(n_l == n_ph, f'launched {n_l} photons of {n_ph}')
    check(img.shape == (st.nx, st.ny, 1), f'image shape {img.shape}')
    check(np.isfinite(img).all() and (img >= 0).all(),
          'image not finite and >= 0')
    check(launches == steps,
          f'phase_pair launched {launches} times in {steps} steps')
    mean = float(reduce_radiance(img, n_l, ab, mu0,
                                 precontracted=True)['rad'].mean())
    ref = against_ref('domain-mean radiance', mean, REF_RUN_MEANS,
                      REF_PHOTONS, n_ph, 0.01)
    main = dict(photons=n_l, wall_s=wall, photons_per_s=n_l / wall,
                g_samples_per_s=n_l * st.ng / wall, steps=steps,
                lane_iters=float(tal.lane_iters), ms_per_step=1e3 * wall / steps,
                stage_steps=stats['stage_steps'],
                phase_pair_launches=launches, launches=main_counts,
                host_read_s=stats['host_read_s'],
                host_read_share=stats['host_read_s'] / wall,
                domain_mean=mean, ref_mean=ref['ref'], tol=ref['tol'],
                rel_diff=ref['rel_diff'])
    report['main'] = main
    log('# main path: ' + json.dumps(main))

    if args.profile:
        report['profile'] = profile_steps(scene, st, cfg, dev, rad_w=rad_w)

    # ---- 5. front door ----
    if 'solve' in phases:
        t0 = time.perf_counter()
        res = solve(atm=atm, abs_coef=ab, **scene_kw, target='radiance',
                    photons=SOLVE_PHOTONS, n_run=2, batch=BATCH,
                    tile_size=16, qmc_launch=True, n_scat_max=600,
                    seed=args.seed + 3, device=dev)
        rad = np.asarray(res['rad'])
        check(rad.shape == (st.nx, st.ny) and np.isfinite(rad).all(),
              'solve: rad not a finite (nx, ny) image')
        check(res.toa == toa, f'solve: toa {res.toa} != {toa}')
        report['solve'] = dict(wall_s=time.perf_counter() - t0,
                               domain_mean=float(rad.mean()),
                               n_photon_effective=res.n_photon_effective)
        log('# solve: ' + json.dumps(report['solve']))

    # ---- 5b. independent g-points ----
    if 'independent' in phases:
        independent_phase(args, dev, atm, ab, scene_kw, st, res, report)

    # ---- 4b. flux path ----
    if 'flux' in phases:
        flux_phase(args, dev, atm, ab, scene_kw, scene, st, report)

    # ---- 7. the other solvers, sensors and knobs ----
    if 'modes' in phases:
        max_err = max(max_err, modes_phase(args, dev, atm, ab, scene_kw,
                                           scene, st, report))

    # ---- 8. the marching engine and the quasi renderer ----
    if 'march' in phases:
        max_err = max(max_err, march_phase(args, dev, atm, ab, scene_kw,
                                           scene, st, report))
        quasi_phase(dev, ab, scene, st, report)

    # ---- 9. multi-device transport ----
    if 'dist' in phases:
        max_err = max(max_err, dist_phase(args, dev, atm, ab, scene_kw,
                                          scene, st, report))

    # ---- 10. the application layer ----
    if 'apps' in phases:
        max_err = max(max_err, apps_phase(
            args, dev, scene_kw.get('pha') or pha_mie_wc(650.0), report))

    # ---- 11. the satellite layer ----
    if 'sat' in phases:
        max_err = max(max_err, sat_phase(args, dev, report))

    # ---- 12. the native bridge, the example driver and vis ----
    if 'scripts' in phases:
        max_err = max(max_err, scripts_phase(args, dev, report))

    # ---- 13. the measurement entry points: bench_torch, ablate ----
    if 'bench' in phases:
        max_err = max(max_err, bench_phase(args, dev, ab, scene, st, report))

    # ---- 6. probe phase ----
    probe_counts, probe_err, probe_kt = {}, {}, {}
    if 'probes' in phases:
        probe_counts, probe_err, probe_kt = probe_phase(args, dev, rng,
                                                        floor_ms, rows,
                                                        report)
    report['rows'] = rows

    def entry(name, source, replaces, n, err, t):
        return dict(name=name, route='cuda', source=source,
                    replaces=replaces, launches=n, max_abs_err=err,
                    ms=t['ms'], plain_ms=t['plain_ms'],
                    bound_ms=t['bound_ms'], bound_by=t['bound_by'],
                    library_ms=t['library_ms'], floor_ms=t['floor_ms'])
    pp_entry = entry('phase_pair', PP_SOURCE, PP_REPLACES, launches, max_err,
                     kt['bench_tables'])
    if 'flux' in phases:
        pp_entry['flux_launches'] = report['flux']['phase_pair_launches']
    for name, rec in {**report.get('modes', {}),
                      **report.get('march', {})}.items():
        pp_entry[f'{name}_launches'] = rec['phase_pair_launches']
    for name, rec in report.get('dist', {}).items():
        pp_entry[f'dist_{name}_launches'] = rec['phase_pair_launches']
    for name, rec in report.get('apps', {}).items():
        pp_entry[f'apps_{name}_launches'] = rec['phase_pair_launches']
    if 'sat' in phases:
        for name in ('3d', 'ipa'):
            pp_entry[f'sat_{name}_launches'] = \
                report['sat'][name]['phase_pair_launches']
    if 'scripts' in phases:
        for case in ('01', '06'):
            pp_entry[f'examples_{case}_launches'] = \
                report['scripts'][f'example_{case}']['phase_pair_launches']
    for name, rec in report.get('bench', {}).items():
        pp_entry[f'{name}_launches'] = rec['phase_pair_launches']
    kernels = {'kernels': [pp_entry] + [
        entry(name, source, replaces, probe_counts[name], probe_err[name],
              probe_kt[name]) for name, (source, replaces)
        in PROBE_KERNELS.items() if name in probe_kt]}
    report['kernels'] = kernels
    os.makedirs(os.path.dirname(OUT_JSON), exist_ok=True)
    with open(OUT_JSON, 'w') as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


def probe_phase(args, dev, rng, floor_ms, rows, report):
    """Phase 6: every probe kernel against its plain version on its cases,
    timed beside it (rows gains their PERF.md rows), then the probe path
    with the launch counts from 0 (see the module docstring).  Returns the
    probe path's launch counts, each kernel's largest |kernel - plain| and
    its timed case."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    probe_err = dict.fromkeys(PROBE_KERNELS, 0.0)
    probe_kt = {}
    for c in probe_kernel_cases(rng, dev, gen):
        kernel = c['kernel']
        err, same = compare(c['kern'](), c['plain']())
        probe_err[kernel] = max(probe_err[kernel], err)
        check(same, f'{kernel} kernel != plain on {c["case"]}: max |diff| '
                    f'{err}')
        t = ''
        if c['row']:
            t = rows[c['row']] = dict(kernel=kernel, **time_case(c, floor_ms))
            probe_kt.setdefault(kernel, t)
        log(f'# {kernel} {c["case"]}: bitwise equal; {t}')
    report['probe_kernels'] = probe_kt

    # the probe path, its launch counts from 0
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    reset_counts()
    t0 = time.perf_counter()
    probes = gather_probe.run('all', args.seed, dev)
    torch.cuda.synchronize()
    probe_counts = launch_counts()
    report.update(probes=probes, probes_s=time.perf_counter() - t0,
                  probe_launches=probe_counts)
    log(f'# probes: {len(probes)} lines in {report["probes_s"]:.1f} s; '
        f'launches {probe_counts}')
    check(sum(r['probe'] == 'device' for r in probes) == len(
        gather_probe.PROBES), 'not every probe entry point ran')
    for name in PROBE_KERNELS:
        check(probe_counts[name] > 0, f'{name} never launched on the probe '
                                      f'path')
    ceiling = [(r['bytes'], r['ok']) for r in probes
               if r['probe'] == 'vmem_ceiling']
    check(ceiling[-2:] == [(limit, True), (limit + 4, False)],
          f'shared memory ceiling {ceiling[-2:]} is not the opt-in limit '
          f'{limit} B')

    return probe_counts, probe_err, probe_kt


def independent_phase(args, dev, atm, ab, scene_kw, st, corr, report):
    """Phase 5b: solve(spectral='independent') on the bench scene, the
    protocol of bench.py's noise phase (see the module docstring); ``corr``
    is phase 5's correlated result."""
    res, rec = path_run('independent g passes', lambda run: solve(
        atm=atm, abs_coef=ab, **scene_kw, target='radiance',
        spectral='independent', photons=INDEP_PHOTONS, n_run=2, batch=BATCH,
        tile_size=16, qmc_launch=False, n_scat_max=600, seed=args.seed + 7,
        mode='all', device=dev))
    passes = rec['passes']
    ng = st.ng
    check(len(passes) == 2 * ng, f'{len(passes)} per-g passes, not 2 x {ng}')
    check(res.n_photon_effective == 2 * INDEP_PHOTONS,
          f'launched {res.n_photon_effective} photons of 2 x {INDEP_PHOTONS}')
    rad = np.asarray(res['rad'])
    check(rad.shape == (st.nx, st.ny) and np.isfinite(rad).all()
          and (rad >= 0).all(), 'independent solve: rad not a finite (nx, '
                                'ny) image >= 0')
    check(len(res.runs) == 2, 'mode=all kept no runs')
    total = float(smooth_diffusion(rad, 1).sum())
    total_err = abs(total / float(rad.sum()) - 1)
    check(total_err <= 1e-9, f'diffusion changed the image total by '
                             f'{total_err:.3g}')
    runs = []
    for r in range(2):
        part = passes[r * ng:(r + 1) * ng]
        w = sum(p['wall_s'] for p in part)
        n = sum(p['photons'] for p in part)
        runs.append(dict(wall_s=w, steps=sum(p['steps'] for p in part),
                         photons=n, photons_per_s=n / w))
        log(f'# independent run {r}: ' + json.dumps(runs[-1]))
    var_i = float(np.mean(res.std['rad_std'] ** 2)) * INDEP_PHOTONS
    var_c = float(np.mean(corr.std['rad_std'] ** 2)) * SOLVE_PHOTONS
    report['independent'] = dict(
        wall_s=rec['wall_s'], steps=rec['steps'],
        phase_pair_launches=rec['phase_pair_launches'],
        launches=rec['launches'], runs=runs, passes=passes,
        n_photon_effective=res.n_photon_effective,
        diffusion_total_rel_err=total_err,
        domain_mean=against_ref('independent-g domain-mean radiance',
                                float(rad.mean()), REF_RUN_MEANS, REF_PHOTONS,
                                2 * INDEP_PHOTONS, 0.01),
        noise_var_ratio_indep_over_corr=var_i / var_c,
        noise_var_ratio_note=(
            'two-run estimate: mean per-pixel rad_std^2 times photons per '
            f'run, 2 x {INDEP_PHOTONS} independent (qmc_launch off) over '
            f'phase 5\'s 2 x {SOLVE_PHOTONS} correlated (qmc_launch on)'))
    log('# independent g: ' + json.dumps(
        {k: v for k, v in report['independent'].items() if k != 'passes'}))


def flux_phase(args, dev, atm, ab, scene_kw, scene, st, report):
    """Phase 4b: the flux path of the flight kernel and the heating-rate
    front door on the bench scene (see the module docstring)."""
    cfg = SolverConfig(target='flux', batch=BATCH, n_scat_max=600,
                       tile_size=16, use_pallas=True, qmc_launch=True,
                       flux_per_column=True, flux_kcross=4)
    factors, toa = spectral_factors(ab, nz_out=st.nz + 1)
    mu0 = float(np.cos(np.deg2rad(30.0)))
    t0 = time.perf_counter()
    warm = mc_flight.run_transport_flight(scene, st, cfg, WARM_PHOTONS,
                                          args.seed + 4, dev, flux_w=factors)
    torch.cuda.synchronize()
    check(int(warm.n_launched) == WARM_PHOTONS, 'flux warm-up launched count')
    log(f'# flux warm-up {WARM_PHOTONS:.0e} photons '
        f'{time.perf_counter() - t0:.2f} s')

    n_ph = FLUX_PHOTONS
    stats = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tal = mc_flight.run_transport_flight(scene, st, cfg, n_ph, args.seed + 5,
                                         dev, flux_w=factors, stats=stats)
    tally = tal.flux.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = int(tal.n_steps)
    n_l = int(tal.n_launched)
    check(n_l == n_ph, f'flux path launched {n_l} photons of {n_ph}')
    check(tally.shape == (st.nx, st.ny, st.nz + 1, 3, 1),
          f'flux tally shape {tally.shape}')
    check(np.isfinite(tally).all() and (tally >= 0).all(),
          'flux tally not finite and >= 0')
    check(counts['phase_pair'] == steps,
          f'phase_pair launched {counts["phase_pair"]} times in {steps} '
          f'flux steps')
    red = reduce_flux(tally, n_l, ab, mu0, precontracted=True)
    toa_err = float(np.max(np.abs(red['f_down_direct'][:, :, -1]
                                  / (toa * mu0) - 1)))
    check(toa_err <= 1e-5, f'TOA down-direct flux off toa * mu0 by {toa_err}')
    ref_sfc, ref_toa = zip(*FLUX_REF_RUNS)
    report['flux'] = dict(
        photons=n_l, wall_s=wall, photons_per_s=n_l / wall,
        g_samples_per_s=n_l * st.ng / wall, steps=steps,
        lane_iters=float(tal.lane_iters), ms_per_step=1e3 * wall / steps,
        stage_steps=stats['stage_steps'],
        phase_pair_launches=counts['phase_pair'], launches=counts,
        host_read_s=stats['host_read_s'],
        host_read_share=stats['host_read_s'] / wall,
        toa_direct_max_rel_err=toa_err,
        f_down_sfc=against_ref('domain-mean surface f_down',
                               float(red['f_down'][:, :, 0].mean()),
                               ref_sfc, FLUX_REF_PHOTONS, n_ph, 0.01),
        f_up_toa=against_ref('domain-mean TOA f_up',
                             float(red['f_up'][:, :, -1].mean()),
                             ref_toa, FLUX_REF_PHOTONS, n_ph, 0.01))
    log('# flux path: ' + json.dumps(report['flux']))
    if args.profile:
        report['profile_flux'] = profile_steps(scene, st, cfg, dev,
                                               flux_w=factors)

    reset_counts()
    t0 = time.perf_counter()
    res = solve(atm=atm, abs_coef=ab, **scene_kw, target='heating_rate',
                photons=HR_PHOTONS, n_run=2, batch=BATCH, tile_size=16,
                qmc_launch=True, n_scat_max=600, seed=args.seed + 6,
                device=dev)
    wall = time.perf_counter() - t0
    hr = np.asarray(res['hr'])
    check(hr.shape == (st.nz,) and np.isfinite(hr).all()
          and (hr >= -1e-9).all(), 'solve: hr not a finite (nz,) profile '
                                   '>= 0')
    heat = atm.lay.pressure * 100.0 / (287.0 * atm.lay.temperature) \
        * 1004.0 * atm.lay.thickness * 1000.0
    col = float(np.sum(hr / 86400.0 * heat))
    net = res['f_down'][0, 0] - res['f_up'][0, 0]
    conv = float(net[-1] - net[0])
    check(abs(col / conv - 1) <= 0.05,
          f'heating rate column {col:.6g} vs net-flux convergence {conv:.6g}')
    report['heating_rate'] = dict(
        wall_s=wall, n_photon_effective=res.n_photon_effective,
        launches=launch_counts(), hr=hr.tolist(), net_flux_convergence=conv,
        closure_rel_diff=col / conv - 1,
        column_absorbed=against_ref('column-absorbed power', col,
                                    HR_REF_RUNS, HR_REF_PHOTONS,
                                    2 * HR_PHOTONS, 0.02))
    log('# heating rate: ' + json.dumps(report['heating_rate']))


def path_run(name, fn, entry='run_transport_flight', module=solver,
             k1=True):
    """Run ``fn(run)`` with every launch count set to 0 just before, where
    ``run`` is ``module``'s ``entry`` (the solver's run_transport_flight,
    or the marching engine's run_transport; mc_flight's
    run_transport_flight for phase 13) with each pass timed (the passes of
    solve, or of whatever calls ``module.entry``, go through it too).
    Checks that phase_pair (not at all without ``k1``: the 'phase'
    ablation), and no other kernel, launched once per step, and that no
    marching pass ended at its step cap; logs and returns (fn's result, a
    record of the wall, steps, photons, photons/s, lane iterations per
    photon, launch counts and passes, each marching pass with its cap,
    each flight pass with its cap and the lanes still in flight when it
    ended)."""
    passes = []
    engine = getattr(module, entry)
    marching = entry == 'run_transport'

    def timed(*a, **kw):
        stats = kw.setdefault('stats', {})
        t0 = time.perf_counter()
        tal = engine(*a, **kw)
        passes.append(dict(photons=int(tal.n_launched),
                           steps=int(tal.n_steps),
                           lane_iters=float(tal.lane_iters),
                           wall_s=time.perf_counter() - t0))
        if marching:
            passes[-1]['max_steps'] = stats['max_steps']
        else:
            passes[-1].update(cap=stats['max_steps'],
                              in_flight=stats['in_flight'])
        return tal
    reset_counts()
    torch.cuda.synchronize()
    setattr(module, entry, timed)
    try:
        t0 = time.perf_counter()
        out = fn(timed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(module, entry, engine)
    counts = launch_counts()
    steps = sum(p['steps'] for p in passes)
    photons = sum(p['photons'] for p in passes)
    check(steps > 0 and counts['phase_pair'] == (steps if k1 else 0),
          f'{name}: phase_pair launched {counts["phase_pair"]} times in '
          f'{steps} steps')
    check(all(n == 0 for k, n in counts.items() if k != 'phase_pair'),
          f'{name}: other kernels launched: {counts}')
    check(all(p['steps'] < p.get('max_steps', p['steps'] + 1)
              for p in passes),
          f'{name}: a marching pass ended at its step cap: {passes}')
    rec = dict(wall_s=wall, steps=steps, photons=photons,
               photons_per_s=photons / wall,
               lane_iters_per_photon=sum(p['lane_iters'] for p in passes)
               / photons,
               phase_pair_launches=counts['phase_pair'], launches=counts,
               passes=passes)
    log(f'# {name}: ' + json.dumps(
        {k: v for k, v in rec.items() if k != 'passes'}))
    return out, rec


def modes_phase(args, dev, atm, ab, scene_kw, scene, st, report):
    """Phase 7: IPA, partial 3D, the cameras and the variance knobs on the
    bench scene (see the module docstring).  Returns the largest
    phase_pair |kernel - plain| on the camera-path inputs."""
    mu0 = float(np.cos(np.deg2rad(30.0)))
    modes = report['modes'] = {}
    common = dict(atm=atm, abs_coef=ab, **scene_kw, target='radiance',
                  photons=MODES_PHOTONS, n_run=MODES_RUNS, batch=BATCH,
                  tile_size=16, qmc_launch=True, n_scat_max=600, mode='all',
                  device=dev)

    def ref_runs(name, i=0):
        return [r[i] for r in MODES_REF_RUNS[name]]

    # (a) IPA and partial 3D through the front door
    for i, (name, extra) in enumerate((
            ('ipa', dict(solver='ipa')),
            ('p3d', dict(solver='p3d', p3d_order=1)))):
        res, rec = path_run(f'phase 7 {name}', lambda run: solve(
            **common, seed=args.seed + 8 + i, **extra))
        rad = np.asarray(res['rad'])
        check(rad.shape == (st.nx, st.ny) and np.isfinite(rad).all()
              and (rad >= 0).all(), f'{name}: rad not a finite (nx, ny) '
                                    f'image >= 0')
        check(res.n_photon_effective == MODES_RUNS * MODES_PHOTONS,
              f'{name}: launched {res.n_photon_effective} photons')
        rec['domain_mean'] = against_ref(
            f'{name} domain-mean radiance', float(rad.mean()), ref_runs(name),
            MODES_REF_PHOTONS, MODES_RUNS * MODES_PHOTONS, 0.01)
        modes[name] = rec

    # (a) IPA flux: per-column crossings in the birth column
    cfg = SolverConfig(target='flux', batch=BATCH, n_scat_max=600,
                       tile_size=16, use_pallas=True, qmc_launch=True,
                       flux_per_column=True, flux_kcross=4)
    factors, toa = spectral_factors(ab, nz_out=st.nz + 1)
    tal, rec = path_run('phase 7 ipa_flux', lambda run: run(
        scene, dataclasses.replace(st, ipa=True), cfg, MODES_PHOTONS,
        args.seed + 10, dev, flux_w=factors))
    tally = tal.flux.cpu().numpy()
    n_l = int(tal.n_launched)
    check(n_l == MODES_PHOTONS and tally.shape == (st.nx, st.ny, st.nz + 1,
                                                    3, 1)
          and np.isfinite(tally).all() and (tally >= 0).all(),
          f'ipa_flux: {n_l} photons, tally {tally.shape} not finite >= 0')
    red = reduce_flux(tally, n_l, ab, mu0, precontracted=True)
    toa_err = float(np.max(np.abs(red['f_down_direct'][:, :, -1]
                                  / (toa * mu0) - 1)))
    check(toa_err <= 1e-5, f'ipa_flux: TOA down-direct off toa * mu0 by '
                           f'{toa_err}')
    ref_sfc, ref_toa = zip(*IPA_FLUX_REF_RUNS)
    rec.update(
        toa_direct_max_rel_err=toa_err,
        f_down_sfc=against_ref('IPA domain-mean surface f_down',
                               float(red['f_down'][:, :, 0].mean()), ref_sfc,
                               IPA_FLUX_REF_PHOTONS, MODES_PHOTONS, 0.01),
        f_up_toa=against_ref('IPA domain-mean TOA f_up',
                             float(red['f_up'][:, :, -1].mean()), ref_toa,
                             IPA_FLUX_REF_PHOTONS, MODES_PHOTONS, 0.01))
    modes['ipa_flux'] = rec

    # (b) the ground all-sky camera, then the airborne one with its
    # phase-pair inputs captured
    captured = []
    plain_pair = mc_flight.phase_pair

    def capture(*a):
        if len(captured) < 4 and phase_pair.launches % 25 == 0:
            captured.append([t.clone() for t in a])
        return plain_pair(*a)
    area = (st.nx * st.dx) * (st.ny * st.dy)
    for i, (name, extra) in enumerate((
            ('camera', dict(sensor_type='camera')),
            ('camera_air', dict(camera=AIR_CAMERA, pathlength=True)))):
        if name == 'camera_air':
            mc_flight.phase_pair = capture
        try:
            res, rec = path_run(f'phase 7 {name}', lambda run: solve(
                **common, seed=args.seed + 11 + i, **extra))
        finally:
            mc_flight.phase_pair = plain_pair
        cam = extra.get('camera', {})
        npix, qmax = cam.get('npix', 64), cam.get('qmax', 89.0)
        rad = np.asarray(res['rad'])
        mask = np.isnan(reduce_camera_radiance(
            np.ones((npix, npix, 1), np.float32), 1, ab, mu0, area, qmax,
            precontracted=True)['rad'])
        check(rad.shape == (npix, npix)
              and np.array_equal(np.isnan(rad), mask)
              and (rad[~mask] >= 0).all(),
              f'{name}: image {rad.shape} without the fisheye NaN mask')
        check(res.n_photon_effective == MODES_RUNS * MODES_PHOTONS,
              f'{name}: launched {res.n_photon_effective} photons')
        rec['mean_finite'] = against_ref(
            f'{name} mean radiance over the finite pixels',
            float(np.nanmean(rad)), ref_runs(name), MODES_REF_PHOTONS,
            MODES_RUNS * MODES_PHOTONS, 0.01)
        if 'pathlength' in extra:
            plen = float(np.mean([r['plen'][r['plen'] > 0].mean()
                                  for r in res.runs]))
            rec['mean_plen'] = against_ref(
                f'{name} mean pathlength', plen, ref_runs(name, 1),
                MODES_REF_PHOTONS, MODES_RUNS * MODES_PHOTONS, 0.01)
        modes[name] = rec
    err = 0.0
    check(len(captured) >= 2, f'{len(captured)} camera-path steps captured')
    for i, a in enumerate(captured):
        e, same = compare(phase_pair(*a), phase_pair_ref(*a))
        err = max(err, e)
        check(same, f'phase_pair kernel != plain on captured camera-path '
              f'inputs #{i}: max |diff| {e}')
    modes['camera_air']['k1_bitwise_steps'] = len(captured)
    log(f'# phase_pair bitwise equal on {len(captured)} captured airborne '
        f'camera steps')

    # (c) the variance knobs on the production config
    base = dict(target='radiance', batch=BATCH, n_scat_max=600, tile_size=16,
                use_pallas=True, qmc_launch=True)
    rad_w = spectral_factors(ab, nz_out=1)[0][0]
    for i, (name, extra) in enumerate(KNOBS.items()):
        tal, rec = path_run(f'phase 7 {name}', lambda run: run(
            scene, st, SolverConfig(**base, **extra), MODES_PHOTONS,
            args.seed + 13 + i, dev, rad_w=rad_w))
        img = tal.rad.cpu().numpy()
        n_l = int(tal.n_launched)
        check(n_l == MODES_PHOTONS and img.shape == (st.nx, st.ny, 1)
              and np.isfinite(img).all() and (img >= 0).all(),
              f'{name}: {n_l} photons, image {img.shape} not finite >= 0')
        rec['domain_mean'] = against_ref(
            f'{name} domain-mean radiance',
            float(reduce_radiance(img, n_l, ab, mu0,
                                  precontracted=True)['rad'].mean()),
            REF_RUN_MEANS, REF_PHOTONS, MODES_PHOTONS, 0.01)
        modes[name] = rec
    log('# phase 7: ' + json.dumps({k: {kk: vv for kk, vv in v.items()
                                        if kk != 'passes'}
                                    for k, v in modes.items()}))
    return err


def march_phase(args, dev, atm, ab, scene_kw, scene, st, report):
    """Phase 8 (a)-(c): the event-marching engine on the bench scene (see
    the module docstring).  Returns the largest phase_pair |kernel -
    plain| on the marching-path inputs."""
    mu0 = float(np.cos(np.deg2rad(30.0)))
    march = report['march'] = {}
    base = dict(batch=BATCH, n_scat_max=600)
    cfg = SolverConfig(target='flux', **base)
    n_ph = MARCH_PHOTONS
    t0 = time.perf_counter()
    warm = mc.run_transport(scene, st, cfg, WARM_PHOTONS, args.seed + 20,
                            dev)
    check(int(warm.n_launched) == WARM_PHOTONS, 'marching warm-up launched')
    log(f'# marching warm-up {WARM_PHOTONS:.0e} photons '
        f'{time.perf_counter() - t0:.2f} s')

    def timed_run(name, rec):
        p = rec['passes'][0]
        rec.update(max_steps=p['max_steps'],
                   ms_per_step=1e3 * p['wall_s'] / p['steps'])
        log(f'# phase 8 {name}: {p["steps"]} steps of the cap '
            f'{p["max_steps"]}, {p["wall_s"]:.3f} s, '
            f'{rec["ms_per_step"]:.3f} ms/step, '
            f'{p["photons"] / p["wall_s"]:.4g} photons/s')

    # (a) flux, domain-average tallies
    tal, rec = path_run('phase 8 march_flux', lambda run: run(
        scene, st, cfg, n_ph, args.seed + 21, dev), entry='run_transport')
    timed_run('march_flux', rec)
    tally = tal.flux.cpu().numpy()
    n_l = int(tal.n_launched)
    check(n_l == n_ph and tally.shape == (1, 1, st.nz + 1, 3, st.ng)
          and np.isfinite(tally).all() and (tally >= 0).all(),
          f'march_flux: {n_l} photons, tally {tally.shape} not finite >= 0')
    red = reduce_flux(tally, n_l, ab, mu0)
    toa = red['toa']
    toa_err = float(np.max(np.abs(red['f_down_direct'][:, :, -1]
                                  / (toa * mu0) - 1)))
    check(toa_err <= 1e-5, f'march_flux: TOA down-direct off toa * mu0 by '
                           f'{toa_err}')
    ref_sfc, ref_toa = zip(*MARCH_FLUX_REF_RUNS)
    rec.update(
        toa_direct_max_rel_err=toa_err,
        f_down_sfc=against_ref('marching domain-mean surface f_down',
                               float(red['f_down'][:, :, 0].mean()), ref_sfc,
                               MARCH_REF_PHOTONS, n_ph, 0.01),
        f_up_toa=against_ref('marching domain-mean TOA f_up',
                             float(red['f_up'][:, :, -1].mean()), ref_toa,
                             MARCH_REF_PHOTONS, n_ph, 0.01))
    march['march_flux'] = rec

    # (b) nadir radiance, the phase-pair inputs of some steps captured
    captured = []
    plain_pair = mc.phase_pair

    def capture(*a):
        if len(captured) < 4 and phase_pair.launches % 25 == 0:
            captured.append([t.clone() for t in a])
        return plain_pair(*a)
    mc.phase_pair = capture
    try:
        tal, rec = path_run('phase 8 march_rad', lambda run: run(
            scene, st, SolverConfig(target='radiance', **base), n_ph,
            args.seed + 22, dev), entry='run_transport')
    finally:
        mc.phase_pair = plain_pair
    timed_run('march_rad', rec)
    img = tal.rad.cpu().numpy()
    n_l = int(tal.n_launched)
    check(n_l == n_ph and img.shape == (st.nx, st.ny, st.ng)
          and np.isfinite(img).all() and (img >= 0).all(),
          f'march_rad: {n_l} photons, image {img.shape} not finite >= 0')
    rec['domain_mean'] = against_ref(
        'marching domain-mean radiance',
        float(reduce_radiance(img, n_l, ab, mu0)['rad'].mean()),
        MARCH_RAD_REF_RUNS, MARCH_REF_PHOTONS, n_ph, 0.01)
    err = 0.0
    n_pf = scene.pt_mu.shape[0]
    tms_lanes = sum(int(torch.sum(a[1] >= n_pf)) for a in captured)
    check(len(captured) >= 2 and tms_lanes > 0,
          f'{len(captured)} marching steps captured, {tms_lanes} lanes on '
          f'the TMS rows')
    for i, a in enumerate(captured):
        e, same = compare(phase_pair(*a), phase_pair_ref(*a))
        err = max(err, e)
        check(same, f'phase_pair kernel != plain on captured marching '
                    f'inputs #{i}: max |diff| {e}')
    rec.update(k1_bitwise_steps=len(captured), k1_tms_lanes=tms_lanes)
    log(f'# phase_pair bitwise equal on {len(captured)} captured marching '
        f'steps ({tms_lanes} lanes on the TMS rows)')
    march['march_rad'] = rec

    # (c) the heating rate of the marching engine (flux divergence)
    res, rec = path_run('phase 8 march_hr', lambda run: solve(
        atm=atm, abs_coef=ab, **scene_kw, target='heating_rate',
        flux_engine='marching', photons=n_ph, n_run=2, batch=BATCH,
        n_scat_max=600, seed=args.seed + 23, mode='all', device=dev),
        entry='run_transport')
    hr = np.asarray(res['hr'])
    check(hr.shape[-1] == st.nz and np.isfinite(hr).all()
          and 'hr_std' in res.std and len(res.runs) == 2
          and all('hr' in r for r in res.runs),
          f'march_hr: hr {hr.shape} not finite, or without hr_std or runs')
    heat = atm.lay.pressure * 100.0 / (287.0 * atm.lay.temperature) \
        * 1004.0 * atm.lay.thickness * 1000.0
    rec.update(
        hr=hr.reshape(-1).tolist(),
        column_absorbed=against_ref(
            'marching column-absorbed power',
            float(np.sum(hr.reshape(-1) / 86400.0 * heat)),
            MARCH_HR_REF_RUNS, MARCH_REF_PHOTONS, 2 * n_ph, 0.02))
    march['march_hr'] = rec
    log('# phase 8 marching: ' + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != 'passes'}
         for k, v in march.items()}))
    return err


def dist_path(name, fn):
    """Run ``fn(run)`` with every launch count set to 0 just before, where
    ``run`` maps 'transport_decomp' and 'transport_photon_parallel' to the
    solver's dist entries, each call timed and its stats kept (solve's
    passes go through them too).  Checks that phase_pair, and no other
    kernel, launched once per flight step of every rank; logs and returns
    (fn's result, a record of the wall, steps per rank, rounds against the
    cap and lanes left in flight, photons, photons/s, migration counts and
    walls, and launch counts)."""
    passes = []
    engines = {k: getattr(solver, k) for k in ('transport_decomp',
                                               'transport_photon_parallel')}

    def timed(engine):
        def run(*a, **kw):
            stats = kw.setdefault('stats', {})
            t0 = time.perf_counter()
            tal = engine(*a, **kw)
            n = int(tal.n_launched)
            passes.append(dict(photons=n, wall_s=time.perf_counter() - t0,
                               **stats))
            return tal
        return run
    runs = {k: timed(e) for k, e in engines.items()}
    reset_counts()
    torch.cuda.synchronize()
    for k, r in runs.items():
        setattr(solver, k, r)
    try:
        t0 = time.perf_counter()
        out = fn(runs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, e in engines.items():
            setattr(solver, k, e)
    counts = launch_counts()
    rank_steps = [p['rank_steps'] for p in passes]
    steps = sum(map(sum, rank_steps))
    photons = sum(p['photons'] for p in passes)
    check(steps > 0 and counts['phase_pair'] == steps,
          f'{name}: phase_pair launched {counts["phase_pair"]} times in '
          f'{steps} rank steps')
    check(all(n == 0 for k, n in counts.items() if k != 'phase_pair'),
          f'{name}: other kernels launched: {counts}')
    rec = dict(wall_s=wall, steps=steps, rank_steps=rank_steps,
               rounds=[p.get('rounds') for p in passes], photons=photons,
               photons_per_s=photons / wall,
               phase_pair_launches=counts['phase_pair'], launches=counts)
    if 'shipped' in passes[0]:
        rounds = sum(p['rounds'] for p in passes)
        flight = sum(p['flight_s'] for p in passes)
        mig = sum(p['migrate_s'] for p in passes)
        rec.update(max_rounds=[p['max_rounds'] for p in passes],
                   in_flight=sum(p['in_flight'] for p in passes),
                   shipped=sum(p['shipped'] for p in passes),
                   held=sum(p['held'] for p in passes),
                   shipped_per_superstep=sum(p['shipped'] for p in passes)
                   / rounds, flight_s=flight, migrate_s=mig,
                   migrate_share=mig / (flight + mig))
    log(f'# phase 9 {name}: ' + json.dumps(rec))
    return out, rec


def dist_phase(args, dev, atm, ab, scene_kw, scene, st, report):
    """Phase 9: photon-parallel, decomposed and process-group runs on the
    bench scene, four ranks on this card (see the module docstring).
    Returns the largest phase_pair |kernel - plain| on the captured slab
    steps."""
    mu0 = float(np.cos(np.deg2rad(30.0)))
    runs = report['dist'] = {}
    cfg = SolverConfig(target='radiance', batch=BATCH, n_scat_max=600,
                       tile_size=16, use_pallas=True, qmc_launch=True)
    factors, toa = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]
    devs = [dev] * DIST_RANKS

    def radiance_mean(what, tal, n, rec):
        img = tal.rad.cpu().numpy()
        n_l = int(tal.n_launched)
        check(n_l == n, f'{what}: launched {n_l} photons of {n}')
        check(img.shape == (st.nx, st.ny, 1) and np.isfinite(img).all()
              and (img >= 0).all(), f'{what}: image {img.shape} not finite '
                                    f'>= 0')
        rec['domain_mean'] = against_ref(
            f'{what} domain-mean radiance',
            float(reduce_radiance(img, n_l, ab, mu0,
                                  precontracted=True)['rad'].mean()),
            REF_RUN_MEANS, REF_PHOTONS, n, 0.01)

    def below_cap(what, rec):
        check(all(r < m for r, m in zip(rec['rounds'], rec['max_rounds']))
              and rec['in_flight'] == 0,
              f'{what}: rounds {rec["rounds"]} of the cap '
              f'{rec["max_rounds"]}, {rec["in_flight"]} lanes in flight')

    # (a) photon-parallel
    n = DIST_PHOTONS
    tal, rec = dist_path('photon', lambda run: run['transport_photon_parallel'](
        scene, st, cfg, n, make_mesh(DIST_RANKS, decomp=1, device=devs),
        seed=args.seed + 30, rad_w=rad_w))
    radiance_mean('photon-parallel', tal, n, rec)
    runs['photon'] = rec

    # (b) decomposed radiance, phase-pair inputs of some slab steps captured
    captured = []
    plain_pair = mc_flight.phase_pair

    def capture(*a):
        if len(captured) < 4 and phase_pair.launches % 97 == 0:
            captured.append([t.clone() for t in a])
        return plain_pair(*a)
    mesh4 = make_mesh(DIST_RANKS, decomp=DIST_RANKS, device=devs)
    mc_flight.phase_pair = capture
    try:
        tal, rec = dist_path('decomp', lambda run: run['transport_decomp'](
            scene, st, cfg, n, mesh4, seed=args.seed + 31, rad_w=rad_w))
    finally:
        mc_flight.phase_pair = plain_pair
    below_cap('decomposed radiance', rec)
    radiance_mean('decomposed', tal, n, rec)
    err = 0.0
    check(len(captured) >= 2, f'{len(captured)} slab steps captured')
    for i, a in enumerate(captured):
        e, same = compare(phase_pair(*a), phase_pair_ref(*a))
        err = max(err, e)
        check(same, f'phase_pair kernel != plain on captured slab-step '
                    f'inputs #{i}: max |diff| {e}')
    rec['k1_bitwise_steps'] = len(captured)
    log(f'# phase_pair bitwise equal on {len(captured)} captured slab steps')
    runs['decomp'] = rec

    # (c) decomposed per-column flux
    fcfg = dataclasses.replace(cfg, target='flux', flux_per_column=True,
                               flux_kcross=4)
    flux_w, ftoa = spectral_factors(ab, nz_out=st.nz + 1)
    nf = DIST_FLUX_PHOTONS
    tal, rec = dist_path('flux', lambda run: run['transport_decomp'](
        scene, st, fcfg, nf, mesh4, seed=args.seed + 32, flux_w=flux_w))
    tally = tal.flux.cpu().numpy()
    n_l = int(tal.n_launched)
    check(n_l == nf and tally.shape == (st.nx, st.ny, st.nz + 1, 3, 1)
          and np.isfinite(tally).all() and (tally >= 0).all(),
          f'decomposed flux: {n_l} photons, tally {tally.shape} not finite '
          f'>= 0')
    red = reduce_flux(tally, n_l, ab, mu0, precontracted=True)
    toa_err = float(np.max(np.abs(red['f_down_direct'][:, :, -1]
                                  / (ftoa * mu0) - 1)))
    check(toa_err <= 1e-5, f'decomposed flux: TOA down-direct off toa * mu0 '
                           f'by {toa_err}')
    ref_sfc, ref_toa = zip(*FLUX_REF_RUNS)
    rec.update(
        toa_direct_max_rel_err=toa_err,
        f_down_sfc=against_ref('decomposed domain-mean surface f_down',
                               float(red['f_down'][:, :, 0].mean()), ref_sfc,
                               FLUX_REF_PHOTONS, nf, 0.01),
        f_up_toa=against_ref('decomposed domain-mean TOA f_up',
                             float(red['f_up'][:, :, -1].mean()), ref_toa,
                             FLUX_REF_PHOTONS, nf, 0.01))
    runs['flux'] = rec

    # (d) the front door on the decomposition
    ns = DIST_SOLVE_PHOTONS
    res, rec = dist_path('solve', lambda run: solve(
        atm=atm, abs_coef=ab, **scene_kw, target='radiance', photons=ns,
        n_run=1, batch=BATCH, tile_size=16, qmc_launch=True, n_scat_max=600,
        seed=args.seed + 33, mesh=mesh4, device=dev))
    below_cap('solve(mesh=)', rec)
    rad = np.asarray(res['rad'])
    check(rad.shape == (st.nx, st.ny) and np.isfinite(rad).all()
          and res.n_photon_effective == ns and res.toa == toa,
          f'solve(mesh=): rad {rad.shape}, {res.n_photon_effective} photons')
    rec['domain_mean'] = against_ref('solve(mesh=) domain-mean radiance',
                                     float(rad.mean()), REF_RUN_MEANS,
                                     REF_PHOTONS, ns, 0.01)
    runs['solve'] = rec

    # (e) the process-group path: NCCL, a world of one
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    init_distributed(f'tcp://127.0.0.1:{port}', world_size=1, rank=0,
                     device=dev, timeout_s=120)
    try:
        pg = make_mesh(device=dev)
        check(pg.size == 1 and type(pg.comm).__name__ == 'ProcessComm',
              f'process-group mesh {pg}')
        backend = dist.get_backend()
        tal, rec = dist_path('process_group', lambda run: run[
            'transport_photon_parallel'](scene, st, cfg, ns, pg,
                                         seed=args.seed + 34, rad_w=rad_w))
    finally:
        dist.destroy_process_group()
    rec['backend'] = backend
    radiance_mean(f'process group ({backend})', tal, ns, rec)
    runs['process_group'] = rec
    log('# phase 9: ' + json.dumps(runs))
    return err


def pair_capture(captured, seen, per_table=2, every=25):
    """A stand-in for mc_flight.phase_pair that runs it and keeps a copy of
    the inputs of steps 0, ``every``, 2 ``every``, ... (``per_table`` of
    them) of each phase table it is given, the tables of every scene a path
    builds (both wavelengths of the LUT among them) listed in ``seen`` as
    [table, calls]."""
    plain = mc_flight.phase_pair

    def capture(*a):
        rec = next((r for r in seen if r[0] is a[4]), None)
        if rec is None:
            rec = [a[4], 0]
            seen.append(rec)
        n = rec[1]
        rec[1] += 1
        if n % every == 0 and n // every < per_table:
            captured.append([t.clone() for t in a])
        return plain(*a)
    return capture


def captured_path(name, fn, **kw):
    """path_run(name, fn, **kw) with the phase-pair inputs captured
    (pair_capture); holds the kernel bitwise against its plain version on
    each capture and returns (fn's result, the record with the number of
    phase tables the path ran and their shapes, the largest |kernel -
    plain|)."""
    captured, seen = [], []
    plain = mc_flight.phase_pair
    mc_flight.phase_pair = pair_capture(captured, seen)
    try:
        out, rec = path_run(name, fn, **kw)
    finally:
        mc_flight.phase_pair = plain
    err = 0.0
    for i, a in enumerate(captured):
        e, same = compare(phase_pair(*a), phase_pair_ref(*a))
        err = max(err, e)
        check(same, f'{name}: phase_pair kernel != plain on captured inputs '
                    f'#{i} (tables {tuple(a[4].shape)}, {tuple(a[5].shape)}):'
                    f' max |diff| {e}')
    shapes = [[list(t.shape) for t in a[4:]] for a in captured]
    rec.update(k1_bitwise_steps=len(captured), k1_tables=len(seen),
               k1_shapes=shapes,
               passes_at_cap=sum(p['steps'] >= p['cap']
                                 for p in rec['passes']),
               in_flight=sum(p['in_flight'] for p in rec['passes']))
    log(f'# phase_pair bitwise equal on {len(captured)} captured steps of '
        f'{name} ({len(seen)} tables, pt_p and pt_mu {shapes}); '
        f'{rec["passes_at_cap"]} of {len(rec["passes"])} passes at their '
        f'step cap, {rec["in_flight"]} lanes in flight at the end')
    return out, rec, err


def apps_phase(args, dev, pha650, report):
    """Phase 10: the application layer on the card (see the module
    docstring): (a) example case 05 on a file-backed scene, (b) the
    bispectral LUT at its defaults and the reflectance curve of projects/05,
    (c) spectral flux against the 1D solver.  ``pha650`` is the bench
    scene's Mie table of 650 nm.  Returns the largest phase_pair |kernel -
    plain| on the captured inputs."""
    apps = report['apps'] = {}
    err = 0.0
    mu0 = float(np.cos(np.deg2rad(30.0)))

    # (a) LES nadir radiance: a SAM snapshot and a 16-g database, written
    # here, read by cld_les / aer_les and abs_16g_from_txt (no h5py)
    fdir = os.path.join(os.path.dirname(OUT_JSON) or '.', 'phase10')
    os.makedirs(fdir, exist_ok=True)
    t0 = time.perf_counter()
    les = chip_smoke_files.write_les_snapshot(
        os.path.join(fdir, 'les.nc'), seed=0, shape=APPS_LES_SHAPE)
    db = chip_smoke_files.write_abs_16g_txt(os.path.join(fdir, 'abs_16g'),
                                            [650.0], gen_abs_16g_h5)
    files_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                     np.arange(3.0, 20.1, 1.0)]))
    ab = abs_16g_from_txt(650.0, atm, fdir_k=db)
    cld = cld_les(les, coarsen=chip_smoke_files.LES_COARSEN)
    aer = aer_les(les, ssa=0.9, asy=0.7, coarsen=chip_smoke_files.LES_COARSEN,
                  ext_scale=0.1)
    load_s = time.perf_counter() - t0
    cloud_layers = int(np.sum((cld.extinction > 0).any(axis=(0, 1))))
    check(not ab.synthetic and ab.ng == 16,
          'les: the AbsCoef is not database-backed')
    check((cld.nx, cld.ny) == APPS_LES_SHAPE[:2] and cloud_layers >= 4,
          f'les: cloud {cld.nx}x{cld.ny} with {cloud_layers} cloud layers')
    res, rec, e = captured_path('phase 10 les', lambda run: solve(
        atm=atm, abs_coef=ab, cld=cld, pha=pha650, aer_3ds=[aer],
        surface=0.03, target='radiance', solar_zenith_angle=30.0,
        solar_azimuth_angle=45.0, forward_trunc_deg=5.0,
        photons=APPS_LES_PHOTONS, n_run=2, seed=args.seed + 40, device=dev))
    err = max(err, e)
    rad = np.asarray(res['rad'])
    check(rad.shape == (cld.nx, cld.ny) and np.isfinite(rad).all()
          and (rad >= 0).all(), f'les: rad {rad.shape} not finite >= 0')
    check(res.n_photon_effective == 2 * APPS_LES_PHOTONS,
          f'les: launched {res.n_photon_effective} photons')
    rec.update(files_s=files_s, load_s=load_s, synthetic=ab.synthetic,
               cloud_layers=cloud_layers,
               cloud_fraction=float(cld.cloud_mask_2d.mean()),
               domain_mean=against_ref(
                   'LES domain-mean radiance', float(rad.mean()),
                   APPS_LES_REF_RUNS, APPS_LES_REF_PHOTONS,
                   2 * APPS_LES_PHOTONS, 0.01))
    apps['les'] = rec

    # (b) the bispectral LUT at its default grids and wavelengths, the
    # retrieval of three interior nodes, the 31-node reflectance curve
    atm1 = atm_atmmod(np.linspace(0, 20, 21))
    lut, rec, e = captured_path('phase 10 lut', lambda run: (
        gen_bispectral_lookup_table(atm1, photons=APPS_LUT_PHOTONS,
                                    seed=args.seed + 41, device=dev)))
    err = max(err, e)
    check(rec['k1_tables'] == 2 and len(rec['passes']) == 2,
          f'lut: {rec["k1_tables"]} phase tables in {len(rec["passes"])} '
          f'passes, not one a wavelength')
    names = ('mean', 'cot_lo_cer_lo', 'cot_lo_cer_hi', 'cot_hi_cer_lo',
             'cot_hi_cer_hi')
    for band, k in (('ref_vis', 0), ('ref_nir', 1)):
        t = np.asarray(lut[band])
        check(t.shape == (25, 11) and np.isfinite(t).all() and (t >= 0).all(),
              f'lut: {band} {t.shape} not finite >= 0')
        got = chip_smoke_files.lut_summary(t)
        rec[band] = {n: against_ref(
            f'LUT {band} {n}', got[i], [r[k][i] for r in APPS_LUT_REF_RUNS],
            APPS_LUT_REF_PHOTONS, APPS_LUT_PHOTONS, 0.01)
            for i, n in enumerate(names)}
    ic, ie = (list(p) for p in APPS_LUT_PICKS)
    cot_hat, cer_hat = retrieve_cot_cer(
        lut, np.asarray(lut['ref_vis'])[ic, ie],
        np.asarray(lut['ref_nir'])[ic, ie])
    check(np.array_equal(cot_hat, lut['cot'][ic])
          and np.array_equal(cer_hat, lut['cer'][ie]),
          f'lut: retrieval of nodes {APPS_LUT_PICKS} gave COT {cot_hat}, '
          f'CER {cer_hat}')
    rec['retrieved'] = [[float(c) for c in cot_hat],
                        [float(c) for c in cer_hat]]
    apps['lut'] = rec

    curve, rec, e = captured_path('phase 10 curve', lambda run: (
        func_ref_vs_cot(atm1, photons=APPS_CURVE_PHOTONS, seed=args.seed + 42,
                        device=dev)))
    err = max(err, e)
    ref = np.asarray(curve.ref)
    rising = chip_smoke_files.curve_rises(curve.cot, ref)
    check(ref.shape == (31,) and np.isfinite(ref).all() and rising,
          f'curve: {ref.shape}, not finite or not rising from COT 1 in '
          f'means of five nodes: {ref}')
    rec.update(rising=rising, mean=against_ref(
        'reflectance-curve mean', float(ref.mean()),
        APPS_CURVE_REF_RUNS, APPS_CURVE_PHOTONS,
        APPS_CURVE_PHOTONS, 0.01))
    apps['curve'] = rec

    # (c) spectral flux on a clear sky: MC against the 1D solver
    wv = list(APPS_FLUX_WAVELENGTHS)
    out, rec, e = captured_path('phase 10 spectral_flux', lambda run: (
        spectral_flux(atm1, wv, abs_fn=abs_synthetic, surface=0.2,
                      solar_zenith_angle=30.0, photons=APPS_FLUX_PHOTONS,
                      n_run=1, seed=args.seed + 43, device=dev)))
    err = max(err, e)
    one_d = spec_flx(atm1, wavelengths=wv, solar_zenith_angle=30.0,
                     surface_albedo=0.2, slit=None, n_streams=8,
                     abs_fn=abs_synthetic)
    rec['wavelengths'] = {}
    for i, w in enumerate(wv):
        dn = float(out['f_down'][i].reshape(-1, atm1.nz + 1)[:, 0].mean())
        up = float(out['f_up'][i].reshape(-1, atm1.nz + 1)[:, -1].mean())
        direct = out['f_down_direct'][i].reshape(-1, atm1.nz + 1)[:, -1]
        toa_err = float(np.max(np.abs(direct / (out['toa'][i] * mu0) - 1)))
        d_dn, d_up = dn / one_d['f_down'][i] - 1, up / one_d['f_up'][i] - 1
        check(toa_err <= 1e-5 and abs(d_dn) <= 0.03 and abs(d_up) <= 0.06,
              f'spectral_flux {w} nm: surface f_down {dn:.6g} against '
              f'{one_d["f_down"][i]:.6g} ({d_dn:+.2%}, bound 3 %), TOA f_up '
              f'{up:.6g} against {one_d["f_up"][i]:.6g} ({d_up:+.2%}, bound '
              f'6 %), TOA down-direct off toa * mu0 by {toa_err}')
        rec['wavelengths'][str(w)] = dict(
            f_down_sfc=dn, f_down_sfc_1d=float(one_d['f_down'][i]),
            rel_diff_f_down=d_dn, f_up_toa=up,
            f_up_toa_1d=float(one_d['f_up'][i]), rel_diff_f_up=d_up,
            toa_direct_max_rel_err=toa_err)
    apps['spectral_flux'] = rec
    log('# phase 10: ' + json.dumps({k: {kk: vv for kk, vv in v.items()
                                         if kk != 'passes'}
                                     for k, v in apps.items()}))
    return err


def sat_scene(fname, nx):
    """projects/03's scene from an AHI CLP granule (main_pre, main_sim):
    ahi_l2 over its extent gridded to nx x nx, cld_sat, the atmosphere,
    gases and Mie table at SAT_WAVELENGTH.  Returns (atm, ab, cld, pha, the
    gridded COT)."""
    obj = ahi_l2([fname], extent=chip_smoke_files.AHI_EXTENT, nx=nx, ny=nx)
    cot = obj.data['cot_2d']['data']
    cer = np.where(cot > 0, obj.data['cer_2d']['data'], 0.0)
    cld = cld_sat(cot_2d=cot, cer_2d=cer, dx=0.5, dy=0.5, cth=2.0, cgt=1.0,
                  dz=0.5)
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                     np.arange(3.0, 20.1, 1.0)]))
    return (atm, abs_synthetic(SAT_WAVELENGTH, atm), cld,
            pha_mie_wc(SAT_WAVELENGTH), cot)


def sat_phase(args, dev, report):
    """Phase 11: projects/03's AHI-to-flux pipeline on the card (see the
    module docstring).  Returns the largest phase_pair |kernel - plain| on
    the captured inputs."""
    sat = report['sat'] = {}
    fdir = os.path.join(os.path.dirname(OUT_JSON) or '.', 'phase11')
    os.makedirs(fdir, exist_ok=True)
    t0 = time.perf_counter()
    fname = chip_smoke_files.write_ahi_clp(os.path.join(fdir, 'ahi_clp.nc'),
                                           seed=0)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    atm, ab, cld, pha, cot = sat_scene(fname, SAT_NX)
    read_s = time.perf_counter() - t0
    exact = (float(cot.sum()), float((cot > 0).mean()),
             float(cld.extinction.sum()))
    check(exact == SAT_EXACT, f'sat: gridded COT sum, cloud fraction and '
                              f'extinction sum {exact} != the JAX '
                              f'package\'s {SAT_EXACT}')
    sat.update(file_mb=os.path.getsize(fname) / 1e6, write_s=write_s,
               read_s=read_s, grid=list(cot.shape), exact=exact)
    mu0 = float(np.cos(np.deg2rad(SAT_SZA)))
    iz = int(np.argmin(np.abs(atm.lev.altitude - SAT_ALT_KM)))
    fx, fy = chip_smoke_files.flight_track(SAT_NX)
    err = 0.0
    for mode in ('3d', 'ipa'):
        res, rec, e = captured_path(f'phase 11 {mode}', lambda run: solve(
            atm=atm, abs_coef=ab, cld=cld, pha=pha, surface=0.06,
            target='flux', solver=mode, flux_per_column=True,
            solar_zenith_angle=SAT_SZA, solar_azimuth_angle=SAT_SAA,
            photons=SAT_PHOTONS, n_run=1, seed=args.seed + 7, device=dev))
        err = max(err, e)
        f_dn, f_up = np.asarray(res['f_down']), np.asarray(res['f_up'])
        shape = (cld.nx, cld.ny, atm.nz + 1)
        check(f_dn.shape == f_up.shape == shape and np.isfinite(f_dn).all()
              and np.isfinite(f_up).all() and (f_dn >= 0).all()
              and (f_up >= 0).all(),
              f'sat {mode}: f_down {f_dn.shape}, f_up {f_up.shape} not '
              f'finite >= 0 of {shape}')
        check(res.n_photon_effective == SAT_PHOTONS,
              f'sat {mode}: launched {res.n_photon_effective} photons')
        toa_err = float(np.max(np.abs(
            np.asarray(res['f_down_direct'])[..., -1] / (res.toa * mu0) - 1)))
        check(toa_err <= 1e-5, f'sat {mode}: TOA down-direct off toa * mu0 '
                               f'by {toa_err}')
        z = atm.lev.altitude[iz]
        rec.update(toa_direct_max_rel_err=toa_err, track_level_km=float(z))
        means = {'f_down_sfc': ('domain-mean surface f_down',
                                f_dn[..., 0].mean()),
                 'f_up_toa': ('domain-mean TOA f_up', f_up[..., -1].mean()),
                 'f_down_track': (f'track-mean f_down at {z:g} km',
                                  f_dn[fx, fy, iz].mean())}
        for refs, (key, (what, value)) in zip(zip(*SAT_REF_RUNS[mode]),
                                              means.items()):
            rec[key] = against_ref(f'sat {mode} {what}', float(value), refs,
                                   SAT_REF_PHOTONS, SAT_PHOTONS, 0.01)
        sat[mode] = rec
    log('# phase 11: ' + json.dumps({k: ({kk: vv for kk, vv in v.items()
                                          if kk != 'passes'}
                                         if isinstance(v, dict) else v)
                                     for k, v in sat.items()}))
    return err


def load_script(path, name):
    """The driver at ``path`` as a module named ``name`` (its file name
    starts with a digit), its ``main`` not run."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def native_scene(dev):
    """The scene of tests/test_cross_native.py:20-30 on ``dev``: 4 x 4
    columns of 1 km, a homogeneous cloud (COT 6, 1-3 km) over half of
    them."""
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[2:] = 0.0   # half cloudy, half clear
    cld.cer[2:] = 0.0
    scene, st = build_scene(atm, ab, cld=cld, surface=0.15,
                            solar_zenith_angle=30.0, device=dev)
    return ab, scene, st


def cross_flux(name, a, b, w):
    """Relative differences of two (nz+1, 3, ng) flux tallies per photon
    at tests/test_cross_native.py:44-58's bounds: 5 % at every level
    (above 1e-3) of down-direct and up, 8 % for the surface down-diffuse.
    Returns the worst of each."""
    out = {}
    for ch, key in ((0, 'down_direct'), (2, 'up')):
        x, y = a[:, ch, :] @ w, b[:, ch, :] @ w
        sel = x > 1e-3
        out[key] = float(np.max(np.abs(x[sel] / y[sel] - 1)))
    out['sfc_down_diffuse'] = float((a[0, 1, :] @ w) / (b[0, 1, :] @ w) - 1)
    log(f'# phase 12 native {name}: worst level down-direct '
        f'{out["down_direct"]:+.3%}, up {out["up"]:+.3%}; surface '
        f'down-diffuse {out["sfc_down_diffuse"]:+.3%}')
    check(out['down_direct'] <= 0.05 and out['up'] <= 0.05
          and abs(out['sfc_down_diffuse']) <= 0.08,
          f'native {name}: {out} beyond 5 % per level / 8 % surface '
          f'down-diffuse')
    return out


def native_phase(args, dev):
    """Phase 12 (a): the C++ solver through the port's bridge on a scene
    whose tensors live on the card, against the flight engine (flux and
    radiance) and the marching engine (flux) on the same scene."""
    t0 = time.perf_counter()
    lib = native.ensure_built()
    threads = native.max_threads()
    rec = dict(library=os.path.basename(lib),
               build_s=native.build_seconds, load_s=time.perf_counter() - t0,
               omp_threads=threads if threads is not None else 'serial')
    built = ('found built' if native.build_seconds is None
             else f'built by g++ in {native.build_seconds:.2f} s')
    log(f'# phase 12 native: {rec["library"]} {built}, OpenMP threads '
        f'{rec["omp_threads"]}')
    ab, scene, st = native_scene(dev)
    check(scene.ext3d.device.type == dev.type, 'native: scene not on the '
                                               'card')
    w, n = ab.weight, NATIVE_PHOTONS
    runs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        runs[name] = dict(wall_s=time.perf_counter() - t0)
        return out

    _, flux_nat, n_nat = timed('native_flux', lambda: native.mc_ref_run(
        scene, st, albedo=0.15, sza_deg=30.0, saa_deg=0.0, n_photon=n,
        seed=args.seed + 77, do_radiance=False))
    rad_nat, _, _ = timed('native_rad', lambda: native.mc_ref_run(
        scene, st, albedo=0.15, sza_deg=30.0, saa_deg=0.0, n_photon=n,
        seed=args.seed + 99))
    flux_cfg = SolverConfig(target='flux', batch=BATCH, flux_per_column=False)
    rad_cfg = SolverConfig(target='radiance', batch=BATCH)
    t_flux = timed('flight_flux', lambda: mc_flight.run_transport_flight(
        scene, st, flux_cfg, n, args.seed + 21, dev))
    t_rad = timed('flight_rad', lambda: mc_flight.run_transport_flight(
        scene, st, rad_cfg, n, args.seed + 31, dev))
    t_march = timed('march_flux', lambda: mc.run_transport(
        scene, st, flux_cfg, n, seed=args.seed + 41, device=dev))
    for name, t in (('flight_flux', t_flux), ('flight_rad', t_rad),
                    ('march_flux', t_march)):
        check(int(t.n_launched) == n, f'native {name}: launched '
                                      f'{int(t.n_launched)} of {n}')
        runs[name]['steps'] = int(t.n_steps)
    flux_fl = t_flux.flux[0, 0].double().cpu().numpy() / n
    flux_mc = t_march.flux[0, 0].double().cpu().numpy() / n
    flux_nat = flux_nat / n_nat
    rec['flux'] = {'flight_vs_native': cross_flux('flight vs C++', flux_fl,
                                                  flux_nat, w),
                   'march_vs_native': cross_flux('marching vs C++', flux_mc,
                                                 flux_nat, w),
                   'flight_vs_march': cross_flux('flight vs marching',
                                                 flux_fl, flux_mc, w)}
    # nadir radiance (tests/test_cross_native.py:68-75): the domain mean
    # within 4 %, the cloudy and the clear half within 6 %
    rad_fl = (t_rad.rad.double().cpu().numpy() @ w) / n
    rad_nat = (rad_nat @ w) / n_nat
    rel = {k: float(rad_fl[sl].mean() / rad_nat[sl].mean() - 1)
           for k, sl in (('mean', np.s_[:]), ('cloudy', np.s_[:2]),
                         ('clear', np.s_[2:]))}
    log(f'# phase 12 native flight vs C++ radiance: domain mean '
        f'{rel["mean"]:+.3%}, cloudy half {rel["cloudy"]:+.3%}, clear half '
        f'{rel["clear"]:+.3%}')
    check(abs(rel['mean']) <= 0.04 and abs(rel['cloudy']) <= 0.06
          and abs(rel['clear']) <= 0.06,
          f'native radiance: flight vs C++ {rel} beyond 4 % / 6 %')
    rec.update(radiance_flight_vs_native=rel, photons=n, runs=runs)
    log('# phase 12 native: ' + json.dumps(runs))
    return rec


def html_fields(fname):
    """The two fields a page of vis.compare_data_2d_html holds."""
    with open(fname) as f:
        text = f.read()
    return [np.array(json.loads(text.split(f'const {k} = ', 1)[1]
                                .split(';\n', 1)[0])) for k in ('A', 'B')]


def scripts_phase(args, dev, report):
    """Phase 12: the native bridge on the card's scene (native_phase), then
    examples/00_er3t_tpu_torch.py's cases 01 and 06 at their defaults
    through its own case functions, and the comparison page of case 06's
    image (see the module docstring).  Returns the largest phase_pair
    |kernel - plain| on the captured inputs."""
    rep = report['scripts'] = {'native': native_phase(args, dev)}
    ex = load_script(EXAMPLE_00, 'example_00_torch')
    ex.OUT = EXAMPLES_OUT
    os.makedirs(EXAMPLES_OUT, exist_ok=True)
    # the card machine may have no matplotlib: then the case functions'
    # PNG writers are never called (the images are kept in memory instead)
    have_mpl = importlib.util.find_spec('matplotlib') is not None
    drawn = {}
    if not have_mpl:
        def keep(data, *a, fname=None, **kw):
            drawn[os.path.basename(fname)] = data
        ex.plot_flux_profile = ex.quicklook_radiance = keep
    rep['matplotlib'] = have_mpl
    err = 0.0
    mu0 = float(np.cos(np.deg2rad(30.0)))
    res, rec, e = captured_path('phase 12 example 01', lambda run: (
        ex.EXAMPLES['01'](EXAMPLES_PHOTONS, device=dev)))
    err = max(err, e)
    f_dn, f_up = np.squeeze(res['f_down']), np.squeeze(res['f_up'])
    direct = np.squeeze(res['f_down_direct'])
    check(f_dn.ndim == 1 and f_dn.shape == f_up.shape == direct.shape
          and np.isfinite(f_dn).all() and np.isfinite(f_up).all(),
          f'example 01: f_down {f_dn.shape}, f_up {f_up.shape} not finite '
          f'domain-average profiles')
    check(res.n_photon_effective == 3 * EXAMPLES_PHOTONS,
          f'example 01: launched {res.n_photon_effective} photons')
    toa_err = float(abs(direct[-1] / (res.toa * mu0) - 1))
    check(toa_err <= 1e-5, f'example 01: TOA down-direct off toa * mu0 by '
                           f'{toa_err}')
    refs = EXAMPLES_REF_RUNS['01']
    rec.update(toa_direct_rel_err=toa_err, f_down_sfc=against_ref(
        'example 01 surface f_down', float(f_dn[0]), [r[0] for r in refs],
        EXAMPLES_REF_PHOTONS, 3 * EXAMPLES_PHOTONS, 0.01), f_up_toa=against_ref(
        'example 01 TOA f_up', float(f_up[-1]), [r[1] for r in refs],
        EXAMPLES_REF_PHOTONS, 3 * EXAMPLES_PHOTONS, 0.01))
    rep['example_01'] = rec

    res, rec, e = captured_path('phase 12 example 06', lambda run: (
        ex.EXAMPLES['06'](EXAMPLES_PHOTONS, device=dev)))
    err = max(err, e)
    rad = np.asarray(res['rad'])
    check(rad.shape == (200, 200) and np.isfinite(rad).all()
          and (rad >= 0).all(), f'example 06: rad {rad.shape} not a finite '
                                f'200 x 200 image >= 0')
    check(res.n_photon_effective == 3 * EXAMPLES_PHOTONS,
          f'example 06: launched {res.n_photon_effective} photons')
    rec['domain_mean'] = against_ref(
        'example 06 domain-mean radiance', float(rad.mean()),
        [r[0] for r in EXAMPLES_REF_RUNS['06']], EXAMPLES_REF_PHOTONS,
        3 * EXAMPLES_PHOTONS, 0.01)
    rep['example_06'] = rec

    # (c) the comparison page of case 06's image: one panel from a tensor
    # on the card, one from the host array; the page holds the image's
    # block means (intv.py:97-101)
    page = vis.compare_data_2d_html(
        torch.from_numpy(rad).to(dev), rad, name0='card tensor',
        name1='host array', fname=os.path.join(EXAMPLES_OUT, '06_rad_hem.html'),
        title='example 06', max_px=HTML_MAX_PX)
    step = int(np.ceil(max(rad.shape) / HTML_MAX_PX))
    n0, n1 = rad.shape[0] // step * step, rad.shape[1] // step * step
    want = np.round(rad.astype(np.float64)[:n0, :n1].reshape(
        n0 // step, step, n1 // step, step).mean((1, 3)), 7)
    fields = html_fields(page)
    check(all(f.shape == want.shape and np.array_equal(f, want)
              for f in fields), f'page {page}: its fields are not the '
                                f'image\'s {step} x {step} block means')
    pngs = {'01_flux_clear_sky.png': 0, '06_rad_hem.png': 0}
    if have_mpl:
        for f in pngs:
            pngs[f] = os.path.getsize(os.path.join(EXAMPLES_OUT, f))
        check(all(pngs.values()), f'example PNGs empty: {pngs}')
    else:
        check(sorted(drawn) == sorted(pngs), f'images drawn: {sorted(drawn)}')
    rep['vis'] = dict(page=page, page_bytes=os.path.getsize(page),
                      block=step, page_shape=list(want.shape), pngs=pngs,
                      png_writers_called=have_mpl)
    log('# phase 12: ' + json.dumps({k: ({kk: vv for kk, vv in v.items()
                                          if kk not in ('passes', 'k1_shapes')}
                                         if isinstance(v, dict) else v)
                                     for k, v in rep.items()}))
    return err


def quasi_summary(img, weight):
    """(NaN count, mean over the finite pixels, the means of the 4 x 4
    blocks) of the g-weighted (npix, npix) image of a (npix, npix, Ng)
    quasi-radiance render."""
    img = np.asarray(img, np.float64) @ weight
    q = img.shape[0] // 4
    blocks = img.reshape(4, q, 4, q).transpose(0, 2, 1, 3).reshape(16, -1)
    return (int(np.isnan(img).sum()), float(np.nanmean(img)),
            tuple(float(v) for v in np.nanmean(blocks, axis=1)))


def quasi_phase(dev, ab, scene, st, report):
    """Phase 8 (d): quasi-radiance of the bench scene for the two cameras,
    against the JAX reference to QUASI_RTOL (deterministic: the bound only
    absorbs f32 rounding between XLA on the CPU and CUDA)."""
    quasi = report['quasi'] = {}
    for name, cam in QUASI_CAMERAS.items():
        cfg = SolverConfig(sensor_type='camera', cam_npix=QUASI_NPIX, **cam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = quasi_radiance(scene, st, cfg, n_steps=QUASI_STEPS, device=dev)
        img = img.cpu().numpy()
        wall = time.perf_counter() - t0
        check(img.shape == (QUASI_NPIX, QUASI_NPIX, st.ng),
              f'quasi {name}: image {img.shape}')
        n_nan, mean, blocks = quasi_summary(img, ab.weight)
        r_nan, r_mean, r_blocks = QUASI_REF[name]
        rel = [mean / r_mean - 1] + [b / r - 1 for b, r in zip(blocks,
                                                              r_blocks)]
        worst = int(np.argmax(np.abs(rel)))
        quasi[name] = dict(wall_s=wall, nan_count=n_nan, ref_nan_count=r_nan,
                           mean_finite=mean, ref_mean_finite=r_mean,
                           blocks=blocks, rel_diff_mean=rel[0],
                           max_abs_rel_diff_block=float(np.max(np.abs(
                               rel[1:]))),
                           worst=('mean' if worst == 0
                                  else f'block {worst - 1}'))
        log(f'# quasi {name}: ' + json.dumps(quasi[name]))
        check(n_nan == r_nan, f'quasi {name}: {n_nan} NaN pixels, the '
                              f'reference {r_nan}')
        check(np.isfinite(img[~np.isnan(img)]).all()
              and (img[~np.isnan(img)] >= 0).all(),
              f'quasi {name}: finite pixels not >= 0')
        check(abs(rel[worst]) <= QUASI_RTOL,
              f'quasi {name}: {quasi[name]["worst"]} off the JAX reference '
              f'by {rel[worst]:.3g} (bound {QUASI_RTOL})')


def bench_phase(args, dev, ab, scene, st, report):
    """Phase 13: bench_torch.main at a cut budget (BENCH_BUDGET) on the
    bench scene, then the ablation stand-ins of SolverConfig.ablate at
    ABLATE_STEPS pinned steps (see the module docstring).  Returns the
    largest phase_pair |kernel - plain| on the captured inputs."""
    rep = report['bench'] = {}
    mu0 = float(np.cos(np.deg2rad(30.0)))
    plain_build = bench_torch.build
    kept = []                 # the production-config runs' tallies

    def bench(run):
        def keep(*a, **kw):
            tal = run(*a, **kw)
            if a[2].qmc_launch:
                kept.append((tal.rad.cpu().numpy().astype(np.float64),
                             int(tal.n_launched)))
            return tal
        mc_flight.run_transport_flight = keep
        try:
            return bench_torch.main(device=dev, **BENCH_BUDGET)
        finally:
            mc_flight.run_transport_flight = run
    # the scene built above (bench_torch builds the same one)
    bench_torch.build = lambda device: (ab, scene, st)
    try:
        out, rec, err = captured_path('phase 13 bench', bench,
                                      module=mc_flight)
    finally:
        bench_torch.build = plain_build
    noise = 'noise_var_ratio_indep_over_corr' in out
    keys = set(BENCH_KEYS['noise' if noise else 'degraded'])
    if not noise and out['healthy']:
        keys.discard('degraded')     # healthy, but the noise phase skipped
    check(set(out) == keys, f'bench_torch line: keys {sorted(out)} are not '
                            f"bench.py's {sorted(keys)}")
    budget = BENCH_BUDGET
    n_corr = budget['warmup'] + budget['probe'] + budget['max_chunks'] \
        * budget['chunk'] + (budget['repeats'] * budget['n_noise']
                             if noise else 0)
    n_l = sum(n for _, n in kept)
    check(n_l == n_corr, f'bench: {n_l} production-config photons, not '
                         f'{n_corr}')
    img = sum(im for im, _ in kept)
    mean = float(reduce_radiance(img, n_l, ab, mu0,
                                 precontracted=True)['rad'].mean())
    rec.update(line=out, branch='noise' if noise else 'degraded',
               domain_mean=against_ref('bench domain-mean radiance', mean,
                                       REF_RUN_MEANS, REF_PHOTONS, n_l,
                                       0.01))
    rep['bench'] = rec

    # (b) the ablation stand-ins at pinned steps
    factors, _ = spectral_factors(ab, nz_out=1)
    for name, ablate in ABLATIONS.items():
        cfg = SolverConfig(target='radiance', batch=BATCH, n_scat_max=600,
                           tile_size=16, use_pallas=True,
                           max_events=ABLATE_STEPS, ablate=ablate)
        tal, r, e = captured_path(
            f'phase 13 ablate {name}', lambda run: run(
                scene, st, cfg, 1 << 30, args.seed + 40, dev,
                rad_w=factors[0]),
            module=mc_flight, k1='phase' not in ablate)
        err = max(err, e)
        check(r['steps'] == ABLATE_STEPS, f'ablate {name}: {r["steps"]} '
                                          f'steps, not {ABLATE_STEPS}')
        check(bool(torch.isfinite(tal.rad).all()),
              f'ablate {name}: image not finite')
        r['ms_per_step'] = 1e3 * r['passes'][0]['wall_s'] / r['steps']
        rep[f'ablate_{name}'] = r
    log('# phase 13: ' + json.dumps(
        {k: {kk: vv for kk, vv in v.items()
             if kk in ('wall_s', 'steps', 'photons_per_s', 'ms_per_step',
                       'phase_pair_launches', 'branch', 'domain_mean')}
         for k, v in rep.items()}))
    return err


def profile_steps(scene, st, cfg, dev, rad_w=None, flux_w=None):
    """Device time by kernel over 20 flight steps at B = 2^17 (after 30
    warm steps), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    kern = mc_flight.FlightKernel(scene, st, cfg, 10 ** 9, rad_w=rad_w,
                                  flux_w=flux_w)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    c = kern.carry0(cfg.batch)
    for _ in range(30):
        c = kern.step(c, mc_flight.draw_deviates(gen, cfg.batch, dev), 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            c = kern.step(c, mc_flight.draw_deviates(gen, cfg.batch, dev), 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    total_dev = 0.0
    for e in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): the CPU ops
        # that launch them carry the same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        d = e.self_device_time_total
        total_dev += d
        rows.append((d, e.key, e.count))
    rows.sort(reverse=True)
    out = dict(wall_ms_per_step=1e3 * wall / 20,
               device_ms_per_step=total_dev / 1e3 / 20,
               device_busy_share=total_dev / 1e6 / wall,
               kernels_per_step=sum(r[2] for r in rows) / 20,
               top=[dict(name=k[:80], ms_per_step=d / 1e3 / 20, calls=n)
                    for d, k, n in rows[:15]])
    log(f'# profile ({cfg.target}): ' + json.dumps(
        {k: v for k, v in out.items() if k != 'top'}))
    for r in out['top']:
        log(f'#   {r["ms_per_step"]:.4f} ms/step  x{r["calls"]}  {r["name"]}')
    return out


if __name__ == '__main__':
    sys.exit(main())
