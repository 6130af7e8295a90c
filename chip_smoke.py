#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (er3t_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py                 # needs one CUDA card; ~1 min
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
6. probe phase: every probe kernel (take_reps, gather_row_sum, take2d,
   smem_stage, the bf16 phase pair) against its plain version, bitwise,
   at the TPU probe scripts' shapes and at a ragged B = 100003, timed
   beside it, and on the paths of the kernels' width and alignment
   dispatch: take_reps windows at the wrap of a table at widths 1 and 3,
   gather_row_sum on a ragged width (99) and on a table view one float
   off 16-byte alignment; then the probe path, the gather probes
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
build/chip_smoke.json.  With --profile, 20 radiance steps and 20 flux
steps are profiled (keys "profile" and "profile_flux").
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from er3t_tpu_torch import _build
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.probes import gather, gather_probe
from er3t_tpu_torch.probes.gather_probe import card_line, device_ms
from er3t_tpu_torch.rtm import mc_flight
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.out import (reduce_flux, reduce_radiance,
                                    spectral_factors)
from er3t_tpu_torch.rtm.phase_pair import phase_pair, phase_pair_ref
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.rtm.solver import solve

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
FLUX_PHOTONS = 4_000_000         # photons of the timed flux-path run
HR_PHOTONS = 1_000_000           # photons per run of the heating-rate solve
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, HBM3
F32_FLOPS = 67e12                # H100 SXM data sheet, f32 outside the
                                 # tensor cores


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def build_bench_scene(device):
    """The bench.py scene (bench.py:66-81) through the port."""
    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hem(nx=480, ny=480, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                      cot_scale=15.0, cloud_base=0.5, seed=7)
    pha = pha_mie_wc(650.0)
    kw = dict(cld=cld, pha=pha, surface=0.03, solar_zenith_angle=30.0,
              solar_azimuth_angle=45.0, forward_trunc_deg=25.0)
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
    for row, (mode, tab, idx, hi) in zip(('K7', 'K6', None, None, None,
                                          None), (
            ('axis0', (1280, 128), (1280, 128), 1280),
            ('axis1', (2048, 1024), (2048, 128), 1024),
            ('rows', (4096, 128), (2048,), 4096),
            ('rows', (4096, 8), (RAGGED,), 4096),
            ('axis0', (4096, 8), (RAGGED, 8), 4096),
            ('axis1', (RAGGED, 16), (RAGGED, 8), 16))):
        add('take2d', f'{mode}_tab{tab}_idx{idx}'.replace(' ', ''),
            gather.take2d, gather.take2d_ref, randint(hi, *idx),
            randn(*tab), mode, row=row, cost=take2d_cost,
            library=take2d_library)
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


def run(args, dev):
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
    t0 = time.perf_counter()
    res = solve(atm=atm, abs_coef=ab, **scene_kw, target='radiance',
                photons=SOLVE_PHOTONS, n_run=2, batch=BATCH, tile_size=16,
                qmc_launch=True, n_scat_max=600, seed=args.seed + 3,
                device=dev)
    rad = np.asarray(res['rad'])
    check(rad.shape == (st.nx, st.ny) and np.isfinite(rad).all(),
          'solve: rad not a finite (nx, ny) image')
    check(res.toa == toa, f'solve: toa {res.toa} != {toa}')
    report['solve'] = dict(wall_s=time.perf_counter() - t0,
                           domain_mean=float(rad.mean()),
                           n_photon_effective=res.n_photon_effective)
    log('# solve: ' + json.dumps(report['solve']))

    # ---- 4b. flux path ----
    flux_phase(args, dev, atm, ab, scene_kw, scene, st, report)

    # ---- 6. probe phase ----
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
    report.update(probe_kernels=probe_kt, rows=rows)

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

    def entry(name, source, replaces, n, err, t):
        return dict(name=name, route='cuda', source=source,
                    replaces=replaces, launches=n, max_abs_err=err,
                    ms=t['ms'], plain_ms=t['plain_ms'],
                    bound_ms=t['bound_ms'], bound_by=t['bound_by'],
                    library_ms=t['library_ms'], floor_ms=t['floor_ms'])
    pp_entry = entry('phase_pair', PP_SOURCE, PP_REPLACES, launches, max_err,
                     kt['bench_tables'])
    pp_entry['flux_launches'] = report['flux']['phase_pair_launches']
    kernels = {'kernels': [pp_entry] + [
        entry(name, source, replaces, probe_counts[name], probe_err[name],
              probe_kt[name])
        for name, (source, replaces) in PROBE_KERNELS.items()]}
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
