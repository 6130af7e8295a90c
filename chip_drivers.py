#!/usr/bin/env python3
"""The port's example, project and bin/ drivers run at their defaults on
one NVIDIA GPU, each in its own process.

    python chip_drivers.py                 # every driver, one after another
    python chip_drivers.py ex00_05 p03     # some of them
    python chip_drivers.py --list          # their names and command lines

Each driver runs through its own ``main()`` at its default arguments, apart
from its output folder, which is ``chiprun_out/drivers/`` (the examples'
``OUT``, the projects' ``--outdir`` or ``--out``).  In the driver's
process the solver's flight engine (``solver.run_transport_flight``) is
wrapped to count its passes and steps (the phase-pair kernel must have
launched once per step) and the lanes still in flight at each pass's step
cap.  Without matplotlib the drivers' own PNG writers are replaced by
recorders that keep the shape of what each would have drawn; projects 01,
03 and 04 skip their plots by themselves (the reference's behaviour).
bin/lss_torch and bin/lsa_torch list the AHI CLP granule of
``chip_smoke_files.write_ahi_clp`` (chip_smoke.py's phase 11).

One JSON line per driver: its name and command, the card, the wall of its
``main()`` (host clock, ending in a synchronise), its passes, steps, passes
at the step cap, lanes in flight at the end, photons, phase-pair launches,
the files it wrote and the last lines of its own output; its whole output
goes to ``chiprun_out/drivers/<name>.log``.  Exits non-zero without a CUDA
device, or when a driver fails.
"""

import argparse
import importlib.util
import json
import logging
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join('chiprun_out', 'drivers')
EX00 = 'examples/00_er3t_tpu_torch.py'
# name -> (script, arguments); the output folder is added by run_one
DRIVERS = {
    'ex00_02': (EX00, ['02']), 'ex00_03': (EX00, ['03']),
    'ex00_04': (EX00, ['04']), 'ex00_05': (EX00, ['05']),
    'ex01': ('examples/01_er3t_tpu_torch_spectral.py', []),
    'ex02': ('examples/02_er3t_tpu_torch_lrt_rad.py', []),
    'p01': ('projects/01_oco2_rad_sim_torch.py', []),
    'p02': ('projects/02_sat_rad_sim_torch.py', []),
    'p03': ('projects/03_spns_flux_sim_torch.py', []),
    'p04': ('projects/04_cam_nadir_rad_sim_torch.py', []),
    'p05': ('projects/05_cnn_les_factory_torch.py', []),
    'lss': ('bin/lss_torch', []),
    'lsa': ('bin/lsa_torch', []),
}
# The JAX package's drivers on the CPU at the same photons and batch (the
# card's 2^17 where a driver leaves it to solve), for comparison: a driver
# name of REF_DRIVERS as the argument; its images go to build/drivers_ref/
REF_COMMAND = """\
JAX_PLATFORMS=cpu python - p03 <<'EOF'  # from the repository root
import importlib.util, os, sys, time, types
import jax; jax.config.update('jax_platforms', 'cpu')
name = sys.argv[1]
paths = {'ex00': 'examples/00_er3t_tpu.py', 'ex02': 'examples/02_er3t_tpu_lrt_rad.py',
         'p01': 'projects/01_oco2_rad_sim.py', 'p02': 'projects/02_sat_rad_sim.py',
         'p03': 'projects/03_spns_flux_sim.py'}
key = name.split('_')[0]
spec = importlib.util.spec_from_file_location('d', paths[key])
mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)
out = os.path.join('build', 'drivers_ref', name); os.makedirs(out, exist_ok=True)
if hasattr(mod, 'OUT'):
    mod.OUT = out
plain = mod.solver.solve
def solve(**kw):
    kw.setdefault('batch', 1 << 17)
    return plain(**kw)
mod.solver = types.SimpleNamespace(solve=solve)
t0 = time.time()
if key == 'ex00':
    mod.EXAMPLES[name.split('_')[1]](1e6)
elif key == 'ex02':
    vaa, rad = mod.sun_glint()
    print('glint', [float(r) for r in rad])
else:
    sys.argv = [paths[key], '--outdir', out]
    mod.main()
print(name, 'wall', time.time() - t0)
EOF"""
REF_DRIVERS = ('ex00_02', 'ex00_03', 'ex00_04', 'ex00_05', 'ex02', 'p01',
               'p02', 'p03')
# the PNG writers a driver calls itself (its module's attributes)
PNG_WRITERS = ('plot', 'plot_flux_profile', 'quicklook_radiance',
               'compare_data_2d')


def out_args(name):
    """The driver's output folder argument, under OUT."""
    if name.startswith(('ex', 'lss', 'lsa')):
        return []
    if name == 'p05':
        return ['--out', os.path.join(OUT, '05', 'cnn_les_training.npz')]
    return ['--outdir', os.path.join(OUT, name[1:])]


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT,
                                                                     path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(name):
    """Run driver ``name`` in this process; returns its record."""
    import torch

    from er3t_tpu_torch.rtm import solver
    from er3t_tpu_torch.rtm.phase_pair import phase_pair
    from er3t_tpu_torch.util.logger import get_logger

    path, argv = DRIVERS[name]
    mod = load(path, f'driver_{name}')
    argv = argv + out_args(name)
    if hasattr(mod, 'OUT'):
        mod.OUT = os.path.join(OUT, 'examples')
    drawn = []
    if importlib.util.find_spec('matplotlib') is None:
        def recorder(writer):
            def keep(*a, **kw):
                shapes = [list(getattr(x, 'shape', ())) for x in a
                          if hasattr(x, 'shape')]
                drawn.append(dict(writer=writer, shapes=shapes,
                                  fname=kw.get('fname')))
            return keep
        for writer in PNG_WRITERS:
            if callable(getattr(mod, writer, None)):
                setattr(mod, writer, recorder(writer))
    passes = []
    engine = solver.run_transport_flight

    def counted(*a, **kw):
        stats = kw.setdefault('stats', {})
        tal = engine(*a, **kw)
        passes.append(dict(photons=int(tal.n_launched),
                           steps=int(tal.n_steps), cap=stats['max_steps'],
                           in_flight=stats['in_flight']))
        return tal
    solver.run_transport_flight = counted
    said = []
    handler = logging.Handler()
    handler.emit = lambda r: said.append(r.getMessage())
    get_logger().addHandler(handler)
    launches0 = phase_pair.launches
    sys.argv = [path, *argv]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.main()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = sum(p['steps'] for p in passes)
    launches = phase_pair.launches - launches0
    if launches != steps:
        raise AssertionError(f'{name}: phase_pair launched {launches} times '
                             f'in {steps} steps')
    return dict(wall_s=wall, passes=len(passes), steps=steps,
                passes_at_cap=sum(p['steps'] >= p['cap'] for p in passes),
                in_flight=sum(p['in_flight'] for p in passes),
                photons=sum(p['photons'] for p in passes),
                phase_pair_launches=launches, not_drawn=drawn,
                said=said[-8:])


def run_tool(name, granule):
    """bin/<name>_torch on the AHI granule, in its own process."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, DRIVERS[name][0]),
                           granule], capture_output=True, text=True,
                          timeout=600, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT, f'{name}.log'), 'w') as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f'{name} exited {proc.returncode}: '
                           f'{proc.stderr[-2000:]}')
    lines = proc.stdout.splitlines()
    return dict(wall_s=wall, lines=len(lines), said=lines[:3] + lines[-3:])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('names', nargs='*', choices=list(DRIVERS),
                    help='drivers to run (default: all)')
    ap.add_argument('--one', help=argparse.SUPPRESS)
    ap.add_argument('--list', action='store_true')
    args = ap.parse_args()
    if args.list:
        for name, (path, argv) in DRIVERS.items():
            print(name, path, *argv, *out_args(name))
        return 0
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('chip_drivers: no CUDA device visible; the drivers run on the '
              'card', file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    if args.one:
        print(json.dumps(dict(name=args.one, **run_one(args.one))),
              flush=True)
        return 0
    from er3t_tpu_torch.probes.gather_probe import card_line
    card = card_line()
    print(card, flush=True)
    granule = None
    failed = []
    for name in args.names or list(DRIVERS):
        path, argv = DRIVERS[name]
        cmd = ' '.join([path, *argv, *out_args(name)])
        t0 = time.perf_counter()
        try:
            if name in ('lss', 'lsa'):
                if granule is None:
                    import chip_smoke_files
                    os.makedirs(os.path.join('build', 'drivers'),
                                exist_ok=True)
                    granule = chip_smoke_files.write_ahi_clp(os.path.join(
                        'build', 'drivers', 'ahi_clp.nc'), seed=0)
                rec = run_tool(name, granule)
            else:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), '--one',
                     name], capture_output=True, text=True, timeout=1800,
                    cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
                with open(os.path.join(OUT, f'{name}.log'), 'w') as f:
                    f.write(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    raise RuntimeError(f'exited {proc.returncode}: '
                                       f'{proc.stderr[-2000:]}')
                rec = json.loads(proc.stdout.strip().splitlines()[-1])
                rec.pop('name')
        except (RuntimeError, subprocess.TimeoutExpired,
                json.JSONDecodeError) as e:
            failed.append(name)
            rec = dict(error=str(e))
        rec = dict(name=name, command=cmd, card=card,
                   process_s=time.perf_counter() - t0, **rec)
        files = []
        for d, _, fs in os.walk(OUT):
            files += [os.path.join(d, f) for f in fs
                      if not f.endswith('.log')]
        rec['files'] = sorted(os.path.relpath(f, OUT) for f in files)
        print(json.dumps(rec), flush=True)
    if failed:
        print(f'chip_drivers: failed: {failed}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
