"""One run of a cell: set-up, the measured window, the metrics, and the
check that decides ``correct``.

The window drives ``er3t_tpu_torch.rtm.solver.solve`` as its users call
it: one closed-loop caller, requests back to back, each with its own seed
from the traffic's fixed sequence (the same in every run).  A new request
starts while less than ``seconds`` have passed; the one in flight at the
close runs to its end and counts.  After the window the plain reference
(``benchmark/reference``), seeded from ``--seed``, traces its own photons
through its own optics, and :mod:`.compare` holds the window's fields
against it.  A configuration may name its own inputs builder and plain
reference (:func:`.manifest.inputs_builder`,
:func:`.manifest.reference_module`).
"""

from __future__ import annotations

import dataclasses
import gc
import time
import types

import torch

from ..frozen import measure
from ..frozen import pha as frozen_pha
from . import compare, manifest
from .inputs import request_seeds, seeds
from .trace import Shims, reduce_trace

__all__ = ['run_cell', 'prepare', 'warm_up', 'window', 'reference', 'judge',
           'judge_requests', 'Request', 'Prep']

# seed streams: the reference's (from --seed); the warm-up's and the traced
# request's (from the traffic's request_seed, as the requests' in .inputs)
_REFERENCE, _WARMUP, _TRACED = 3, 4, 5


@dataclasses.dataclass
class Request:
    start: float
    end: float
    n_asked: int
    n_launched: int
    n_cut: int              # photons in flight at the step cap, dropped
    steps: int              # flight steps (the phase-pair kernel's launches)
    images: dict            # field name -> its image (compare.field_images)
    flights: list           # its run_transport_flight records

    @property
    def wall_s(self):
        return self.end - self.start


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


@dataclasses.dataclass
class Prep:
    """A cell made ready: its inputs, solve's keyword arguments, and the
    port's modules."""
    cell: object
    inputs: object
    kw: dict
    n_asked: int
    target: str
    solver: object
    flight: object


def prepare(cell, device):
    """Inputs and solve's arguments of one run; the port computes its Mie
    tables here, as its users do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from er3t_tpu_torch.pre.pha import pha_mie_wc
    from er3t_tpu_torch.rtm import mc_flight, solver

    traffic = cell.traffic
    inp = manifest.inputs_builder(cell.root, cell.config)(cell.config)
    pha = pha_mie_wc(**inp.mie) if inp.mie is not None else None
    req = {'photons': cell.config['photons'], 'n_run': cell.config['n_run']}
    req.update(traffic['solve'])
    kw = dict(inp.solve_kw, **inp.solve_objects)
    kw.update(req, atm=inp.atm, abs_coef=inp.abs_coef, cld=inp.cld, pha=pha,
              device=device)
    kw['photons'] = float(req['photons'])
    return Prep(cell=cell, inputs=inp, kw=kw,
                n_asked=int(float(req['photons'])) * int(req['n_run']),
                target=req['target'], solver=solver, flight=mc_flight)


def _fixed_seed(prep, stream):
    return seeds(int(prep.cell.traffic['request_seed']), 1, stream)[0]


def warm_up(prep):
    """One small request through the full batch and both drain stages,
    which loads the phase-pair kernel (built on a checkout's first run)."""
    prep.solver.solve(**dict(prep.kw, n_run=1, photons=float(
        prep.cell.traffic['warmup_photons'])),
        seed=_fixed_seed(prep, _WARMUP))
    _sync(prep.kw['device'])


def window(prep, shims, seconds=None, n_requests=None):
    """The closed loop: requests back to back while less than ``seconds``
    have passed (or ``n_requests`` of them), inside ``shims`` (a
    :class:`Shims` entered); returns (requests, start)."""
    from er3t_tpu_torch.rtm.phase_pair import phase_pair
    fields = prep.cell.check['fields']
    r_seeds = request_seeds(int(prep.cell.traffic['request_seed']), 256)
    requests = []
    w0 = time.perf_counter()
    while not requests or (
            time.perf_counter() - w0 < seconds if n_requests is None
            else len(requests) < n_requests):
        nf = len(shims.flights)
        k1 = phase_pair.launches
        s = time.perf_counter()
        res = prep.solver.solve(**prep.kw, seed=r_seeds[len(requests)])
        _sync(prep.kw['device'])
        e = time.perf_counter()
        flights = shims.flights[nf:]
        requests.append(Request(
            start=s, end=e, n_asked=prep.n_asked,
            n_launched=int(res.n_photon_effective),
            n_cut=sum(f['in_flight'] for f in flights),
            steps=phase_pair.launches - k1,
            images=compare.field_images(res.data, fields), flights=flights))
        del res
    return requests, w0


def reference(prep, seed, dtype=torch.float32, n_photons=None, batches=None):
    """The plain reference's fields: ({field: [image per batch]}, photons
    a batch), its optics worked out again from the inputs (its own Mie
    tables included), by the configuration's reference."""
    check, inp = prep.cell.check, prep.inputs
    plain = manifest.reference_module(prep.cell.root, prep.cell.config)
    dev = prep.kw['device']
    if torch.device(dev).type == 'cuda':
        gc.collect()
        torch.cuda.empty_cache()
    ref_inp = dataclasses.replace(
        inp, pha=(frozen_pha.pha_mie_wc(**inp.mie) if inp.mie is not None
                  else None))
    opt = plain.optics(ref_inp, dev, dtype=dtype)
    nb = int(batches or check['reference_batches'])
    n = int(float(n_photons or check['reference_photons']))
    img, counts = plain.run(opt, n, seeds(seed, 1, _REFERENCE)[0],
                            target=prep.target, n_tallies=nb,
                            batch=int(check.get('reference_lanes', 1 << 20)))
    out = {f['name']: [] for f in check['fields']}
    for k in range(nb):
        red = plain.reduce(opt, img[k], counts[k], inp.abs_coef, prep.target)
        for name, im in compare.field_images(red, check['fields']).items():
            out[name].append(im)
    return out, n / nb


def judge(prep, images, n_prog, photons_missing, photons_cut, ref, n_b):
    """(correct, [(name, value, limit)]) of the program's fields
    ``images`` ({field: [image per request]}, ``n_prog`` photons asked in
    all) against the reference's."""
    check = prep.cell.check
    values = compare.numbers(images, n_prog, ref, n_b, check['fields'],
                             photons_missing, photons_cut)
    return compare.judge(values, check['limits'])


def judge_requests(prep, requests, ref, n_b):
    """:func:`judge` of the window's ``requests``."""
    return judge(
        prep, {f['name']: [r.images[f['name']] for r in requests]
               for f in prep.cell.check['fields']},
        sum(r.n_asked for r in requests),
        sum(abs(r.n_asked - r.n_launched) for r in requests),
        sum(r.n_cut for r in requests), ref, n_b)


def run_cell(cell, seed, seconds, trace, device, t0, trace_path=None):
    """The result dict of one run (``correct``, ``metrics``, ``device``,
    the numbers compared, ...); ``t0``: the host clock at the start of the
    process, where set-up begins."""
    prep = prepare(cell, device)
    warm_up(prep)
    setup_s = time.perf_counter() - t0

    on_card = torch.device(device).type == 'cuda'
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    shims = Shims(prep.solver, prep.flight, cell.traffic['profile_start'],
                  cell.traffic['profile_steps'],
                  trace_path if trace else None)
    with shims:
        requests, w0 = window(prep, shims, seconds=seconds)
        w1 = requests[-1].end
        peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        if trace:
            # one more request, not in the window, for the device trace
            shims.arm()
            prep.solver.solve(**prep.kw, seed=_fixed_seed(prep, _TRACED))
            _sync(device)

    tr = k1_bound_s = None
    if trace:
        if shims.traced:
            tr = reduce_trace(trace_path)
        if shims.k1_args is not None:
            k1_bound_s = measure.bound(measure.pair_cost(*shims.k1_args))[0]
            shims.k1_args = None
    record = types.SimpleNamespace(
        requests=requests, trace=tr, k1_bound_s=k1_bound_s,
        setup_s=setup_s, window_s=w1 - w0,
        photons=sum(r.n_launched - r.n_cut for r in requests),
        noise_images=[r.images[cell.check['noise_field']] for r in requests],
        noise_photons=prep.n_asked)

    # ---- the check, once the program's state is freed ----
    tc = time.perf_counter()
    ref, n_b = reference(prep, seed)
    correct, rows = judge_requests(prep, requests, ref, n_b)
    check_s = time.perf_counter() - tc

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = manifest.metric_reader(cell.root, m['name'])(record)
        if v is not None:
            metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    dev = {'platform': 'gpu' if on_card else 'cpu',
           'kind': (torch.cuda.get_device_name(torch.device(device))
                    if on_card else 'cpu'),
           'count': cell.chips, 'memory_peak_bytes': peak}
    out = {'correct': bool(correct), 'attempted': len(requests), 'failed': 0,
           'metrics': metrics, 'device': dev}
    if tr is not None:
        dev['busy_s'] = tr['busy_s']
        dev['window_s'] = tr['window_s']
        out['breakdown'] = {'device_ops': tr['device_ops'],
                            'idle_gaps': tr['idle_gaps']}
    out['card'] = measure.card_line() if on_card else 'cpu'
    out['window_s'] = w1 - w0
    out['request_s'] = [r.wall_s for r in requests]
    out['request_steps'] = [r.steps for r in requests]
    out['request_cut'] = [r.n_cut for r in requests]
    out['check_s'] = check_s
    out['checks'] = {k: {'value': v, 'limit': lim} for k, v, lim in rows}
    return out
