"""The rehearsal of chip_smoke.run on the CPU (tests/test_torch_chip_smoke.py)
for phase 13: bench_torch.main at a tiny budget through the port's flight
engine, its line's keys against bench.py's, the domain mean of its
production-config runs, the launch counts of its runs, and the ablation
stand-ins at pinned steps (no phase-pair launch under 'phase').  The
bench's runs are recorded at their own batch (2^17) and run at the
rehearsal's 1024 lanes; a stub clock makes every chunk clean."""

import dataclasses
import json
import types

import torch

import bench_torch
import chip_smoke
from er3t_tpu_torch.rtm import mc_flight
from test_torch_chip_smoke import PHASE13, rehearse
from test_torch_chip_smoke import rehearsal  # noqa: F401  (the fixture)

torch.set_num_threads(2)


def test_chip_smoke_bench_rehearsed_on_cpu(rehearsal, capsys,  # noqa: F811
                                           monkeypatch):
    budget = dict(warmup=300, probe=600, chunk=600, chunk_min=600,
                  chunk_max=600, target_seconds=3600.0, max_chunks=3,
                  repeats=2, n_noise=600, n_ind=800)
    monkeypatch.setattr(chip_smoke, 'BENCH_BUDGET', budget)
    now = [0.0]

    def clock():
        now[0] += 1.0
        return now[0]
    monkeypatch.setattr(bench_torch, 'time', types.SimpleNamespace(time=clock))
    batches = []
    plain = mc_flight.run_transport_flight

    def narrow(scene, st, cfg, *a, **kw):
        batches.append(cfg.batch)
        return plain(scene, st, dataclasses.replace(
            cfg, batch=chip_smoke.BATCH), *a, **kw)
    monkeypatch.setattr(mc_flight, 'run_transport_flight', narrow)
    lines, report, kernels = rehearse(rehearsal, capsys, ('bench',))
    rep = report['bench']
    assert set(rep) == set(PHASE13)
    b = rep['bench']
    # the line is printed as bench_torch prints it, before the last three
    assert json.loads(lines[lines.index(json.dumps(b['line']))]) == b['line']
    assert lines.index(json.dumps(b['line'])) < len(lines) - 3
    assert b['branch'] == 'noise' and b['line']['healthy'] is True
    assert set(b['line']) == set(chip_smoke.BENCH_KEYS['noise'])
    assert b['line']['chunk_rates'] == [600.0] * 3
    # warm-up, probe, 3 chunks, 2 + 2 noise repeats (4 g-points a run)
    assert len(b['passes']) == 7 + 2 * 4
    assert b['phase_pair_launches'] == b['steps'] > 0
    assert b['photons'] == 300 + 6 * 600 + 2 * 800
    assert b['domain_mean']['value'] > 0 and b['k1_bitwise_steps'] >= 1
    assert batches.count(1 << 17) == len(b['passes'])   # the bench's runs
    for name in PHASE13[1:]:
        rec = rep[name]
        assert rec['steps'] == chip_smoke.ABLATE_STEPS, name
        k1 = 0 if name in ('ablate_phase', 'ablate_floor') else rec['steps']
        assert rec['phase_pair_launches'] == k1, name
        assert (rec['k1_bitwise_steps'] > 0) == (k1 > 0), name
        assert all(n == 0 for k, n in rec['launches'].items()
                   if k != 'phase_pair'), name
        assert rec['ms_per_step'] > 0 and rec['passes_at_cap'] == 1, name
        assert kernels[0][f'{name}_launches'] == k1, name
    assert kernels[0]['bench_launches'] == b['steps']
    assert any(line.startswith('# phase 13: ') for line in lines)
