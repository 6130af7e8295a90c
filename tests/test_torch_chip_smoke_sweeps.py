"""The rehearsal of chip_smoke.run on the CPU (tests/test_torch_chip_smoke.py)
for phase 14: the harnesses of scripts/ through the port's flight engine
and dist layer, and the scatter probes.  The harnesses run every config at
tiny budgets (SWEEPS patched), their runs at the rehearsal's 1024 lanes
(their own batches recorded), the clouds cut to 12 x 12 columns of 1 km,
the scatter probes at 256 lanes and 3 steps and a thousandth of their
shapes.  Checked: K1 once a step or rank-step and bitwise on every table
(the three table shapes new to the card among them), budgets and pinned
steps, the printed lines' prefixes against the JAX sources', the drain to
its line, and the kernels line's phase-14 launch counts."""

import dataclasses

import torch

import chip_smoke
from er3t_tpu_torch.pre import cld
from er3t_tpu_torch.rtm import mc_flight
from test_torch_bench import _shrunk
from test_torch_chip_smoke import PHASE14, rehearse
from test_torch_chip_smoke import rehearsal  # noqa: F401  (the fixture)

torch.set_num_threads(2)

TINY = {
    'ab_sweep': ['--photons', '600', '--warm', '300', '--rounds', '1'],
    'tile2_sweep': ['--scale', '0.0003', '--warm', '300', '--rounds', '1'],
    'flux_ab': ['600', '--rounds', '1'],
    'isolate_ab': ['3'],
    'pallas_ab': ['3'],
    'r3_sweep': ['--steps', '3'],
    'r5_sweep': ['600', '1', '--warm', '300'],
    'cam_importance_ab': ['2000', '2'],
    'scaling': ['--base-photons', '500', '--reps', '1', '--devices', '1,2',
                '--batch', '256'],
    'drain': ['2', '2000'],
}
NEW_TABLES = ('tables_4x4096_2x8192', 'tables_4x1024_2x1024',
              'tables_4x512_2x512')


def test_chip_smoke_sweeps_rehearsed_on_cpu(rehearsal, capsys,  # noqa: F811
                                            monkeypatch):
    monkeypatch.setattr(chip_smoke, 'SWEEPS', {
        k: (script, TINY[k]) for k, (script, _) in chip_smoke.SWEEPS.items()})
    monkeypatch.setattr(chip_smoke, 'PROBE4', dict(B=256, K=3))
    monkeypatch.setattr(chip_smoke, 'SCATTER_SCALE', 1e-3)
    clouds = []
    monkeypatch.setattr(cld, 'cld_gen_hem', _shrunk(cld.cld_gen_hem, clouds))
    batches = []
    plain = mc_flight.run_transport_flight

    def narrow(scene, st, cfg, *a, **kw):
        batches.append(cfg.batch)
        return plain(scene, st, dataclasses.replace(
            cfg, batch=chip_smoke.BATCH), *a, **kw)
    monkeypatch.setattr(mc_flight, 'run_transport_flight', narrow)
    lines, report, kernels = rehearse(rehearsal, capsys, ('sweeps',))
    rep = report['sweeps']
    assert set(rep) == set(PHASE14) | {'probes', 'wall_s',
                                       'k1_launches_by_table'}
    for name in PHASE14:
        rec = rep[name]
        assert rec['phase_pair_launches'] == rec['steps'] > 0, name
        assert kernels[0][f'sweeps_{name}_launches'] == rec['steps'], name
        assert rec['k1_bitwise_steps'] >= rec['k1_tables'] > 0, name
        assert rec['lines'] > 0, name
    # every config of the harnesses ran: 5 + 5 warm and timed runs, the
    # rest one round, the pinned ones 3 rounds
    runs = {k: rep[k]['runs'] for k in PHASE14[:8]}
    assert runs == {'ab_sweep': 10, 'tile2_sweep': 10, 'flux_ab': 5,
                    'isolate_ab': 12, 'pallas_ab': 12, 'r3_sweep': 30,
                    'r5_sweep': 14, 'cam_importance_ab': 8}
    assert {k: rep[k]['pinned_runs'] for k in runs} == dict(
        runs, ab_sweep=0, tile2_sweep=0, flux_ab=0, r5_sweep=0,
        cam_importance_ab=0)
    assert rep['r3_sweep']['steps'] == 30 * 3
    assert 1 << 18 in batches and 1 << 12 in batches
    # the three table shapes new to the card ran, and phase 3 timed them
    shapes = {tuple(map(tuple, s)) for s in rep['isolate_ab']['k1_shapes']}
    assert ((4, 4096), (2, 8192)) in shapes
    shapes = {tuple(map(tuple, s)) for s in rep['r5_sweep']['k1_shapes']}
    assert {((4, b), (2, b)) for b in (2048, 1024, 512)} <= shapes
    for key in NEW_TABLES:
        kt = report['phase_pair'][key]
        assert kt['sweeps_launches'] == rep['k1_launches_by_table'][key] > 0
        assert kt['ms'] == kt['plain_ms'] == 1.0 and kt['bound_ms'] > 0
    # the dist harnesses: the scaling rows and the drain
    scaling = rep['scaling']
    assert [r['n_dev'] for r in scaling['rows']['decomp']] == [1, 2]
    assert scaling['rounds'].count(None) == 4      # photon-parallel runs
    drain = rep['drain']
    assert drain['drained'] is not None and sum(drain['launched']) == 2000
    assert any(line == f'drained at round {drain["drained"]}'
               for line in lines)
    probes = rep['probes']
    assert probes['gather_probe4']['tally_max_rel_err'] <= 1e-5
    assert len(probes['scatter_bench']) == 7
    assert all(r['match'] for r in probes['sorted_scatter'].values())
    assert clouds and any(line.startswith('# phase 14: ') for line in lines)
