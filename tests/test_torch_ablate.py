"""SolverConfig.ablate, the flight kernel's profiling stand-ins, against
er3t_tpu: one step at a time with JAX's deviates injected
(tests/test_torch_flight_modes.py's ``step_parity``), for each stand-in
and for the floor of scripts/tpu_profile_ablate.py.  Under ``'phase'`` the
phase-pair kernel is not called at all."""

import pytest
import torch

from er3t_tpu_torch.rtm import mc_flight as tmf
from test_torch_flight_modes import KW, broken, step_parity

torch.set_num_threads(2)


@pytest.mark.parametrize('ablate', ['phase', 'vox', 'firstdep', 'deposit',
                                    'vox,phase,deposit'])
def test_ablate_step_parity_with_injected_deviates(ablate, monkeypatch):
    ab, scn, st, rad_w, _ = broken()
    calls = []
    plain = tmf.phase_pair

    def counting(*a):
        calls.append(1)
        return plain(*a)
    monkeypatch.setattr(tmf, 'phase_pair', counting)
    got, kern = step_parity(scn, st, dict(KW, ablate=ablate), steps=6,
                            rad_w=rad_w)
    assert kern.ablate == set(ablate.split(','))
    assert len(calls) == (0 if 'phase' in ablate else 6)
    rad = got.rad
    assert torch.isfinite(rad).all() and float(rad.sum()) > 0
    if 'deposit' in ablate:
        # every pixel holds the same running sum of the deposits
        assert torch.equal(rad, rad[:1].expand_as(rad))
