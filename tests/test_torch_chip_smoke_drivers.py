"""The rehearsal of chip_smoke.run on the CPU (tests/test_torch_chip_smoke.py)
for phase 12: the native bridge at 80000 photons, each solver held against
the others at the reference test's bounds, example 00's cases 01 and 06 at
4000 photons a run, and the comparison page."""

import torch

from test_torch_chip_smoke import check_scripts, rehearse
from test_torch_chip_smoke import rehearsal  # noqa: F401  (the fixture)

torch.set_num_threads(2)


def test_chip_smoke_scripts_rehearsed_on_cpu(rehearsal,  # noqa: F811
                                             capsys):
    check_scripts(*rehearse(rehearsal, capsys, ('scripts',)),
                  rehearsal / 'phase12')
