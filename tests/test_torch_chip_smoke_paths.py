"""The rehearsal of chip_smoke.run on the CPU (tests/test_torch_chip_smoke.py)
for phases 8 (the marching engine and the quasi renders, held against the
JAX package's on the same small scene) and 9 (multi-device transport, two
ranks)."""

import torch

from test_torch_chip_smoke import check_dist, check_march, rehearse
from test_torch_chip_smoke import rehearsal  # noqa: F401  (the fixture)

torch.set_num_threads(2)


def test_chip_smoke_march_rehearsed_on_cpu(rehearsal, capsys,  # noqa: F811
                                           monkeypatch):
    check_march(*rehearse(rehearsal, capsys, ('march',), monkeypatch))


def test_chip_smoke_dist_rehearsed_on_cpu(rehearsal,  # noqa: F811
                                          capsys):
    check_dist(*rehearse(rehearsal, capsys, ('dist',)))
