"""The rehearsal of chip_smoke.run on the CPU (tests/test_torch_chip_smoke.py)
for phases 10 (the application layer) and 11 (the satellite layer: the
AHI granule gridded to 12 x 12, its reader and cloud values held against
the JAX package's on the same file, exactly)."""

import torch

from test_torch_chip_smoke import check_apps, check_sat, rehearse
from test_torch_chip_smoke import rehearsal  # noqa: F401  (the fixture)

torch.set_num_threads(2)


def test_chip_smoke_apps_rehearsed_on_cpu(rehearsal,  # noqa: F811
                                          capsys):
    check_apps(*rehearse(rehearsal, capsys, ('apps',)))


def test_chip_smoke_sat_rehearsed_on_cpu(rehearsal, capsys,  # noqa: F811
                                         monkeypatch):
    check_sat(*rehearse(rehearsal, capsys, ('sat',), monkeypatch))
