"""Delta truncation with TMS rows and the pfpeak clamp on the port.

Mirrors the transport closures of ``tests/test_truncation.py`` (both
``slow`` there, so here): the port's ``build_scene`` and
``run_transport_flight`` on the CPU, with the reference's scene, budget,
seeds and bounds.  The tables themselves are held bit for bit in
``tests/test_torch_scene.py``.
"""

import numpy as np
import pytest
import torch

from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.cld import cld_gen_hem
from er3t_tpu_torch.pre.pha import pha_mie_wc
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.mc_flight import run_transport_flight
from er3t_tpu_torch.rtm.scene import build_scene

torch.set_num_threads(2)


def _scene():
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                     np.arange(3.0, 20.1, 2.0)]))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hem(nx=48, ny=48, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.5, 1.0), cot_scale=15.0,
                      cloud_base=0.5, seed=7)
    return atm, ab, cld


def _mean_radiance(atm, ab, cld, seed, **scene_kw):
    scene, st = build_scene(atm, ab, cld=cld, pha=pha_mie_wc(650.0),
                            surface=0.03, solar_zenith_angle=30.0,
                            solar_azimuth_angle=45.0, device='cpu',
                            **scene_kw)
    cfg = SolverConfig(target='radiance', batch=1 << 14, n_scat_max=500,
                       tile_size=16)
    t = run_transport_flight(scene, st, cfg, 250_000, seed, 'cpu')
    assert int(t.n_launched) == 250_000
    return float(((t.rad.numpy() @ ab.weight) / int(t.n_launched)).mean())


@pytest.mark.slow
def test_truncated_radiance_matches_mild_truncation():
    """tests/test_truncation.py:54: 20-deg truncation with TMS agrees with
    5-deg truncation within 3 % on a broken-cloud Mie radiance scene."""
    atm, ab, cld = _scene()
    means = {td: _mean_radiance(atm, ab, cld, 9, forward_trunc_deg=td)
             for td in (5.0, 20.0)}
    assert means[20.0] == pytest.approx(means[5.0], rel=0.03)


@pytest.mark.slow
def test_pfpeak_small_bias():
    """tests/test_truncation.py:108: on the 20-deg truncated table the
    pfpeak clamp moves the radiance mean by less than 2 %."""
    atm, ab, cld = _scene()
    means = {pk: _mean_radiance(atm, ab, cld, 11, forward_trunc_deg=20.0,
                                pfpeak=pk)
             for pk in (None, 30.0)}
    assert means[30.0] == pytest.approx(means[None], rel=0.02)
