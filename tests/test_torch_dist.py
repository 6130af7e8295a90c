"""The port's multi-device transport (er3t_tpu_torch.dist) against the JAX
package: every test of tests/test_dist.py, on the same scene, with the same
photon budget, tolerance and ``slow`` mark.

The reference runs on conftest's 8 virtual XLA CPU devices; the port's
ranks are CPU ranks of one process (``make_mesh(..., device='cpu')``), and
its runs are held against the reference's single-device runs, as the
reference's tests hold its own.  The two-process tests start real gloo
process groups on a free localhost port.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu.rtm.mc_flight import run_transport_flight
from er3t_tpu.rtm.mc import SolverConfig as JConfig
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu_torch.dist import mesh as tmesh
from er3t_tpu_torch.dist.decomp import transport_decomp
from er3t_tpu_torch.dist.photon import transport_photon_parallel
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.rtm.scene import scene_from_numpy

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def cloudy_scene():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=16, ny=8, nz=2, dx=0.5, dy=0.5, cot0=8.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    # horizontally inhomogeneous: clear out half the domain
    cld.extinction[8:] = 0.0
    cld.cer[8:] = 0.0
    scn, st = build_scene(atm, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=30.0)
    return ab, scn, st, scene_from_numpy(scn, st, 'cpu')


def cpu_mesh(n, decomp=None):
    return tmesh.make_mesh(n, decomp=decomp, device='cpu')


def _mean_rad(tal, ab, st):
    return np.asarray(tal.rad) @ ab.weight / int(tal.n_launched) * st.nx * st.ny


def test_devices_available():
    assert len(jax.devices()) >= 8
    m = tmesh.make_mesh(8, device=['cpu'] * 8)
    assert m.size == 8 and m.local_ranks == list(range(8))


def test_photon_parallel_matches_single(cloudy_scene):
    ab, scn, st, (tscn, tst) = cloudy_scene
    t1 = run_transport_flight(scn, st, JConfig(target='radiance',
                                                batch=1 << 11), 60000, seed=3)
    cfg = SolverConfig(target='radiance', batch=1 << 11)
    t8 = transport_photon_parallel(tscn, tst, cfg, 60000, cpu_mesh(8, 1),
                                   seed=4)
    assert int(t8.n_launched) == 60000
    r1 = _mean_rad(t1, ab, st).mean()
    r8 = _mean_rad(t8, ab, st).mean()
    assert r8 == pytest.approx(r1, rel=0.05)


@pytest.mark.slow
def test_decomp_matches_single(cloudy_scene):
    ab, scn, st, (tscn, tst) = cloudy_scene
    t1 = run_transport_flight(scn, st, JConfig(target='radiance',
                                                batch=1 << 11), 120000, seed=5)
    cfg = SolverConfig(target='radiance', batch=1 << 11)
    td = transport_decomp(tscn, tst, cfg, 120000, cpu_mesh(4, 4), seed=6,
                          k_super=16)
    assert int(td.n_launched) == 120000
    r1 = _mean_rad(t1, ab, st)
    rd = _mean_rad(td, ab, st)
    # domain mean and per-half means agree within MC noise
    assert rd.mean() == pytest.approx(r1.mean(), rel=0.05)
    assert rd[:8].mean() == pytest.approx(r1[:8].mean(), rel=0.07)   # cloudy half
    assert rd[8:].mean() == pytest.approx(r1[8:].mean(), rel=0.07)   # clear half


@pytest.mark.slow
def test_decomp_2d_mesh(cloudy_scene):
    """Composite sharding: 2 slabs x 4 photon streams."""
    ab, scn, st, (tscn, tst) = cloudy_scene
    cfg = SolverConfig(target='radiance', batch=1 << 10)
    td = transport_decomp(tscn, tst, cfg, 80000, cpu_mesh(8, 2), seed=8,
                          k_super=16)
    assert int(td.n_launched) == 80000
    rd = _mean_rad(td, ab, st)
    assert np.all(np.isfinite(rd))
    assert rd[:8].mean() > rd[8:].mean()  # cloudy half brighter


@pytest.mark.slow
def test_decomp_with_tile_majorants(cloudy_scene):
    """x-slab decomposition composed with per-tile majorants: tile faces
    inside the slab clamp flights; the slab face keeps migration priority."""
    ab, scn, st, (tscn, tst) = cloudy_scene
    kw = dict(target='radiance', batch=1 << 11, tile_size=2)
    t1 = run_transport_flight(scn, st, JConfig(**kw), 120000, seed=5)
    td = transport_decomp(tscn, tst, SolverConfig(**kw), 120000,
                          cpu_mesh(4, 4), seed=6, k_super=16)
    assert int(td.n_launched) == 120000
    r1 = _mean_rad(t1, ab, st)
    rd = _mean_rad(td, ab, st)
    assert rd.mean() == pytest.approx(r1.mean(), rel=0.05)
    assert rd[:8].mean() == pytest.approx(r1[:8].mean(), rel=0.07)


def _flux_means(tal, ab):
    return np.asarray(tal.flux)[0, 0] @ ab.weight / int(tal.n_launched)


@pytest.mark.slow
def test_photon_parallel_flux(cloudy_scene):
    """Flux tallies must be summed across the mesh like radiance."""
    ab, scn, st, (tscn, tst) = cloudy_scene
    kw = dict(target='flux', batch=1 << 11, flux_per_column=False,
              n_scat_max=300)
    t1 = run_transport_flight(scn, st, JConfig(**kw), 60000, seed=11)
    t8 = transport_photon_parallel(tscn, tst, SolverConfig(**kw), 60000,
                                   cpu_mesh(8, 1), seed=12)
    f1, f8 = _flux_means(t1, ab), _flux_means(t8, ab)
    assert f8[0, 0] + f8[0, 1] == pytest.approx(f1[0, 0] + f1[0, 1], rel=0.08)
    assert f8[-1, 2] == pytest.approx(f1[-1, 2], rel=0.12)
    # TOA down-direct is deterministic: exactly 1 per photon
    assert f8[-1, 0] == pytest.approx(1.0, rel=1e-5)


@pytest.mark.slow
def test_decomp_flux_domain_average(cloudy_scene):
    ab, scn, st, (tscn, tst) = cloudy_scene
    kw = dict(target='flux', batch=1 << 11, flux_per_column=False,
              n_scat_max=300)
    t1 = run_transport_flight(scn, st, JConfig(**kw), 48000, seed=13)
    td = transport_decomp(tscn, tst, SolverConfig(**kw), 48000,
                          cpu_mesh(4, 4), seed=14, k_super=32)
    assert int(td.n_launched) == 48000
    f1, fd = _flux_means(t1, ab), _flux_means(td, ab)
    assert fd[-1, 0] == pytest.approx(1.0, rel=1e-5)      # TOA down-direct
    assert fd[0, 0] + fd[0, 1] == pytest.approx(f1[0, 0] + f1[0, 1], rel=0.08)
    assert fd[-1, 2] == pytest.approx(f1[-1, 2], rel=0.12)
    np.testing.assert_allclose(fd[:, 2], f1[:, 2], rtol=0.2, atol=0.01)


@pytest.mark.slow
def test_decomp_flux_per_column(cloudy_scene):
    """Per-column level-crossing tallies partition with the slabs."""
    ab, scn, st, (tscn, tst) = cloudy_scene
    kw = dict(target='flux', batch=1 << 11, flux_per_column=True,
              n_scat_max=300)
    t1 = run_transport_flight(scn, st, JConfig(**kw), 60000, seed=15)
    td = transport_decomp(tscn, tst, SolverConfig(**kw), 60000,
                          cpu_mesh(4, 4), seed=16, k_super=32)
    assert np.asarray(td.flux).shape == (st.nx, st.ny, st.nz + 1, 3, st.ng)
    f1 = np.asarray(t1.flux) @ ab.weight
    fd = np.asarray(td.flux) @ ab.weight
    n1, nd = int(t1.n_launched), int(td.n_launched)
    sfc1 = (f1[:, :, 0, 0] + f1[:, :, 0, 1]) / n1 * (st.nx * st.ny)
    sfcd = (fd[:, :, 0, 0] + fd[:, :, 0, 1]) / nd * (st.nx * st.ny)
    assert sfcd[:8].mean() == pytest.approx(sfc1[:8].mean(), rel=0.1)
    assert sfcd[8:].mean() == pytest.approx(sfc1[8:].mean(), rel=0.1)
    # TOA down-direct per column is deterministic
    np.testing.assert_allclose(fd[:, :, -1, 0] / nd * (st.nx * st.ny),
                               1.0, rtol=1e-4)


def test_decomp_pathlength(cloudy_scene):
    """Pathlength through photon migration: the per-lane odometer rides
    the lane pack, deposits land in the global pathlength-weighted image,
    and the mean detected pathlength matches the reference's
    single-device run within MC noise."""
    ab, scn, st, (tscn, tst) = cloudy_scene
    kw = dict(target='radiance', batch=1 << 11, pathlength=True,
              n_scat_max=300)
    t1 = run_transport_flight(scn, st, JConfig(**kw), 60000, seed=21)
    td = transport_decomp(tscn, tst, SolverConfig(**kw), 60000,
                          cpu_mesh(4, 4), seed=22, k_super=32)
    assert np.asarray(td.rad_plen).shape == (st.nx, st.ny, st.ng)
    w = ab.weight

    def mean_plen(t):
        r = np.asarray(t.rad) @ w
        pl = np.asarray(t.rad_plen) @ w
        return pl.sum() / r.sum()

    p1, pd = mean_plen(t1), mean_plen(td)
    assert p1 > 20.0                       # km: >= TOA vertical exit path
    assert pd == pytest.approx(p1, rel=0.05)
    # clear vs cloudy halves keep their distinct mean pathlengths
    r1 = np.asarray(t1.rad) @ w
    rd = np.asarray(td.rad) @ w
    pl1 = np.asarray(t1.rad_plen) @ w
    pld = np.asarray(td.rad_plen) @ w
    for sl in (slice(0, 8), slice(8, 16)):
        m1 = pl1[sl].sum() / max(r1[sl].sum(), 1e-30)
        md = pld[sl].sum() / max(rd[sl].sum(), 1e-30)
        assert md == pytest.approx(m1, rel=0.08)


def test_mesh_shapes_and_errors():
    """Mesh construction: axis sizing, divisibility and availability
    errors, and init_distributed as a no-op in one process."""
    devs = ['cpu'] * 8
    msh = tmesh.make_mesh(8, decomp=4, device=devs)
    assert dict(msh.shape) == {'x': 4, 'b': 2} and msh.size == 8
    assert msh.ranks.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    msh1 = tmesh.make_mesh(6, device=devs)
    assert dict(msh1.shape) == {'x': 6, 'b': 1}
    with pytest.raises(ValueError, match='not divisible'):
        tmesh.make_mesh(6, decomp=4, device=devs)
    with pytest.raises(ValueError, match='only 8 available'):
        tmesh.make_mesh(9, device=devs)
    assert tmesh.make_mesh(device='cpu').size == 1
    # init_distributed is a safe no-op on a single process
    assert tmesh.init_distributed() is None


def test_decomp_rejects_uneven_nx(cloudy_scene):
    _, _, _, (tscn, tst) = cloudy_scene
    with pytest.raises(ValueError, match='divide'):
        transport_decomp(tscn, tst, SolverConfig(), 1000, cpu_mesh(5, 5))


WORKER = '''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, port, kind = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from er3t_tpu_torch.dist.mesh import init_distributed, make_mesh
import torch.distributed as dist
init_distributed('tcp://127.0.0.1:' + port, world_size=2, rank=rank,
                 device='cpu', timeout_s=120)
assert dist.get_world_size() == 2
from er3t_tpu_torch.pre.atm import atm_atmmod
from er3t_tpu_torch.pre.abs import abs_synthetic
from er3t_tpu_torch.pre.cld import cld_gen_hom
from er3t_tpu_torch.rtm.scene import build_scene
from er3t_tpu_torch.rtm.mc import SolverConfig
from er3t_tpu_torch.dist.decomp import transport_decomp
from er3t_tpu_torch.dist.photon import transport_photon_parallel
atm = atm_atmmod(np.linspace(0, 20, 11))
ab = abs_synthetic(650.0, atm)
cld = cld_gen_hom(nx=8, ny=4, nz=2, dx=0.5, dy=0.5, cot0=8.0, cer0=10.0,
                  cloud_base=2.0, cloud_top=6.0)
scn, st = build_scene(atm, ab, cld=cld, surface=0.1, solar_zenith_angle=30.0,
                      device='cpu')
cfg = SolverConfig(target='radiance', batch=1 << 10)
if kind == 'photon':
    mesh = make_mesh(2, decomp=1, device='cpu')
    tal = transport_photon_parallel(scn, st, cfg, 20000, mesh, seed=5)
else:
    mesh = make_mesh(2, decomp=2, device='cpu')
    tal = transport_decomp(scn, st, cfg, 20000, mesh, seed=5)
mean = float((tal.rad.numpy() @ ab.weight).mean()
             / int(tal.n_launched) * st.nx * st.ny)
print('RESULT ' + json.dumps({'rank': rank, 'launched': int(tal.n_launched),
                              'mean': mean}))
dist.destroy_process_group()
'''


@pytest.mark.parametrize('kind', ['photon', 'decomp'])
def test_two_process_distributed(tmp_path, kind):
    """init_distributed across two real processes (gloo, a free localhost
    port, a bounded init timeout): a 2-rank mesh spanning the processes
    runs transport_photon_parallel, or transport_decomp with the slabs'
    migration exchanged by batch_isend_irecv; both ranks return the same
    global tallies, the budget is conserved, and the mean radiance matches
    the reference's single-process run."""
    with socket.socket() as s:        # a free port for the rendezvous
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    script = tmp_path / 'worker.py'
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(port),
                               kind], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail(f'2-process {kind} run timed out')
    finally:
        for p in procs:
            p.kill()
            p.wait()
    res = []
    for rc, out, err in outs:
        assert rc == 0, f'worker failed:\n{err[-3000:]}'
        res += [json.loads(ln[len('RESULT '):]) for ln in out.splitlines()
                if ln.startswith('RESULT ')]
    assert sorted(r['rank'] for r in res) == [0, 1]
    assert all(r['launched'] == 20000 for r in res)
    assert res[0]['mean'] == res[1]['mean']

    # the reference's single-process run on the same scene
    atm = atm_atmmod(np.linspace(0, 20, 11))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=8, ny=4, nz=2, dx=0.5, dy=0.5, cot0=8.0, cer0=10.0,
                      cloud_base=2.0, cloud_top=6.0)
    scn, st = build_scene(atm, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=30.0)
    t1 = run_transport_flight(scn, st, JConfig(target='radiance',
                                                batch=1 << 10), 20000, seed=6)
    assert res[0]['mean'] == pytest.approx(float(_mean_rad(t1, ab, st).mean()),
                                           rel=0.08)


def test_decomp_slant_sensor_matches_single(cloudy_scene):
    """Slant satellite radiance (sensor_zenith=30) through the x-slab
    decomposition: deposits project across slab faces into the global
    summed image; the estimator is the single-device one."""
    ab, scn, st, (tscn, tst) = cloudy_scene
    kw = dict(target='radiance', batch=1 << 11, sensor_zenith=30.0,
              sensor_azimuth=60.0)
    t1 = run_transport_flight(scn, st, JConfig(**kw), 120000, seed=21)
    td = transport_decomp(tscn, tst, SolverConfig(**kw), 120000,
                          cpu_mesh(4, 4), seed=22, k_super=16)
    assert int(td.n_launched) == 120000
    r1 = _mean_rad(t1, ab, st)
    rd = _mean_rad(td, ab, st)
    assert rd.shape == r1.shape == (st.nx, st.ny)
    assert rd.mean() == pytest.approx(r1.mean(), rel=0.05)
    assert rd[:8].mean() == pytest.approx(r1[:8].mean(), rel=0.08)
    assert rd[8:].mean() == pytest.approx(r1[8:].mean(), rel=0.08)


@pytest.mark.slow
def test_decomp_camera_matches_single(cloudy_scene):
    """Ground-camera fisheye radiance through the decomposition: the
    camera image is global and summed; the estimate uses only local
    columns, so the physics is the single-device run's."""
    ab, scn, st, (tscn, tst) = cloudy_scene
    kw = dict(target='radiance', batch=1 << 11, sensor_type='camera',
              cam_npix=16, cam_zloc=0.0, cam_qmax=85.0, n_scat_max=300)
    t1 = run_transport_flight(scn, st, JConfig(**kw), 150000, seed=31)
    td = transport_decomp(tscn, tst, SolverConfig(**kw), 150000,
                          cpu_mesh(4, 4), seed=32, k_super=16)
    assert int(td.n_launched) == 150000
    i1 = np.asarray(t1.rad) @ ab.weight / int(t1.n_launched)
    id_ = np.asarray(td.rad) @ ab.weight / int(td.n_launched)
    assert id_.shape == i1.shape == (16, 16)
    m1, md = i1[i1 > 0].mean(), id_[id_ > 0].mean()
    assert md == pytest.approx(m1, rel=0.07)
