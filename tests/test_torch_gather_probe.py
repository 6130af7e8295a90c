"""Gather probe kernels of the port (er3t_tpu_torch/probes/gather.py).

Each plain version is held against the Pallas kernel it replaces, run in
interpret mode on the CPU.  The kernels are nested inside the probe
scripts' ``main`` and cannot be imported, so their bodies are restated here
verbatim, each citing its file:line; only the sizes are cut (B = 2048,
lane blocks of 256-1024, fewer table rows), except K7/K8's phase pair,
which runs at its full (1280, 128) block tables.  Tolerances: bitwise for
K2, K5, K6 and K7/K8; for K3/K4 |diff| <= 1e-6 * sum |row|, since the
one-hot product (K4) sums a row in another order.  The CUDA kernels
themselves run only on a card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from er3t_tpu_torch import _build
from er3t_tpu_torch.probes import gather, gather_probe
from er3t_tpu_torch.rtm.phase_pair import phase_pair, phase_pair_ref

torch.set_num_threads(2)
_F = jnp.float32
B = 2048


def _rng(seed):
    return np.random.default_rng(seed)


def _lane(lane_block):
    return pl.BlockSpec((lane_block,), lambda i: (i,),
                        memory_space=pltpu.VMEM)


def _row_tol(got, ref, tab, idx):
    """K3/K4 bound: 1e-6 of the sum of |row| of each lane's table row."""
    bound = 1e-6 * np.abs(tab[idx]).sum(axis=1)
    assert np.all(np.abs(np.asarray(got) - np.asarray(ref)) <= bound)


# ---- K2: scripts/tpu_gather_probe.py:105-113 (pallas_call :115-125) ----

def _k2(idx, tab, reps, lane_block):
    rows, width = tab.shape

    def kern(idx_ref, tab_ref, out_ref):
        ix = idx_ref[:]
        acc = jnp.zeros((lane_block,), _F)
        for r in range(reps):
            v = tab_ref[:, 0] if width else None
            g = jnp.take(tab_ref[:, min(r, width - 1)],
                         (ix + r) % rows, axis=0)
            acc = acc + g
        out_ref[:] = acc

    fn = pl.pallas_call(
        kern,
        grid=(B // lane_block,),
        in_specs=[_lane(lane_block),
                  pl.BlockSpec((rows, width), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=_lane(lane_block),
        out_shape=jax.ShapeDtypeStruct((B,), _F),
        interpret=True,
    )
    return fn(jnp.asarray(idx), jnp.asarray(tab))


@pytest.mark.parametrize('rows,width,reps,lane_block', [
    (6144, 1, 1, 256), (6144, 1, 4, 512), (4096, 3, 4, 1024)],
    ids=['phase_1x', 'phase_4x', 'w3_4x'])
def test_take_reps_equals_pallas_k2(rows, width, reps, lane_block):
    rng = _rng(0)
    tab = rng.normal(size=(rows, width)).astype(np.float32)
    idx = rng.integers(0, rows, B).astype(np.int32)
    idx[:8] = rows - 1 - np.arange(8)          # wrap past the last row
    ref = _k2(idx, tab, reps, lane_block)
    got = gather.take_reps(torch.from_numpy(idx), torch.from_numpy(tab), reps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---- K3: scripts/tpu_gather_probe.py:145-150 (pallas_call :152-162) ----

def _k3(idx, tab_flat, width, lane_block):
    def kern(idx_ref, tab_ref, out_ref):
        ix = idx_ref[:] * width
        acc = jnp.zeros((lane_block,), _F)
        for c in range(width):
            acc = acc + jnp.take(tab_ref[:], ix + c, axis=0)
        out_ref[:] = acc

    fn = pl.pallas_call(
        kern,
        grid=(B // lane_block,),
        in_specs=[_lane(lane_block),
                  pl.BlockSpec((tab_flat.shape[0],), lambda i: (0,),
                               memory_space=pltpu.VMEM)],
        out_specs=_lane(lane_block),
        out_shape=jax.ShapeDtypeStruct((B,), _F),
        interpret=True,
    )
    return fn(jnp.asarray(idx), jnp.asarray(tab_flat))


def test_gather_row_sum_equals_pallas_k3():
    rows, width = 9216, 2                      # the vox2w table, rows cut
    rng = _rng(1)
    tab = rng.normal(size=(rows * width,)).astype(np.float32)
    idx = rng.integers(0, rows, B).astype(np.int32)
    ref = _k3(idx, tab, width, 512)
    got = gather.gather_row_sum(torch.from_numpy(idx),
                                torch.from_numpy(tab).view(rows, width))
    _row_tol(got.numpy(), ref, tab.reshape(rows, width), idx)


# ---- K4: scripts/tpu_gather_probe.py:178-183 (pallas_call :185-195) ----

def _k4(idx, tab, lane_block):
    rows, width = tab.shape

    def kern(idx_ref, tab_ref, out_ref):
        ix = idx_ref[:].reshape(lane_block, 1)
        cols = jax.lax.broadcasted_iota(jnp.int32, (lane_block, rows), 1)
        oh = (cols == ix).astype(_F)
        v = jnp.dot(oh, tab_ref[:], preferred_element_type=_F)
        out_ref[:] = jnp.sum(v, axis=1)

    fn = pl.pallas_call(
        kern,
        grid=(B // lane_block,),
        in_specs=[_lane(lane_block),
                  pl.BlockSpec((rows, width), lambda i: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=_lane(lane_block),
        out_shape=jax.ShapeDtypeStruct((B,), _F),
        interpret=True,
    )
    return fn(jnp.asarray(idx), jnp.asarray(tab))


@pytest.mark.parametrize('rows', [64, 512], ids=['64x128', '512x128'])
def test_gather_row_sum_equals_pallas_k4(rows):
    rng = _rng(2)
    tab = rng.normal(size=(rows, 128)).astype(np.float32)
    idx = rng.integers(0, rows, B).astype(np.int32)
    ref = _k4(idx, tab, 1024)
    got = gather.gather_row_sum(torch.from_numpy(idx), torch.from_numpy(tab))
    _row_tol(got.numpy(), ref, tab, idx)


# ---- the summation order of gather_row_sum, rebuilt in numpy ----

ROW_SUM_WIDTHS = [1, 2, 3, 5, 31, 32, 33, 64, 100, 128, 200, 1024]


def _row_sum_documented(idx, tab, lanes):
    """The order of gather_row_sum_ref's docstring, built from its words
    alone: element e of a row is added, in index order, to the partial of
    lane (e // 4) mod lanes; lane 0 then ends an xor butterfly of offsets
    lanes/2, ..., 1 over the partials."""
    rows = tab[np.clip(idx, 0, tab.shape[0] - 1)]
    part = np.zeros((len(idx), lanes), np.float32)
    for e in range(rows.shape[1]):
        lane = (e // 4) % lanes
        part[:, lane] = part[:, lane] + rows[:, e]
    o = lanes // 2
    while o:
        part = part + part[:, np.arange(lanes) ^ o]
        o //= 2
    return part[:, 0]


@pytest.mark.parametrize('width', ROW_SUM_WIDTHS)
def test_gather_row_sum_ref_follows_the_documented_order(width):
    """Bitwise, at every lane count and at the default one (out-of-range
    indices clamped); the orders differ, so the check can tell them
    apart."""
    rng = _rng(10)
    tab = rng.normal(size=(97, width)).astype(np.float32)
    idx = rng.integers(-5, 105, 257).astype(np.int32)
    t_idx, t_tab = torch.from_numpy(idx), torch.from_numpy(tab)
    for lanes in gather.ROW_SUM_LANES:
        got = gather.gather_row_sum_ref(t_idx, t_tab, lanes).numpy()
        np.testing.assert_array_equal(got, _row_sum_documented(idx, tab,
                                                               lanes))
    lanes = gather.row_sum_lanes(width)
    np.testing.assert_array_equal(gather.gather_row_sum(t_idx, t_tab).numpy(),
                                  _row_sum_documented(idx, tab, lanes))
    if width > 32:
        assert not np.array_equal(_row_sum_documented(idx, tab, 1),
                                  _row_sum_documented(idx, tab, 8))


def test_row_sum_lanes_cover_the_row_chunks_up_to_eight():
    assert [gather.row_sum_lanes(w) for w in ROW_SUM_WIDTHS] == [
        1, 1, 1, 2, 8, 8, 8, 8, 8, 8, 8, 8]
    assert [gather.row_sum_lanes(w) for w in (4, 8, 9, 16, 17)] == [
        1, 2, 4, 4, 8]


# ---- K5: scripts/tpu_gather_probe.py:212-213 (pallas_call :215-220) ----

def _k5(tab):
    n = tab.shape[0]

    def kern(tab_ref, out_ref):
        out_ref[0] = tab_ref[0] + tab_ref[n - 1]

    fn = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1,), _F),
        interpret=True,
    )
    return fn(jnp.asarray(tab))


@pytest.mark.parametrize('n', [1, 12345, 232448 // 4],
                         ids=['n1', 'n12345', 'h100_optin'])
def test_smem_stage_equals_pallas_k5(n):
    tab = _rng(3).normal(size=n).astype(np.float32)
    got = gather.smem_stage(torch.from_numpy(tab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_k5(tab)))


# ---- K6: scripts/tpu_gather_probe2.py:73-102 (run_kernel :60-70) ----

def kern_a(tab_ref, idx_ref, out_ref):             # probe2 :73-74
    out_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)


def kern_b(tab_ref, idx_ref, out_ref):             # probe2 :81-82
    out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=0)


def kern_c(tab_ref, idx_ref, out_ref):             # probe2 :87-88, :93-94
    out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=1)


def kern_d(tab_ref, idx_ref, out_ref):             # probe2 :99-100
    out_ref[:] = jnp.take(tab_ref[:], idx_ref[:, 0], axis=0)


def _run_kernel(kern, tab, idx, out_shape):
    fn = pl.pallas_call(
        kern,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(out_shape, _F),
        interpret=True,
    )
    return fn(jnp.asarray(tab), jnp.asarray(idx))


LB = 256
# tag (the script's) -> (kernel body, take2d mode, tab, idx, idx max, out)
K6_FORMS = {
    'mosaic_take_rows_w128': (kern_a, 'rows', (512, 128), (LB,), 512,
                              (LB, 128)),
    'mosaic_take_rows_w8': (kern_a, 'rows', (512, 8), (LB,), 512, (LB, 8)),
    'mosaic_tala_axis0': (kern_b, 'axis0', (512, 128), (LB, 128), 512,
                          (LB, 128)),
    'mosaic_tala_axis1': (kern_c, 'axis1', (LB, 128), (LB, 128), 128,
                          (LB, 128)),
    'mosaic_tala_axis1_wide': (kern_c, 'axis1', (LB, 1024), (LB, 128), 1024,
                               (LB, 128)),
    'mosaic_take_rows_idx2d': (kern_d, 'rows', (512, 128), (LB, 1), 512,
                               (LB, 128)),
}


@pytest.mark.parametrize('tag', list(K6_FORMS))
def test_take2d_equals_pallas_k6(tag):
    kern, mode, tab_shape, idx_shape, hi, out_shape = K6_FORMS[tag]
    rng = _rng(4)
    tab = rng.normal(size=tab_shape).astype(np.float32)
    idx = rng.integers(0, hi, idx_shape).astype(np.int32)
    ref = _run_kernel(kern, tab, idx, out_shape)
    got = gather.take2d(torch.from_numpy(idx), torch.from_numpy(tab), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---- K7/K8 mosaic_form: scripts/tpu_gather_probe3.py:70-71 (the same
# body in tpu_gather_probe3b.py:70-71), pallas_call :58-63 ----

@pytest.mark.parametrize('tab_rows,idx_rows', [(2048, 2048), (1024, 2048),
                                               (1280, 1280), (8, 8)],
                         ids=['eq_2048', 'tab1024_idx2048', 'tab1280_idx1280',
                              'eq_8'])
def test_take2d_equals_pallas_k7_take_along_axis0(tab_rows, idx_rows):
    rng = _rng(5)
    tab = rng.normal(size=(tab_rows, 128)).astype(np.float32)
    idx = rng.integers(0, tab_rows, (idx_rows, 128)).astype(np.int32)
    ref = _run_kernel(kern_b, tab, idx, (idx_rows, 128))
    got = gather.take2d(torch.from_numpy(idx), torch.from_numpy(tab), 'axis0')
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---- K7/K8 make_pair: scripts/tpu_gather_probe3.py:109-152, the same
# body as scripts/tpu_gather_probe3b.py:96-139 ----

NPF2, NM = 40, 4096
NPF, NU = 20, 8192
NBL_E = NM // 128
NBL_S = NU // 128
KE = NPF2 * NBL_E
KS = NPF * NBL_S


def _make_pair(lb, dtype, p_e, p_s, n):
    tp = p_e.astype(dtype)
    ts = p_s.astype(dtype)

    def kern(apf_ref, mu_ref, u_ref, first_ref, tp_ref, ts_ref,
             pe_ref, mn_ref):
        apf = apf_ref[:].reshape(lb // 128, 128)
        mu = mu_ref[:].reshape(lb // 128, 128)
        u = u_ref[:].reshape(lb // 128, 128)
        first = first_ref[:].reshape(lb // 128, 128)
        # eval index
        ib = jnp.clip(((mu + 1.0) * 0.5 * (NM - 1) + 0.5).astype(jnp.int32),
                      0, NM - 1)
        row_e = apf + first * NPF
        ke = row_e * NBL_E + (ib >> 7)
        # sample index
        iu = jnp.clip((u * (NU - 1) + 0.5).astype(jnp.int32), 0, NU - 1)
        ks = apf * NBL_S + (iu >> 7)

        outs = []
        for kk, tab_ref, kdim, lo in ((ke, tp_ref, KE, ib),
                                      (ks, ts_ref, KS, iu)):
            k2 = kk.reshape(lb, 1)
            cols = jax.lax.broadcasted_iota(jnp.int32, (lb, kdim), 1)
            oh = (cols == k2).astype(dtype)
            v = jnp.dot(oh, tab_ref[:], preferred_element_type=_F)
            v = v.reshape(lb // 128, 128, 128)
            # select lane lo & 127 within each 128 block: axis1 shuffle
            sel = jnp.take_along_axis(
                v.reshape(lb, 128),
                (lo.reshape(lb, 1) & 127), axis=1)
            outs.append(sel.reshape(lb // 128, 128))
        pe_ref[:] = outs[0].reshape(lb)
        mn_ref[:] = outs[1].reshape(lb)

    lane = lambda: pl.BlockSpec((lb,), lambda i: (i,),
                                memory_space=pltpu.VMEM)
    tspec = lambda rows: pl.BlockSpec((rows, 128), lambda i: (0, 0),
                                      memory_space=pltpu.VMEM)
    fn = pl.pallas_call(
        kern,
        grid=(n // lb,),
        in_specs=[lane(), lane(), lane(), lane(),
                  tspec(KE), tspec(KS)],
        out_specs=(lane(), lane()),
        out_shape=(jax.ShapeDtypeStruct((n,), _F),
                   jax.ShapeDtypeStruct((n,), _F)),
        interpret=True,
    )
    return fn, tp, ts


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_phase_pair_equals_pallas_make_pair(dtype):
    """The port's phase pair on one-plane bf16 or f32 tables equals the
    one-hot make_pair of K7/K8 bit for bit (the one-hot product picks a
    single table value, widened exactly to f32)."""
    rng = _rng(6)
    pt_p = rng.normal(size=(NPF2, NM)).astype(np.float32)
    pt_mu = rng.normal(size=(NPF, NU)).astype(np.float32)
    u = rng.uniform(0, 1, (3, B)).astype(np.float32)
    apf = (u[0] * (NPF - 1)).astype(np.int32)           # probe3 :150-152
    first = (u[2] > 0.5).astype(np.int32)
    mu = (u[1] * 2 - 1).astype(np.float32)
    fn, tp, ts = _make_pair(1024, getattr(jnp, dtype),
                            jnp.asarray(pt_p).reshape(KE, 128),
                            jnp.asarray(pt_mu).reshape(KS, 128), B)
    ref_pe, ref_mn = fn(jnp.asarray(apf), jnp.asarray(mu), jnp.asarray(u[2]),
                        jnp.asarray(first), tp, ts)
    tdt = getattr(torch, dtype)
    pe, mn = phase_pair(torch.from_numpy(apf),
                        torch.from_numpy(apf + first * NPF),
                        torch.from_numpy(mu), torch.from_numpy(u[2].copy()),
                        torch.from_numpy(pt_p).to(tdt),
                        torch.from_numpy(pt_mu).to(tdt))
    assert pe.dtype == mn.dtype == torch.float32
    np.testing.assert_array_equal(pe.numpy(), np.asarray(ref_pe))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(ref_mn))


# ---- the build ----

def test_library_hash_covers_shared_headers(tmp_path):
    """An edit to a shared header of csrc/ renames (so rebuilds) the library
    of every source; an edit to one source renames only its own."""
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    for f in ('phase_pair.cu', 'gather_probe.cu', 'common.cuh'):
        (csrc / f).write_bytes((_build._PKG / 'csrc' / f).read_bytes())
    sources = sorted({src for src, _, _ in _build.KERNELS.values()})
    assert sources == ['gather_probe.cu', 'phase_pair.cu']

    def paths():
        return [_build.lib_path(s, csrc, tmp_path) for s in sources]
    first = paths()
    assert first == [_build.lib_path(s, csrc, tmp_path) for s in sources]
    (csrc / 'common.cuh').write_text((csrc / 'common.cuh').read_text()
                                     + '// edit\n')
    second = paths()
    assert all(a != b for a, b in zip(first, second))
    (csrc / 'gather_probe.cu').write_text(
        (csrc / 'gather_probe.cu').read_text() + '// edit\n')
    third = paths()
    assert third[0] != second[0] and third[1] == second[1]


# ---- the wrappers ----

def _wrapper_args(name):
    rng = _rng(7)
    idx = torch.from_numpy(rng.integers(0, 64, 300).astype(np.int32))
    tab = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    wide = torch.from_numpy(rng.normal(size=(64, 130)).astype(np.float32))
    return {'take_reps': (gather.take_reps, gather.take_reps_ref,
                          [idx, tab, 3]),
            'gather_row_sum': (gather.gather_row_sum,
                               gather.gather_row_sum_ref, [idx, tab]),
            'gather_row_sum_wide': (gather.gather_row_sum,
                                    gather.gather_row_sum_ref, [idx, wide]),
            'gather_row_sum_lanes4': (gather.gather_row_sum,
                                      gather.gather_row_sum_ref,
                                      [idx, wide, 4]),
            'take2d_rows': (gather.take2d, gather.take2d_ref,
                            [idx, tab, 'rows']),
            'take2d_axis0': (gather.take2d, gather.take2d_ref,
                             [idx[:240].reshape(30, 8), tab, 'axis0']),
            'take2d_axis1': (gather.take2d, gather.take2d_ref,
                             [idx[:256].reshape(64, 4) % 8, tab, 'axis1']),
            'smem_stage': (gather.smem_stage, gather.smem_stage_ref,
                           [tab.reshape(-1)])}[name]


WRAPPERS = ['take_reps', 'gather_row_sum',
            'gather_row_sum_wide', 'gather_row_sum_lanes4', 'take2d_rows',
            'take2d_axis0', 'take2d_axis1', 'smem_stage']


@pytest.mark.parametrize('name', WRAPPERS)
def test_cpu_dispatch_runs_plain_version(name):
    fn, ref, args = _wrapper_args(name)
    before = fn.launches
    assert torch.equal(fn(*args), ref(*args))
    assert fn.launches == before == 0


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'contiguous', 'empty'])
@pytest.mark.parametrize('name', WRAPPERS)
def test_wrapper_rejects_bad_inputs(name, bad):
    fn, _, args = _wrapper_args(name)
    i = 1 if name != 'smem_stage' else 0       # the table argument
    t = args[i]
    if bad == 'dtype':
        args[i] = t.double()
    elif bad == 'shape':
        args[i] = t.reshape(-1, 1, 1) if t.dim() == 1 else t.reshape(-1)
    elif bad == 'contiguous':
        args[i] = torch.stack([t, t], -1)[..., 0]
    else:
        args[i] = t[:0]
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize('lanes', [0, 3, 16, 32, 64, -32])
def test_gather_row_sum_rejects_bad_lane_counts(lanes):
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match='lanes'):
        gather.gather_row_sum(idx, torch.zeros(4, 128), lanes)


@pytest.mark.parametrize('mode,idx_shape', [('rows', (10, 2)),
                                            ('axis0', (10, 3)),
                                            ('axis1', (3, 4)),
                                            ('axis9', (64,))])
def test_take2d_rejects_mismatched_index_shapes(mode, idx_shape):
    idx = torch.zeros(idx_shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.take2d(idx, torch.zeros(64, 8), mode)


# outputs a chunk (gather.take2d_vec) of each take2d case of chip_smoke's
# phase 6, at its own alignment (RAGGED = 100003)
TAKE2D_VECS = [1, 4, 4, 4, 1, 4, 1, 1, 4, 1, 1, 1, 4, 1, 4, 1, 1, 1, 1]


def _take2d_views(k):
    """Zero views of case k of chip_smoke's take2d cases, on the CPU (an
    allocation there is 64-byte aligned, so an offset view is not)."""
    _, mode, tab, idx, _, t_off, i_off = chip_smoke.take2d_cases()[k]
    t = torch.zeros(int(np.prod(tab)) + t_off)[t_off:].view(tab)
    i = torch.zeros(int(np.prod(idx)) + i_off,
                    dtype=torch.int32)[i_off:].view(idx)
    return mode, t, i


@pytest.mark.parametrize('k', range(len(TAKE2D_VECS)))
def test_take2d_plan_at_the_chip_smoke_cases(k):
    """The dispatch rule is a pure function of shapes and addresses: at
    each phase-6 case it gives the vector width written above."""
    mode, t, i = _take2d_views(k)
    n_j = t.shape[1] if mode == 'rows' else i.shape[1]
    assert gather.take2d_vec(mode, n_j, t.shape[1], t.data_ptr(),
                             i.data_ptr()) == TAKE2D_VECS[k]


def test_take2d_cases_cover_every_kernel_path():
    """rows and axis1 with one and four outputs a chunk, axis0 with one;
    rows of more chunks than a block has threads (256) in each mode that
    allows them."""
    cases = chip_smoke.take2d_cases()
    paths = {(cases[k][1], vec) for k, vec in enumerate(TAKE2D_VECS)}
    assert paths == {('rows', 1), ('rows', 4), ('axis0', 1), ('axis1', 1),
                     ('axis1', 4)}
    width = [tab[1] if mode == 'rows' else idx[1]
             for _, mode, tab, idx, *_ in cases]
    wide = {cases[k][1] for k, vec in enumerate(TAKE2D_VECS)
            if width[k] // vec > 256}
    assert wide == {'rows', 'axis1'}


@pytest.mark.parametrize('shape,vec', [
    (('axis1', 128, 1024, 0, 0), 4),        # K6
    (('axis1', 128, 1024, 4, 0), 4),        # table: no matter
    (('axis1', 128, 1024, 0, 8), 1),        # idx off 16 B
    (('axis1', 126, 1024, 0, 0), 1),        # 126 % 4
    (('axis1', 4096, 8192, 0, 0), 4),       # 1024 chunks
    (('axis0', 128, 128, 0, 0), 1),         # K7
    (('axis0', 5, 5, 0, 0), 1),
    (('rows', 128, 128, 0, 4), 4),          # idx: no matter
    (('rows', 128, 128, 4, 0), 1),
    (('rows', 5, 5, 0, 0), 1),
    (('rows', 1, 1, 0, 0), 1)])
def test_take2d_plan_rule(shape, vec):
    """Four outputs a chunk for rows and axis1 where the row width is a
    multiple of 4 and what is read in 16-byte pieces is 16-byte aligned
    (rows: the table, axis1: the indices), never for axis0."""
    assert gather.take2d_vec(*shape) == vec


def test_take2d_plan_is_plain_on_the_cpu():
    """A forced vector width changes nothing on CPU tensors: the plain
    version runs and no launch is counted."""
    rng = _rng(10)
    tab = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2, 18, (64, 8)).astype(np.int32))
    before = gather.take2d.launches
    for vec in (1, 4):
        assert torch.equal(gather.take2d(idx, tab, 'axis1', _vec=vec),
                           gather.take2d_ref(idx, tab, 'axis1'))
    assert gather.take2d.launches == before


def test_plain_versions_clamp_and_wrap_out_of_range_indices():
    """A kernel must never read outside a table: take_reps wraps an index as
    jnp's % does (floor modulo), the others clamp it, like JAX's gathers."""
    tab = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([-7, -1, 0, 5, 6, 100], dtype=torch.int32)
    assert gather.take_reps(idx, tab, 1).tolist() == [10, 10, 0, 10, 0, 8]
    assert gather.gather_row_sum(idx, tab).tolist() == [1, 1, 1, 21, 21, 21]
    assert gather.take2d(idx, tab, 'rows')[:, 1].tolist() == \
        [1, 1, 1, 11, 11, 11]


def test_phase_pair_rejects_mixed_table_dtypes():
    rng = _rng(8)
    apf = torch.from_numpy(rng.integers(0, 3, 64).astype(np.int32))
    u = torch.from_numpy(rng.uniform(0, 1, 64).astype(np.float32))
    pt_p = torch.zeros(6, 300)
    with pytest.raises(ValueError):
        phase_pair(apf, apf, u, u, pt_p, torch.zeros(3, 500).bfloat16())
    with pytest.raises(ValueError):
        phase_pair(apf, apf, u, u, pt_p.double(), torch.zeros(3, 500).double())


def test_probe_entry_point_runs_every_experiment_on_plain_versions(
        monkeypatch, capsys):
    """A rehearsal of ``gather_probe all`` on the CPU at B = 1024, K = 2
    (device queries and timer stubbed): every script's tag is printed once
    per run, the kernel rows carry the plain time, and the shared-memory
    sweep ends with the refusal one float above the limit."""
    limit = 232448
    monkeypatch.setattr(gather_probe, 'B', 1024)
    monkeypatch.setattr(gather_probe, 'K', 2)
    monkeypatch.setattr(gather_probe, 'device_ms',
                        lambda fn, n=100, per_launch=False: (fn(), 1.0)[1])
    monkeypatch.setattr(gather_probe, 'card_line', lambda: 'cpu')
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda d=None: 'cpu')
    monkeypatch.setattr(torch.cuda, 'get_device_properties', lambda d=None:
                        type('P', (), {'shared_memory_per_block_optin': limit}))

    def refusing(tab):
        if tab.numel() * 4 > limit:
            raise _build.CudaError('smem_stage', 1)
        return gather.smem_stage(tab)
    monkeypatch.setattr(gather_probe, 'smem_stage', refusing)
    recs = gather_probe.run('all', 0, torch.device('cpu'))
    tags = [r['probe'] for r in recs]
    assert tags.count('device') == 4
    for tag in ('health_matmul', 'xla_gather_1w', 'xla_scatter_flux1',
                'pallas_take_1M_4x', 'pallas_take_vox2w',
                'pallas_onehot_512x128', 'mosaic_tala_axis1_wide',
                'loop_gather_vox5', 'loop_rng12', 'tala0_eq_8'):
        assert tags.count(tag) == 1, tag
    for tag in ('pair_onehot_bf16_lb1024', 'pair_onehot_f32_lb1024',
                'pair_xla_gathers'):
        assert tags.count(tag) == 2, tag               # probes 3 and 3b
    kern = [r for r in recs if r['route'] == 'cuda' and 'ms' in r]
    assert kern and all('plain_ms' in r for r in kern
                        if r['probe'] not in ('row_sum_lanes',
                                              'take2d_plans'))
    assert [(r['mode'], r['tab'], r['vec']) for r in recs
            if r['probe'] == 'take2d_plans'] == [
        ('axis1', [2048, 1024], 1), ('axis1', [2048, 1024], 4),
        ('axis1', [2048, 128], 1), ('axis1', [2048, 128], 4),
        ('rows', [4096, 128], 1), ('rows', [4096, 128], 4)]
    sweep = [(r['tab_rows'], r['width'], r['lanes']) for r in recs
             if r['probe'] == 'row_sum_lanes']
    assert sweep == [(921600 * 5 // max(w, 5), w, n)
                     for w in gather_probe.SWEEP_WIDTHS
                     for n in gather.ROW_SUM_LANES] + [
        (512, 128, n) for n in gather.ROW_SUM_LANES]
    ceiling = [(r['bytes'], r['ok']) for r in recs
               if r['probe'] == 'vmem_ceiling']
    assert ceiling[-2:] == [(limit, True), (limit + 4, False)]
    assert [r['kernel'] for r in recs if r['probe'] == 'timing_methods'] == [
        'launch_floor', 'phase_pair_bench_f32', 'smem_stage_optin']
    assert capsys.readouterr().out.count('\n') == len(recs)


def test_smem_stage_refuses_a_misaligned_table_on_any_device():
    tab = torch.from_numpy(_rng(9).normal(size=64).astype(np.float32))
    assert tab.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match='16-byte'):
        gather.smem_stage(tab[1:])
    assert torch.equal(gather.smem_stage(tab[4:]), gather.smem_stage_ref(tab[4:]))


@pytest.mark.parametrize('kernel', ['launch_floor', 'phase_pair_bench_f32',
                                    'smem_stage_optin'])
def test_timing_methods_time_each_kernel_both_ways(monkeypatch, capsys,
                                                   kernel):
    """Each ``timing_methods`` row times its kernel amortised over 100 calls
    and as the median of 30 per-call event pairs, and reports both; on CPU
    tensors the kernels run their plain versions (the floor does nothing)
    and count no launch."""
    calls = []

    def timer(fn, n=100, per_launch=False):
        fn()
        calls.append((n, per_launch))
        return 2.0 if per_launch else 1.0
    monkeypatch.setattr(gather_probe, 'B', 1024)
    monkeypatch.setattr(gather_probe, 'device_ms', timer)
    monkeypatch.setattr(torch.cuda, 'get_device_properties', lambda d=None:
                        type('P', (), {'shared_memory_per_block_optin': 4096}))
    before = (gather.noop.launches, gather.smem_stage.launches,
              phase_pair.launches)
    p = gather_probe._Probes(torch.device('cpu'), 0)
    p.timing_methods()
    rec = {r['kernel']: r for r in p.records}[kernel]
    assert rec['probe'] == 'timing_methods'
    assert rec['amortised_n100_ms'] == 1.0
    assert rec['per_launch_median30_ms'] == 2.0
    assert calls == [(100, False), (30, True)] * 3
    assert (gather.noop.launches, gather.smem_stage.launches,
            phase_pair.launches) == before
    assert capsys.readouterr().out.count('\n') == 3
