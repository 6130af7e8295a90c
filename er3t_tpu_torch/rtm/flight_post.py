"""The second half of the flight step (estimate, turn, roulette) as one
hand-written kernel, ``csrc/flight_post.cu``.

:meth:`~.mc_flight.FlightKernel._step_post` issues this half as ~290-500
PyTorch ops a step; on the card the kernel does the same work in one
launch, one thread per lane, and writes the new lanes where the caller
asks (the replayed step's static lanes), so no copies follow it.
``_step_post`` stays the plain version: the CPU path, and the path of
every mode that :func:`applies` refuses.

:func:`applies` decides from a kernel's configuration alone; the flight
kernel sets ``fused_post`` from it and its device.  :func:`fused_post`
fills the kernel's one argument (:class:`PostArgs`, the C struct of
``csrc/flight_post.cuh``) from the first half's ``_Mid`` and K1's pair,
and launches it.  The per-lane body also builds for the host
(``csrc/host_twin.cpp``), which the CPU tests hold against the
plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .._build import launch_struct, ptr

__all__ = ['PostArgs', 'applies', 'fused_post']

# ablations whose deposits the kernel does not make (mc_flight's sites)
_ABLATIONS = frozenset({'firstdep', 'deposit', 'phase'})
# the lane fields that the post half changes; the others pass through
_CHANGED = ('ux', 'uy', 'uz', 'wsc', 'tau', 'nscat', 'alive', 'direct')
_PASSED = ('x', 'y', 'z', 'labs', 'plen', 'ix0', 'iy0', 'launched')
# (field of _Mid, dtype), in the order of csrc/flight_post.cuh
_IN = (('x', torch.float32), ('y', torch.float32), ('z', torch.float32),
       ('ux', torch.float32), ('uy', torch.float32), ('uz', torch.float32),
       ('wsc', torch.float32), ('labs', torch.float32),
       ('tau', torch.float32), ('nscat', torch.int32),
       ('alive', torch.bool), ('direct', torch.bool),
       ('ix0', torch.int32), ('iy0', torch.int32), ('plen', torch.float32),
       ('launched', torch.int64), ('active', torch.bool),
       ('accept', torch.bool), ('collided', torch.bool),
       ('hit_sfc', torch.bool), ('exit_toa', torch.bool),
       ('tclamp', torch.bool), ('zclamp', torch.bool), ('ix', torch.int32),
       ('l_col', torch.int64), ('apf', torch.int32),
       ('tau3_above', torch.float32), ('tau_sens_abs', torch.float32),
       ('tau_sens_sig', torch.float32), ('ssa_ev', torch.float32),
       ('mu_sc', torch.float32))
_OUT = ('x', 'y', 'z', 'labs', 'plen', 'ix0', 'iy0', 'launched') + _CHANGED
_PTRS = ([f for f, _ in _IN] + ['pe', 'mu_new', 'u', 'sfc_tab', 'rad_w']
         + ['o_' + f for f in _OUT]
         + ['rad', 'absorbed', 'outcome', 'sfc_branch', 'tile_stops'])
_INTS = ('n', 'ng', 'nz', 'estimate', 'tally_absorbed', 'sfc_mode', 'nxs',
         'nys', 'nx_img', 'ny_img', 'n_scat_max', 'rr_sensor')
_FLOATS = ('lx', 'ly', 'dx', 'dy', 'sx', 'sy', 'mu_s', 'sx_mu', 'sy_mu',
           'den_vol', 'rr_wmin', 'rr_value')


class PostArgs(ctypes.Structure):
    """``er3t::post::PostArgs`` of ``csrc/flight_post.cuh``, field for
    field: pointers, then ints, then f32 constants."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTRS]
                + [(f, ctypes.c_int) for f in _INTS]
                + [(f, ctypes.c_float) for f in _FLOATS])


def applies(kern) -> bool:
    """Whether the post half of flight kernel ``kern`` can run as the
    kernel, from its configuration alone (no device is asked): a satellite
    sensor's radiance image contracted over g in the step (``rad_w``), or
    any flux target; no camera, pathlength, pinned column (IPA, partial
    3D), slab, or ablation that drops or stands in for a deposit or K1.
    Those modes deposit elsewhere (per-g images, the camera's pixels, the
    pinned pixel, pathlength images) and keep ``_step_post``."""
    if (kern.camera or kern.cfg.pathlength or kern.pinned
            or kern.slab is not None or kern.ablate & _ABLATIONS):
        return False
    if kern.radiance:
        return kern.scalar_rad and kern.nxr * kern.nyr > 1
    return True


def _args(kern, mid, pe_pair, mu_new, lanes, tallies) -> PostArgs:
    """The kernel's argument for the lanes of ``mid``, writing the lanes
    ``lanes`` (the pass-through fields may be absent: not written)."""
    st, cfg, c = kern.st, kern.cfg, mid.c
    b, ng, dev = mid.x.shape[0], st.ng, mid.x.device
    a = PostArgs()

    def numel(f):
        return 1 if f == 'launched' else b * {'labs': ng + 1,
                                              'tau_sens_abs': ng}.get(f, 1)
    for f, dt in _IN:
        setattr(a, f, ptr(getattr(mid, f), f, dt, numel(f), dev))
    a.pe = ptr(pe_pair, 'pe_pair', torch.float32, b, dev)
    a.mu_new = ptr(mu_new, 'mu_new', torch.float32, b, dev)
    if mid.u.shape[0] < 11:
        raise ValueError('fused_post: u needs the rows 5-10')
    a.u = ptr(mid.u, 'u', torch.float32, mid.u.shape[0] * b, dev)
    a.sfc_tab = ptr(kern.sfc_tab, 'sfc_tab', torch.float32,
                     kern.sfc_tab.shape[0] * 6, dev)
    for f in _OUT:
        if f in lanes:
            setattr(a, 'o_' + f, ptr(lanes[f], 'the new ' + f,
                                      getattr(mid, f).dtype, numel(f), dev))
    estimate = kern.radiance
    if estimate:
        a.rad_w = ptr(kern.rad_w, 'rad_w', torch.float32, ng, dev)
        a.rad = ptr(tallies['rad'], 'rad', torch.float32,
                     kern.nxr * kern.nyr, dev)
    if kern.tally_absorbed:
        a.absorbed = ptr(tallies['absorbed'], 'absorbed', torch.float32,
                          st.nz * ng, dev)
    for f, k in (('outcome', 5), ('sfc_branch', 3), ('tile_stops', 2)):
        t = getattr(kern, f)
        if t is not None:
            setattr(a, f, ptr(t, f, torch.int64, k, dev))
    a.n, a.ng, a.nz = b, ng, st.nz
    a.estimate, a.tally_absorbed = int(estimate), int(kern.tally_absorbed)
    a.sfc_mode = (0 if kern.uniform_sfc else 1 if st.nxs == st.nx else 2)
    a.nxs, a.nys = st.nxs, st.nys
    a.nx_img, a.ny_img = kern.nxr, kern.nyr
    a.n_scat_max = cfg.n_scat_max
    a.rr_sensor = int(cfg.rr_value > 0 and kern.radiance)
    a.lx, a.ly, a.dx, a.dy = kern.lx, kern.ly, st.dx, st.dy
    a.sx, a.sy, a.mu_s = kern.sx, kern.sy, kern.mu_s
    # the plain version's scalars, each rounded to f32 once
    a.sx_mu, a.sy_mu = kern.sx / kern.mu_s, kern.sy / kern.mu_s
    a.den_vol = 4.0 * math.pi * kern.mu_s
    a.rr_wmin, a.rr_value = cfg.rr_wmin, cfg.rr_value
    return a


def _card_entry(dev):
    """The card kernel's launch on ``dev``'s current stream."""
    return lambda a: launch_struct('flight_post', dev, a)


def fused_post(kern, mid, pe_pair, mu_new, out=None, entry=None):
    """The post half of ``kern``'s step (what ``kern._step_post(mid,
    pe_pair, mu_new)`` computes) by one kernel launch; returns the new
    carry.

    ``out``: ``None`` (the changed lane fields in new tensors, the others
    the first half's), or a dict of every lane field and ``launched`` into
    which the kernel writes the new lanes (the replayed step's static
    lanes; they may be the first half's own tensors).  ``entry``: the
    function called with the :class:`PostArgs` (by default the card
    kernel's launch on the current stream; the CPU tests pass the host
    build's).  The tallies and counters grow in place, as in the plain
    version."""
    c = mid.c
    if out is None:
        lanes = {f: torch.empty_like(getattr(mid, f)) for f in _CHANGED}
        new = dict({f: getattr(mid, f) for f in _PASSED}, **lanes)
    else:
        lanes = new = out
    a = _args(kern, mid, pe_pair, mu_new, lanes,
              {'rad': c.rad, 'absorbed': c.absorbed})
    (entry or _card_entry(mid.x.device))(a)
    return c._replace(step=c.step + 1, **{f: new[f] for f in _OUT})
