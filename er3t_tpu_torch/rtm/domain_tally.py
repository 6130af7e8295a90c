"""The domain-average flux and absorbed-energy tallies of the flight step
as one hand-written kernel, ``csrc/domain_tally.cu``.

:meth:`~.mc_flight.FlightKernel._step_pre` tallies a domain-average flux
flight (the heating rate's) by building dense (B, Nz+1, Ng) arrays of the
lanes' attenuated weights at every level and absorbed energy in every
layer, and summing them over the lanes.  On the card, where the kernel's
``fused_tally`` holds (the post half fuses, and no collision forcing),
:func:`domain_tally` adds the same sums from one launch that keeps no
dense array.  The dense branch stays the plain version: the CPU path, and
the path of forced flights.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import launch_struct, ptr

__all__ = ['TallyArgs', 'domain_tally']

_PTRS = ('z', 'uz', 'inv_uz', 's_star', 'wsc', 'labs', 'trav', 'active',
         'term', 'direct', 'z_lev', 'kabs', 'flux', 'absorbed')


class TallyArgs(ctypes.Structure):
    """``er3t::tally::TallyArgs`` of ``csrc/domain_tally.cuh``, field for
    field."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTRS]
                + [(f, ctypes.c_int) for f in ('n', 'ng', 'nz')])


def _card_entry(dev):
    """The card kernel's launch on ``dev``'s current stream."""
    return lambda a: launch_struct('domain_tally', dev, a)


def domain_tally(kern, z, uz, inv_uz, s_star, wsc, labs, trav, active,
                 term, direct, flux, absorbed, entry=None) -> None:
    """Add the flights of ``kern``'s step to the domain-average tallies
    ``flux`` ((Nz+1)*3, Ng) and ``absorbed`` (Nz, Ng), in place: what the
    dense branch of ``_step_pre`` adds without forcing.  The lanes: the
    flight's start ``z``, direction ``uz`` and ``inv_uz``, length
    ``s_star``, weight ``wsc``, log-transmissions ``labs`` (Ng+1, B)
    before the flight's absorption, per-layer paths ``trav`` (Nz, B), and
    the masks ``active``, ``term`` (ended at the surface or TOA) and
    ``direct``.  ``entry``: as for :func:`.flight_post.fused_post`."""
    st, dev = kern.st, z.device
    b, ng, nz = z.shape[0], st.ng, st.nz
    a = TallyArgs()
    f32, u8 = torch.float32, torch.bool
    for name, t, dt, numel in (
            ('z', z, f32, b), ('uz', uz, f32, b), ('inv_uz', inv_uz, f32, b),
            ('s_star', s_star, f32, b), ('wsc', wsc, f32, b),
            ('labs', labs, f32, (ng + 1) * b), ('trav', trav, f32, nz * b),
            ('active', active, u8, b), ('term', term, u8, b),
            ('direct', direct, u8, b),
            ('z_lev', kern.scene.z_lev, f32, nz + 1),
            ('kabs', kern.scene.kabs, f32, nz * ng),
            ('flux', flux, f32, (nz + 1) * 3 * ng),
            ('absorbed', absorbed, f32, nz * ng)):
        setattr(a, name, ptr(t, name, dt, numel, dev))
    a.n, a.ng, a.nz = b, ng, nz
    (entry or _card_entry(dev))(a)
