"""The inputs of a cell, made from its configuration file.

The atmosphere, the 16-g absorption and the cloud field come from the
benchmark's frozen copies (``benchmark/frozen``), so the port and the
reference get the very same objects.  The Mie phase functions are not
made here: each side computes its own from ``Inputs.mie`` (the port with
its ``pha_mie_wc`` in set-up, the reference with the frozen copy).
A configuration that names its own builder (``"inputs"``, see
:mod:`.manifest`) may also hand both sides further ``solve`` arguments made
from frozen copies (``Inputs.solve_objects``: 3D aerosols, a surface
object); what the port derives from them it derives in set-up.

Every seed gets the same inputs and the same work: the configuration and
the traffic's fixed sequence of request seeds (:func:`request_seeds`) make
them, and ``--seed`` seeds only the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..frozen import absco, atm, cld

__all__ = ['Inputs', 'make_inputs', 'seeds', 'request_seeds']


@dataclasses.dataclass
class Inputs:
    atm: object
    abs_coef: object
    cld: object
    mie: dict | None          # pha_mie_wc keyword arguments, or no Mie
    solve_kw: dict            # solve's keyword arguments of the configuration
    pha: object = None        # the side's own phase object, once made
    # further solve keyword arguments made from frozen copies (aer_3ds, a
    # surface object, ...), handed to both sides
    solve_objects: dict = dataclasses.field(default_factory=dict)


def seeds(seed, n, stream):
    """``n`` 31-bit seeds of stream ``stream`` drawn from ``seed`` (any
    whole number, negative or past 64 bits)."""
    ss = np.random.SeedSequence([abs(int(seed)) % (1 << 64),
                                 int(int(seed) < 0), int(stream)])
    return [int(v) for v in ss.generate_state(n) & 0x7FFFFFFF]


def request_seeds(request_seed, n):
    """The seeds of a window's first ``n`` requests: one fixed sequence,
    drawn from the traffic's ``request_seed``, the same in every run (and
    its first ``k`` the same for every ``n`` >= ``k``)."""
    return seeds(request_seed, n, stream=2)


def make_inputs(config):
    """Inputs of the configuration dict ``config``."""
    a = atm.atm_atmmod(np.asarray(config['levels_km'], dtype=np.float64))
    if config['absorption'] != 'abs_16g':
        raise ValueError(f"unknown absorption {config['absorption']!r}")
    # the 16-g database is not bundled: abs_16g's own fallback
    ab = absco.abs_synthetic(float(config['wavelength_nm']), a, ng=16)
    c_kw = dict(config['cloud'])
    if c_kw.pop('generator') != 'cld_gen_hem':
        raise ValueError('unknown cloud generator')
    c = cld.cld_gen_hem(**c_kw)
    mie = config.get('mie')
    return Inputs(atm=a, abs_coef=ab, cld=c,
                  mie=None if mie is None else dict(mie),
                  solve_kw=dict(config['solve']))
