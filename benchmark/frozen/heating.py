"""Frozen copy of ``er3t_tpu_torch/rtm/out.py:26-27, 133-147 (at 0ce2d1a)``
(``_CP``, ``_RD``, ``_heat_capacity``, ``heating_rate``), kept for the
benchmark's plain reference; do not edit.
"""

from __future__ import annotations

__all__ = ['heating_rate']

_CP = 1004.0            # specific heat of dry air [J/kg/K]
_RD = 287.0             # gas constant of dry air [J/kg/K]


def _heat_capacity(atm):
    """Per-layer air heat capacity per area rho * cp * dz [J/m^2/K]."""
    dz_m = atm.lay.thickness * 1000.0
    rho = atm.lay.pressure * 100.0 / (_RD * atm.lay.temperature)
    return rho * _CP * dz_m


def heating_rate(flux: dict, atm):
    """Heating rate [K/day] per layer from the level net fluxes of
    :func:`reduce_flux`: the net-flux convergence over the layer's air
    heat capacity."""
    f_net = flux['f_down'] - flux['f_up']                       # (..., Nlev)
    d_fnet = f_net[..., 1:] - f_net[..., :-1]
    return d_fnet / _heat_capacity(atm) * 86400.0
