"""OCO-2 hyperspectral gas absorption (NumPy copy of
``er3t_tpu/pre/abs_oco.py:15-113``: ``load_oco_idl``, ``abs_oco_idl`` and
``abs_oco_h5``).

The IDL save holds ``lamx (Nwl)`` wavelengths [um], ``absgl (Ng, Nz, Nwl)``
absorption coefficients, ``absgy (Ng, Nwl)`` slit profiles and ``solx``
solar factors; the per-wavelength weights are the normalized slit column.
The HDF5 variant is read with ``h5py``, imported inside
:func:`abs_oco_h5`.
"""

from __future__ import annotations

import os

import numpy as np

from .abs import AbsCoef

__all__ = ['abs_oco_idl', 'abs_oco_h5', 'load_oco_idl']


def load_oco_idl(fname_idl):
    """Read the raw IDL save into a dict of arrays."""
    from scipy.io import readsav
    f = readsav(fname_idl)
    wvls = np.asarray(f.lamx) * 1000.0           # um -> nm
    abso = np.asarray(f.absgl)                   # (Ng, Nz, Nwl)
    slit = np.asarray(f.absgy)                   # (Ng, Nwl)
    solar = np.asarray(f.solx)                   # (Nwl, Ng) or (Ng, Nwl)
    if solar.shape[0] != wvls.size:
        solar = solar.T
    weight = slit / slit.sum(axis=0, keepdims=True)
    return {'wvls': wvls, 'abso': abso, 'slit': slit, 'solar': solar,
            'weight': weight}


def abs_oco_idl(wavelength, atm, fname_idl, wvl_threshold=1.0):
    """AbsCoef for the hyperspectral sample nearest ``wavelength`` [nm].

    The IDL profiles are tabulated on their own layer grid; they are
    interpolated onto ``atm``'s layers by pressure ordering (the reference
    requires matching grids; interpolation makes the loader robust to the
    user grid).
    """
    if not os.path.exists(fname_idl):
        raise FileNotFoundError(fname_idl)
    db = load_oco_idl(fname_idl)
    i = int(np.abs(db['wvls'] - wavelength).argmin())
    if abs(db['wvls'][i] - wavelength) > wvl_threshold:
        raise ValueError(
            f'{wavelength} nm is {abs(db["wvls"][i] - wavelength):.2f} nm from '
            f'the nearest tabulated sample ({db["wvls"][i]:.2f} nm)')

    abso = db['abso'][:, :, i]                   # (Ng, Nz_db)
    ng, nz_db = abso.shape
    nz = atm.lay.altitude.size
    if nz_db == nz:
        abso_i = abso.T                          # (Nz, Ng)
    else:
        # interpolate in normalized layer index (profiles are monotone in z)
        x_db = np.linspace(0.0, 1.0, nz_db)
        x = np.linspace(0.0, 1.0, nz)
        abso_i = np.stack([np.interp(x, x_db, abso[g]) for g in range(ng)],
                          axis=1)
    slit = np.broadcast_to(db['slit'][:, i], (nz, ng)).copy()
    return AbsCoef(wvl=float(db['wvls'][i]), abso_coef=abso_i,
                   slit_func=slit, solar=np.asarray(db['solar'][i]),
                   weight=np.asarray(db['weight'][:, i]), synthetic=False)


def abs_oco_h5(wavelength, atm, fname_h5, wvl_threshold=1.0):
    """AbsCoef from the self-defined HDF5 variant of the OCO database
    (reference ``abs_oco_h5``, abs_crk.py:1673-1814).

    Dataset layout mirrors the reference reader: ``lamx (Nwl)`` [um],
    ``absgn (Nwl)`` per-wavelength g counts, ``absgx (Nwl, Ngmax)``
    sub-line wavelengths [um], ``absgl (Nz, Nwl, Ngmax)`` absorption
    coefficients, ``absgy (Nwl, Ngmax)`` slit profile (normalized column =
    g weights), ``solx (Nwl, Ngmax)`` solar factors.  Profiles are
    interpolated onto ``atm``'s layers like :func:`abs_oco_idl`.
    """
    import h5py

    if not os.path.exists(fname_h5):
        raise FileNotFoundError(fname_h5)
    with h5py.File(fname_h5, 'r') as f:
        wvls = np.asarray(f['lamx']) * 1000.0
        i = int(np.abs(wvls - wavelength).argmin())
        if abs(wvls[i] - wavelength) > wvl_threshold:
            raise ValueError(
                f'{wavelength} nm is {abs(wvls[i] - wavelength):.2f} nm from '
                f'the nearest tabulated sample ({wvls[i]:.2f} nm)')
        ng = int(np.asarray(f['absgn'])[i])
        abso = np.asarray(f['absgl'])[:, i, :ng]         # (Nz_db, Ng)
        slit0 = np.asarray(f['absgy'])[i, :ng]
        solar = np.asarray(f['solx'])[i, :ng]
    weight = slit0 / slit0.sum()
    nz_db = abso.shape[0]
    nz = atm.lay.altitude.size
    if nz_db == nz:
        abso_i = abso
    else:
        x_db = np.linspace(0.0, 1.0, nz_db)
        x = np.linspace(0.0, 1.0, nz)
        abso_i = np.stack([np.interp(x, x_db, abso[:, g]) for g in range(ng)],
                          axis=1)
    slit = np.broadcast_to(slit0, (nz, ng)).copy()
    return AbsCoef(wvl=float(wvls[i]), abso_coef=abso_i, slit_func=slit,
                   solar=solar, weight=weight, synthetic=False)
