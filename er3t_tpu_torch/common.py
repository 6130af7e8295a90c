"""Global configuration of the port (copy of ``er3t_tpu/common.py:12-79``):
module-level dtypes, default run parameters, data directories, capability
flags and a citation registry, with the reference's environment variables
(``ER3T_TPU_TMP``, ``ER3T_ABS_16G_H5``, ``ER3T_MIE_CDF``).  ``fdir_data`` is
the port's own ``er3t_tpu_torch/data``.
"""

from __future__ import annotations

import os

import numpy as np

# ----------------------------------------------------------------------------
# dtypes (reference: er3t/common.py:7-8 uses f_dtype=np.float32, i_dtype=int16)
# ----------------------------------------------------------------------------
f_dtype = np.float32
i_dtype = np.int32

# ----------------------------------------------------------------------------
# directories
# ----------------------------------------------------------------------------
fdir_er3t = os.path.dirname(os.path.abspath(__file__))
fdir_data = os.path.join(fdir_er3t, 'data')
fdir_data_tmp = os.environ.get('ER3T_TPU_TMP', '/tmp/er3t_tpu')

# optional external databases (used when present; otherwise we fall back to
# bundled/generated physics data)
fname_abs_16g_h5 = os.environ.get('ER3T_ABS_16G_H5', os.path.join(fdir_data, 'abs_16g.h5'))
fname_mie_cdf = os.environ.get('ER3T_MIE_CDF', os.path.join(fdir_data, 'wc.sol.mie.cdf'))

has_abs_16g = os.path.exists(fname_abs_16g_h5)
has_mie_cdf = os.path.exists(fname_mie_cdf)

# ----------------------------------------------------------------------------
# default run parameters (reference: er3t/common.py:34-55)
# ----------------------------------------------------------------------------
params = {
    'wavelength': 650.0,           # nm
    'solar_zenith_angle': 30.0,    # deg
    'solar_azimuth_angle': 0.0,    # deg
    'sensor_zenith_angle': 0.0,    # deg
    'sensor_azimuth_angle': 0.0,   # deg
    'sensor_altitude': 705000.0,   # m
    'target': 'radiance',
    'solver': '3d',                # '3d' | 'ipa' | 'p3d'
    'photons': 1.0e8,
    'runs': 3,
    'surface_albedo': 0.03,
    'date': None,
    'verbose': False,
}

# ----------------------------------------------------------------------------
# citation registry (reference: er3t/util/util.py:765-784)
# ----------------------------------------------------------------------------
references: list[str] = []


def add_reference(ref: str) -> None:
    """Register a citation string (deduplicated)."""
    if ref not in references:
        references.append(ref)


def print_references() -> None:
    for ref in references:
        print(ref)


add_reference(
    'EaR3T (Chen et al., 2023):\n'
    '- Chen, H. et al.: The Education and Research 3D Radiative Transfer Toolbox (EaR3T), '
    'Atmos. Meas. Tech., 16, 1971-2000, doi:10.5194/amt-16-1971-2023, 2023.'
)
