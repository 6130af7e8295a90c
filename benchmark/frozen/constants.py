"""Frozen copy of ``er3t_tpu_torch/physics/constants.py (whole, at bdb0f8e)``, kept for the benchmark's inputs and its
plain reference; do not edit.

Physical constants (NumPy copy of ``er3t_tpu/physics/constants.py:8-37``).

Values follow CODATA and the conventions of the upstream EaR3T toolbox
(``er3t/util/util.py:888-930``, ``er3t/pre/atm/atm_atmmod.py:223-240``).
"""

# Avogadro constant [1/mol]
N_A = 6.02214179e23

# molar gas constant [J / (mol K)]
R_GAS = 8.314472

# molar mass of dry air [kg/mol]
M_DRY_AIR = 0.0289644

# molar mass of water [kg/mol]
M_H2O = 0.0180160

# density of liquid water [kg/m^3]
RHO_WATER = 1000.0

# standard surface pressure [hPa]
P_STD = 1013.25

# Boltzmann constant [J/K]
K_B = 1.380649e-23

# number-density factor: n [cm^-3] = ND_FACTOR * p[hPa] / T[K]
# (reference: er3t/pre/atm/atm_atmmod.py:223-240)
ND_FACTOR = N_A / R_GAS * 1.0e-4

# Loschmidt number at 273.15 K, 1013.25 hPa [cm^-3]
N_LOSCHMIDT = 2.6867811e19

# Earth-Sun mean distance eccentricity (reference: er3t/util/util.py:944-948)
ORBIT_ECCENTRICITY = 0.0167086
