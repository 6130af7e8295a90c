"""Frozen copy of ``er3t_tpu_torch/physics/hg.py (whole, at bdb0f8e)``, kept for the benchmark's inputs and its
plain reference; do not edit.

Henyey-Greenstein phase function (copy of ``er3t_tpu/physics/hg.py:9-38``).

:func:`sample_hg_mu` is the reference's expression order in NumPy only: the
reference evaluates it with ``jax.numpy``, which the port does not import.
"""

from __future__ import annotations

import numpy as np

__all__ = ['hg_phase', 'sample_hg_mu']


def hg_phase(g, mu):
    """HG phase function P(mu), normalized so that integral over mu is 2
    (i.e. integral over solid angle of P/(4 pi) is 1 — the framework-wide
    convention; the reference's tabulation carries an extra 1/2,
    pha_hg.py:10-27, which its solver renormalizes away)."""
    g = np.asarray(g, dtype=np.float64)
    return (1.0 - g * g) / (1.0 - 2.0 * g * mu + g * g) ** 1.5




def sample_hg_mu(g, u):
    """Analytic inverse-CDF sample of the HG scattering cosine, elementwise;
    ``u`` uniform in [0, 1).  Handles |g| ~ 0 with the isotropic limit."""
    g = np.asarray(g)
    u = np.asarray(u)
    safe_g = np.where(np.abs(g) < 1e-4, 1e-4, g)
    frac = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u)
    mu_aniso = (1.0 + safe_g * safe_g - frac * frac) / (2.0 * safe_g)
    mu_iso = 2.0 * u - 1.0
    return np.where(np.abs(g) < 1e-4, mu_iso, np.clip(mu_aniso, -1.0, 1.0))
