"""The relative noise of a window's field, per photon."""

import numpy as np

from ..frozen.measure import pixel_var_per_photon


def relvar_per_photon(run):
    """Mean per-pixel variance per photon of the noise field over its
    squared domain mean, from the window's requests (each an independent
    field of equal photons); nothing with fewer than two, or a mean of 0."""
    mean = float(np.mean(run.noise_images)) if run.noise_images else 0.0
    if len(run.noise_images) < 2 or mean == 0.0:
        return None
    var = pixel_var_per_photon(run.noise_images, run.noise_photons)
    return var / mean ** 2
