"""s_to_5pct: seconds, at this run's photons_per_s, for the mean per-pixel
variance of the cell's noise field to fall to (5 % of its domain mean)^2:
relvar_per_photon / 0.05^2 / photons_per_s.  Needs two requests or more."""

from benchmark.lib.noise import relvar_per_photon


def read(run):
    rv = relvar_per_photon(run)
    if rv is None:
        return None
    return rv / 0.05 ** 2 / (run.photons / run.window_s)
