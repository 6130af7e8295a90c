"""transport.relvar_per_photon: the window's per-pixel variance per photon
of the cell's noise field (frozen ``_pixel_var_per_photon`` over the
requests) over its squared domain mean."""

from benchmark.lib.noise import relvar_per_photon


def read(run):
    return relvar_per_photon(run)
