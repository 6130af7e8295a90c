"""flight.lane_iters_per_photon: Tallies.lane_iters over n_launched, summed
over the window's flights (null collisions and drain lanes included)."""


def read(run):
    fl = [f for r in run.requests for f in r.flights]
    n = sum(f['n_launched'] for f in fl)
    return sum(f['lane_iters'] for f in fl) / n if n else None
