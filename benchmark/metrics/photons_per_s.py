"""photons_per_s: photons traced to their end by all requests of the
window (launched, less those still in flight at a flight's step cap) over
the wall time from the first request's start to the last one's end (host
clock; each request ends in a synchronize)."""


def read(run):
    return run.photons / run.window_s
