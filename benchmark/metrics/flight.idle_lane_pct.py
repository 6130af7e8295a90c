"""flight.idle_lane_pct: lane slots of the window's flight steps that held
no live photon, over all their lane slots, in percent (the program's
``stats['idle_lanes']`` and ``stats['lane_slots']``, counted on the host
from the two numbers the loop reads back each step); nothing where the
program does not count them."""


def read(run):
    st = [f['stats'] for r in run.requests for f in r.flights]
    if not st or any('lane_slots' not in s for s in st):
        return None
    slots = sum(s['lane_slots'] for s in st)
    return 100.0 * sum(s['idle_lanes'] for s in st) / slots if slots else None
