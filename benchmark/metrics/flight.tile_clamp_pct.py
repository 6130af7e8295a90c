"""flight.tile_clamp_pct: active lane iterations of the window's flights
that ended on a tile face (the tile majorants' clamp), over all their
active lane iterations, in percent (the program's ``stats['tile_stops']``,
counted on the device and read back once a flight); nothing where the
program does not count them."""


def read(run):
    st = [f['stats'] for r in run.requests for f in r.flights]
    if not st or any('tile_stops' not in s for s in st):
        return None
    active = sum(s['tile_stops']['active'] for s in st)
    return 100.0 * sum(s['tile_stops']['clamped'] for s in st) / active \
        if active else None
