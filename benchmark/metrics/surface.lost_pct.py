"""surface.lost_pct: Cox-Munk surface hits of the window's flights whose
facet reflection pointed down and got weight 0, over all their Cox-Munk
surface hits, in percent (the program's ``stats['sfc_branch']``: upward
facet reflections, whitecap bounces and lost reflections, counted on the
device and read back once a flight); nothing where the program does not
count them."""


def read(run):
    st = [f['stats'] for r in run.requests for f in r.flights]
    if not st or any('sfc_branch' not in s for s in st):
        return None
    hits = sum(sum(s['sfc_branch'].values()) for s in st)
    return 100.0 * sum(s['sfc_branch']['lost'] for s in st) / hits \
        if hits else None
