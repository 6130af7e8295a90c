"""flight.fused_post_pct: steps whose second half (estimate, turn,
roulette) ran as the one hand-written kernel, over all steps of the
window's flights, in percent (the program's ``stats['fused_post_steps']``
and ``stats['stage_steps']``); nothing where the program does not count
them."""


def read(run):
    st = [f['stats'] for r in run.requests for f in r.flights]
    if not st or any('fused_post_steps' not in s for s in st):
        return None
    steps = sum(sum(s['stage_steps']) for s in st)
    return (100.0 * sum(s['fused_post_steps'] for s in st) / steps
            if steps else None)
