"""flight.drain_step_pct: steps in the drain stages over all steps of the
window's flights, in percent (``stats['stage_steps']``)."""


def read(run):
    fl = [f for r in run.requests for f in r.flights]
    steps = sum(sum(f['stats']['stage_steps']) for f in fl)
    drain = sum(sum(f['stats']['stage_steps'][1:]) for f in fl)
    return 100.0 * drain / steps if steps else None
