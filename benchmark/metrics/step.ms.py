"""step.ms: wall time inside run_transport_flight over its steps, for the
whole window, in ms a step."""


def read(run):
    fl = [f for r in run.requests for f in r.flights]
    steps = sum(f['n_steps'] for f in fl)
    return 1e3 * sum(f['wall_s'] for f in fl) / steps if steps else None
