"""solver.host_ms_per_request: request wall minus the time inside
run_transport_flight (scene build, reductions, host copies), mean over the
window's requests, in ms."""


def read(run):
    rows = [r.wall_s - sum(f['wall_s'] for f in r.flights)
            for r in run.requests if r.flights]
    return 1e3 * sum(rows) / len(rows) if rows else None
