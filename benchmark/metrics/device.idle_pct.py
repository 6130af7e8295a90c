"""device.idle_pct: the share of the profiled slice in which no kernel,
copy or fill ran on the device, in percent."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t['busy_s'] / t['window_s']) if t else None
