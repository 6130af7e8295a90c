"""kernels.device_ms_per_step: summed kernel device time a step in the
profiled slice, in ms."""


def read(run):
    t = run.trace
    return 1e3 * t['kernel_s'] / t['n_steps'] if t else None
