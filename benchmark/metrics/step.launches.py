"""step.launches: CUDA kernels a step in the profiled slice."""


def read(run):
    t = run.trace
    return t['n_kernels'] / t['n_steps'] if t else None
