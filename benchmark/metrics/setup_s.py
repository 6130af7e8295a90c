"""setup_s: host seconds from the process start to the window: imports,
inputs, the Mie tables, loading the kernels, the warm-up request."""


def read(run):
    return run.setup_s
