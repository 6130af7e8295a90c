"""phase_pair_roofline: the phase-pair kernel's bound (frozen ``pair_cost`` and
``bound`` on the arguments of its first call in the profiled slice: bytes
over 3.35 TB/s or operations over 67 TFLOP/s) over its mean device time in
the slice, in percent; nothing where the slice ran no such kernel."""


def read(run):
    t = run.trace
    if not t or t['k1_mean_s'] is None or run.k1_bound_s is None:
        return None
    return 100.0 * run.k1_bound_s / t['k1_mean_s']
