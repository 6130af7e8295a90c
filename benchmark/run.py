"""Run one cell of the port's benchmark once, on the card.

    python benchmark/run.py --workload rad_les.run1e6 --seed 7 \
        --seconds 51 --trace 0

Prints one JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then, as the last lines of standard error, each number that
decided ``correct`` beside its limit (also under ``checks``, the line's
last key).  Exits non-zero, with no result, where no card (or too few) is
visible or where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()           # set-up starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'er3t_tpu')


def forbidden_modules(names=None):
    """The loaded modules (or ``names``) whose top-level name is JAX's or
    the JAX package's (compared whole: ``er3t_tpu_torch`` is not
    ``er3t_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def _environment():
    """Every build and kernel cache at a fixed path inside the checkout;
    one host thread for the CPU math libraries (the step is issued by one
    thread, and idle pool threads only compete with it for the host)."""
    build = ROOT / 'build'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['CUDA_CACHE_PATH'] = str(build / 'cuda_cache')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    for k in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        os.environ[k] = '1'


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.lib import harness, manifest

    cell = manifest.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'benchmark: {args.workload} needs {cell.chips} CUDA '
              f'device(s); {seen} visible', file=sys.stderr)
        return 2
    fd, trace_path = tempfile.mkstemp(suffix='.json', prefix='bench_trace_')
    os.close(fd)
    try:
        out = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), 'cuda', T0,
                               trace_path=trace_path)
    finally:
        if os.path.exists(trace_path):
            os.remove(trace_path)
    leaked = forbidden_modules()
    if leaked:
        print(f'benchmark: loaded {leaked}; the port must not load JAX or '
              'the JAX package', file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for k, c in out['checks'].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
