"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each kernel source has plain C entry points; it is compiled with ``nvcc``
into a shared library at first use and loaded with ``ctypes`` (seconds,
where ``torch.utils.cpp_extension.load`` with PyTorch's headers takes
minutes).  Libraries go to ``build/er3t_tpu_torch/`` under the repository
root, keyed by a hash of the source, the shared headers of ``csrc/`` and
the flags, so a changed source or header is rebuilt and an unchanged one is
loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ['load', 'load_together', 'build', 'build_all', 'launch',
           'launch_struct', 'ptr', 'lib_path', 'CudaError',
           'BUILD_DIR', 'NVCC_FLAGS', 'KERNELS']

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / 'build' / 'er3t_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_c = ctypes.c_void_p
_i = ctypes.c_int
_PAIR = [_c, _c, _c, _c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _c]
# C signatures of the entry points: name -> (source, symbol, argtypes); the
# last argument of each is the CUDA stream
KERNELS = {
    'phase_pair': ('phase_pair.cu', 'er3t_phase_pair', _PAIR),
    'phase_pair_bf16': ('phase_pair.cu', 'er3t_phase_pair_bf16', _PAIR),
    'flight_post': ('flight_post.cu', 'er3t_flight_post', [_c, _c]),
    'flight_post_args_size': ('flight_post.cu', 'er3t_flight_post_args_size',
                              [_c]),
    'domain_tally': ('domain_tally.cu', 'er3t_domain_tally', [_c, _c]),
    'domain_tally_args_size': ('domain_tally.cu',
                               'er3t_domain_tally_args_size', [_c]),
    'take_reps': ('gather_probe.cu', 'er3t_take_reps',
                  [_c, _c, _c, _i, _i, _i, _i, _c]),
    'gather_row_sum': ('gather_probe.cu', 'er3t_gather_row_sum',
                       [_c, _c, _c, _i, _i, _i, _i, _c]),
    'take2d': ('gather_probe.cu', 'er3t_take2d',
               [_c, _c, _c, _i, _i, _i, _i, _i, _i, _c]),
    'smem_stage': ('gather_probe.cu', 'er3t_smem_stage', [_c, _c, _i, _c]),
    'noop': ('gather_probe.cu', 'er3t_noop', [_c]),
}

_loaded: dict = {}                      # kernel name -> ctypes function
build_log: dict[str, str] = {}          # source stem -> nvcc/ptxas output
build_seconds: dict[str, float] = {}    # source stem -> wall time of the build


class CudaError(RuntimeError):
    """A kernel entry point returned a CUDA error (``code``, a cudaError_t)."""

    def __init__(self, name: str, code: int):
        super().__init__(f'{name} kernel launch failed: CUDA error {code}')
        self.code = code


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and Path(cand, 'bin', 'nvcc').exists():
            return str(Path(cand, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                           'of er3t_tpu_torch are built on the GPU machine')
    return found


def lib_path(source: str, csrc: Path = _PKG / 'csrc',
             build_dir: Path = BUILD_DIR) -> Path:
    """Library path of ``source``: its hash covers the source, every shared
    header (``*.cuh``) of ``csrc`` and the flags."""
    h = hashlib.sha256((csrc / source).read_bytes())
    for header in sorted(csrc.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return build_dir / f'{Path(source).stem}-{h.hexdigest()[:16]}.so'


def build(name: str) -> Path:
    """Compile the source of kernel ``name`` if its library is missing;
    return the library's path."""
    source = KERNELS[name][0]
    stem = Path(source).stem
    lib = lib_path(source)
    if lib.exists():
        build_seconds.setdefault(stem, 0.0)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.{stem}.tmp')
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                           str(_PKG / 'csrc' / source)],
                          capture_output=True, text=True)
    build_seconds[stem] = time.perf_counter() - t0
    build_log[stem] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {source}:\n{build_log[stem]}')
    os.replace(tmp, lib)
    return lib


def _build_together(names) -> dict[str, Path]:
    """Build the sources of kernels ``names`` at once, one ``nvcc`` per
    source started together; source stem -> library path."""
    first = {}                          # one kernel name per source
    for name in names:
        first.setdefault(Path(KERNELS[name][0]).stem, name)
    with ThreadPoolExecutor(len(first)) as pool:
        futures = {stem: pool.submit(build, name)
                   for stem, name in first.items()}
        return {stem: f.result() for stem, f in futures.items()}


def build_all() -> dict[str, Path]:
    """Build every source of ``csrc/`` at once (see
    :func:`_build_together`); source stem -> library path."""
    return _build_together(KERNELS)


def load_together(*names) -> None:
    """Load kernels ``names``; the libraries missing among theirs are
    built at once, one ``nvcc`` per source in parallel."""
    missing = [n for n in names if n not in _loaded]
    if len(missing) > 1:
        _build_together(missing)
    for name in missing:
        load(name)


def load(name: str):
    """The ctypes entry point of kernel ``name`` (built at first use)."""
    fn = _loaded.get(name)
    if fn is None:
        _, symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(build(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream with ``args``
    (pointers and ints, the stream appended); raise :class:`CudaError` if
    the entry point reports an error."""
    fn = load(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise CudaError(name, err)


_sized: set = set()                     # kernels whose struct size matched


def launch_struct(name: str, device: torch.device, args) -> None:
    """Launch kernel ``name``, whose one argument is a C struct, with
    ``args`` (its :class:`ctypes.Structure` mirror) on ``device``'s current
    stream.  At the first launch the mirror's size is checked against the
    library's (the entry point ``<name>_args_size``)."""
    if name not in _sized:
        size = load(name + '_args_size')(None)
        if size != ctypes.sizeof(args):
            raise RuntimeError(f"{name}: the kernel's argument has {size} "
                               f'bytes, {type(args).__name__} '
                               f'{ctypes.sizeof(args)}')
        _sized.add(name)
    launch(name, device, ctypes.addressof(args))


def ptr(t: torch.Tensor, name: str, dtype: torch.dtype, numel: int,
        device: torch.device) -> int:
    """The address of tensor ``t`` (argument ``name`` of a kernel), once
    it is checked to be a contiguous ``dtype`` tensor of ``numel``
    elements on ``device``."""
    if t.dtype != dtype or t.device != device or not t.is_contiguous() \
            or t.numel() != numel:
        raise ValueError(f'{name} must be a contiguous {dtype} tensor of '
                         f'{numel} elements on {device}, got {t.dtype} '
                         f'{tuple(t.shape)} on {t.device}')
    return t.data_ptr()
