"""ctypes bridge to the native C++ reference Monte Carlo solver (a copy of
``er3t_tpu/native/__init__.py``, lines 1-111).

Builds ``native/mc_ref.cpp`` on demand with g++ (plain C ABI + ctypes), with
the reference's command (``-O3 -march=native -shared -fPIC -std=c++17
-fopenmp``, serial without OpenMP where the toolchain lacks it).  The
source is read in place; the library goes to ``build/er3t_tpu_torch/``
under the repository root, named by a hash of the source and the flags, and
is written under a temporary name and renamed into place, so processes that
build it at once never load a half-written file.  The native solver is the
independent implementation the port's transport engines are
cross-validated against (tests/test_cross_native.py, chip_smoke.py phase
12).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
import uuid
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR
from ..rtm.out import _host

__all__ = ['mc_ref_run', 'ensure_built', 'lib_path', 'max_threads', 'SRC',
           'CXX_FLAGS']

SRC = Path(__file__).resolve().parents[2] / 'native' / 'mc_ref.cpp'
CXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-std=c++17')
OPENMP_FLAG = '-fopenmp'

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.c_int
# the C signature of mc_ref_run (native/mc_ref.cpp:116-125)
_ARGTYPES = ([_I] * 9 + [_D] * 7 + [ctypes.POINTER(_I)] + [_D] * 2
             + [ctypes.c_double] * 5
             + [ctypes.c_longlong, ctypes.c_uint64, _I, ctypes.c_double, _D,
                _D])

_lib = None
build_seconds = None            # wall of this process's build, if it built


def lib_path(openmp: bool = True) -> Path:
    """Library path of the source built with (``openmp``) or without
    OpenMP: its hash covers the source and the flags."""
    flags = CXX_FLAGS + ((OPENMP_FLAG,) if openmp else ())
    h = hashlib.sha256(SRC.read_bytes())
    h.update(' '.join(flags).encode())
    return BUILD_DIR / f'libmc_ref-{h.hexdigest()[:16]}.so'


def _compile(lib: Path, openmp: bool) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'{lib.name}.{uuid.uuid4().hex}.tmp')
    cmd = ['g++', *CXX_FLAGS, *((OPENMP_FLAG,) if openmp else ()),
           str(SRC), '-o', str(tmp)]
    t0 = time.perf_counter()
    try:
        subprocess.run(cmd, check=True)
    except subprocess.CalledProcessError:
        tmp.unlink(missing_ok=True)
        raise
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, lib)


def ensure_built() -> str:
    """Build the library if it is missing (with OpenMP, else serial);
    return its path."""
    lib = lib_path(openmp=True)
    if lib.exists():
        return str(lib)
    try:
        _compile(lib, openmp=True)
    except subprocess.CalledProcessError:
        # toolchains without OpenMP: build serial
        lib = lib_path(openmp=False)
        if not lib.exists():
            _compile(lib, openmp=False)
    return str(lib)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.mc_ref_run.argtypes = _ARGTYPES
        lib.mc_ref_run.restype = None
        _lib = lib
    return _lib


def max_threads() -> int | None:
    """``omp_get_max_threads()`` of the loaded library; None for the serial
    build."""
    fn = getattr(_load(), 'omp_get_max_threads', None)
    return None if fn is None else int(fn())


def mc_ref_run(scene, st, albedo, sza_deg, saa_deg, n_photon, seed=1,
               do_radiance=True, rr_wmin=0.1):
    """Run the native reference solver on a (SceneArrays, SceneStatic) pair
    of either package (tensors on any device, or arrays).

    Returns (rad (nx, ny, ng), flux (nz+1, 3, ng), n_photon) in the same raw
    photon-weight units as the transport kernels' tallies.
    """
    lib = _load()
    host = lambda a: np.asarray(_host(a))                    # noqa: E731
    f64 = lambda a: np.ascontiguousarray(host(a), dtype=np.float64)  # noqa: E731
    i32 = lambda a: np.ascontiguousarray(host(a), dtype=np.int32)    # noqa: E731

    z_lev = f64(scene.z_lev)
    sig_ray = f64(scene.sig_ray)
    # the C++ cross-check models one CONSERVATIVE aerosol channel using the
    # LAST phase row (mc_ref.cpp); guard the assumptions loudly so a future
    # cross-validation scene with absorbing or multi-constituent aerosol
    # cannot silently validate against wrong reference physics (the ns3
    # guard below does the same for the 3D region)
    aer_ext = host(scene.sig_aer)
    if aer_ext.any():
        if aer_ext.shape[1] > 1 and (aer_ext != 0).any(axis=0).sum() > 1:
            raise NotImplementedError(
                'the native cross-check solver models a single aerosol '
                'constituent (last phase row)')
        if (host(scene.aer_ssa) < 1.0).any():
            raise NotImplementedError(
                'the native cross-check solver treats aerosol as '
                'conservative (ssa=1); absorbing aerosol scenes are '
                'cross-validated flight-vs-marching instead')
    sig_aer = f64(aer_ext.sum(axis=1))
    kabs = f64(scene.kabs)
    sig_maj = f64(scene.sig_maj)
    if getattr(st, 'ns3', 1) != 1:
        raise NotImplementedError(
            'the native cross-check solver models a single 3D constituent; '
            'per-constituent scenes are cross-validated flight-vs-marching')
    ext3d = f64(scene.ext3d)
    ssa3d = f64(host(scene.ssa3d)[..., 0])
    apf3d = i32(host(scene.apf3d)[..., 0])
    pt_mu = f64(scene.pt_mu)
    pt_p = f64(scene.pt_p)

    npf, nu = pt_mu.shape
    nm = pt_p.shape[1]
    nz3 = st.nz3 if st.has_3d else 0
    for name, a, size in (('z_lev', z_lev, st.nz + 1),
                          ('sig_ray', sig_ray, st.nz),
                          ('sig_aer', sig_aer, st.nz),
                          ('sig_maj', sig_maj, st.nz),
                          ('kabs', kabs, st.nz * st.ng),
                          ('pt_p', pt_p, 2 * npf * nm)):
        if a.size != size:
            raise ValueError(f'{name} has {a.size} elements, not {size}')
    for name, a in (('ext3d', ext3d), ('ssa3d', ssa3d), ('apf3d', apf3d)):
        if a.size < st.nx * st.ny * nz3:
            raise ValueError(f'{name} has {a.size} elements, fewer than '
                             f'{st.nx} x {st.ny} x {nz3}')
    rad = np.zeros((st.nx, st.ny, st.ng), dtype=np.float64)
    flux = np.zeros((st.nz + 1, 3, st.ng), dtype=np.float64)

    c = ctypes
    ptr = lambda a: a.ctypes.data_as(c.POINTER(c.c_double))  # noqa: E731
    iptr = lambda a: a.ctypes.data_as(c.POINTER(c.c_int))    # noqa: E731

    lib.mc_ref_run(
        c.c_int(st.nz), c.c_int(st.ng), c.c_int(st.nx), c.c_int(st.ny),
        c.c_int(nz3), c.c_int(st.iz3l),
        c.c_int(npf), c.c_int(nu), c.c_int(nm),
        ptr(z_lev), ptr(sig_ray), ptr(sig_aer), ptr(kabs), ptr(sig_maj),
        ptr(ext3d), ptr(ssa3d), iptr(apf3d), ptr(pt_mu), ptr(pt_p),
        c.c_double(st.dx), c.c_double(st.dy), c.c_double(albedo),
        c.c_double(sza_deg), c.c_double(saa_deg),
        c.c_longlong(int(n_photon)), c.c_uint64(seed),
        c.c_int(1 if do_radiance else 0), c.c_double(rr_wmin),
        ptr(rad), ptr(flux))
    return rad, flux, int(n_photon)
