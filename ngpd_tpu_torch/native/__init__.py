"""ctypes bindings for the port's native host runtime
(``ngpd_native.cpp``): the OBJ parser and the exact grid-hash kNN of
``ngpd_tpu/native``, with its signatures and return types.

The library is built with g++ at first use into ``native/`` of the build
cache (``build/native/`` by default, ``utils/cache.py``), never into the
package. Its file name carries a hash
of the compiler, the flags, the source and the host CPU (``-march=native``
code runs only on the kind of CPU that built it); a build goes to a
temporary name that is renamed into place, so processes building at once
never load a half-written file. The flags are the reference's: first
``-O3 -march=native -fopenmp -shared -fPIC``, and if that fails
``-O3 -shared -fPIC``. Each flag set is tried with ``$CXX`` (where it is
set) and then ``/usr/bin/g++`` before the next set. ``BUILD_COMPILER``
and ``BUILD_FLAGS`` record what built the loaded library and
``BUILD_FAILURES`` the compiler output of every attempt that failed
before it. Without a compiler every entry point returns ``None`` and
``io/obj.py::read_obj`` reads with its Python path, as the reference's
does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils.cache import cache_dir

_SRC = Path(__file__).resolve().parent / "ngpd_native.cpp"
FLAG_SETS = (
    ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"),
    ("-O3", "-shared", "-fPIC"),
)
BUILD_COMPILER: Optional[str] = None
BUILD_FLAGS: Optional[tuple] = None
BUILD_FAILURES: list[str] = []
_lib = None
_build_failed = False


def compilers() -> tuple:
    """``$CXX`` where it is set, then ``/usr/bin/g++``."""
    return tuple(dict.fromkeys(c for c in (os.environ.get("CXX"), "/usr/bin/g++") if c))


def _host_cpu() -> bytes:
    """The CPU's model and feature flags, which ``-march=native`` reads."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = {ln for ln in lines if ln.startswith(("model name", "flags", "Features"))}
    return "\n".join(sorted(keep)).encode()


def library_path(flags: tuple = FLAG_SETS[0], cxx: Optional[str] = None) -> Path:
    """Where the library built by ``cxx`` (default: the first of
    ``compilers()``) with ``flags`` goes in the build cache in use."""
    h = hashlib.sha256(" ".join((cxx or compilers()[0], *flags)).encode())
    h.update(_SRC.read_bytes())
    h.update(_host_cpu())
    return cache_dir() / "native" / f"libngpd_native_{h.hexdigest()[:16]}.so"


def _build(flags: tuple, cxx: str) -> Optional[Path]:
    path = library_path(flags, cxx)
    if path.is_file():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    try:
        subprocess.run([cxx, *flags, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        said = getattr(e, "stderr", None) or str(e)
        BUILD_FAILURES.append(f"{cxx} {' '.join(flags)}: {said[-2000:]}")
        return None
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.obj_load.restype = ctypes.c_void_p
    lib.obj_load.argtypes = [ctypes.c_char_p]
    for name in ("obj_nv", "obj_nn", "obj_nf"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.obj_has_fn.restype = ctypes.c_int
    lib.obj_has_fn.argtypes = [ctypes.c_void_p]
    for name in ("obj_v", "obj_vn"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_float)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("obj_fv", "obj_fn"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int32)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.grid_knn.restype = ctypes.c_int
    lib.grid_knn.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; ``None`` when no flag set
    builds and loads."""
    global _lib, _build_failed, BUILD_COMPILER, BUILD_FLAGS
    if _lib is not None or _build_failed:
        return _lib
    for flags in FLAG_SETS:
        for cxx in compilers():
            path = _build(flags, cxx)
            if path is None:
                continue
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                BUILD_FAILURES.append(f"loading {path}: {e}")
                continue
            BUILD_COMPILER, BUILD_FLAGS = cxx, flags
            return _lib
    _build_failed = True
    return None


def native_read_obj(path: str | Path):
    """Fast OBJ parse -> (v, vn, fv, fn) numpy arrays, or None."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.obj_load(str(path).encode())
    if not handle:
        return None
    try:
        nv, nn, nf = lib.obj_nv(handle), lib.obj_nn(handle), lib.obj_nf(handle)
        v = np.ctypeslib.as_array(lib.obj_v(handle), (max(nv, 1), 3))[:nv].copy()
        vn = np.ctypeslib.as_array(lib.obj_vn(handle), (max(nn, 1), 3))[:nn].copy()
        fv = np.ctypeslib.as_array(lib.obj_fv(handle), (max(nf, 1), 3))[:nf].copy()
        if lib.obj_has_fn(handle) and nf:
            fn = np.ctypeslib.as_array(lib.obj_fn(handle), (nf, 3)).copy()
        else:
            fn = np.zeros((0, 3), np.int32)
        return (v.astype(np.float32), vn.astype(np.float32),
                fv.astype(np.int32), fn.astype(np.int32))
    finally:
        lib.obj_free(handle)


def _host(x) -> np.ndarray:
    """A C-contiguous float32 (n, 3) array, the layout grid_knn reads."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"native_grid_knn takes (n, 3) points, got shape {x.shape}")
    return x


def native_grid_knn(points, k: int, queries=None):
    """Exact host kNN -> (idx (Q, k) int32, sqdist (Q, k) float32), or
    None. ``points`` and ``queries`` are numpy arrays or tensors on any
    device. Rows past the n points hold distance 1e30 and index 0."""
    lib = get_lib()
    if lib is None:
        return None
    pts = _host(points)
    q = pts if queries is None else _host(queries)
    nq = len(q)
    idx = np.empty((nq, k), np.int32)
    d = np.empty((nq, k), np.float32)
    rc = lib.grid_knn(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nq,
        k,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        return None
    return idx, d
