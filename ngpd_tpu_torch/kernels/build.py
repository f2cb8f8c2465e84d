"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` at first use into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``). The file name
carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded. The nvcc processes of all sources
start together.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
under ``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("k0", "k1", "k2", "pass_a", "pass_b", "pass_c", "pass_d", "pass_bd")
HEADERS = ("window_common.cuh", "passes_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ARGTYPES = {
    "k0": (_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP),
    "k1": (_VP, _VP, _VP, _I, _I, _I, _I, _F, _VP),
    "k2": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _VP),
    "pass_a": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _F, _VP),
    "pass_b": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _VP),
    "pass_c": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _VP),
    "pass_d": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
               _F, _F, _F, _I, _I, _I, _VP),
    "pass_bd": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F,
                _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I, _VP),
}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be "
        "built, and the port does not fall back to the plain versions on a card"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"libngpd_{name}_{_digest(name)}.so"


def build_kernels() -> dict[str, Path]:
    """Compile every source whose library is missing, all nvcc processes
    at once. Returns {name: library path}; raises with nvcc's output on a
    failed build. The ptxas report (registers, spills) of each build is
    kept beside its library as ``<lib>.log``."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = {k: p for k, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        path.with_name(path.name + ".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_kernels()[name]))
        fn = getattr(lib, f"ngpd_{name}_launch")
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
