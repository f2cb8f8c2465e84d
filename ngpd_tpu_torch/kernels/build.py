"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source in ``csrc/`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` at first use into ``kernels/`` of the
build cache (``utils/cache.py``): ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``) unless ``NGPD_TORCH_BUILD_DIR`` moves
it. The file name
carries a hash of the source, of every header in ``HEADERS`` and of the
flags, so an edited source or header is rebuilt and a stale library is
never loaded. The nvcc processes of all sources
start together.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
under ``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from ..utils.cache import cache_dir

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("k0", "k1", "k2", "pass_a", "pass_b", "pass_c", "pass_d", "pass_bd", "knn",
           "feature_knn", "edge_block", "dgcnn_epilogue", "hybrid_vu", "hybrid_update",
           "dense_vote", "dense_classify", "dense_sums", "dense_delta", "dense_update")
HEADERS = ("window_common.cuh", "passes_common.cuh", "walk_common.cuh",
           "pass_walk.cuh", "dense_common.cuh")
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
    "knn": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
    "feature_knn": (_VP, _VP, _I, _I, _I, _I, _VP),
    "edge_block": (_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
    "dgcnn_epilogue": (_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP),
    "hybrid_vu": (_VP, _I, _VP, _VP, _I, _F, _F, _VP),
    "hybrid_update": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _F, _I, _I, _I, _F, _F, _F,
                      _I, _I, _I, _I, *(_I,) * 9, _VP),
    "dense_vote": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _F, _F, _F, _VP, _VP),
    "dense_classify": (_VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _F, _F, _I, _VP, _VP,
                       _VP, _VP),
    "dense_sums": (_VP, _I, _I, _VP, _VP),
    "dense_delta": (_VP, _VP, _VP, _I, _VP, _VP, _I, _I, _VP, _VP),
    "dense_update": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _I, _VP, _F, _I, _I,
                     _I, _F, _F, _F, _I, _VP, _VP),
}
# Further C functions of a library beside its ngpd_<name>_launch: the kNN
# kernel's tile boxes, the split's caps pass, its split launch, its merge
# and the split's slice count.
ENTRY_ARGTYPES = {
    "knn": {"ngpd_knn_boxes_launch": (_VP, _VP, _I, _VP),
            "ngpd_knn_caps_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP),
            "ngpd_knn_split_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                      _VP),
            "ngpd_knn_merge_launch": (_VP, _VP, _VP, _I, _I, _I, _VP),
            "ngpd_knn_slices": (_I, _I, _I)},
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


def _digest(source: Path, headers) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (source, *headers):
        h.update(Path(f).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """``kernels/`` of the build cache in use: ``BUILD_DIR`` by default."""
    return cache_dir() / "kernels"


def library_path(name: str, csrc: Path = CSRC, out_dir: Optional[Path] = None) -> Path:
    """Where the library of ``csrc/name.cu`` goes (``out_dir``, default
    ``build_dir()``). The package's own sources hash the listed
    ``HEADERS``, any other directory every ``.cuh`` in it."""
    out_dir = build_dir() if out_dir is None else out_dir
    headers = ([csrc / f for f in HEADERS] if csrc == CSRC
               else sorted(csrc.glob("*.cuh")))
    return out_dir / f"libngpd_{name}_{_digest(csrc / f'{name}.cu', headers)}.so"


def compile_all(jobs: dict) -> None:
    """Compile ``{library path: source}`` wherever the library is
    missing, all nvcc processes at once, each with its source's
    directory on the include path; raises with nvcc's output on a failed
    build. The ptxas report (registers, spills) of each build is kept
    beside its library as ``<lib>.log``."""
    todo = {p: j for p, j in jobs.items() if not p.is_file()}
    if not todo:
        return
    nvcc = find_nvcc()
    procs = {}
    for path, source in todo.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(source.parent), "-o", str(tmp), str(source)]
        procs[path] = (tmp, source, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for path, (tmp, source, proc) in procs.items():
        log, _ = proc.communicate()
        path.with_name(path.name + ".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {source.name}:\n{log}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_kernels() -> dict[str, Path]:
    """Compile every source whose library is missing. Returns {name:
    library path}."""
    paths = {name: library_path(name) for name in SOURCES}
    compile_all({p: CSRC / f"{name}.cu" for name, p in paths.items()})
    return paths


def ptxas_report(library: Path) -> list[dict]:
    """The ptxas log kept beside ``library``, one record an entry function:
    its mangled name, registers, stack frame and spill bytes."""
    log = Path(str(library) + ".log")
    out = []
    for line in log.read_text().splitlines() if log.is_file() else ():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            out.append({"function": m.group(1)})
        elif out and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                line)):
            out[-1].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(m.group(1))
    return out


def template_tag(kernel: str, *flags: bool | int) -> str:
    """The part of the mangled name of ``kernel<flags...>`` (bool or int
    template arguments; none for a kernel that is not a template) that
    tells it from the other instances."""
    args = "".join(f"Lb{int(f)}E" if isinstance(f, bool) else f"Li{f}E" for f in flags)
    return kernel + (f"I{args}" if flags else "") + "E"


def template_entry(report: list[dict], kernel: str, *flags: bool | int) -> dict:
    """The record of ``kernel<flags...>`` in a ``ptxas_report``; empty if
    it is not there."""
    tag = template_tag(kernel, *flags)
    return next((r for r in report if tag in r["function"]), {})


def bind_library(name: str, path: Path) -> ctypes.CDLL:
    """The ctypes handle of the library at ``path`` of kernel ``name``, its
    C functions given their argument types."""
    lib = ctypes.CDLL(str(path))
    entries = {f"ngpd_{name}_launch": ARGTYPES[name], **ENTRY_ARGTYPES.get(name, {})}
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = bind_library(name, build_kernels()[name])
    return lib
