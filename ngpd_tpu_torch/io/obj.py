"""Wavefront OBJ IO (host side), the port of ``ngpd_tpu/io/obj.py``.

``read_obj`` parses with the C++ parser of ``native/`` when it builds and
with the Python path otherwise, as the reference does. The two parsers
differ where the reference's differ: the C++ one skips leading blanks and
takes a tab after the tag, the Python one reads only lines that start
with ``"v "``, ``"vn "`` or ``"f "`` (``native/ngpd_native.cpp``). Vertex
normals: face-indexed normals are accumulated onto their vertices and
renormalised; else one normal per vertex is used directly; else the cloud
has no normals.
"""

from __future__ import annotations

import dataclasses
import io as _io
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.cloud import PointCloud


@dataclasses.dataclass
class ObjData:
    """Raw parse result (all numpy, 0-based indices)."""

    v: np.ndarray  # (V, 3) float32
    vn: np.ndarray  # (Nn, 3) float32 (may be empty)
    fv: np.ndarray  # (F, 3) int32 vertex indices (triangulated)
    fn: np.ndarray  # (F, 3) int32 normal indices (may be empty)


def _parse_faces(face_lines: list[str]) -> tuple[np.ndarray, np.ndarray]:
    fv: list[tuple[int, int, int]] = []
    fn: list[tuple[int, int, int]] = []
    any_fn = False
    for line in face_lines:
        vi: list[int] = []
        ni: list[int] = []
        for t in line.split()[1:]:
            parts = t.split("/")
            vi.append(int(parts[0]))
            ni.append(int(parts[2]) if len(parts) >= 3 and parts[2] else 0)
        if any(x != 0 for x in ni):
            any_fn = True
        # Fan-triangulate polygons.
        for a in range(1, len(vi) - 1):
            fv.append((vi[0], vi[a], vi[a + 1]))
            fn.append((ni[0], ni[a], ni[a + 1]))
    fv_arr = np.asarray(fv, dtype=np.int64).reshape(-1, 3) - 1
    if any_fn:
        fn_arr = np.asarray(fn, dtype=np.int64).reshape(-1, 3) - 1
    else:
        fn_arr = np.zeros((0, 3), dtype=np.int64)
    return fv_arr.astype(np.int32), fn_arr.astype(np.int32)


def _rows(buf: list[str]) -> np.ndarray:
    if not buf:
        return np.zeros((0, 3), np.float32)
    return np.loadtxt(_io.StringIO("".join(buf)), dtype=np.float32, ndmin=2)[:, :3]


def read_obj(file_path: str | Path, use_native: bool = True) -> ObjData:
    """Parse an .obj file into raw arrays: with the C++ parser
    (``native/``) when ``use_native`` and it builds, else in Python."""
    path = Path(file_path)
    assert path.is_file(), path
    if use_native:
        from ..native import native_read_obj

        parsed = native_read_obj(path)
        if parsed is not None:
            v, vn, fv, fn = parsed
            return ObjData(v=v, vn=vn, fv=fv, fn=fn)
    v_buf, vn_buf, f_lines = [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                v_buf.append(line[2:])
            elif line.startswith("vn "):
                vn_buf.append(line[3:])
            elif line.startswith("f "):
                f_lines.append(line)
    fv, fn = _parse_faces(f_lines)
    return ObjData(v=_rows(v_buf), vn=_rows(vn_buf), fv=fv, fn=fn)


def face2vertex_normals(
    v: np.ndarray, fv: np.ndarray, n: np.ndarray, fn: np.ndarray
) -> np.ndarray:
    """Accumulate face-corner normals onto vertices and renormalise."""
    vn = np.zeros_like(v)
    np.add.at(vn, fv.reshape(-1), n[fn.reshape(-1)])
    norms = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norms, 1e-12)


def load_obj(file_path: str | Path) -> PointCloud:
    """Load an .obj as a point cloud with best-effort vertex normals."""
    data = read_obj(file_path)
    v = data.v
    if data.vn.shape[0] > 0 and data.fn.shape[0] > 0:
        normals = face2vertex_normals(v, data.fv, data.vn, data.fn)
    elif data.vn.shape[0] == v.shape[0] and v.shape[0] > 0:
        normals = data.vn
    else:
        normals = None
    return PointCloud.from_numpy(v, normals)


def save_obj(
    file_path: str | Path,
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    overwrite: bool = True,
) -> None:
    """Write points (+ optional normals / per-vertex colours / faces)."""
    path = Path(file_path)
    if path.exists() and not overwrite:
        raise FileExistsError(path)
    points = np.asarray(points)
    lines = ["# ngpd_tpu_torch\n"]
    if colors is not None:
        colors = np.asarray(colors)
        for p, c in zip(points, colors):
            lines.append(
                f"v {p[0]:.8g} {p[1]:.8g} {p[2]:.8g} {c[0]:.5g} {c[1]:.5g} {c[2]:.5g}\n"
            )
    else:
        lines += [f"v {p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n" for p in points]
    if normals is not None:
        lines += [f"vn {n[0]:.8g} {n[1]:.8g} {n[2]:.8g}\n" for n in np.asarray(normals)]
    if faces is not None:
        lines += [f"f {f[0]} {f[1]} {f[2]}\n" for f in np.asarray(faces) + 1]
    with open(path, "w") as fh:
        fh.writelines(lines)
