"""Minimal PLY reader and writer (ascii + binary_little_endian), as
``ngpd_tpu/io/ply.py``: x/y/z and optional nx/ny/nz vertex properties."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.cloud import PointCloud

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def load_ply(file_path: str | Path) -> PointCloud:
    path = Path(file_path)
    assert path.is_file(), path
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", "not a PLY file"
        fmt = None
        vertex_count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()[:3]
                in_vertex = name == "vertex"
                if in_vertex:
                    vertex_count = int(cnt)
            elif line.startswith("property") and in_vertex:
                toks = line.split()
                if toks[1] == "list":
                    in_vertex = False  # a list property ends the fixed layout
                else:
                    props.append((toks[2], _PLY_DTYPES[toks[1]]))
            elif line == "end_header":
                break

        names = [p[0] for p in props]
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(vertex_count)]
            arr = np.asarray(rows, dtype=np.float64)
            table = {n: arr[:, i] for i, n in enumerate(names)}
        else:
            assert fmt == "binary_little_endian", f"unsupported PLY format {fmt}"
            dt = np.dtype([(n, "<" + t) for n, t in props])
            raw = f.read(dt.itemsize * vertex_count)
            rec = np.frombuffer(raw, dtype=dt, count=vertex_count)
            table = {n: rec[n].astype(np.float64) for n in names}

    v = np.stack([table["x"], table["y"], table["z"]], axis=1).astype(np.float32)
    if all(k in table for k in ("nx", "ny", "nz")):
        n = np.stack([table["nx"], table["ny"], table["nz"]], axis=1).astype(np.float32)
        return PointCloud.from_numpy(v, n)
    return PointCloud.from_numpy(v)


def _pack_header(count: int, with_normals: bool) -> bytes:
    lines = [
        b"ply",
        b"format binary_little_endian 1.0",
        f"element vertex {count}".encode(),
        b"property float x",
        b"property float y",
        b"property float z",
    ]
    if with_normals:
        lines += [b"property float nx", b"property float ny", b"property float nz"]
    lines.append(b"end_header")
    return b"\n".join(lines) + b"\n"


def save_ply(file_path: str | Path, points: np.ndarray, normals=None) -> None:
    pts = np.asarray(points, dtype=np.float32)
    cols = pts if normals is None else np.concatenate(
        [pts, np.asarray(normals, dtype=np.float32)], axis=1
    )
    with open(file_path, "wb") as f:
        f.write(_pack_header(len(pts), normals is not None))
        f.write(np.ascontiguousarray(cols, dtype="<f4").tobytes())
