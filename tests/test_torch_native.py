"""The port's native host runtime (``ngpd_tpu_torch/native``: the C++ OBJ
parser and the exact grid-hash kNN) and ``read_obj(use_native=)`` against
``ngpd_tpu``'s, parser for parser, on the same files.

No test skips without a toolchain: g++ is part of the port's build (it
also builds nvcc's host code), so a library that does not build fails
here. The reference's ``get_lib`` builds its own ignored library beside its
source when it is missing, as its own tests do; the port's goes to the
build cache and never into the package.

Behaviours of the reference that the port copies (each case says where):
the C++ parser skips leading blanks and takes a tab after the tag while
the Python path reads only lines that start with ``"v "``, ``"vn "`` or
``"f "``; neither resolves negative (relative) indices; the C++ parser
keeps at most 64 corners of a polygon; ``grid_knn`` may keep a higher
index than the lowest among points tied at the k-th distance.
"""

import time

import numpy as np
import pytest
import torch

import ngpd_tpu.native as jnative
from ngpd_tpu.io import obj as jobj
from ngpd_tpu.native import native_grid_knn as jgrid_knn
from ngpd_tpu.native import native_read_obj as jnative_read_obj
from ngpd_tpu_torch import native
from ngpd_tpu_torch.io.obj import read_obj, save_obj
from ngpd_tpu_torch.native import native_grid_knn, native_read_obj
from ngpd_tpu_torch.utils import cache

from fixtures import sphere_cloud

torch.set_num_threads(2)

QUADS = """# two quads and a pentagon, v/vt/vn corners
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 2 0 0
v 2 1 0
v 1.5 2 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
vn 0 0 -1
f 1/1/1 2/2/1 3/3/1 4/1/1
f 2/1/2 5/2/2 6/3/2 3/1/2
f 4/1/1 3/2/1 6/3/2 7/1/1 1/2/2
"""

MIXED_NORMALS = """v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
f 1//1 2//1 3//1
f 1 3 4
f 2/1 3/1 4/1
"""

CRLF = "v 0.5 0.25 -1\r\nv 1e-3 2 3\r\nv 4 5 6\r\nvn 0 1 0\r\nf 1 2 3\r\n"

FOUR_COORDS = "v 1 2 3 1.0\nv 4 5 6 0.5\nv 7 8 9 2\nf 1 2 3\n"

# The reference's two parsers differ on this file: the C++ one reads 3
# vertices and 1 face, the Python path 1 vertex and no face.
BLANKS = "v\t0 0 0\n  v 1 0 0\nv 1 1 0\nf\t1 2 3\n"

# Neither parser resolves a relative index: both give -4 -3 -2.
NEGATIVE = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"

# A polygon of 70 corners: the C++ parser keeps 64 of them (62 triangles),
# the Python path all 70 (68 triangles).
_RING = np.stack([np.cos(np.arange(70) * 2 * np.pi / 70),
                  np.sin(np.arange(70) * 2 * np.pi / 70), np.zeros(70)], 1)
WIDE = "".join(f"v {x:.6f} {y:.6f} {z:.1f}\n" for x, y, z in _RING) + \
    "f " + " ".join(str(i + 1) for i in range(70)) + "\n"

TEXTS = {"quads_pentagon": QUADS, "mixed_normals": MIXED_NORMALS, "crlf": CRLF,
         "four_coords": FOUR_COORDS, "blanks_and_tabs": BLANKS, "negative": NEGATIVE,
         "wide_polygon": WIDE}


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    """The reference builds its library beside its source at first use,
    writing it in place; a process that loaded it while another process of
    the test run was still writing it gave up on it. Retry a few times."""
    for _ in range(5):
        if jnative.get_lib() is not None:
            return
        jnative._build_failed = False
        time.sleep(2.0)
    assert jnative.get_lib() is not None, "the reference's native library does not build"


def _write(tmp_path, name):
    path = tmp_path / f"{name}.obj"
    if name == "sphere100":
        pts, nrm = sphere_cloud(100, seed=3)
        save_obj(path, pts, nrm)
    else:
        path.write_bytes(TEXTS[name].encode())
    return path


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _arrays(data):
    return data.v, data.vn, data.fv, data.fn


def test_the_library_builds_into_the_build_cache():
    assert native.get_lib() is not None
    assert native.BUILD_FLAGS in native.FLAG_SETS
    assert native.BUILD_COMPILER in native.compilers()
    path = native.library_path(native.BUILD_FLAGS, native.BUILD_COMPILER)
    assert path.is_file()
    assert path.parent == cache.cache_dir() / "native"
    assert not list(native._SRC.parent.glob("*.so"))


@pytest.mark.parametrize("name", ["sphere100", *TEXTS])
def test_parsers_equal_the_reference(tmp_path, name):
    """The port's C++ parser equals the reference's, and the port's Python
    path the reference's Python path."""
    path = _write(tmp_path, name)
    _equal(native_read_obj(path), jnative_read_obj(path))
    _equal(_arrays(read_obj(path)), _arrays(jobj.read_obj(path)))
    _equal(_arrays(read_obj(path, use_native=False)),
           _arrays(jobj.read_obj(path, use_native=False)))
    _equal(_arrays(read_obj(path)), native_read_obj(path))


def test_the_sphere_cloud_reads_back(tmp_path):
    pts, nrm = sphere_cloud(100, seed=3)
    v, vn, fv, fn = native_read_obj(_write(tmp_path, "sphere100"))
    np.testing.assert_allclose(v, pts, atol=1e-5)
    np.testing.assert_allclose(vn, nrm, atol=1e-5)
    assert fv.shape == fn.shape == (0, 3)


def test_the_parsers_differ_where_the_reference_s_do(tmp_path):
    """Copied divergences of the reference: blanks and tabs, the 64-corner
    cap; and the relative index neither parser resolves."""
    path = _write(tmp_path, "blanks_and_tabs")
    v, _, fv, _ = native_read_obj(path)
    py = read_obj(path, use_native=False)
    assert (len(v), len(fv), len(py.v), len(py.fv)) == (3, 1, 1, 0)
    np.testing.assert_array_equal(fv, [[0, 1, 2]])

    path = _write(tmp_path, "wide_polygon")
    assert len(native_read_obj(path)[2]) == 62
    assert len(read_obj(path, use_native=False).fv) == 68

    path = _write(tmp_path, "negative")
    np.testing.assert_array_equal(native_read_obj(path)[2], [[-4, -3, -2]])
    np.testing.assert_array_equal(read_obj(path, use_native=False).fv, [[-4, -3, -2]])


def test_mixed_normals_mark_missing_corners(tmp_path):
    _, vn, fv, fn = native_read_obj(_write(tmp_path, "mixed_normals"))
    assert len(vn) == 1
    np.testing.assert_array_equal(fv, [[0, 1, 2], [0, 2, 3], [1, 2, 3]])
    np.testing.assert_array_equal(fn, [[0, 0, 0], [-1, -1, -1], [-1, -1, -1]])


def test_a_missing_file_gives_none(tmp_path):
    assert native_read_obj(tmp_path / "absent.obj") is None


def _brute(pts, q, k):
    d = ((q[:, None] - pts[None]) ** 2).sum(-1)
    return np.sort(d, axis=1)[:, :k]


def test_grid_knn_equals_the_reference_and_brute_force():
    """The reference test's 1,500 sphere points, k = 8."""
    pts = sphere_cloud(1500, seed=4)[0]
    idx, d = native_grid_knn(pts, 8)
    jidx, jd = jgrid_knn(pts, 8)
    _equal((idx, d), (jidx, jd))
    np.testing.assert_allclose(np.sort(d, 1), _brute(pts, pts, 8), atol=1e-5)
    np.testing.assert_array_equal(idx[:, 0], np.arange(len(pts)))
    got = native_grid_knn(torch.from_numpy(pts), 8)
    _equal(got, (idx, d))


def test_grid_knn_other_queries():
    """Queries that are not the points, some outside the bounding box."""
    rng = np.random.default_rng(5)
    pts = sphere_cloud(800, seed=6)[0]
    q = np.concatenate([rng.uniform(-1, 1, (200, 3)), rng.uniform(-4, 4, (56, 3))])
    q = q.astype(np.float32)
    assert (np.abs(q) > 1.0).any(axis=1).sum() > 20
    idx, d = native_grid_knn(pts, 12, q)
    jidx, jd = jgrid_knn(pts, 12, q)
    _equal((idx, d), (jidx, jd))
    np.testing.assert_allclose(d, _brute(pts, q, 12), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(((q[:, None] - pts[idx]) ** 2).sum(-1), d,
                               rtol=1e-5, atol=1e-6)


def test_grid_knn_rejects_other_shapes():
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        native_grid_knn(np.zeros((10, 2), np.float32), 4)
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        native_grid_knn(np.zeros((10, 3), np.float32), 4, np.zeros(3, np.float32))


def test_grid_knn_pads_past_n_points():
    pts = sphere_cloud(5, seed=7)[0]
    idx, d = native_grid_knn(pts, 8)
    jidx, jd = jgrid_knn(pts, 8)
    _equal((idx, d), (jidx, jd))
    assert (d[:, 5:] == np.float32(1e30)).all() and (idx[:, 5:] == 0).all()
    np.testing.assert_allclose(d[:, :5], _brute(pts, pts, 5), atol=1e-6)
    assert sorted(idx[0, :5]) == list(range(5))


def test_grid_knn_ties_keep_the_reference_s_order():
    """On an integer grid the 8th neighbour is one of 12 points tied at
    distance 2. ``grid_knn`` keeps the one its cell order meets first, as the
    reference's does, which is not always the lowest index that
    ``jax.lax.top_k`` would keep; the distances are exact."""
    g = np.arange(6, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = np.ascontiguousarray(pts[np.random.default_rng(8).permutation(len(pts))])
    idx, d = native_grid_knn(pts, 8)
    jidx, jd = jgrid_knn(pts, 8)
    _equal((idx, d), (jidx, jd))
    dm = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(d, np.sort(dm, 1)[:, :8])
    lowest = np.argsort(dm, axis=1, kind="stable")[:, :8]
    assert (np.sort(idx, 1) != np.sort(lowest, 1)).any()


def test_the_smoke_phase_on_the_cpu(tmp_path):
    """chip_smoke's ``native`` checks at a small size on the CPU: the
    parsers agree on an icosphere with normals, and ``knn`` and
    ``knn_grid`` agree with the grid oracle."""
    import chip_smoke as cs

    parse = cs.check_native_parse(str(tmp_path), subdiv=3)
    assert parse["equal"] and parse["faces"] == 1280 and parse["vertices"] == 642
    rec = cs.check_native_knn(n=4096, device="cpu")
    for name in ("knn", "knn_grid"):
        assert rec[name]["wrong_clear_indices"] == 0
        assert rec[name]["max_err_over_bound"] <= 1.0
        assert rec[name]["clear_share"] > 0.5


@pytest.mark.parametrize("wrong", ["distances_short", "swapped"])
def test_the_smoke_oracle_refuses_a_wrong_knn(wrong):
    """A kNN whose distances are 1% short, or that swaps two clearly
    separated neighbours of every seventh point, ends the run."""
    import chip_smoke as cs
    from ngpd_tpu_torch.ops.knn import knn

    def stand_in(pts, k):
        nbh, d = knn(pts, k)
        if wrong == "distances_short":
            return nbh, d * 0.99
        idx = nbh.idx.clone()
        idx[::7, [1, 2]] = idx[::7, [2, 1]]
        return nbh._replace(idx=idx), d

    with pytest.raises(SystemExit):
        cs.check_native_knn(n=4096, device="cpu", knn_fn=stand_in)
