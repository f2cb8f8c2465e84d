"""The contract the kNN kernel (``ngpd_tpu_torch/kernels/csrc/knn.cu``)
has to meet, pinned where no card exists.

On CUDA tensors ``ops/knn.py::knn`` and ``::nn_distances`` launch the
kernel once a call; on CPU tensors they run the plain tile loop,
``knn_plain``, which the card tests and ``chip_smoke.py`` hold the kernel
to with ``torch.equal``. The kernel tiles the points and queries unlike
the loop, so the loop's result must not depend on its tiles: here it
equals a one-shot selection, a stable sort of the whole int64 key block
(distance bits above the point index), at tiles of 1, 7, 64 and 2,048.
The same cases go through ``ngpd_tpu`` at ``tests/test_torch_knn.py``'s
tolerances (distances to 1e-6, indices where the gap to the neighbouring
slots is clear; everywhere on an integer lattice, where the two sides'
distances are exact). ``chip_smoke``'s ``knn_kernel`` check must refuse a
kNN that breaks ties by the higher index and one that drops
``num_valid``.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from ngpd_tpu_torch import bench
from ngpd_tpu_torch.kernels import build
from ngpd_tpu_torch.kernels import knn as kknn
from ngpd_tpu_torch.ops import knn as tknn

jknn = importlib.import_module("ngpd_tpu.ops.knn")  # ngpd_tpu.ops.knn is the function

torch.set_num_threads(2)

D_TOL = 1e-6  # tests/test_torch_knn.py: an ulp of the largest term on unit-scale clouds
INF = float("inf")


def _cloud(n, seed=0, dup=0.2):
    """Gaussian points, the last ``dup`` share copies of earlier ones."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    m = int(n * dup)
    if m:
        pts[n - m:] = pts[rng.integers(0, n - m, m)]
    return pts


def _lattice(side):
    g = np.arange(side, dtype=np.float32)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)


def _cases(n):
    """(name, points, k, queries, exclude_self, num_valid, exact): every k
    the callers pass and one past the largest register variant, the masks,
    separate queries, exact ties, duplicated points, k past the valid
    count."""
    pts = _cloud(n)
    side = round(n ** (1 / 3))
    q = _cloud(n // 3, seed=1, dup=0.0)
    return [
        ("k1", pts, 1, None, False, None, False),
        ("k6_exclude_self", pts, 6, None, True, None, False),
        ("k12_num_valid_queries", pts, 12, q, False, n - 17, False),
        ("k16_lattice_ties", _lattice(side), 16, None, True, None, True),
        ("k16_lattice_num_valid", _lattice(side), 16, None, False, side**3 - 5, True),
        ("k64_duplicates", pts, 64, None, False, None, False),
        ("k130_row_variant", pts, 130, None, True, n - 3, False),
        ("k_past_valid", pts, 16, q, False, 5, False),
    ]


CASE_NAMES = [c[0] for c in _cases(150)]


def _one_shot(points, k, queries=None, exclude_self=False, num_valid=None):
    """The selection with no tiles: the whole (nq, n) block's int64 keys,
    distance bits above the point index, stably sorted; slots past the
    points hold (inf, 0)."""
    p = torch.as_tensor(points)
    q = p if queries is None else torch.as_tensor(queries)
    n, nq = p.shape[0], q.shape[0]
    d = tknn.pairwise_sqdist(q, p)
    cols = torch.arange(n)
    d = torch.where(cols[None, :] >= (n if num_valid is None else num_valid), INF, d)
    if exclude_self:
        d = torch.where(cols[None, :] == torch.arange(nq)[:, None], INF, d)
    key = ((d + 0.0).view(torch.int32).to(torch.int64) << 32) | cols[None, :]
    pos = torch.sort(key, dim=1, stable=True).indices[:, :k]
    dk = torch.full((nq, k), INF)
    ik = torch.zeros((nq, k), dtype=torch.int64)
    dk[:, : pos.shape[1]] = torch.gather(d, 1, pos)
    ik[:, : pos.shape[1]] = pos
    return tknn._finish(dk, ik)


def _equal(a, b):
    (na, da), (nb, db) = a, b
    return (torch.equal(da, db) and torch.equal(na.idx, nb.idx)
            and torch.equal(na.mask, nb.mask))


# Every tile size on both axes; a tile of one point (or one query) runs
# against the other axis untiled or at 7.
TILES = [(1, 2048), (2048, 1), (7, 7), (7, 64), (64, 7), (64, 64), (2048, 2048), (1, 7)]


@pytest.mark.parametrize("point_tile,query_tile", TILES)
def test_the_plain_loop_is_the_one_shot_selection(point_tile, query_tile):
    """The running top-k over tiles keeps exactly the (distance bits,
    index) order of one stable sort of the whole key block, whatever the
    tiles: the kernel, which tiles otherwise, is held to the same bits."""
    for name, pts, k, q, ex, nv, _ in _cases(150):
        got = tknn.knn_plain(torch.as_tensor(pts), k,
                             None if q is None else torch.as_tensor(q), exclude_self=ex,
                             num_valid=nv, point_tile=point_tile, query_tile=query_tile)
        assert _equal(got, _one_shot(pts, k, q, ex, nv)), name


def test_the_lattice_has_ties_and_short_rows():
    """The cases reach what they are for: equal distances inside the kept
    k and across its edge, and masked slots where k passes the valid
    count."""
    cases = {c[0]: c for c in _cases(150)}
    _, pts, k, q, ex, nv, _ = cases["k16_lattice_ties"]
    nbh, d = _one_shot(pts, k + 1, q, ex, nv)
    assert (d[:, 1:] == d[:, :-1]).float().mean() > 0.5
    assert bool((d[:, k] == d[:, k - 1]).any())  # a tie across the k-th slot
    _, pts, k, q, ex, nv, _ = cases["k_past_valid"]
    nbh, d = tknn.knn(torch.as_tensor(pts), k, torch.as_tensor(q), num_valid=nv)
    assert nbh.mask[:, :nv].all() and not nbh.mask[:, nv:].any()
    assert torch.isinf(d[:, nv:]).all() and (nbh.idx[:, nv:] == 0).all()


def _against_reference(name, pts, k, q, ex, nv, exact):
    jq = None if q is None else jnp.asarray(q)
    jn, jd = jknn.knn(jnp.asarray(pts), k, jq, exclude_self=ex,
                      num_valid=None if nv is None else jnp.asarray(nv))
    tn, td = tknn.knn(torch.as_tensor(pts), k, None if q is None else torch.as_tensor(q),
                      exclude_self=ex, num_valid=nv)
    jd, td_np = np.asarray(jd), td.numpy()
    ji, ti = np.asarray(jn.idx), tn.idx.numpy()
    np.testing.assert_array_equal(np.asarray(jn.mask), tn.mask.numpy(), err_msg=name)
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(finite, np.isfinite(td_np), err_msg=name)
    if exact:
        np.testing.assert_array_equal(td_np, jd, err_msg=name)
        np.testing.assert_array_equal(ti, ji, err_msg=name)
        return
    np.testing.assert_allclose(td_np[finite], jd[finite], atol=D_TOL, rtol=0, err_msg=name)
    gap = np.diff(np.where(finite, jd, 1e30), axis=1) > 4 * D_TOL
    clear = finite.copy()
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    np.testing.assert_array_equal(ti[clear], ji[clear], err_msg=name)
    assert clear.sum() > 0.5 * finite.sum() or not finite.any(), name


@pytest.mark.parametrize("name", CASE_NAMES)
def test_the_cases_match_the_reference(name):
    """Each case through ``knn`` on the CPU against ``ngpd_tpu.ops.knn.knn``
    at 1,000-1,728 points."""
    case = {c[0]: c for c in _cases(1200)}[name]
    _against_reference(*case)


def test_nn_distances_matches_the_reference():
    a, b = _cloud(600, seed=3, dup=0.0), _cloud(2048, seed=4)
    jd, ji = jknn.nn_distances(jnp.asarray(a), jnp.asarray(b), num_valid_b=jnp.asarray(2000))
    td, ti = tknn.nn_distances(torch.as_tensor(a), torch.as_tensor(b), num_valid_b=2000)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=D_TOL, rtol=0)
    assert np.mean(ti.numpy() == np.asarray(ji)) > 0.99
    assert int(ti.max()) < 2000
    # The plain selection of k 1 is knn_plain's, at nn_distances' tiles.
    nbh, d = tknn.knn_plain(torch.as_tensor(b), 1, torch.as_tensor(a), num_valid=2000,
                            point_tile=16384, query_tile=2048)
    assert torch.equal(d[:, 0], td) and torch.equal(nbh.idx[:, 0], ti)


def _params(src, fn):
    sig = src[src.index(f'extern "C" int {fn}('):]
    return sig[sig.index("(") + 1 : sig.index(")")].split(",")


def test_the_launch_arguments_match_the_kernel_source():
    """One ctypes type per parameter of ``ngpd_knn_launch`` and of the
    boxes' and the split path's C functions; the wrapper's variants, block
    shapes and shared-memory sizes are the source's (``knn_dispatch``, each
    warp's static chunk and done bytes, and ``knn_buf_bytes``): a register list of 1, 8 or 16 keys up to k 16, a
    row in device memory above, and no row kernel."""
    src = (build.CSRC / "knn.cu").read_text()
    entries = {"ngpd_knn_launch": build.ARGTYPES["knn"], **build.ENTRY_ARGTYPES["knn"]}
    assert set(entries) == {"ngpd_knn_launch", "ngpd_knn_boxes_launch",
                            "ngpd_knn_caps_launch", "ngpd_knn_split_launch",
                            "ngpd_knn_merge_launch", "ngpd_knn_slices"}
    for fn, argtypes in entries.items():
        params = _params(src, fn)
        assert len(params) == len(argtypes), fn
        for text, ctype in zip(params, argtypes):
            want = build._VP if "*" in text else build._F if "float" in text else build._I
            assert ctype is want, (fn, text)
    assert "knn_row_kernel" not in src and "RegisterList" not in src
    launched = set(re.findall(r"fn\(knn_kernel<(\w+), (\w+), (\d+)>\)", src))
    assert launched == {("KNN_T1", "KNN_Q1", "1"), ("KNN_TS", "KNN_QS", "8"),
                        ("KNN_TS", "KNN_QS", "16"), ("KNN_TL", "KNN_QL", "0")}
    assert "NGPD_KNN" not in src  # constants, no compile switches
    # Each shared buffer is declared with the type it holds.
    assert "__shared__ float4 chunk[T / 32][KNN_CHUNK];" in src
    assert "extern __shared__ Key knn_buf[];" in src
    for name, value in (("T1", kknn.BLOCKS["one"][0]), ("Q1", kknn.BLOCKS["one"][1]),
                        ("TS", kknn.BLOCKS["small"][0]), ("QS", kknn.BLOCKS["small"][1]),
                        ("TL", kknn.BLOCKS["large"][0]), ("QL", kknn.BLOCKS["large"][1]),
                        ("TILE", kknn.TILE), ("BUF", kknn.BUF)):
        assert f"KNN_{name} = {value};" in src, name
    assert f"KNN_SMALL_K = {kknn.SMALL_K};" in src
    assert f"KNN_MAX_SLICES = {kknn.MAX_SLICES};" in src
    assert "KNN_MIN_SLICE = 8 * KNN_TILE;" in src and kknn.MIN_SLICE == 8 * kknn.TILE
    # The skip: the box kernel's name falls in the benchmark's kNN group, and
    # the margin and the overflow guard are the plain version's.
    assert "knn_kernel_boxes(" in src and "KNN_HOME_MIN" not in src
    assert f"KNN_ULPS = {kknn.ULPS!r}f;" in src and kknn.ULPS == 16 * 2.0**-24
    assert f"KNN_TINY = {kknn.TINY!r}f;" in src
    assert "__int_as_float(0x7e800000)" in src and kknn.TOP == 2.0**126
    assert "knn_sq_norm(gx, gy, gz), 0.99999f" in src
    assert f"KNN_CHUNK = {kknn.CHUNK};" in src
    assert [kknn.variant(k) for k in (1, 2, 8, 9, 16, 17, 64, 65, 128, 1000)] == \
        [(64, 4, 1), (128, 1, 8), (128, 1, 8), (128, 1, 16), (128, 1, 16)] + [(64, 1, 0)] * 5
    assert [kknn.smem_bytes(k) for k in (1, 8, 16, 17, 300)] == \
        [4096, 8192, 8192, 4096 + 64 * 32 * 8, 4096 + 64 * 32 * 8]
    assert f"KNN_MARKED = {kknn.MARKED};" in src
    for word in ("mma", "wgmma", "TF32"):  # the header says why they are not used
        assert word in src
    assert "__fmul_rn" in src and "-fmad=false" in " ".join(build.NVCC_FLAGS)


def _small_cases():
    return cs.knn_kernel_cases(n=2048, mesh_subdiv=2, nn_points=4096, nn_queries=512,
                               lattice_side=10, dense_n=1024, split_queries=64)


def test_the_smoke_check_passes_the_plain_version():
    rec = cs.check_knn_kernel(device="cpu", cases=_small_cases())
    variants = {r["case"]: r["variant"][2] for r in rec["cases"]}
    assert variants == {
        "cloud": 16, "cloud_exclude_self": 16, "cloud_num_valid": 16, "roof_k64": 0,
        "mesh_centroids": 0, "chamfer_gate": 1, "nn_whole_cloud": 1, "split": 16,
        "dense_k6": 8, "dense_k8": 8, "dense_k16": 16, "dense_k6_exclude_self": 8,
        "dense_k24_exclude_self": 0, "lattice_ties": 16, "separate_queries": 16,
        "k_past_valid": 16, "k65": 0, "k128": 0, "dense_shuffled": 8, "dense_far": 8,
        "dense_nonfinite": 8}
    assert set(variants.values()) == {0, 1, 8, 16}  # every variant
    assert all(r["equal"] and r["max_abs_err"] == 0.0 for r in rec["cases"])
    gate = rec["cases"][5]
    assert (gate["n"], gate["queries"]) == (512, 512)  # the gate's subsample on both sides
    split = rec["cases"][7]
    assert (split["n"], split["queries"], split["k"]) == (4096, 64, 16)


def _higher_index_ties(points, k, queries=None, *, exclude_self=False, num_valid=None):
    """A kNN whose equal distances keep the higher index."""
    n = points.shape[0]
    q = points if queries is None else queries
    d = tknn.pairwise_sqdist(q, points)
    cols = torch.arange(n)
    d = torch.where(cols[None, :] >= (n if num_valid is None else num_valid), INF, d)
    if exclude_self:
        d = torch.where(cols[None, :] == torch.arange(q.shape[0])[:, None], INF, d)
    pos = n - 1 - torch.sort(d.flip(1), dim=1, stable=True).indices[:, :k]
    return tknn._finish(torch.gather(d, 1, pos), pos)


def _without_num_valid(points, k, queries=None, *, num_valid=None, **kw):
    return tknn.knn_plain(points, k, queries, **kw)


@pytest.mark.parametrize("wrong", [_higher_index_ties, _without_num_valid],
                         ids=["higher_index_ties", "drops_num_valid"])
def test_the_smoke_check_refuses_a_wrong_knn(wrong):
    with pytest.raises(SystemExit):
        cs.check_knn_kernel(device="cpu", knn_fn=wrong, cases=_small_cases())


# The split path: the kernel's slices write each query's sorted keys to a
# partial row and the merge keeps the k smallest. Its plain versions
# (kernels/knn.py::split_plain, ::merge_plain) are held to the tile loop on
# splits the kernel's rule would not choose: uneven slices, a slice with
# fewer valid points than k, +inf pads past num_valid, self at a slice
# border, exact ties across slices, and k past the register lists.
def _split_cases():
    pts, lat = _cloud(1500, seed=5), _lattice(12)
    return {
        "uneven_slices": (pts, 16, None, False, None, [(0, 100), (100, 1100), (1100, 1500)]),
        "slice_short_of_k": (pts, 16, None, False, None, [(0, 7), (7, 1500)]),
        "inf_pads_past_num_valid": (pts, 16, _cloud(300, seed=6, dup=0.0), False, 1490,
                                    kknn.slice_bounds(1490, 4)),
        "exclude_self_at_a_border": (pts, 8, None, True, None, [(0, 500), (500, 501),
                                                                (501, 1500)]),
        "lattice_ties": (lat, 16, None, True, None, kknn.slice_bounds(len(lat), 5)),
        "k65": (pts, 65, None, True, None, kknn.slice_bounds(1500, 3)),
        "k128": (pts, 128, None, False, 1400, kknn.slice_bounds(1400, 7)),
    }


SPLIT_NAMES = list(_split_cases())


def _split_and_merge(pts, k, q, ex, nv, bounds, cap=None):
    p = torch.as_tensor(pts)
    qt = None if q is None else torch.as_tensor(q)
    part = kknn.split_plain(p, k, qt, exclude_self=ex, num_valid=nv, bounds=bounds, cap=cap)
    return part, tknn._finish(*kknn.merge_plain(part))


@pytest.mark.parametrize("name", SPLIT_NAMES)
def test_the_keyed_merge_of_any_split_is_the_plain_loop(name):
    """Each slice's k smallest keys, merged by key, are the tile loop's
    result bit for bit: the union of the slices' k best holds the global k
    best, and keys are unique, so neither the split nor the order of the
    candidates matters."""
    pts, k, q, ex, nv, bounds = _split_cases()[name]
    part, got = _split_and_merge(pts, k, q, ex, nv, bounds)
    want = tknn.knn_plain(torch.as_tensor(pts), k, None if q is None else torch.as_tensor(q),
                          exclude_self=ex, num_valid=nv)
    assert _equal(got, want)
    assert part.shape == (len(bounds), len(pts) if q is None else len(q), k)
    # Each partial row is sorted, its empty slots last.
    key = torch.where(part == kknn.NONE, torch.iinfo(torch.int64).max, part)
    assert (key[..., 1:] >= key[..., :-1]).all()
    if name == "slice_short_of_k":
        assert (part[0, :, 7:] == kknn.NONE).all() and (part[0, :, :7] != kknn.NONE).all()


@pytest.mark.parametrize("name", SPLIT_NAMES)
def test_a_cap_from_any_k_points_changes_no_merge(name):
    """The kernel caps every slice by the k-th distance of a home tile; any
    k points give a cap at or above the true k-th, so the capped partial
    rows merge to the same result, while a cap below it loses neighbours."""
    pts, k, q, ex, nv, bounds = _split_cases()[name]
    p = torch.as_tensor(pts)
    qt = p if q is None else torch.as_tensor(q)
    nv_ = len(pts) if nv is None else nv
    home = kknn.split_plain(p, k, None if q is None else qt, exclude_self=ex, num_valid=nv,
                            bounds=[(nv_ - min(nv_, 4 * k), nv_)])[0]
    full = (home != kknn.NONE).all(dim=1)
    cap = torch.where(full, ((home[:, -1] >> 32).to(torch.int32)).view(torch.float32),
                      torch.finfo(torch.float32).max)
    _, got = _split_and_merge(pts, k, q, ex, nv, bounds, cap)
    _, want = _split_and_merge(pts, k, q, ex, nv, bounds)
    assert _equal(got, want)
    d_k = want[1][:, -1]
    _, short = _split_and_merge(pts, k, q, ex, nv, bounds, torch.nextafter(d_k, -d_k))
    assert not _equal(short, want)


@pytest.mark.parametrize("nv,s", [(1, 1), (7, 3), (100_000, 2), (100_000, 64), (32_768, 4),
                                  (1_000_000, 64)])
def test_the_kernel_slices_partition_the_points(nv, s):
    """ceil(tiles / s) whole tiles a slice, as knn_kernel cuts them, so that
    each slice's tiles are the boxed tiles: every point in exactly one
    slice, in index order; trailing slices may be empty."""
    bounds = kknn.slice_bounds(nv, s)
    assert len(bounds) == s and bounds[0][0] == 0 and bounds[-1][1] == nv
    assert all(a <= b and b == c for (a, b), (c, _) in zip(bounds, bounds[1:]))
    tiles = -(-nv // kknn.TILE)
    assert max(b - a for a, b in bounds) == min(nv, -(-tiles // s) * kknn.TILE)
    assert all(a % kknn.TILE == 0 for a, b in bounds if a < b)



# The skip (kernels/knn.py::tile_boxes_plain, ::needs_plain, ::scanned_plain;
# csrc/knn.cu::knn_needs). A warp takes a tile where one of its queries may
# take a point of the tile's box at its limit, and scans a chunk of it
# where one of its queries may take a point of the chunk's box. Every
# limit the kernel holds is at or above the query's final k-th distance
# (the largest finite float while its list has an empty slot), so the
# decision at the final k-th distances skips every tile and chunk the
# kernel can skip: if the full scan's k best lie in what is left, the
# kernel's result is the full scan's.
def _roof(n):
    return torch.as_tensor(bench.make_cloud(n)[0])


def _skip_cases():
    roof = _roof(2048)
    shuffled = roof[torch.randperm(len(roof), generator=torch.Generator().manual_seed(3))]
    nonfinite = roof.clone()
    nonfinite[::97] = float("nan")
    nonfinite[5::193] = 1e30  # |p|^2 overflows: every distance is inf
    nonfinite[1024:1536] = float("nan")  # a tile with no finite point
    outlier = roof.clone()
    outlier[700] = torch.tensor([40.0, -25.0, 9.0])
    return {
        "dense_roof": roof,
        "rows_shuffled": shuffled,
        "far_from_origin": roof + 1000.0,
        "lattice_ties": torch.as_tensor(_lattice(13)),
        "nan_and_overflow_rows": nonfinite,
        "far_outlier_in_a_tile": outlier,
    }


SKIP_NAMES = list(_skip_cases())


def _final_limits(points, k, exclude_self):
    nbh, d = tknn.knn_plain(points, k, exclude_self=exclude_self)
    lim = torch.where(nbh.mask[:, -1], d[:, -1], torch.finfo(torch.float32).max)
    return lim, (nbh, d)


def _scanned(points, k, lim):
    return kknn.scanned_plain(points, points, lim)


@pytest.mark.parametrize("k,exclude_self", [(8, False), (32, True)])
@pytest.mark.parametrize("name", SKIP_NAMES)
def test_no_skipped_tile_holds_a_kept_neighbour(name, k, exclude_self):
    """No tile or chunk a warp skips holds a neighbour the full scan keeps, and the k smallest keys of what is left are
    ``knn_plain``'s result bit for bit. The margin bounds every pair's
    rounding; the roof's index order lets most blocks skip, its shuffle
    none, and far from the origin the margin stops every skip."""
    points = _skip_cases()[name]
    n = len(points)
    lim, want = _final_limits(points, k, exclude_self)
    nbh, _ = want
    scanned = _scanned(points, k, lim)
    rows = torch.arange(n)[:, None].expand(-1, k)
    assert scanned[rows[nbh.mask], nbh.idx[nbh.mask]].all()

    # The keyed merge of what is left.
    d = tknn.pairwise_sqdist(points, points)
    ok = torch.isfinite(d) & scanned
    if exclude_self:
        ok &= ~torch.eye(n, dtype=torch.bool)
    key = ((d + 0.0).view(torch.int32).to(torch.int64) << 32) | torch.arange(n)[None, :]
    key = torch.where(ok, key, torch.iinfo(torch.int64).max)
    part = torch.sort(key, dim=1).values[:, :k]
    got = tknn._finish(*kknn.merge_plain(torch.where(
        part == torch.iinfo(torch.int64).max, kknn.NONE, part)[None]))
    assert _equal(got, want)

    # The margin holds every pair: |computed - exact| <= ULPS (|q|^2 + |p|^2) + TINY.
    p64 = points.double()
    exact = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    nn = (p64 * p64).sum(-1)
    finite = torch.isfinite(d) & torch.isfinite(exact)
    err = (d.double() - exact).abs()  # the clamp at 0 only moves toward exact
    assert (err <= kknn.ULPS * (nn[:, None] + nn[None, :]) + kknn.TINY)[finite].all()

    share = scanned.float().mean().item()
    roof = _scanned(_skip_cases()["dense_roof"], k, _final_limits(
        _skip_cases()["dense_roof"], k, exclude_self)[0]).float().mean().item()
    if name in ("dense_roof", "lattice_ties"):
        assert share < 0.6, share
    if name in ("rows_shuffled", "far_from_origin"):
        assert share == 1.0, share
    if name == "far_outlier_in_a_tile":  # its boxes, and its own block, skip little
        assert roof < share < 0.8, (roof, share)
    if name == "nan_and_overflow_rows":
        assert not scanned[:, 1024:1536].any() and share < 0.6


def test_a_limit_below_the_kth_distance_loses_neighbours():
    """The decision is tight enough to matter: at a quarter of each query's
    k-th distance some skipped chunk holds a kept neighbour, so the limits
    the kernel tests against must stay at or above the final k-th."""
    points = _skip_cases()["dense_roof"]
    k = 8
    lim, (nbh, _) = _final_limits(points, k, False)
    scanned = _scanned(points, k, lim * 0.25)
    rows = torch.arange(len(points))[:, None].expand(-1, k)
    assert not scanned[rows, nbh.idx].all()


def test_the_plain_boxes_cover_only_finite_points():
    """A box and its largest |p|^2 come from the points with a finite
    |p|^2, a tile's and each of its chunks'; a box with none holds -1 and
    no query needs it; a query with no finite |q|^2 needs no box."""
    points = _skip_cases()["nan_and_overflow_rows"]
    finite = torch.isfinite(points).all(1) & (points.abs().amax(1) < 1e19)
    for size in (kknn.TILE, kknn.CHUNK):
        lo, hi, pp = kknn.tile_boxes_plain(points, size=size)
        assert len(pp) == -(-len(points) // size)
        for t in range(len(pp)):
            rows = points[t * size:(t + 1) * size]
            ok = finite[t * size:(t + 1) * size]
            if not ok.any():
                assert pp[t] == -1 and torch.isinf(lo[t]).all() and torch.isinf(hi[t]).all()
                continue
            assert torch.equal(lo[t], rows[ok].amin(0)) and torch.equal(hi[t], rows[ok].amax(0))
        need = kknn.needs_plain(points, torch.full((len(points),), 1e30), lo, hi, pp)
        assert torch.equal(need, finite[:, None] & (pp >= 0)[None, :])
    assert int((pp == -1).sum()) == kknn.TILE // kknn.CHUNK  # the tile of NaN rows
