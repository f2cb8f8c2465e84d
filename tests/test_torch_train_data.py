"""The port's training data (``learn/dataset.py``, ``meshproc/collector.py``,
``io/matpatch.py``, ``io/h5paths.py``) against ngpd_tpu on the CPU.

``process_cloud`` is fed the reference's own noise draws (``jax.random``'s
normal and permutation of ``generate_noise``'s two keys), on a surface
sample of a box and on a cube corner (a third of its points MD-flat, so the
balancing drops patches at a ratio of 0.05; a grid, whose kNN ties leave its frames to
tests/test_torch_point_patches.py). Its patches
inherit the point track's ill-conditioned frames (tests/test_torch_point_patches.py):
frames, node features (relative to the patch's largest |feature| where it
exceeds 1: the rotated coordinates reach ~1.5) and targets (where the
clean cloud's estimated normals agree to 1e-6) are held to 1e-5
where the patch's relative eigen gap exceeds 0.05 and to 5e-5 / gap
elsewhere, on the patches whose members' noisy normals (each package
estimates them) agree to 1e-6; neighbour
rows and masks equal where the patch kNN is clear. The balancing keeps the
patches whose MD class is not flat and a numpy-seeded share of the flat
ones: the MD class sits on eigenvalue thresholds, so a point near one may
flip between the packages; flips are counted and held under 2% of the
points. A flip changes the flat set, and the numpy draw of the flat share
then picks another subset; the port's kept rows are held to the rows the
reference's rule keeps on the port's classes, and equal to the
reference's where no point flips.

``generate_dataset`` draws its noise from a ``torch.Generator`` (other
numbers than ``jax.random``), so the shards' contents differ; without
balancing the manifest is the reference's, key for key, and each package
reads the other's shards with the same batch order for a seed. The
collector's shards are held on the same noisy OBJ: face indices, sources
and neighbour rows equal, features, targets and frames under the gap rule
of tests/test_torch_mesh_cascade.py (1e-5 where the relative gap exceeds
0.05, 2e-5 / gap elsewhere); its ``.mat`` archives are equal for equal
patches; ``h5paths`` equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from ngpd_tpu.config import PatchConfig as JPatchConfig
from ngpd_tpu.config import TrainConfig as JTrainConfig
from ngpd_tpu.core import patches as jpatches
from ngpd_tpu.core import voting as jvoting
from ngpd_tpu.io import h5paths as jh5
from ngpd_tpu.io import matpatch as jmat
from ngpd_tpu.io.obj import save_obj as jsave_obj
from ngpd_tpu.io.sampling import sample_mesh as jsample_mesh
from ngpd_tpu.learn import dataset as jds
from ngpd_tpu.meshproc import collector as jcol
from ngpd_tpu.meshproc.synthetic import box as jbox
from ngpd_tpu.meshproc.synthetic import icosphere
from ngpd_tpu.meshproc.trimesh import add_mesh_noise
from ngpd_tpu_torch.config import PatchConfig, TrainConfig
from ngpd_tpu_torch.core import patches as tpatches
from ngpd_tpu_torch.core import voting as tvoting
from ngpd_tpu_torch.io import h5paths as th5
from ngpd_tpu_torch.io import matpatch as tmat
from ngpd_tpu_torch.learn import dataset as tds
from ngpd_tpu_torch.meshproc import collector as tcol
from ngpd_tpu_torch.meshproc import patches as tmp_
from ngpd_tpu_torch.meshproc.trimesh import TriMesh, face_normals_areas_centroids

from fixtures import cube_corner, sphere_cloud

torch.set_num_threads(2)

SMALL = dict(num_nodes=32, patch_k=8)
CLEAR_GAP = 0.05
POINT_GAP_LAW = 5e-5  # tests/test_torch_point_patches.py
MESH_GAP_LAW = 2e-5  # tests/test_torch_mesh_cascade.py
FLIP_SHARE = 0.02


def _rel_gap(points, normals, cfg):
    nbh, mass, _ = tpatches.md_selection(torch.as_tensor(points), cfg)
    dec, _ = tvoting.md_transformation(torch.as_tensor(points), nbh, torch.as_tensor(normals),
                                       mass)
    ev = dec.eigval.double()
    gap = torch.minimum(ev[:, 1] - ev[:, 0], ev[:, 2] - ev[:, 1])
    return (gap / torch.clamp(ev[:, 2].abs(), min=1e-30)).numpy()


def _reference_draws(key, n):
    """generate_noise's own draws for ``key``."""
    k_gauss, k_perm = jax.random.split(key)
    return (torch.as_tensor(np.asarray(jax.random.normal(k_gauss, (n, 3), dtype=jnp.float32))),
            torch.as_tensor(np.asarray(jax.random.permutation(k_perm, n))))


def _box_sample():
    box = jbox(n=4)
    return np.asarray(jsample_mesh(np.asarray(box.v), np.asarray(box.f), 400, seed=3).points)


def _cube():
    """Three faces of a cube: a third of the points MD-flat, so the
    balancing drops some."""
    return cube_corner(10)[0]


@pytest.fixture(scope="module", params=[("box", 0.03, 0), ("box", 0.3, 1), ("cube", 0.03, 0)],
                ids=["box-gaussian", "box-impulsive", "cube-gaussian"])
def clouds(request):
    name, level, ntype = request.param
    pts = _box_sample() if name == "box" else _cube()
    key = jax.random.PRNGKey(11)
    cfg = PatchConfig(**SMALL)
    ref = jds.process_cloud(jnp.asarray(pts), key, level, ntype, JPatchConfig(**SMALL))
    port = tds.process_cloud(torch.as_tensor(pts), _reference_draws(key, len(pts)), level,
                             ntype, cfg, device="cpu")
    # The cube has 23 flat points beside 248 others (class 0 included): a lower
    # ratio makes the balancing drop some.
    ratio = 0.05 if name == "cube" else 1.5
    refb = jds.process_cloud(jnp.asarray(pts), key, level, ntype, JPatchConfig(**SMALL),
                             balance_ratio=ratio, balance_seed=4)
    portb = tds.process_cloud(torch.as_tensor(pts), _reference_draws(key, len(pts)), level,
                              ntype, cfg, balance_ratio=ratio, balance_seed=4, device="cpu")
    return dict(name=name, pts=pts, key=key, level=level, ntype=ntype, ref=ref, port=port,
                refb=refb, portb=portb, ratio=ratio)


def _noisy_of(c):
    """The noisy cloud and its normals, as process_cloud builds them (the
    reference's functions)."""
    pts = jnp.asarray(c["pts"])
    gt_n = jds._estimate_normals(pts)
    from ngpd_tpu.core import noise as jnoise
    from ngpd_tpu.ops import metrics as jmetrics
    import importlib

    jknn = importlib.import_module("ngpd_tpu.ops.knn")
    nbh6, _ = jknn.knn(pts, 6)
    noisy = jnoise.generate_noise(c["key"], pts, gt_n, c["level"],
                                  jmetrics.average_edge_length(pts, nbh6), noise_type=c["ntype"])
    return np.asarray(noisy), np.asarray(jds._estimate_normals(noisy))


def test_process_cloud_without_balancing_matches(clouds):
    c = clouds
    ref, port = c["ref"], c["port"]
    assert set(port) == set(ref) == set(tds.KEYS)
    for k in tds.KEYS:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, k
    if c["name"] == "cube":  # a grid: its kNN ties leave frames to the tests below
        return
    noisy, noisy_n = _noisy_of(c)
    gap = _rel_gap(noisy, noisy_n, PatchConfig(**SMALL))
    # Each package estimates the noisy cloud's normals itself, and the PVT
    # normal is ill-conditioned where a box's edge crosses its neighbourhood:
    # patches are compared where every member's normal agrees to 1e-6.
    from ngpd_tpu_torch.core.normals import estimated_normals

    dn = np.abs(estimated_normals(torch.as_tensor(noisy)).numpy() - noisy_n).max(axis=1)
    nbh = tpatches.md_selection(torch.as_tensor(noisy), PatchConfig(**SMALL))[0]
    same_in = np.where(nbh.mask.numpy(), dn[nbh.idx.numpy()], 0.0).max(axis=1) <= 1e-6
    print("patches whose inputs agree", same_in.mean())
    assert same_in.mean() > 0.5
    clear = (gap > CLEAR_GAP) & same_in
    gap = np.where(same_in, gap, 0.0)
    d_r = np.abs(port["r_inv"] - ref["r_inv"]).max(axis=(1, 2))
    # Rotated coordinates reach beyond 1: relative to the patch's largest.
    d_x = (np.abs(port["x"] - ref["x"]).max(axis=(1, 2))
           / np.maximum(np.abs(ref["x"]).max(axis=(1, 2)), 1.0))
    # y = gt_n @ R_inv: the clean cloud's estimated normals carry their own
    # conditioning (a box's edges), so y is held where those agree to 1e-6.
    gt_j = np.asarray(jds._estimate_normals(jnp.asarray(c["pts"])))
    gt_same = np.abs(estimated_normals(torch.as_tensor(c["pts"])).numpy() - gt_j).max(1) <= 1e-6
    d_y = np.where(gt_same, np.abs(port["y"] - ref["y"]).max(axis=1), 0.0)
    assert gt_same.mean() > 0.8
    for d in (d_r, d_x, d_y):
        assert d[clear].max() <= 1e-5 and (d * gap).max() <= POINT_GAP_LAW
    np.testing.assert_array_equal(port["node_mask"], ref["node_mask"])
    same = (port["nbr_idx"] == ref["nbr_idx"]).all(axis=(1, 2))
    assert same[clear].mean() > 0.95


def _kept(md, seed, ratio=1.5):
    """The balancing's kept points for MD classes ``md``."""
    feature_idx = np.where(md != 1)[0]
    flat_idx = np.where(md == 1)[0]
    n_keep = min(len(flat_idx), int(ratio * max(len(feature_idx), 1)))
    kept = np.concatenate([feature_idx, np.random.default_rng(seed).permutation(flat_idx)[:n_keep]])
    return np.sort(kept)


def test_balancing_keeps_the_reference_s_patches(clouds):
    c = clouds
    noisy, noisy_n = _noisy_of(c)
    jnbh, jmass, _ = jpatches.md_selection(jnp.asarray(noisy), JPatchConfig(**SMALL))
    jmd = np.asarray(jvoting.md_features(jvoting.md_transformation(
        jnp.asarray(noisy), jnbh, jnp.asarray(noisy_n), jmass)[0]))
    tnbh, tmass, _ = tpatches.md_selection(torch.as_tensor(noisy), PatchConfig(**SMALL))
    tmd = tvoting.md_features(tvoting.md_transformation(
        torch.as_tensor(noisy), tnbh, torch.as_tensor(noisy_n), tmass)[0]).numpy()
    flips = int((jmd != tmd).sum())
    print("MD class flips", flips, "of", len(jmd))
    assert flips <= FLIP_SHARE * len(jmd)
    kj, kt = _kept(jmd, 4, c["ratio"]), _kept(tmd, 4, c["ratio"])
    assert len(c["refb"]["y"]) == len(kj) and len(c["portb"]["y"]) == len(kt)
    # The port's balanced rows are its unbalanced rows at its kept points.
    for k in tds.KEYS:
        np.testing.assert_array_equal(c["portb"][k], c["port"][k][kt], err_msg=k)
    if flips == 0:
        np.testing.assert_array_equal(kt, kj)
    # A flip moves a point in or out of the flat set, and the numpy draw of
    # the flat share then picks another subset: the non-flat sets differ by
    # the flipped points only.
    flipped = np.where(jmd != tmd)[0]
    assert np.isin(np.setxor1d(np.where(tmd != 1)[0], np.where(jmd != 1)[0]), flipped).all()
    if c["name"] == "cube":
        assert 0 < len(kt) < len(c["pts"])  # the balancing drops flat patches


def _write_clouds(tmp_path, n=2):
    paths = []
    for i in range(n):
        pts, nrm = sphere_cloud(90 + 10 * i, seed=i)
        jsave_obj(str(tmp_path / f"c{i}.obj"), pts, nrm)
        paths.append(str(tmp_path / f"c{i}.obj"))
    return paths


SMALL_TRAIN = dict(gaussian_noise_levels=(0.01, 0.02), impulsive_noise_levels=(0.03,))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ds")
    raws = _write_clouds(tmp)
    jm = jds.generate_dataset(raws, tmp / "j", JTrainConfig(**SMALL_TRAIN), JPatchConfig(**SMALL),
                              balance=False)
    tm = tds.generate_dataset(raws, tmp / "t", TrainConfig(**SMALL_TRAIN), PatchConfig(**SMALL),
                              balance=False, device="cpu")
    return tmp, jm, tm


def test_manifest_is_the_reference_s(datasets):
    tmp, jm, tm = datasets
    assert tm == jm
    assert (json.loads((tmp / "t" / "manifest.json").read_text())
            == json.loads((tmp / "j" / "manifest.json").read_text()))
    for s in tm["shards"]:
        a, b = np.load(tmp / "t" / s["file"]), np.load(tmp / "j" / s["file"])
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


@pytest.mark.parametrize("writer", ["t", "j"])
def test_each_package_reads_the_other_s_shards(datasets, writer):
    tmp, _, _ = datasets
    for split, seed in (("train", 0), ("val", 1)):
        jd = jds.PatchDataset(tmp / writer, split)
        td = tds.PatchDataset(tmp / writer, split, device="cpu")
        assert len(td) == len(jd) > 0
        jb = list(jd.batches(16, seed=seed))
        tb = list(td.batches(16, seed=seed))
        assert len(tb) == len(jb) == len(td) // 16
        for a, b in zip(tb, jb):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=k)
        assert td.batches(16, seed=seed).__next__()["nbr_idx"].dtype == torch.int64


def test_patch_dataset_unstaged_batches_are_the_staged_ones(datasets, monkeypatch):
    tmp, _, _ = datasets
    staged = list(tds.PatchDataset(tmp / "t", "train", device="cpu").batches(16, seed=3,
                                                                          drop_remainder=False))
    monkeypatch.setattr(tds.PatchDataset, "DEVICE_STAGE_BYTES", 0)
    plain = list(tds.PatchDataset(tmp / "t", "train", device="cpu").batches(
        16, seed=3, drop_remainder=False))
    assert len(plain) == len(staged)
    for a, b in zip(plain, staged):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """A clean icosphere(2) and a noisy copy under the collector's folder
    convention, written by the reference."""
    tmp = tmp_path_factory.mktemp("mesh")
    clean = icosphere(2)
    noisy = add_mesh_noise(clean, jax.random.PRNGKey(3), 0.3)
    (tmp / "Noise").mkdir()
    jsave_obj(str(tmp / "ico.obj"), np.asarray(clean.v), faces=np.asarray(clean.f))
    jsave_obj(str(tmp / "Noise" / "ico_3.obj"), np.asarray(noisy.v), faces=np.asarray(noisy.f))
    return tmp


def test_clean_twin_path_matches(meshes):
    p = meshes / "Noise" / "ico_3.obj"
    assert tcol.clean_twin_path(p) == jcol.clean_twin_path(p) == meshes / "ico.obj"
    with pytest.raises(ValueError):
        tcol.clean_twin_path(meshes / "plain.obj")


def _mesh_gap(noisy_path):
    mesh = tcol.load_mesh(noisy_path)
    import ngpd_tpu_torch.meshproc.gcn_denoiser as tgd

    pre = tgd.centroid_knn(mesh, 64)
    patches = tmp_.extract_mesh_patches(mesh, pre_nbh=pre, device="cpu")
    normals, areas, centroids = face_normals_areas_centroids(mesh.v, mesh.f)
    radius = torch.sqrt(areas * 16.0)
    dv = (centroids[pre[0]] - centroids[:, None, :]) / radius[:, None, None]
    t = tmp_.voting_tensor(dv, normals[pre[0]], areas[pre[0]], patches.node_mask)
    ev = torch.linalg.eigvalsh(t.double())
    return (torch.minimum(ev[:, 1] - ev[:, 0], ev[:, 2] - ev[:, 1]) / ev[:, 2]).numpy()


@pytest.mark.parametrize("bucketed,crease_boost", [(False, 0.0), (True, 2.0)])
def test_collector_shard_matches(meshes, tmp_path, bucketed, crease_boost):
    noisy = meshes / "Noise" / "ico_3.obj"
    gt = meshes / "ico.obj" if crease_boost else None
    kw = dict(max_patches=60, seed=5, bucketed=bucketed, crease_boost=crease_boost)
    jp = jcol.collect_patch_shard(noisy, tmp_path / "j.npz", gt_path=gt, **kw)
    tp = tcol.collect_patch_shard(noisy, tmp_path / "t.npz", gt_path=gt, device="cpu", **kw)
    a, b = np.load(tp), np.load(jp)
    assert set(a.files) == set(b.files) == {"x", "y", "rot", "face_index", "source"}
    np.testing.assert_array_equal(a["face_index"], b["face_index"])
    assert str(a["source"]) == str(b["source"])
    np.testing.assert_array_equal(a["x"][:, 17:20], b["x"][:, 17:20])
    gap = _mesh_gap(noisy)[a["face_index"]]
    clear = gap > CLEAR_GAP
    d_x = np.abs(a["x"][:, :17] - b["x"][:, :17]).max(axis=(1, 2))
    d_r = np.abs(a["rot"] - b["rot"]).max(axis=(1, 2))
    d_y = np.abs(a["y"] - b["y"]).max(axis=1)
    for d in (d_x, d_r, d_y):
        assert d[clear].max() <= 1e-5 and (d * gap).max() <= MESH_GAP_LAW


def test_crease_mask_and_mat_archive_match(meshes, tmp_path):
    from ngpd_tpu.meshproc.synthetic import box as jbox
    from ngpd_tpu_torch.meshproc.synthetic import box as tbox

    jb, tb = jbox(n=4), tbox(n=4)
    np.testing.assert_array_equal(tcol.crease_face_mask(tb), jcol.crease_face_mask(jb))
    assert tcol.crease_face_mask(tb).any()
    noisy = meshes / "Noise" / "ico_3.obj"
    batch = jcol.collect_patches(noisy)
    faces = np.array([0, 7, 100])
    jpaths = jcol.save_patch_archive(noisy, batch, faces, out_dir=tmp_path / "j")
    tbatch = tmp_.MeshPatchBatch(*(torch.as_tensor(np.asarray(v)) for v in batch))
    tpaths = tcol.save_patch_archive(noisy, tbatch, faces, out_dir=tmp_path / "t")
    assert [p.split("/")[-1] for p in tpaths] == [p.split("/")[-1] for p in jpaths]
    for tp, jp in zip(tpaths, jpaths):
        a, b = sio.loadmat(tp), sio.loadmat(jp)
        for k in ("MAT", "FEA", "GT", "ROT"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(tmat.load_mat_patch(tp)["x"], jmat.load_mat_patch(jp)["x"])


def test_build_mesh_dataset_follows_the_conventions(meshes, tmp_path):
    """The port's noise stage writes the reference's file names; given the
    same noisy meshes the shards have the reference's names and faces."""
    import shutil

    work = tmp_path / "w"
    work.mkdir()
    shutil.copy(meshes / "ico.obj", work / "ico.obj")
    shards = tcol.build_mesh_dataset([work / "ico.obj"], tmp_path / "shards", levels=(0.1, 0.2),
                                     max_patches_per_mesh=20, device="cpu")
    assert sorted(p.name for p in (work / "Noise").iterdir()) == ["ico_1.obj", "ico_2.obj"]
    assert [p.split("/")[-1] for p in shards] == ["ico_1.npz", "ico_2.npz"]
    noisy = [meshes / "Noise" / "ico_3.obj"]
    kw = dict(max_patches_per_mesh=25, seed=2, noisy_meshes=noisy)
    t = tcol.build_mesh_dataset([meshes / "ico.obj"], tmp_path / "t", device="cpu", **kw)
    j = jcol.build_mesh_dataset([meshes / "ico.obj"], tmp_path / "j", **kw)
    np.testing.assert_array_equal(np.load(t[0])["face_index"], np.load(j[0])["face_index"])


def test_h5paths_match(tmp_path):
    pytest.importorskip("h5py")
    paths = [f"./data/m{i}/{i}_{j}.mat" for i in range(3) for j in range(5)]
    th5.save_path_list(tmp_path / "t.h5", paths)
    jh5.save_path_list(tmp_path / "j.h5", paths)
    assert list(jh5.load_path_list(tmp_path / "t.h5")) == paths
    assert list(th5.load_path_list(tmp_path / "j.h5")) == paths
    np.testing.assert_array_equal(th5.make_split(1000, 0.2, 64, seed=3),
                                  jh5.make_split(1000, 0.2, 64, seed=3))
    split = th5.make_split(len(paths), 0.4, 4, seed=1)
    for a, b in zip(th5.split_paths(np.array(paths), split),
                    jh5.split_paths(np.array(paths), split)):
        np.testing.assert_array_equal(a, b)
    for i in range(2):
        (tmp_path / f"f{i}").mkdir()
        for j in range(4):
            jmat.save_mat_patch(tmp_path / f"f{i}" / f"{j}.mat", np.eye(5), np.ones((5, 17)),
                                np.array([0, 0, 1.0]))
    folders = [tmp_path / "f0", tmp_path / "f1"]
    np.testing.assert_array_equal(th5.scan_mat_folders(folders, 3, seed=2),
                                  jh5.scan_mat_folders(folders, 3, seed=2))
    tb = th5.load_patch_batch(th5.scan_mat_folders(folders))
    jb = jh5.load_patch_batch(jh5.scan_mat_folders(folders))
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
