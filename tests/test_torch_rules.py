"""Rules of the port: it stands alone and never falls back to the CPU."""

import ast
import shutil
from pathlib import Path

import pytest
import torch

from ngpd_tpu_torch.core.cuda_fused import padded_size
from ngpd_tpu_torch.device import resolve_device
from ngpd_tpu_torch.config import DenoiseConfig
from ngpd_tpu_torch.kernels import build
from ngpd_tpu_torch.kernels import dense as kdense
from ngpd_tpu_torch.kernels import graph as kgraph
from ngpd_tpu_torch.kernels import hybrid as khy
from ngpd_tpu_torch.kernels import knn as kknn
from ngpd_tpu_torch.kernels import passes as kp
from ngpd_tpu_torch.kernels import window as kw

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ngpd_tpu", "bench")
PORT_FILES = sorted((ROOT / "ngpd_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_denoise_mesh_without_a_card_raises(tmp_path):
    """``denoise-mesh`` defaults to the card and does not carry on on the
    CPU without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the missing-card path cannot be observed")
    from ngpd_tpu_torch.apps import cli
    from ngpd_tpu_torch.io.obj import save_obj
    from ngpd_tpu_torch.meshproc.synthetic import icosphere

    mesh = icosphere(subdiv=1)
    save_obj(tmp_path / "in.obj", mesh.v.numpy(), faces=mesh.f.numpy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["denoise-mesh", str(tmp_path / "in.obj"), "-o", str(tmp_path / "out.obj")])
    assert not (tmp_path / "out.obj").exists()


def _mesh_entry_points():
    from ngpd_tpu_torch import bench
    from ngpd_tpu_torch.meshproc import autorecipe, filtering, gcn_denoiser, patches
    from ngpd_tpu_torch.meshproc.synthetic import icosphere
    from ngpd_tpu_torch.models.dgcnn import DGCNN

    mesh = icosphere(subdiv=1)
    normals = mesh.face_data()[0]
    return {"gcn_denoise_mesh": lambda: gcn_denoiser.gcn_denoise_mesh(mesh, DGCNN()),
            "predict_face_normals": lambda: gcn_denoiser.predict_face_normals(mesh, DGCNN()),
            "extract_mesh_patches": lambda: patches.extract_mesh_patches(mesh),
            "guided_normal_filter": lambda: filtering.guided_normal_filter(mesh, normals),
            "pick_recipe": lambda: autorecipe.pick_recipe(mesh),
            "run_mesh": lambda: bench.run_mesh(subdiv=1)}


@pytest.mark.parametrize("name", ["gcn_denoise_mesh", "predict_face_normals",
                                  "extract_mesh_patches", "guided_normal_filter",
                                  "pick_recipe", "run_mesh"])
def test_mesh_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the missing-card path cannot be observed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _mesh_entry_points()[name]()


def _point_entry_points():
    import numpy as np

    from ngpd_tpu_torch.core import noise, patches, process
    from ngpd_tpu_torch.learn import predict
    from ngpd_tpu_torch.models.patch2normal import init_patch2normal

    pts = torch.as_tensor(np.random.default_rng(0).random((80, 3), dtype=np.float32))
    nrm = torch.nn.functional.normalize(pts - 0.5, dim=1)
    return {"predict_cloud_normals": lambda: predict.predict_cloud_normals(
                init_patch2normal(), pts, nrm),
            "extract_patches": lambda: patches.extract_patches(pts, nrm),
            "preprocess_pointcloud": lambda: process.preprocess_pointcloud(
                noise.draw_noise(80, torch.Generator().manual_seed(0)), pts)}


@pytest.mark.parametrize("name", ["predict_cloud_normals", "extract_patches",
                                  "preprocess_pointcloud"])
def test_point_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the missing-card path cannot be observed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _point_entry_points()[name]()


@pytest.mark.parametrize("command", ["predict-normals", "add-noise"])
def test_point_cli_without_a_card_raises(tmp_path, command):
    """``predict-normals`` and ``add-noise`` default to the card and do not
    carry on on the CPU without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the missing-card path cannot be observed")
    import numpy as np

    from ngpd_tpu_torch.apps import cli
    from ngpd_tpu_torch.io.obj import save_obj

    save_obj(tmp_path / "in.obj", np.random.default_rng(0).random((80, 3), dtype=np.float32))
    out = tmp_path / ("out.xyz" if command == "predict-normals" else "out.obj")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([command, str(tmp_path / "in.obj"), "-o", str(out)])
    assert not out.exists()


def _training_entry_points(tmp_path):
    import numpy as np

    from ngpd_tpu_torch.core import noise
    from ngpd_tpu_torch.io.obj import save_obj
    from ngpd_tpu_torch.learn import dataset, train, train_dgcnn
    from ngpd_tpu_torch.meshproc import collector
    from ngpd_tpu_torch.meshproc.synthetic import icosphere

    mesh = icosphere(subdiv=1)
    save_obj(tmp_path / "m.obj", mesh.v.numpy(), faces=mesh.f.numpy())
    (tmp_path / "Noise").mkdir()
    save_obj(tmp_path / "Noise" / "m_3.obj", mesh.v.numpy(), faces=mesh.f.numpy())
    (tmp_path / "ds").mkdir()
    (tmp_path / "ds" / "manifest.json").write_text('{"shards": [], "train": [], "val": []}')
    np.savez(tmp_path / "s.npz", x=np.zeros((4, 20, 64), np.float32), y=np.zeros((4, 3), np.float32))
    pts = torch.as_tensor(np.random.default_rng(0).random((80, 3), dtype=np.float32))
    return {"init_model": lambda: train.init_model(),
            "init_dgcnn": lambda: train_dgcnn.init_dgcnn(emb_dims=64),
            "process_cloud": lambda: dataset.process_cloud(
                pts, noise.draw_noise(80, torch.Generator().manual_seed(0)), 0.01, 0),
            "generate_dataset": lambda: dataset.generate_dataset([tmp_path / "m.obj"],
                                                                 tmp_path / "out"),
            "PatchDataset": lambda: dataset.PatchDataset(tmp_path / "ds"),
            "ShardStore": lambda: train_dgcnn.ShardStore([str(tmp_path / "s.npz")]),
            "generate_noisy_meshes": lambda: collector.generate_noisy_meshes(
                tmp_path / "m.obj", (0.1,)),
            "collect_patches": lambda: collector.collect_patches(tmp_path / "Noise" / "m_3.obj"),
            "collect_patch_shard": lambda: collector.collect_patch_shard(
                tmp_path / "Noise" / "m_3.obj", tmp_path / "o.npz"),
            "build_mesh_dataset": lambda: collector.build_mesh_dataset([tmp_path / "m.obj"],
                                                                       tmp_path / "shards")}


@pytest.mark.parametrize("name", ["init_model", "init_dgcnn", "process_cloud",
                                  "generate_dataset", "PatchDataset", "ShardStore",
                                  "generate_noisy_meshes", "collect_patches",
                                  "collect_patch_shard", "build_mesh_dataset"])
def test_training_entry_points_default_to_the_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the missing-card path cannot be observed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _training_entry_points(tmp_path)[name]()
    assert not (tmp_path / "Noise" / "m_1.obj").exists()


@pytest.mark.parametrize("command", ["make-dataset", "train"])
def test_training_cli_without_a_card_raises(tmp_path, command):
    """``make-dataset`` and ``train`` default to the card and do not carry
    on on the CPU without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the missing-card path cannot be observed")
    from ngpd_tpu_torch.apps import cli
    from ngpd_tpu_torch.io.obj import save_obj
    import numpy as np

    save_obj(tmp_path / "in.obj", np.random.default_rng(0).random((80, 3), dtype=np.float32))
    (tmp_path / "ds").mkdir()
    (tmp_path / "ds" / "manifest.json").write_text('{"shards": [], "train": [], "val": []}')
    args = ([str(tmp_path / "in.obj"), "-o", str(tmp_path / "out")] if command == "make-dataset"
            else [str(tmp_path / "ds"), "-o", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([command, *args])
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def cpu_mesh(tmp_path_factory):
    """A gloo process group of one rank and its CPU mesh."""
    import torch.distributed as dist

    from ngpd_tpu_torch.parallel.mesh import init_group, make_mesh

    init_group(str(tmp_path_factory.mktemp("group") / "store"), 0, 1, device="cpu")
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _sharded_entry_points(mesh):
    from ngpd_tpu_torch.meshproc.gcn_denoiser import predict_face_normals
    from ngpd_tpu_torch.meshproc.synthetic import icosphere
    from ngpd_tpu_torch.models.dgcnn import DGCNN
    from ngpd_tpu_torch.parallel import halo, mesh as pmesh, sharded
    from ngpd_tpu_torch.parallel.fused_sharded import fused_denoise_sharded

    pts = torch.rand((256, 3), generator=torch.Generator().manual_seed(0))
    nrm = torch.nn.functional.normalize(pts - 0.5, dim=1)
    return {"make_mesh": lambda: pmesh.make_mesh(),
            "shard_points": lambda: pmesh.shard_points(pts, mesh),
            "knn_sharded": lambda: sharded.knn_sharded(pts, 4, mesh),
            "chamfer_distance_sharded": lambda: sharded.chamfer_distance_sharded(pts, pts, mesh),
            "denoise_sharded": lambda: sharded.denoise_sharded(pts, nrm, mesh),
            "fused_denoise_sharded": lambda: fused_denoise_sharded(pts, nrm, mesh, tile=64,
                                                                   window=64),
            "morton_sort_sharded": lambda: halo.morton_sort_sharded(pts, nrm, mesh),
            "fused_denoise_halo": lambda: halo.fused_denoise_halo(pts, nrm, mesh, tile=64,
                                                                  window=64),
            "predict_face_normals": lambda: predict_face_normals(
                icosphere(subdiv=1), DGCNN(), pmesh=mesh)}


@pytest.mark.parametrize("name", ["make_mesh", "shard_points", "knn_sharded",
                                  "chamfer_distance_sharded", "denoise_sharded",
                                  "fused_denoise_sharded", "morton_sort_sharded",
                                  "fused_denoise_halo", "predict_face_normals"])
def test_sharded_entry_points_default_to_the_card(cpu_mesh, name):
    """The mesh and the sharded engines default to the card like every
    entry point: without one they raise, on a CPU mesh too, before any
    collective runs."""
    from ngpd_tpu_torch.collectives import COLLECTIVES, reset_counts

    if torch.cuda.is_available():
        pytest.skip("a card is present; the missing-card path cannot be observed")
    reset_counts()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _sharded_entry_points(cpu_mesh)[name]()
    assert sum(COLLECTIVES.values()) == 0


def test_make_mesh_checks_its_ranks_shape_and_device(cpu_mesh):
    """A CPU mesh over the gloo group; a mesh of more devices than ranks, a 3-D
    mesh and a call on another device than the mesh's are refused. The
    2-D shape is the reference's (n, 1)."""
    from ngpd_tpu_torch.parallel import knn_sharded, make_mesh

    assert cpu_mesh.device_type == "cpu" and cpu_mesh.mesh_dim_names == ("points",)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="only 1-D or 2-D"):
        make_mesh(axis_names=("a", "b", "c"), device="cpu")
    assert tuple(make_mesh(axis_names=("dp", "mp"), device="cpu").mesh.shape) == (1, 1)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="the mesh is on cpu"):
            knn_sharded(torch.rand((8, 3)), 2, cpu_mesh, device="cuda")


def _small_pack():
    n = padded_size(300, 128, 64, 1)[0]
    pack = torch.rand((8, n))
    return pack, kw.make_windows(n, 300, 128, 64, 1, "cpu")


def test_cuda_wrapper_raises_instead_of_falling_back(monkeypatch):
    """Operands that pass as CUDA reach the kernel build and launch: with
    no nvcc that raises, and no plain result comes back. ``knn`` and
    ``nn_distances`` never run the plain tile loop for them."""
    from ngpd_tpu_torch.ops import knn as ops_knn

    try:
        build.find_nvcc()
        pytest.skip("nvcc is present; the missing-compiler path cannot be observed")
    except RuntimeError:
        pass
    pack, win = _small_pack()
    monkeypatch.setattr(kw, "_check", lambda *a: True)
    monkeypatch.setattr(kknn, "_check", lambda *a: True)
    monkeypatch.setattr(ops_knn, "knn_plain", lambda *a, **k: pytest.fail("ran the loop"))
    monkeypatch.setattr(build, "_LIBS", {})
    before = {**kw.LAUNCHES, **kknn.LAUNCHES}
    pts = torch.rand((300, 3))
    for call in (lambda: kw.k0(pack, win, 16, 8),
                 lambda: kw.k1(pack, win, 1.0),
                 lambda: kw.k2(pack, torch.zeros((8, 128)), win, 1.0,
                               ("flat", "edge", "feature"), 1),
                 lambda: ops_knn.knn(pts, 16, exclude_self=True),
                 lambda: ops_knn.knn(pts, 130, pts[:40], num_valid=250),
                 lambda: ops_knn.nn_distances(pts[:50], pts)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert {**kw.LAUNCHES, **kknn.LAUNCHES} == before


def test_wrappers_reject_other_devices_and_bad_operands():
    from ngpd_tpu_torch.ops.knn import knn

    pts = torch.rand((64, 3))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        knn(pts.to("meta"), 4)
    with pytest.raises(ValueError, match="queries on"):
        kknn._check(pts, pts.to("meta"))
    pack, win = _small_pack()
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        kw.k1(pack.to("meta"), win._replace(starts=win.starts.to("meta")), 1.0)
    with pytest.raises(TypeError):
        kw.k1(pack.double(), win, 1.0)
    with pytest.raises(ValueError):
        kw.k1(pack[:, :-128], win, 1.0)
    with pytest.raises(ValueError):
        kw.k2(pack, torch.zeros((8, 64)), win, 1.0, ("flat", "edge", "feature"), 1)


def test_cpu_wrappers_use_plain_versions():
    """On CPU tensors the wrappers return the plain versions' results and
    count no launch; ``knn`` and ``nn_distances`` return the tile loop's."""
    from ngpd_tpu_torch.ops.knn import knn, knn_plain, nn_distances

    pack, win = _small_pack()
    before = {**kw.LAUNCHES, **kknn.LAUNCHES}
    assert torch.equal(kw.k0(pack, win, 16, 8), kw.k0_plain(pack, win, 16, 8))
    assert torch.equal(kw.k1(pack, win, 1.0), kw.k1_plain(pack, win, kw.cos_f32(1.0)))
    pts = torch.rand((300, 3))
    for args, kwargs in (((pts, 16), {"exclude_self": True}),
                         ((pts, 70, pts[:40]), {"num_valid": 250})):
        (got, gd), (want, wd) = knn(*args, **kwargs), knn_plain(*args, **kwargs)
        assert torch.equal(gd, wd) and torch.equal(got.idx, want.idx)
        assert torch.equal(got.mask, want.mask)
    d, idx = nn_distances(pts[:50], pts, num_valid_b=280)
    nbh, want_d = knn_plain(pts, 1, pts[:50], num_valid=280, point_tile=16384,
                            query_tile=2048)
    assert torch.equal(d, want_d[:, 0]) and torch.equal(idx, nbh.idx[:, 0])
    assert {**kw.LAUNCHES, **kknn.LAUNCHES} == before


def _graph_operands():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 64, 24), generator=g)
    return x, torch.randint(0, 64, (3, 64, 5), generator=g)


def _graph_calls(x, idx):
    """The model-level calls that reach the graph kernels."""
    from ngpd_tpu_torch.models import dgcnn, edge

    return (lambda: dgcnn.feature_knn(x, 8),
            lambda: dgcnn._edge_features(x, idx),
            lambda: edge.edge_block(x, idx, "edgeconv"))


def test_graph_wrappers_raise_instead_of_falling_back(monkeypatch):
    """Operands that pass as CUDA reach the kernel build and launch: with no
    nvcc that raises, and the plain versions never run for them."""
    from ngpd_tpu_torch.models import dgcnn, edge

    try:
        build.find_nvcc()
        pytest.skip("nvcc is present; the missing-compiler path cannot be observed")
    except RuntimeError:
        pass
    monkeypatch.setattr(kgraph, "check_feature_knn", lambda *a: True)
    monkeypatch.setattr(kgraph, "check_edge_block", lambda *a: True)
    monkeypatch.setattr(dgcnn, "feature_knn_plain", lambda *a: pytest.fail("ran the plain kNN"))
    monkeypatch.setattr(edge, "edge_block_plain", lambda *a: pytest.fail("ran the plain block"))
    monkeypatch.setattr(build, "_LIBS", {})
    before = dict(kgraph.LAUNCHES)
    for call in _graph_calls(*_graph_operands()):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert kgraph.LAUNCHES == before


def test_graph_wrappers_reject_other_devices_and_bad_operands():
    """The checks refuse a device other than cuda or cpu, another type,
    shape or layout, and every shape past the kernels' limits, naming the
    limit."""
    from ngpd_tpu_torch.models import dgcnn, edge

    x, idx = _graph_operands()
    for call in _graph_calls(x.to("meta"), idx.to("meta")):
        with pytest.raises(RuntimeError, match="cuda or cpu"):
            call()
    with pytest.raises(ValueError, match="idx on"):
        kgraph.check_edge_block(x, idx.to("meta"), "dgcnn")
    with pytest.raises(ValueError, match="order"):
        edge.edge_block(x, idx, "pointnet")
    with pytest.raises(ValueError, match="order"):
        kgraph.check_edge_block(x, idx, 1)
    cuda = torch.device("cuda")

    def on_card(t):  # a tensor that reports a CUDA device, for the checks alone
        class Fake:
            device, dtype, shape = cuda, t.dtype, t.shape
            dim = t.dim
            is_contiguous = t.is_contiguous
        return Fake()

    with pytest.raises(TypeError):
        kgraph.check_feature_knn(on_card(x.double()), 8)
    with pytest.raises(TypeError):
        kgraph.check_feature_knn(on_card(x[0]), 8)
    with pytest.raises(ValueError, match="contiguous"):
        kgraph.check_feature_knn(on_card(x.transpose(1, 2)), 8)
    with pytest.raises(ValueError, match="FEATURE_KNN_MAX_K"):
        kgraph.check_feature_knn(on_card(x), 17)
    with pytest.raises(ValueError, match="FEATURE_KNN_MAX_K"):
        kgraph.check_feature_knn(on_card(x[:, :6].contiguous()), 8)
    with pytest.raises(ValueError, match="FEATURE_KNN_MAX_P"):
        kgraph.check_feature_knn(on_card(torch.zeros((1, 257, 4))), 8)
    # The patch streams through shared memory in slabs of channels: no C is
    # too wide, and a block's shared memory follows P alone.
    assert kgraph.check_feature_knn(on_card(torch.zeros((1, 64, 1024))), 8)
    assert kgraph.check_feature_knn(on_card(torch.zeros((1, 64, 907))), 16)
    assert kgraph.feature_knn_smem_bytes(64) == 32_768
    assert kgraph.check_edge_block(on_card(x), on_card(idx), "edgeconv")
    with pytest.raises(TypeError):
        kgraph.check_edge_block(on_card(x), on_card(idx.int()), "dgcnn")
    with pytest.raises(TypeError):
        kgraph.check_edge_block(on_card(x.half()), on_card(idx), "dgcnn")
    with pytest.raises(TypeError):
        kgraph.check_edge_block(on_card(x), on_card(idx[:2]), "dgcnn")
    with pytest.raises(ValueError, match="contiguous"):
        kgraph.check_edge_block(on_card(x), on_card(idx.transpose(1, 2).contiguous()
                                                    .transpose(1, 2)), "dgcnn")
    assert not kgraph.check_feature_knn(x, 8) and not kgraph.check_edge_block(x, idx, "dgcnn")


def test_cpu_graph_wrappers_use_plain_versions():
    """On CPU tensors the feature kNN and both edge-block orders return the
    plain versions' results and count no launch."""
    from ngpd_tpu_torch.models import dgcnn, edge, edgeconv

    x, idx = _graph_operands()
    before = dict(kgraph.LAUNCHES)
    assert torch.equal(dgcnn.feature_knn(x, 8), dgcnn.feature_knn_plain(x, 8))
    assert torch.equal(dgcnn._edge_features(x, idx), edge.edge_block_plain(x, idx, "dgcnn"))
    assert torch.equal(edgeconv._edge_block(x, idx), edge.edge_block_plain(x, idx, "edgeconv"))
    assert kgraph.LAUNCHES == before == {"feature_knn": 0, "edge_block": 0, "dgcnn_epilogue": 0}


def test_k0_launches_windows_past_2048_columns(monkeypatch):
    """K0 takes every window whose shared-memory rows fit: wt_c 2,304 (the
    CLI's --window 1024 at tile 256) and 4,352 reach the launch. The
    launch function owns the limit: a window it refuses as an invalid
    value (not even one warp row fits beside it) raises a ValueError that
    names the limit; any other refusal passes through."""
    launched = []

    def launch(name, counts, *args):
        launched.append(args[6])
        if args[6] > 4_352:
            raise kw.LaunchError(name, rcs.pop(0))

    rcs = [kw.CUDA_ERROR_INVALID_VALUE, 2]
    monkeypatch.setattr(kw, "_check", lambda *a: True)
    monkeypatch.setattr(kw, "launch", launch)
    n = 16_384
    for wt_c in (2_304, 4_352):
        win = kw.make_windows(n, n, 256, (wt_c - 256) // 2, 1, "cpu")
        assert win.wt_c == wt_c
        kw.k0(torch.zeros((8, n)), win, 32, 8)
    assert launched == [2_304, 4_352]
    win = kw.make_windows(n, n, 256, 6_000, 1, "cpu")
    with pytest.raises(ValueError, match="K0_SMEM_LIMIT"):
        kw.k0(torch.zeros((8, n)), win, 32, 8)
    with pytest.raises(kw.LaunchError, match="cudaError 2"):
        kw.k0(torch.zeros((8, n)), win, 32, 8)
    assert launched == [2_304, 4_352, 12_256, 12_256]
    assert not hasattr(kw, "K0_MAX_WINDOW")


def _small_packs():
    """GQ/GR/cls packs and lag state of a 300-point cloud, tile 128."""
    n = padded_size(300, 128, 64, 1)[0]
    pos, nrm = torch.rand((3, n)), torch.nn.functional.normalize(torch.rand((3, n)), dim=0)
    gq, gr = kp.build_packs(pos, nrm)
    gq = kp.set_rk(gq, torch.full((n,), 0.05), torch.full((n,), 0.02))
    cls = torch.zeros((kp.CLS_ROWS, n))
    scal = torch.zeros((8, 128))
    scal[0, 0], scal[1, 0] = 0.1, 0.2
    return gq, gr, cls, scal, kw.make_windows(n, 300, 128, 64, 1, "cpu")


def _pass_calls(gq, gr, cls, scal, win):
    cfg = DenoiseConfig()
    return (lambda: kp.pass_a(gq, gr, win, cfg),
            lambda: kp.pass_b(gq, gr, win, cfg, (0,)),
            lambda: kp.pass_c(gq, gr, cls, scal, win, (0,)),
            lambda: kp.pass_d(gq, gr, cls, scal, win, cfg, ("flat", "edge", "feature"), (0,)),
            lambda: kp.pass_bd(gq, gr, scal, win, cfg, ("flat", "edge", "feature"), (0,)))


def test_pass_wrappers_raise_instead_of_falling_back(monkeypatch):
    """Pass operands that pass as CUDA reach the kernel build and launch:
    with no nvcc that raises, and no plain result comes back."""
    try:
        build.find_nvcc()
        pytest.skip("nvcc is present; the missing-compiler path cannot be observed")
    except RuntimeError:
        pass
    monkeypatch.setattr(kp, "_check", lambda *a, **k: True)
    monkeypatch.setattr(build, "_LIBS", {})
    before = dict(kp.LAUNCHES)
    for call in _pass_calls(*_small_packs()):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert kp.LAUNCHES == before


def test_pass_wrappers_reject_other_devices_and_bad_operands():
    gq, gr, cls, scal, win = _small_packs()
    cfg = DenoiseConfig()
    meta = win._replace(starts=win.starts.to("meta"))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        kp.pass_a(gq.to("meta"), gr.to("meta"), meta, cfg)
    with pytest.raises(TypeError):
        kp.pass_a(gq.double(), gr, win, cfg)
    with pytest.raises(ValueError, match="shape"):
        kp.pass_a(gq[:8].contiguous(), gr, win, cfg)  # a slim pack is not a GQ
    with pytest.raises(ValueError, match="shape"):
        kp.pass_b(gq, gr[:, :-128].contiguous(), win, cfg, (0,))
    with pytest.raises(ValueError, match="scal"):
        kp.pass_c(gq, gr, cls, torch.zeros((8, 64)), win, (0,))
    with pytest.raises(ValueError, match="needs_delta"):
        kp.pass_b(gq, gr, win, cfg, (0, 0))
    with pytest.raises(ValueError, match="at least one"):
        kp.pass_c(gq, gr, cls, scal, win, ())
    with pytest.raises(ValueError):
        kp.pass_d(gq, gr, cls, scal, win, cfg, ("flat", "curve", "feature"), (0,))
    with pytest.raises(ValueError, match="delta slot"):
        kp.pass_d(gq, gr, cls, scal, win, cfg, ("flat", "edge", "feature"), ())
    strategy = ("flat", "edge", "feature")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        kp.pass_bd(gq.to("meta"), gr.to("meta"), scal.to("meta"), meta, cfg, strategy, (0,))
    with pytest.raises(TypeError):
        kp.pass_bd(gq, gr.double(), scal, win, cfg, strategy, (0,))
    with pytest.raises(ValueError, match="shape"):
        kp.pass_bd(gq, gr[:18].contiguous(), scal, win, cfg, strategy, (0,))
    with pytest.raises(ValueError, match="contiguous"):
        kp.pass_bd(gq.T.contiguous().T, gr, scal, win, cfg, strategy, (0,))
    with pytest.raises(ValueError, match="scal"):
        kp.pass_bd(gq, gr, scal[:, :64].contiguous(), win, cfg, strategy, (0,))
    with pytest.raises(ValueError, match="delta slot"):
        kp.pass_bd(gq, gr, scal, win, cfg, strategy, ())
    with pytest.raises(ValueError, match="needs_delta"):
        kp.pass_bd(gq, gr, scal, win, cfg, strategy, (0, 3))
    with pytest.raises(ValueError):
        kp.pass_bd(gq, gr, scal, win, cfg, ("flat", "edge", "sharpen"), (0,))


def test_cpu_pass_wrappers_use_plain_versions():
    """On CPU tensors the pass wrappers return the plain versions' results
    and count no launch."""
    gq, gr, cls, scal, win = _small_packs()
    cfg = DenoiseConfig()
    before = dict(kp.LAUNCHES)
    for got, want in zip(kp.pass_a(gq, gr, win, cfg), kp.pass_a_plain(gq, gr, win, cfg)):
        assert torch.equal(got, want)
    assert torch.equal(kp.pass_c(gq, gr, cls, scal, win, (0,)),
                       kp.pass_c_plain(gq, gr, cls, scal, win, (0,)))
    strategy = ("flat", "edge", "feature")
    for got, want in zip(kp.pass_bd(gq, gr, scal, win, cfg, strategy, (0,)),
                         kp.pass_bd_plain(gq, gr, scal, win, cfg, strategy, (0,))):
        assert torch.equal(got, want)
    assert kp.LAUNCHES == before and "pass_bd" in kp.LAUNCHES


def test_pass_bd_never_runs_the_plain_version_for_a_cuda_tensor(monkeypatch):
    """Operands that pass as CUDA go to the kernel launch; the plain
    version is not called, whether the launch succeeds or raises."""
    gq, gr, _, scal, win = _small_packs()
    called = []
    monkeypatch.setattr(kp, "_check", lambda *a, **k: True)
    monkeypatch.setattr(kp, "pass_bd_plain", lambda *a, **k: called.append("plain"))

    def refuse(name, counts, *args):
        called.append(name)
        raise RuntimeError("pass_bd launch failed with cudaError 1")

    monkeypatch.setattr(kw, "launch", refuse)
    with pytest.raises(RuntimeError, match="launch failed"):
        kp.pass_bd(gq, gr, scal, win, DenoiseConfig(), ("flat", "edge", "feature"), (0,))
    assert called == ["pass_bd"]


def test_build_lists_every_kernel_with_its_argument_types():
    assert build.SOURCES == ("k0", "k1", "k2", "pass_a", "pass_b", "pass_c", "pass_d",
                             "pass_bd", "knn", "feature_knn", "edge_block", "dgcnn_epilogue",
                             "hybrid_vu", "hybrid_update", "dense_vote", "dense_classify",
                             "dense_sums", "dense_delta", "dense_update")
    assert set(build.ARGTYPES) == set(build.SOURCES)
    for name in build.SOURCES:
        assert name in {**kw.LAUNCHES, **kp.LAUNCHES, **kknn.LAUNCHES, **kgraph.LAUNCHES,
                        **khy.LAUNCHES, **kdense.LAUNCHES}
        # One ctypes type per parameter of the C launch function.
        src = (build.CSRC / f"{name}.cu").read_text()
        sig = src[src.index(f"ngpd_{name}_launch("):]
        params = sig[sig.index("(") + 1 : sig.index(")")].split(",")
        assert len(params) == len(build.ARGTYPES[name]), name
        for text, ctype in zip(params, build.ARGTYPES[name]):
            want = (build._VP if "*" in text else
                    build._F if "float" in text else build._I)
            assert ctype is want, (name, text)
        # The library's further C functions, each with its own types.
        for entry, argtypes in build.ENTRY_ARGTYPES.get(name, {}).items():
            sig = src[src.index(f'extern "C" int {entry}('):]
            params = sig[sig.index("(") + 1 : sig.index(")")].split(",")
            assert len(params) == len(argtypes), entry
            for text, ctype in zip(params, argtypes):
                assert ctype is (build._VP if "*" in text else build._I), (entry, text)
    assert set(build.ENTRY_ARGTYPES) <= set(build.SOURCES)


def test_every_header_is_hashed_into_the_library_names():
    """A header that ``build.HEADERS`` does not list would not rename the
    libraries when it is edited, and a stale one would be loaded."""
    on_disk = sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert sorted(build.HEADERS) == on_disk
    assert "walk_common.cuh" in build.HEADERS


@pytest.mark.parametrize("header", build.HEADERS)
def test_an_edited_header_renames_the_libraries(header, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name, csrc).name for name in build.SOURCES}
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    after = {name: build.library_path(name, csrc).name for name in build.SOURCES}
    assert all(before[name] != after[name] for name in build.SOURCES)
    (csrc / "k2.cu").write_text((csrc / "k2.cu").read_text() + "// edited\n")
    assert build.library_path("k2", csrc).name != after["k2"]
    assert build.library_path("k1", csrc).name == after["k1"]


@pytest.mark.parametrize("source", sorted(p.name for p in build.CSRC.glob("*.cu*")))
def test_kernel_sources_have_no_compile_time_switches(source):
    """One build of each source: no preprocessor conditional names an
    ``NGPD_`` macro and no ``#define`` makes one, so nothing a build could
    set with ``-D`` changes what a kernel computes or how it is bounded. A
    variant is tried on an edited copy of ``csrc/`` (``kernel_lab
    --against``)."""
    import re

    text = (build.CSRC / source).read_text()
    assert not re.findall(r"^\s*#\s*(?:if|ifdef|ifndef|elif)\b.*\bNGPD_", text, re.M)
    assert not re.findall(r"^\s*#\s*define\s+NGPD_", text, re.M)


_VP, _I, _F = build._VP, build._I, build._F
# The launch arguments each kernel had before its redesign, and the header
# it was rebuilt on: the walk for all but K0, which selects its order
# statistics over the window kernels' shared pieces.
REDESIGNED = {
    "k0": ((_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP), "window_common.cuh"),
    "k1": ((_VP, _VP, _VP, _I, _I, _I, _I, _F, _VP), "walk_common.cuh"),
    "k2": ((_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _VP),
           "walk_common.cuh"),
    "pass_a": ((_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _F, _VP), "pass_walk.cuh"),
    "pass_b": ((_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _VP),
               "pass_walk.cuh"),
    "pass_c": ((_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _VP),
               "pass_walk.cuh"),
    "pass_d": ((_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                _I, _I, _I, _VP), "pass_walk.cuh"),
    "pass_bd": ((_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _F, _I, _I,
                 _I, _F, _F, _F, _I, _I, _I, _I, _I, _I, _I, _VP), "pass_walk.cuh"),
}


@pytest.mark.parametrize("name", list(REDESIGNED))
def test_redesigned_kernels_keep_their_launch_interface(name):
    """K0, K1, K2 and passes A-D and BD are launched with the argument
    lists they had before their redesign; the wrappers and every caller
    rely on them. Each includes the header it was rebuilt on (the passes'
    pass_walk.cuh on walk_common.cuh), says why it leaves the tensor cores
    alone and reports its blocks an SM; the old walks over all columns are
    gone from passes_common.cuh."""
    argtypes, header = REDESIGNED[name]
    assert build.ARGTYPES[name] == argtypes
    src = (build.CSRC / f"{name}.cu").read_text()
    assert f'extern "C" int ngpd_{name}_blocks_per_sm(' in src
    assert f'#include "{header}"' in src
    assert "wgmma" in src  # the header says why the tensor cores are not used
    if header == "pass_walk.cuh":
        assert '#include "walk_common.cuh"' in (build.CSRC / header).read_text()
    common = (build.CSRC / "passes_common.cuh").read_text()
    for gone in ("step_walk", "nvt_t6", "pack_dist", "prepare_launch", "void stage_rows("):
        assert gone not in common, gone


ONE_DEFINITION = [("NvtSums", "walk_common.cuh"), ("nvt_column", "pass_walk.cuh"),
                  ("step_column", "pass_walk.cuh"), ("step_pass", "pass_walk.cuh"),
                  ("stage_rows_pitched", "pass_walk.cuh"), ("SlimRow", "walk_common.cuh"),
                  ("stage_slim", "walk_common.cuh"), ("nvt_slim_column", "walk_common.cuh"),
                  ("nvt_mean", "walk_common.cuh")]


@pytest.mark.parametrize("body,header", ONE_DEFINITION, ids=[b for b, _ in ONE_DEFINITION])
def test_pass_walk_bodies_are_defined_once(body, header):
    """Passes B, D and BD share their accumulations, defined in
    pass_walk.cuh; K1 and K2 share the slim window's staging and the NVT
    column body, and every NVT walk the sums and their mean, defined in
    walk_common.cuh. Each is defined in its header and in no kernel
    source."""
    import re

    pattern = re.compile(rf"(struct|enum|void|NvtSums)\s+{body}\b\s*[({{]")
    where = [p.name for p in sorted(build.CSRC.glob("*.cu*")) if pattern.search(p.read_text())]
    assert where == [header]


def test_ptxas_report_reads_registers_and_spills(tmp_path):
    lib = tmp_path / "libngpd_k2_0.so"
    (tmp_path / "libngpd_k2_0.so.log").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN4ngpd9k2_kernelILb1ELb1ELb0EEEvPKfPKiS2_Pfiiiiifii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4ngpd9k2_kernelILb1ELb1ELb0EEEv\n"
        "    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 127 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN4ngpd9k2_kernelILb0ELb0ELb0EEEvPKfPKiS2_Pfiiiiifii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 90 registers, used 1 barriers\n")
    report = build.ptxas_report(lib)
    assert [r["registers"] for r in report] == [127, 90]
    entry = build.template_entry(report, "k2_kernel", True, True, False)
    assert (entry["registers"], entry["spill_stores"], entry["spill_loads"],
            entry["stack_bytes"]) == (127, 12, 4, 8)
    assert build.template_entry(report, "k2_kernel", True, True, True) == {}
    assert build.ptxas_report(tmp_path / "missing.so") == []
    from ngpd_tpu_torch import kernel_lab

    assert kernel_lab.ptxas_of("k2", lib)["registers"] == 127
    # A kernel that is not a template (pass D) and an older pass B that was not one.
    (tmp_path / "libngpd_pass_d_0.so.log").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN4ngpd13pass_d_kernelEPKfS1_S1_S1_PKiPfiiiiiNS_8StepArgsE' for 'sm_90a'\n"
        "    8 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads\n"
        "ptxas info    : Used 80 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN4ngpd13pass_b_kernelEPKfS1_PKiPfS4_iiiiffiiii' for 'sm_90a'\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n")
    report = build.ptxas_report(tmp_path / "libngpd_pass_d_0.so")
    assert build.template_entry(report, "pass_d_kernel")["spill_stores"] == 12
    assert kernel_lab.ptxas_of("pass_d", tmp_path / "libngpd_pass_d_0.so")["registers"] == 80
    assert kernel_lab.ptxas_of("pass_b", tmp_path / "libngpd_pass_d_0.so")["registers"] == 96


def test_kernel_sources_target_sm90a():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int ngpd_{name}_launch' in src
        # The kNN and graph kernels replace jitted XLA programs, the dense
        # pipeline's stage kernels none (their reference is the XLA program
        # of the dense pipeline), the others pallas_calls.
        replaced = {"knn": "ngpd_tpu/ops/knn.py", "feature_knn": "ngpd_tpu/models/dgcnn.py",
                    "edge_block": "ngpd_tpu/models/dgcnn.py",
                    "dgcnn_epilogue": "ngpd_tpu/models/dgcnn.py"}.get(
                        name, "ngpd_tpu/core/pallas_fused.py")
        if name.startswith("dense_"):
            replaced = "no TPU kernel"
            assert "ngpd_tpu/core/pipeline.py" in src
        assert f"Replaces: {replaced}" in src
        assert "What bounds it on the H100" in src
    assert build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "/build/" in (ROOT / ".gitignore").read_text().split()


def test_kernel_lab_compares_outputs_bit_for_bit():
    from ngpd_tpu_torch import kernel_lab

    a = (torch.arange(12.0).reshape(3, 4), torch.tensor([1.0, float("nan")]))
    same = kernel_lab.compare(a, tuple(x.clone() for x in a))
    assert same["equal"] and same["differing_rows"] == []  # NaN equals NaN here
    b = (a[0].clone(), a[1].clone())
    b[0][2, 1] += 0.5
    diff = kernel_lab.compare(b, a)
    assert not diff["equal"] and diff["differing_rows"] == [[0, [2]]]
    assert diff["max_abs_diff"] == 0.5


def test_kernel_lab_needs_a_card():
    from ngpd_tpu_torch import kernel_lab

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        kernel_lab.main([])


def test_kernel_lab_has_a_call_for_every_kernel():
    from ngpd_tpu_torch import kernel_lab

    assert set(kernel_lab.NAMES) <= set(build.SOURCES)
    for table in (kernel_lab.CALLS, kernel_lab.ENTRIES, kernel_lab.GEOMETRY):
        assert set(table) == set(kernel_lab.NAMES)
    assert {"k0", "k1", "pass_b", "pass_d", "pass_bd", "k2"} <= set(kernel_lab.NAMES)
    for name in kernel_lab.NAMES:
        assert callable(kernel_lab.CALLS[name])
        kernel, _ = kernel_lab.ENTRIES[name]
        assert kernel in (build.CSRC / f"{name}.cu").read_text()
    # K0's entry follows the window: its columns a lane, or the shared-memory kernel.
    assert kernel_lab.entry_of("k0", 512) == ("k0_kernel", (16,))
    assert kernel_lab.entry_of("k0", 1280) == ("k0_kernel", (64,))
    assert kernel_lab.entry_of("k0", 2304) == ("k0_wide_kernel", ())
    assert kernel_lab.entry_of("k2", 2304) == kernel_lab.ENTRIES["k2"]


def test_template_entry_reads_int_template_arguments(tmp_path):
    """K0's register kernel is a template on its columns a lane."""
    lib = tmp_path / "libngpd_k0_0.so"
    (tmp_path / "libngpd_k0_0.so.log").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN4ngpd9k0_kernelILi16EEEvPKfPKiPfiiiiii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 72 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN4ngpd9k0_kernelILi64EEEvPKfPKiPfiiiiii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN4ngpd14k0_wide_kernelEPKfPKiPfiiiiii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n")
    report = build.ptxas_report(lib)
    assert build.template_entry(report, "k0_kernel", 16)["registers"] == 72
    assert build.template_entry(report, "k0_kernel", 64)["registers"] == 128
    assert build.template_entry(report, "k0_kernel", 8) == {}
    assert build.template_entry(report, "k0_wide_kernel")["registers"] == 40
    from ngpd_tpu_torch import kernel_lab

    assert kernel_lab.ptxas_of("k0", lib, 1280)["registers"] == 128
    assert kernel_lab.ptxas_of("k0", lib, 4352)["registers"] == 40
