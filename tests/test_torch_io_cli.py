"""IO, metrics and CLI of the port against ngpd_tpu on the same files."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.io.obj import load_obj as jload_obj
from ngpd_tpu.io.ply import load_ply as jload_ply
from ngpd_tpu.io.ply import save_ply as jsave_ply
from ngpd_tpu.io.xyz import load_xyz as jload_xyz
from ngpd_tpu.ops import metrics as jmetrics
from ngpd_tpu_torch.apps import cli
from ngpd_tpu_torch.io.obj import load_obj, save_obj
from ngpd_tpu_torch.io.ply import load_ply, save_ply
from ngpd_tpu_torch.io.xyz import load_xyz, save_xyz
from ngpd_tpu_torch.ops import metrics

from fixtures import OCTA_F, OCTA_V, cube_corner

torch.set_num_threads(2)


def _cloud(n=300, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    nr = rng.normal(size=(n, 3)).astype(np.float32)
    return p, (nr / np.linalg.norm(nr, axis=1, keepdims=True)).astype(np.float32)


def _same(port, ref):
    np.testing.assert_array_equal(port.points.numpy(), np.asarray(ref.points))
    assert port.has_normals() == ref.has_normals()
    if ref.has_normals():
        np.testing.assert_allclose(port.normals.numpy(), np.asarray(ref.normals),
                                   rtol=1e-6, atol=1e-7)


def test_obj_vertex_normals(tmp_path):
    p, n = _cloud()
    save_obj(tmp_path / "a.obj", p, n)
    _same(load_obj(tmp_path / "a.obj"), jload_obj(tmp_path / "a.obj"))
    np.testing.assert_allclose(load_obj(tmp_path / "a.obj").points.numpy(), p, atol=1e-6)


def test_obj_face_normals_and_polygons(tmp_path):
    """Face-indexed normals accumulate onto vertices; quads fan-triangulate."""
    path = tmp_path / "octa.obj"
    lines = [f"v {x} {y} {z}\n" for x, y, z in OCTA_V]
    fn = np.cross(OCTA_V[OCTA_F[:, 1]] - OCTA_V[OCTA_F[:, 0]],
                  OCTA_V[OCTA_F[:, 2]] - OCTA_V[OCTA_F[:, 0]])
    lines += [f"vn {x} {y} {z}\n" for x, y, z in fn]
    lines += [f"f {a + 1}//{i + 1} {b + 1}//{i + 1} {c + 1}//{i + 1}\n"
              for i, (a, b, c) in enumerate(OCTA_F)]
    lines.append("f 1 2 3 4\n")
    path.write_text("".join(lines))
    _same(load_obj(path), jload_obj(path))


def test_obj_without_normals(tmp_path):
    p, _ = _cloud(50)
    save_obj(tmp_path / "b.obj", p)
    got = load_obj(tmp_path / "b.obj")
    assert not got.has_normals()
    _same(got, jload_obj(tmp_path / "b.obj"))


@pytest.mark.parametrize("with_normals", [True, False])
def test_xyz(tmp_path, with_normals):
    p, n = _cloud()
    save_xyz(tmp_path / "c.xyz", p, n if with_normals else None)
    _same(load_xyz(tmp_path / "c.xyz"), jload_xyz(tmp_path / "c.xyz"))


@pytest.mark.parametrize("binary", [True, False])
def test_ply(tmp_path, binary):
    p, n = _cloud()
    path = tmp_path / "d.ply"
    if binary:
        save_ply(path, p, n)
        jsave_ply(tmp_path / "e.ply", p, n)
        assert path.read_bytes() == (tmp_path / "e.ply").read_bytes()
    else:
        head = ("ply\nformat ascii 1.0\nelement vertex %d\nproperty float x\n"
                "property float y\nproperty float z\nproperty float nx\n"
                "property float ny\nproperty float nz\nelement face 0\n"
                "property list uchar int vertex_indices\nend_header\n" % len(p))
        body = "".join(" ".join(f"{v:.7g}" for v in row) + "\n"
                       for row in np.concatenate([p, n], axis=1))
        path.write_text(head + body)
    _same(load_ply(path), jload_ply(path))


def test_metrics_match_reference():
    """1-NN distances: float32 |q|^2+|p|^2-2q.p on both sides, so the
    means agree to rtol 1e-5 and the NN choices coincide."""
    a, _ = _cloud(700, 1)
    b, _ = _cloud(500, 2)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for f, g in [(metrics.chamfer_distance, jmetrics.chamfer_distance),
                 (metrics.single_chamfer_distance, jmetrics.single_chamfer_distance),
                 (metrics.hausdorff_distance, jmetrics.hausdorff_distance)]:
        np.testing.assert_allclose(f(ta, tb).numpy(), np.asarray(g(ja, jb)),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(metrics.paper_distance(tb, ta).numpy(),
                               np.asarray(jmetrics.paper_distance(jb, ja)),
                               rtol=1e-4, atol=1e-6)


def _cube_files(tmp_path):
    pts, nrm, _ = cube_corner(18, spacing=0.05)
    noisy = (pts + np.random.default_rng(0).normal(scale=0.005, size=pts.shape))
    save_obj(tmp_path / "noisy.obj", noisy.astype(np.float32), nrm)
    save_obj(tmp_path / "clean.obj", pts)
    return tmp_path / "noisy.obj", tmp_path / "clean.obj"


def test_cli_denoise_and_eval(tmp_path, capsys):
    """denoise --fused on the CPU, then eval: the CD falls, and eval's CD
    equals ngpd_tpu.ops.metrics' on the same files (rtol 1e-5)."""
    noisy, clean = _cube_files(tmp_path)
    out = tmp_path / "out.obj"
    cli.main(["denoise", str(noisy), "-o", str(out), "--fused", "--device", "cpu"])
    assert out.is_file()
    capsys.readouterr()
    res = {}
    for name, path in (("in", noisy), ("out", out)):
        cli.main(["eval", str(clean), str(path), "--device", "cpu"])
        res[name] = json.loads(capsys.readouterr().out)
    assert res["out"]["cd"] < res["in"]["cd"]
    gt = jload_obj(clean).points
    test = jload_obj(out).points
    want = float(jnp.mean(jmetrics.chamfer_distance(test, gt)))
    assert res["out"]["cd"] == pytest.approx(want, rel=1e-5)
    assert res["out"]["paper"] == pytest.approx(
        float(jnp.mean(jmetrics.paper_distance(gt, test))), rel=1e-5)


@pytest.mark.parametrize("args", [
    ["--until-min", "--gt", "clean.obj"],
    [],  # a small cloud without --fused takes the dense path
])
def test_cli_unported_routes_exit(tmp_path, args):
    noisy, _ = _cube_files(tmp_path)
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        cli.main(["denoise", str(noisy), "-o", str(tmp_path / "o.obj"),
                  "--device", "cpu", *args])


def test_cli_cloud_without_normals_exits(tmp_path):
    p, _ = _cloud(200)
    save_obj(tmp_path / "nn.obj", p)
    with pytest.raises(SystemExit, match="normal estimation"):
        cli.main(["denoise", str(tmp_path / "nn.obj"), "-o", str(tmp_path / "o.obj"),
                  "--fused", "--device", "cpu"])
