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


def test_cli_dense_route_matches_reference(tmp_path):
    """A small cloud without --fused takes the dense (N, k) pipeline: the
    written positions equal ngpd_tpu's denoise on the same file (1e-5;
    the OBJ keeps 6 digits)."""
    from ngpd_tpu.core.pipeline import denoise as jdenoise

    noisy, _ = _cube_files(tmp_path)
    out = tmp_path / "o.obj"
    cli.main(["denoise", str(noisy), "-o", str(out), "--device", "cpu",
              "--iterations", "2"])
    src = jload_obj(noisy)
    want, want_n, _ = jdenoise(src.points, src.normals, iterations=2)
    got = load_obj(out)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want_n), atol=1e-4)


def test_cli_until_min_route_matches_reference(tmp_path, capsys):
    """--until-min --gt: the same stopping step and positions as
    ngpd_tpu's function with the CLI's arguments."""
    from ngpd_tpu.config import DenoiseConfig as JaxConfig
    from ngpd_tpu.core.pipeline import denoise_until_minimum_error as j_until

    noisy, clean = _cube_files(tmp_path)
    out = tmp_path / "o.obj"
    cli.main(["denoise", str(noisy), "-o", str(out), "--device", "cpu", "--until-min",
              "--gt", str(clean), "--iterations", "3"])
    said = capsys.readouterr().out
    src = jload_obj(noisy)
    want, _, err, iters = j_until(src.points, src.normals, jload_obj(clean).points,
                                  JaxConfig(feature_k=16, step_k=8), max_iterations=3)
    assert f"stopped after {int(iters)} iterations" in said
    printed = float(said.split("error ")[1].split()[0])
    assert printed == pytest.approx(float(err), rel=1e-3)
    np.testing.assert_allclose(load_obj(out).points.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(SystemExit, match="requires --gt"):
        cli.main(["denoise", str(noisy), "-o", str(out), "--device", "cpu", "--until-min"])


def test_cli_cloud_without_normals_estimates_them(tmp_path):
    """No normals in the file: PVT normals over 12 neighbours, oriented,
    then the dense route; equal to ngpd_tpu's chain on the same file."""
    from ngpd_tpu.apps.cli import _estimated_normals as j_est
    from ngpd_tpu.core.pipeline import denoise as jdenoise

    pts, _, _ = cube_corner(14, spacing=0.05)
    noisy = (pts + np.random.default_rng(1).normal(scale=0.004, size=pts.shape))
    save_obj(tmp_path / "nn.obj", noisy.astype(np.float32))
    out = tmp_path / "o.obj"
    cli.main(["denoise", str(tmp_path / "nn.obj"), "-o", str(out), "--device", "cpu"])
    src = jload_obj(tmp_path / "nn.obj")
    assert not src.has_normals()
    want, _, _ = jdenoise(src.points, j_est(src.points), iterations=2)
    got = load_obj(out)
    assert got.has_normals()
    diff = np.abs(got.points.numpy() - np.asarray(want)).max(axis=1)
    # Estimated normals on the cube's exact edges can sit on a decision
    # threshold: the mask-flip bound.
    assert np.mean(diff <= 1e-5) >= 0.99 and diff.max() <= 2e-2, (np.mean(diff <= 1e-5),
                                                                  diff.max())


def test_cli_has_no_unported_route():
    import inspect

    src = inspect.getsource(cli)
    assert "not ported" not in src and "_not_ported" not in src
