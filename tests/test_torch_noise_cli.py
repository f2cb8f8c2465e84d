"""Noise persistence (``core/noise.py``), the HTML viewer
(``apps/htmlviewer.py``) and the CLI's ``add-noise``, ``predict-normals``
and ``denoise-mesh --html`` routes of the port against ngpd_tpu on the CPU.

Tolerances: noise files' names and arrays equal, each package reading the
other's; ``export_html`` byte-equal; ``add-noise --load-noise`` writes the
reference CLI's vertices and faces exactly; ``add-noise --seed`` equals
``apply_noise`` on the port's own draws (``torch.Generator(device)
.manual_seed(seed)``: other numbers than the reference's ``jax.random``).
"""

import numpy as np
import pytest
import torch

from ngpd_tpu.apps import cli as jcli
from ngpd_tpu.apps import htmlviewer as jhtml
from ngpd_tpu.core import noise as jnoise
from ngpd_tpu.io.obj import read_obj as jread_obj
from ngpd_tpu_torch.apps import cli
from ngpd_tpu_torch.apps import htmlviewer as thtml
from ngpd_tpu_torch.core import noise as tnoise
from ngpd_tpu_torch.io.obj import load_obj, read_obj, save_obj
from ngpd_tpu_torch.io.xyz import load_xyz
from ngpd_tpu_torch.meshproc import metrics as tmm
from ngpd_tpu_torch.meshproc.synthetic import icosphere
from ngpd_tpu_torch.meshproc.trimesh import TriMesh, add_mesh_noise
from ngpd_tpu_torch.ops import metrics
from ngpd_tpu_torch.ops.knn import knn

from fixtures import sphere_cloud

torch.set_num_threads(2)


@pytest.mark.parametrize("level", [0.3, 0.1 + 0.2, 1e-05, 2])
def test_save_noise_names_and_arrays_match(tmp_path, level):
    v = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    names_j = [jnoise.save_noise(tmp_path / "j", v + i, level, noise_type=1, direction=0)
               for i in range(2)]
    names_t = [tnoise.save_noise(tmp_path / "t", torch.as_tensor(v + i), level, noise_type=1,
                                 direction=0) for i in range(2)]
    assert names_t == names_j and names_t[1].endswith("_1.npz")
    assert f"_{level!r}_" in names_t[0]
    for nj, nt in zip(names_j, names_t):
        got = tnoise.load_noise(tmp_path / "j" / nj, device="cpu")  # the port reads the reference's
        want = np.asarray(jnoise.load_noise(tmp_path / "t" / nt))  # and the reference the port's
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(AssertionError):
        tnoise.load_noise(tmp_path / "j", device="cpu")


@pytest.mark.parametrize("kind", ["mesh", "mesh_colours", "points"])
def test_export_html_is_byte_equal(tmp_path, kind):
    mesh = icosphere(subdiv=1)
    v, f = mesh.v.numpy(), mesh.f.numpy()
    colors = np.random.default_rng(1).random(v.shape).astype(np.float32)
    kwargs = {"mesh": dict(faces=f), "mesh_colours": dict(faces=f, colors=colors),
              "points": dict(title="cloud")}[kind]
    jhtml.export_html(tmp_path / "j.html", v, **kwargs)
    out = thtml.export_html(tmp_path / "t.html", v, **kwargs)
    assert out == tmp_path / "t.html"
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


@pytest.fixture
def box_obj(tmp_path):
    mesh = icosphere(subdiv=2)
    save_obj(tmp_path / "clean.obj", mesh.v.numpy(), faces=mesh.f.numpy())
    return tmp_path / "clean.obj", mesh


def test_add_noise_load_noise_writes_the_reference_s_obj(tmp_path, box_obj):
    path, mesh = box_obj
    noisy = mesh.v.numpy() + np.random.default_rng(2).normal(
        scale=0.01, size=mesh.v.shape).astype(np.float32)
    name = jnoise.save_noise(tmp_path / "noise", noisy, 0.3)
    realisation = str(tmp_path / "noise" / name)
    jcli.main(["add-noise", str(path), "-o", str(tmp_path / "j.obj"), "--load-noise", realisation])
    cli.main(["add-noise", str(path), "-o", str(tmp_path / "t.obj"), "--load-noise", realisation,
              "--device", "cpu"])
    j, t = jread_obj(tmp_path / "j.obj"), read_obj(tmp_path / "t.obj")
    np.testing.assert_array_equal(t.v, np.asarray(j.v))
    np.testing.assert_array_equal(t.fv, np.asarray(j.fv))
    save_obj(tmp_path / "want.obj", noisy, faces=mesh.f.numpy())
    np.testing.assert_array_equal(t.v, read_obj(tmp_path / "want.obj").v)
    # A cloud (no faces) with a persisted realisation: positions only.
    save_obj(tmp_path / "cloud.obj", mesh.v.numpy())
    cli.main(["add-noise", str(tmp_path / "cloud.obj"), "-o", str(tmp_path / "c.xyz"),
              "--load-noise", realisation, "--device", "cpu"])
    np.testing.assert_allclose(load_xyz(tmp_path / "c.xyz").points.numpy(), noisy, rtol=1e-7)


@pytest.mark.parametrize("noise_type,direction", [("gaussian", "normal"),
                                                  ("impulse", "random")])
def test_add_noise_on_a_mesh_draws_from_its_seed(tmp_path, box_obj, noise_type, direction):
    path, mesh = box_obj
    cli.main(["add-noise", str(path), "-o", str(tmp_path / "out.obj"), "--level", "0.4",
              "--type", noise_type, "--direction", direction, "--seed", "3", "--device", "cpu",
              "--save-noise", str(tmp_path / "kept")])
    draws = tnoise.draw_noise(mesh.num_vertices, torch.Generator("cpu").manual_seed(3))
    want = add_mesh_noise(mesh, draws, 0.4, noise_type=int(noise_type == "impulse"),
                          direction=int(direction == "random")).v.numpy()
    save_obj(tmp_path / "want.obj", want, faces=mesh.f.numpy())
    got = read_obj(tmp_path / "out.obj")
    np.testing.assert_array_equal(got.v, read_obj(tmp_path / "want.obj").v)
    np.testing.assert_array_equal(got.fv, mesh.f.numpy())
    kept = sorted((tmp_path / "kept").iterdir())
    assert [p.name for p in kept] == [
        f"{int(noise_type == 'impulse')}_{int(direction == 'random')}_0.4_0.npz"]
    np.testing.assert_array_equal(tnoise.load_noise(kept[0], device="cpu").numpy(), want)


@pytest.mark.parametrize("with_normals", [True, False])
def test_add_noise_on_a_cloud_draws_from_its_seed(tmp_path, with_normals):
    pts, nrm = sphere_cloud(300, seed=3)
    save_obj(tmp_path / "in.obj", pts, nrm if with_normals else None)
    cli.main(["add-noise", str(tmp_path / "in.obj"), "-o", str(tmp_path / "out.obj"),
              "--seed", "5", "--device", "cpu"])
    p = torch.as_tensor(load_obj(tmp_path / "in.obj").points.numpy())
    if with_normals:
        n = load_obj(tmp_path / "in.obj").normals
    else:
        n = cli._estimated_normals(p)
    nbh, _ = knn(p, 12, exclude_self=True)
    gauss, perm = tnoise.draw_noise(len(p), torch.Generator("cpu").manual_seed(5))
    want = tnoise.apply_noise(p, n, gauss, perm, 0.3, metrics.average_edge_length(p, nbh))
    save_obj(tmp_path / "want.obj", want.numpy(), n.numpy())
    got = load_obj(tmp_path / "out.obj")
    np.testing.assert_array_equal(got.points.numpy(), load_obj(tmp_path / "want.obj").points.numpy())
    np.testing.assert_array_equal(got.normals.numpy(), load_obj(tmp_path / "want.obj").normals.numpy())
    assert float((got.points - p).abs().max()) > 0


def test_denoise_mesh_writes_the_html_viewer(tmp_path, box_obj):
    path, mesh = box_obj
    draws = tnoise.draw_noise(mesh.num_vertices, torch.Generator("cpu").manual_seed(0))
    noisy = add_mesh_noise(mesh, draws, 0.3)
    save_obj(tmp_path / "noisy.obj", noisy.v.numpy(), faces=noisy.f.numpy())
    cli.main(["denoise-mesh", str(tmp_path / "noisy.obj"), "-o", str(tmp_path / "out.obj"),
              "--gt", str(path), "--error-map", "--html", str(tmp_path / "view.html"),
              "--normal-iterations", "2", "--vertex-iterations", "2", "--device", "cpu"])
    out = read_obj(tmp_path / "out.obj")
    html = (tmp_path / "view.html").read_bytes()
    assert html.startswith(b"<!DOCTYPE html>") and b"out.obj" in html
    # The reference viewer's geometry and error-map colours of the denoised
    # mesh (the OBJ rounds the vertices to 8 digits, so not its bytes).
    result = TriMesh.from_numpy(out.v, out.fv)
    colors = tmm.error_map_colors(result, TriMesh.from_numpy(mesh.v.numpy(), mesh.f.numpy()))
    jhtml.export_html(tmp_path / "j.html", out.v, faces=out.fv, colors=colors, title="out.obj")
    got, want = _arrays(html), _arrays((tmp_path / "j.html").read_bytes())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
    assert np.ptp(got[1]) > 0.1  # coloured, not the neutral grey


def _arrays(html: bytes):
    """The viewer's embedded float32 arrays (positions, colours, normals)."""
    import base64
    import re

    return [np.frombuffer(base64.b64decode(b), np.float32)
            for b in re.findall(rb'decode\("([A-Za-z0-9+/=]+)"\)', html)]


def test_predict_normals_refuses_an_orbax_directory(tmp_path):
    save_obj(tmp_path / "in.obj", sphere_cloud(100)[0])
    (tmp_path / "ckpts" / "3").mkdir(parents=True)
    with pytest.raises(SystemExit, match="save_variables_npz"):
        cli.main(["predict-normals", str(tmp_path / "in.obj"), "-o", str(tmp_path / "n.xyz"),
                  "--ckpt", str(tmp_path / "ckpts"), "--device", "cpu"])
    assert not (tmp_path / "n.xyz").exists()


def test_predict_normals_with_the_seeded_model(tmp_path):
    pts, _ = sphere_cloud(120, seed=4)
    save_obj(tmp_path / "in.obj", pts)
    cli.main(["predict-normals", str(tmp_path / "in.obj"), "-o", str(tmp_path / "n.xyz"),
              "--device", "cpu"])
    got = load_xyz(tmp_path / "n.xyz")
    np.testing.assert_array_equal(got.points.numpy(), load_obj(tmp_path / "in.obj").points.numpy())
    n = got.normals.numpy()
    assert n.shape == (120, 3) and np.isfinite(n).all()
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)


def test_predict_normals_matches_the_reference_cli(tmp_path):
    """Full width: the reference CLI restores an orbax checkpoint written
    with its CheckpointManager, the port's reads the same state from the
    ``.npz`` its ``save_variables_npz`` wrote. The normals are held to the
    reference's own spread under one-ulp nudges of the cloud
    (tests/test_torch_point_spread.py reads the rule)."""
    import jax
    import jax.numpy as jnp

    from ngpd_tpu.config import ModelConfig, TrainConfig
    from ngpd_tpu.learn.checkpoints import CheckpointManager
    from ngpd_tpu.learn.predict import predict_cloud_normals as jpredict
    from ngpd_tpu.learn.train import init_model
    from ngpd_tpu_torch.bench import (NORMAL_SPREAD_MAX, NORMAL_SPREAD_MEDIAN, SPREAD_SEEDS,
                                      nudged, within_spread)
    from ngpd_tpu_torch.learn.weights import save_variables_npz

    model, state, _ = init_model(ModelConfig(), TrainConfig(), jax.random.PRNGKey(1))
    rng = np.random.default_rng(11)

    def randomised(path, v):
        leaf = str(path[-1].key)
        draw = {"scale": lambda: rng.uniform(0.5, 1.5, v.shape),
                "bias": lambda: rng.normal(0.0, 0.3, v.shape),
                "mean": lambda: rng.normal(0.0, 0.3, v.shape),
                "var": lambda: rng.uniform(0.5, 2.0, v.shape)}.get(leaf)
        return v if draw is None else jnp.asarray(draw(), jnp.float32)

    state = state.replace(
        params=jax.tree_util.tree_map_with_path(randomised, state.params),
        batch_stats=jax.tree_util.tree_map_with_path(randomised, state.batch_stats))
    CheckpointManager(tmp_path / "ckpts").save(0, state, 0.0)
    save_variables_npz(tmp_path / "w.npz", {"params": jax.tree_util.tree_map(np.asarray, state.params),
                                            "batch_stats": jax.tree_util.tree_map(
                                                np.asarray, state.batch_stats)})
    pts, _ = sphere_cloud(150, seed=12)
    pts = pts + np.random.default_rng(13).normal(scale=0.01, size=pts.shape).astype(np.float32)
    save_obj(tmp_path / "in.obj", pts)
    jcli.main(["predict-normals", str(tmp_path / "in.obj"), "-o", str(tmp_path / "j.xyz"),
               "--ckpt", str(tmp_path / "ckpts")])
    cli.main(["predict-normals", str(tmp_path / "in.obj"), "-o", str(tmp_path / "t.xyz"),
              "--ckpt", str(tmp_path / "w.npz"), "--device", "cpu"])
    want, got = load_xyz(tmp_path / "j.xyz"), load_xyz(tmp_path / "t.xyz")
    np.testing.assert_array_equal(got.points.numpy(), want.points.numpy())
    p = load_obj(tmp_path / "in.obj").points.numpy()
    base = np.asarray(jpredict(model, state, jnp.asarray(p)))
    spreads = [np.asarray(jpredict(model, state, jnp.asarray(nudged(p, s))))
               for s in SPREAD_SEEDS]
    np.testing.assert_allclose(want.normals.numpy(), base, atol=1e-7)
    rec = within_spread(got.normals.numpy(), want.normals.numpy(), spreads, base=base,
                        median=NORMAL_SPREAD_MEDIAN, largest=NORMAL_SPREAD_MAX)
    print("predict-normals CLI", rec)
    assert rec["ok"], rec
