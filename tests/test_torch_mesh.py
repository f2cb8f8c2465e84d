"""The classical mesh path of the port (trimesh, noise, synthetic shapes,
metrics, bucketing, the guided normal filter, the recipe router and the
slot manager) against ngpd_tpu on the same inputs, on the CPU.

Noisy meshes are made once by the reference (``jax.random``) and carried
across as numpy; the noise itself is held by feeding the port the
reference's own Gaussian draws and permutation. Tolerances: face data and
noise 1e-6, adjacency and synthetic shapes equal, metrics 1e-5 relative,
bucketed against plain 1e-5, the filter's vertices 1e-4 and Ea 1e-3
degrees, the recipe statistics 1e-4 relative and the same labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.config import GNFConfig as JGNF
from ngpd_tpu.meshproc import autorecipe as jar
from ngpd_tpu.meshproc import bucketing as jbk
from ngpd_tpu.meshproc import filtering as jfl
from ngpd_tpu.meshproc import metrics as jmm
from ngpd_tpu.meshproc import synthetic as jsyn
from ngpd_tpu.meshproc import trimesh as jtm
from ngpd_tpu_torch.config import GNFConfig
from ngpd_tpu_torch.meshproc import autorecipe as tar
from ngpd_tpu_torch.meshproc import bucketing as tbk
from ngpd_tpu_torch.meshproc import filtering as tfl
from ngpd_tpu_torch.meshproc import metrics as tmm
from ngpd_tpu_torch.meshproc import synthetic as tsyn
from ngpd_tpu_torch.meshproc import trimesh as ttm
from ngpd_tpu_torch.meshproc.datamanager import DataManager

torch.set_num_threads(2)

SHAPES = {"icosphere2": lambda s: s.icosphere(subdiv=2), "box": lambda s: s.box(),
          "cylinder": lambda s: s.cylinder()}


def port(mesh) -> ttm.TriMesh:
    """A reference mesh as the port's, on the CPU."""
    return ttm.TriMesh.from_numpy(np.asarray(mesh.v), np.asarray(mesh.f))


def noisy(mesh, level=0.3, seed=0, noise_type=0):
    return jtm.add_mesh_noise(mesh, jax.random.PRNGKey(seed), level, noise_type=noise_type)


def close(got: torch.Tensor, want, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def ico3():
    clean = jsyn.icosphere(subdiv=3)
    return clean, noisy(clean, 0.3, seed=1)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_face_and_vertex_data_match(shape):
    j = noisy(SHAPES[shape](jsyn), 0.2)
    t = port(j)
    for got, want in zip(t.face_data(), j.face_data()):
        close(got, want, atol=1e-6)
    close(t.vertex_normals(), j.vertex_normals(), atol=1e-6)
    close(t.average_edge_length(), j.average_edge_length(), atol=1e-6)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_adjacency_is_equal(shape):
    j = SHAPES[shape](jsyn)
    t = port(j)
    for got, want in zip(t.vertex_face_adjacency() + t.face_face_adjacency(),
                         j.vertex_face_adjacency() + j.face_face_adjacency()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transforms_match():
    j = noisy(jsyn.box(), 0.2)
    t = port(j)
    r = np.array(jax.random.orthogonal(jax.random.PRNGKey(2), 3), np.float32)
    pairs = [(t.translated([0.1, -0.2, 0.3]), j.translated(jnp.asarray([0.1, -0.2, 0.3]))),
             (t.resized(1.7), j.resized(1.7)), (t.rotated(r), j.rotated(jnp.asarray(r))),
             (t.centered_unit(), j.centered_unit())]
    for got, want in pairs:
        close(got.v, want.v, atol=1e-6)
        assert got.f is t.f and got._ff is t._ff


@pytest.mark.parametrize("noise_type,direction", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_add_mesh_noise_given_the_same_draws(noise_type, direction):
    """The port's apply step, fed the reference's Gaussian draws and its
    impulsive permutation, gives the reference's noisy mesh."""
    clean = jsyn.icosphere(subdiv=2)
    key = jax.random.PRNGKey(5)
    want = jtm.add_mesh_noise(clean, key, 0.3, noise_type=noise_type, direction=direction)
    k_gauss, k_perm = jax.random.split(key)
    n = clean.num_vertices
    draws = torch.as_tensor(np.array(jax.random.normal(k_gauss, (n, 3), jnp.float32)))
    perm = torch.as_tensor(np.array(jax.random.permutation(k_perm, n)))
    got = ttm.add_mesh_noise(port(clean), (draws, perm), 0.3, noise_type, direction)
    close(got.v, want.v, atol=1e-6)
    if noise_type == 1:  # a (1 - level) share of the vertices stays put
        moved = (got.v != port(clean).v).any(dim=1)
        assert int(moved.sum()) == n - int(np.floor(np.float32(n) * np.float32(0.7)))


def test_noise_draws_come_from_the_generator():
    from ngpd_tpu_torch.core.noise import draw_noise

    clean = tsyn.icosphere(subdiv=1)
    a, b = (ttm.add_mesh_noise(clean, draw_noise(clean.num_vertices,
                                                 torch.Generator().manual_seed(7)), 0.3)
            for _ in range(2))
    assert torch.equal(a.v, b.v) and not torch.equal(a.v, clean.v)


def test_cad_suite_is_equal():
    want, got = jsyn.cad_suite(), tsyn.cad_suite()
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].v.numpy(), np.asarray(want[name].v), name)
        np.testing.assert_array_equal(got[name].f.numpy(), np.asarray(want[name].f), name)


@pytest.mark.parametrize("shape", ["icosphere2", "box"])
def test_metrics_match(shape):
    clean = SHAPES[shape](jsyn)
    j = noisy(clean, 0.4, seed=3)
    t, tc = port(j), port(clean)
    for fn in ("mean_angular_error", "msae", "vertex_distance"):
        close(getattr(tmm, fn)(t, tc), getattr(jmm, fn)(j, clean), rtol=1e-5)
    np.testing.assert_allclose(tmm.error_map_colors(t, tc), jmm.error_map_colors(j, clean),
                               rtol=1e-5, atol=1e-6)


def test_vertex_distance_chunks_the_queries():
    """More vertices than one chunk of 1,024 queries."""
    clean = jsyn.icosphere(subdiv=4)
    j = noisy(clean, 0.3, seed=4)
    assert j.num_vertices > tmm.VERTEX_DISTANCE_CHUNK
    close(tmm.vertex_distance(port(j), port(clean)), jmm.vertex_distance(j, clean), rtol=1e-5)


def test_pad_mesh_matches():
    assert [tbk.bucket_size(n) for n in (1, 256, 257, 1000)] == \
        [jbk.bucket_size(n) for n in (1, 256, 257, 1000)]
    j = noisy(jsyn.wedge(), 0.3)
    want, got = jbk.pad_mesh(j), tbk.pad_mesh(port(j))
    assert (got.num_faces, got.num_vertices) == (want.num_faces, want.num_vertices)
    np.testing.assert_array_equal(got.mesh.v.numpy(), np.asarray(want.mesh.v))
    np.testing.assert_array_equal(got.mesh.f.numpy(), np.asarray(want.mesh.f))
    np.testing.assert_array_equal(got.face_mask.numpy(), np.asarray(want.face_mask))
    for a, b in zip(got.mesh.vertex_face_adjacency() + got.mesh.face_face_adjacency(),
                    want.mesh.vertex_face_adjacency() + want.mesh.face_face_adjacency()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    close(tbk.crop_vertices(got, port(j)).v, jbk.crop_vertices(want, j).v)


def test_bucketed_filter_equals_plain():
    """The filter on the padded mesh (sentinel faces guided by their own
    normals, masked out of the radius and sigma) gives the plain mesh, and
    the reference's padded run."""
    j = noisy(jsyn.wedge(), 0.3)
    t = port(j)
    cfg = GNFConfig(normal_iterations=2, vertex_iterations=4)
    guidance = t.face_data()[0]
    plain = tfl.guided_normal_filter(t, guidance, cfg, device="cpu")
    padded = tbk.pad_mesh(t)
    own = padded.mesh.face_data()[0]
    g_pad = torch.cat([guidance, own[padded.num_faces:]])
    out = tfl.guided_normal_filter(padded.mesh, g_pad, cfg, face_mask=padded.face_mask,
                                   device="cpu")
    close(out.v[: padded.num_vertices], plain.v.numpy(), atol=1e-5)
    jp = jbk.pad_mesh(j)
    jg = jp.mesh.face_data()[0].at[: jp.num_faces].set(j.face_data()[0])
    want = jfl.guided_normal_filter(jp.mesh, jg, JGNF(normal_iterations=2, vertex_iterations=4),
                                    face_mask=jp.face_mask)
    close(out.v[: padded.num_vertices], want.v[: jp.num_vertices], atol=1e-5)


@pytest.mark.parametrize("smooth", [0, 1])
def test_guided_normal_filter_matches(ico3, smooth):
    """Default GNFConfig (20 x 8 iterations) on a noisy icosphere(3),
    guided by the clean normals, and with one guidance-smoothing round."""
    clean, j = ico3
    t = port(j)
    g = clean.face_data()[0]
    want = jfl.guided_normal_filter(j, g, JGNF(guidance_smooth_iterations=smooth))
    got = tfl.guided_normal_filter(t, torch.as_tensor(np.asarray(g)),
                                   GNFConfig(guidance_smooth_iterations=smooth), device="cpu")
    close(got.v, want.v, atol=1e-4)
    ea_t = float(tmm.mean_angular_error(got, port(clean)))
    ea_j = float(jmm.mean_angular_error(want, clean))
    assert abs(ea_t - ea_j) <= 1e-3 and ea_t < float(jmm.mean_angular_error(j, clean))


def test_vertex_update_and_radius_match(ico3):
    _, j = ico3
    t = port(j)
    n = j.face_data()[0]
    want = jfl.update_vertex_positions(j.v, j.f, *j.vertex_face_adjacency(), n, iterations=6)
    got = tfl.update_vertex_positions(t.v, t.f, *t.vertex_face_adjacency(),
                                      torch.as_tensor(np.asarray(n)), iterations=6)
    close(got, want, atol=1e-6)
    close(tfl._gnf_radius_sigma(t, 2.0), jfl._gnf_radius_sigma(j, 2.0), rtol=1e-6)


def _plane_mesh(n):
    xs = np.arange(n, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    v = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3)
    faces = [f for i in range(n - 1) for j in range(n - 1) for f in
             ([i * n + j, i * n + j + n, i * n + j + 1],
              [i * n + j + 1, i * n + j + n, i * n + j + n + 1])]
    return v, np.asarray(faces, np.int64)


@pytest.mark.parametrize("fixed", [True, False])
def test_vertex_update_pins_the_boundary_like_the_reference(fixed):
    """An open plane mesh with noisy heights: with ``fixed_boundary`` the
    border vertices stay where they are, without it they move; either
    way the port's positions equal the reference's."""
    n = 8
    v, f = _plane_mesh(n)
    rng = np.random.default_rng(4)
    v[:, 2] = rng.normal(scale=0.2, size=len(v)).astype(np.float32)
    ij = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), -1).reshape(-1, 2)
    border = np.any((ij == 0) | (ij == n - 1), axis=1)
    j = jtm.TriMesh.from_numpy(v, f.astype(np.int32))
    t = ttm.TriMesh.from_numpy(v, f)
    normals = rng.normal(size=(len(f), 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    want = jfl.update_vertex_positions(j.v, j.f, *j.vertex_face_adjacency(),
                                       jnp.asarray(normals), iterations=5,
                                       boundary_mask=jnp.asarray(border), fixed_boundary=fixed)
    got = tfl.update_vertex_positions(t.v, t.f, *t.vertex_face_adjacency(),
                                      torch.as_tensor(normals), iterations=5,
                                      boundary_mask=torch.as_tensor(border), fixed_boundary=fixed)
    close(got, want, atol=1e-6)
    moved = np.any(got.numpy() != v, axis=1)
    assert moved[~border].all()
    assert moved[border].any() != fixed


def test_masks_keep_non_finite_slots_out():
    """A masked face at infinity leaves the radius finite, NaN normals on
    masked adjacency slots add nothing, and a filter whose every weight
    underflows keeps each face's own normal (the reference's hardening,
    tests/test_meshproc.py)."""
    v, f = _plane_mesh(6)
    bad = int(f[-1][0])
    v_bad = v.copy()
    v_bad[bad] = np.inf
    face_mask = torch.as_tensor(~np.any(f == bad, axis=1))
    sigma = tfl._gnf_radius_sigma(ttm.TriMesh.from_numpy(v_bad, f), 1.0, face_mask)
    assert torch.isfinite(sigma)

    m = ttm.TriMesh.from_numpy(*_plane_mesh(4))
    vf_idx, vf_mask = m.vertex_face_adjacency()
    normals = torch.tensor([[0.0, 0.0, 1.0]]).repeat(m.num_faces, 1)
    normals[0] = torch.nan  # face 0 is the padding fill of vf_idx
    out = tfl.update_vertex_positions(m.v, m.f, vf_idx, vf_mask & (vf_idx != 0), normals, 4)
    assert torch.isfinite(out).all()

    rng = np.random.default_rng(3)
    g = rng.normal(size=(len(f), 3))
    g = torch.as_tensor(g / np.linalg.norm(g, axis=1, keepdims=True), dtype=torch.float32)
    cfg = GNFConfig(normal_iterations=2, vertex_iterations=4, sigma_r=1e-6)
    out = tfl.guided_normal_filter(ttm.TriMesh.from_numpy(v, f), g, cfg, neighbors=16,
                                   device="cpu")
    assert torch.isfinite(out.v).all() and float((out.v - torch.as_tensor(v)).abs().max()) < 1.0


@pytest.fixture(scope="module")
def recipe_cases():
    """The noisy shapes of tests/test_autorecipe.py and the label the
    reference gives each."""
    box, sphere = jsyn.box(n=10), jsyn.icosphere(subdiv=3)
    meshes = {"box_heavy": noisy(box, 0.45, seed=7), "sphere_heavy": noisy(sphere, 0.6, seed=7),
              "sphere_light": noisy(sphere, 0.2, seed=7), "box_light": noisy(box, 0.1, seed=7),
              "box_clean": box}
    return {name: (m, jar.pick_recipe(m)) for name, m in meshes.items()}


@pytest.mark.parametrize("name", ["box_heavy", "sphere_heavy", "sphere_light", "box_light",
                                  "box_clean"])
def test_pick_recipe_gives_the_same_label(recipe_cases, name):
    j, want = recipe_cases[name]
    got = tar.pick_recipe(port(j), device="cpu")
    assert got.label == want.label
    assert got.passes == want.passes
    assert dataclasses_equal(got.gnf_cfg, want.gnf_cfg)
    assert dataclasses_equal(got.gnf_cfg2, want.gnf_cfg2)
    for field in ("noise_deg", "crease_frac", "crease_density"):
        np.testing.assert_allclose(getattr(got.stats, field), getattr(want.stats, field),
                                   rtol=1e-4, err_msg=field)


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_recipe_branch_order_is_the_reference():
    """Catastrophic noise with a crease density outside the CAD band goes
    to the default recipe; inside the band the heavy-CAD branch is checked
    first (the reference's order)."""
    for stats in (tar.MeshStats(60.0, 0.1, 9.0), tar.MeshStats(60.0, 0.1, 3.0),
                  tar.MeshStats(40.0, 0.1, 0.5), tar.MeshStats(20.0, 0.0, 0.0)):
        want = jar.pick_recipe(None, jar.MeshStats(*vars(stats).values()))
        assert tar.pick_recipe(None, stats).label == want.label


def test_datamanager_round_trip(tmp_path):
    t = tsyn.box(n=4)
    dm = DataManager()
    path = tmp_path / "box.obj"
    dm.mesh = t
    dm.export_mesh(path)
    got = dm.import_mesh(path)
    np.testing.assert_allclose(got.v.numpy(), t.v.numpy(), atol=1e-6)
    assert torch.equal(got.f, t.f)
    assert dm.original is dm.noisy is dm.denoised is dm.mesh is got
    other = dm.import_mesh(path, is_original=False)
    assert dm.noisy is other and dm.original is got
    dm.use_original()
    assert dm.mesh is got
    dm.clear()
    assert dm.mesh is None
    with pytest.raises(ValueError, match="no current mesh"):
        dm.export_mesh(path)
