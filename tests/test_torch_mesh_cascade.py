"""The learned half of the mesh cascade (patches, the network's world
normals, the two-pass ``gcn_denoise_mesh`` with both committed
checkpoints) against ngpd_tpu on a noisy icosphere(2), on the CPU.

Targets: patch neighbour rows equal; features and frames within 1e-5 where
the eigen gap is clear; ``unrotate_predictions`` within 1e-6; world
normals after pass 1 within 1e-3; final vertices within 2e-4 and Ea within
0.01 degrees.

Where those are not met, the cause is float32 conditioning, shown here
(``-s`` prints the figures quoted below):

* A patch frame is the eigenvector set of a 3x3 voting tensor. A float32
  solve's eigenvectors move by about 1e-5 over the relative eigen gap
  (gap / largest eigenvalue) when the tensor changes by a rounding, in the
  reference's solver as in the port's: on this mesh 15 of 320 frames
  differ by more than 1e-5, at absolute gaps 0.015-0.12 (relative
  0.003-0.02), up to 3.3e-3, and on the worst of them the reference's own
  frame is 2e-3 off the float64 one. So frames and features are held to
  1e-5 where the relative gap is over ``CLEAR_GAP``, and everywhere to
  2e-5 / (relative gap).
* The network's world normal follows its frame: after pass 1 one or two
  faces differ by up to 2.8e-3, each with a relative gap under
  ``CLEAR_GAP``; every other face is within 1e-3.
* The guided filter spreads such a face's guidance over its
  neighbourhood, and pass 2 builds its patches on the nearly clean mesh,
  where a patch is nearly planar and its tensor's two small eigenvalues
  nearly coincide: one ulp of input turns 78% of the reference's pass-2
  frames by more than 1e-5 (13% by more than 1e-3, up to 0.034), and the
  port's frames differ from the reference's about as often (80%, 11%).
  Given the same guidance the port's filter equals the reference's to 1e-5
  (tests/test_torch_mesh.py), but the cascade as a whole is sensitive to
  rounding: the reference itself, run on its input with every coordinate
  moved by one ulp, moves its final vertices by up to 3e-3, with only
  ~73% of them within 2e-4. So the fixed 2e-4 bound on the final
  vertices is replaced by a relative one: the port is held to that spread
  of the reference's own, measured on two such nudges
  (``bench.within_spread``: a median move at most 1.6 times and a largest
  move at most 3 times the spread's; tests/test_torch_mesh_spread.py reads
  the rule on further nudges and on wrong stand-ins), and Ea to 0.01
  degrees.
"""

import importlib
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.config import GNFConfig as JGNF
from ngpd_tpu.learn.weights import load_dgcnn_npz
from ngpd_tpu.meshproc import gcn_denoiser as jgd
from ngpd_tpu.meshproc import filtering as jfl
from ngpd_tpu.meshproc import metrics as jmm
from ngpd_tpu.meshproc import patches as jpt
from ngpd_tpu.meshproc.synthetic import icosphere
from ngpd_tpu.meshproc.trimesh import add_mesh_noise
from ngpd_tpu.models.dgcnn import dgcnn_from_variables
from ngpd_tpu.ops.eigh3 import eigh3x3 as j_eigh3x3
from ngpd_tpu_torch.bench import MESH_EA_TOL, SPREAD_SEEDS, nudged, within_spread
from ngpd_tpu_torch.config import GNFConfig
from ngpd_tpu_torch.learn.weights import load_dgcnn_state_dict
from ngpd_tpu_torch.meshproc import gcn_denoiser as tgd
from ngpd_tpu_torch.meshproc import metrics as tmm
from ngpd_tpu_torch.meshproc import patches as tpt
from ngpd_tpu_torch.meshproc.trimesh import TriMesh, face_normals_areas_centroids
from ngpd_tpu_torch.models.dgcnn import dgcnn_from_state_dict

jknn = importlib.import_module("ngpd_tpu.ops.knn")  # ngpd_tpu.ops.knn is the function

torch.set_num_threads(2)

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BATCH = 64  # divides 320 and 512: the reference pads no batch
CLEAR_GAP = 0.05  # relative eigen gap above which frames agree to 1e-5
NORMAL_GAP = 0.02  # ... above which world normals agree to 1e-3


@pytest.fixture(scope="module")
def ref():
    clean = icosphere(subdiv=2)
    noisy = add_mesh_noise(clean, jax.random.PRNGKey(0), 0.3)
    v1 = load_dgcnn_npz(ASSETS / "dgcnn_mesh.npz")
    v2 = load_dgcnn_npz(ASSETS / "dgcnn_mesh_2.npz")
    model = dgcnn_from_variables(v1)

    def run(mesh):
        return jgd.gcn_denoise_mesh(mesh, model, v1, passes=2, variables2=v2,
                                    gnf_cfg2=JGNF(normal_iterations=4, sigma_r=0.12,
                                                  vertex_iterations=2), batch_size=BATCH)

    nbh, d2 = jknn.knn(noisy.face_data()[2], 64)
    pre = (nbh.idx, nbh.mask, d2)
    return SimpleNamespace(
        clean=clean, noisy=noisy, pre=pre,
        patches=jpt.extract_mesh_patches(noisy, pre_nbh=pre),
        guidance=np.asarray(jgd.predict_face_normals(noisy, model, v1, batch_size=BATCH,
                                                     pre_nbh=pre)),
        out=np.asarray(run(noisy).v),
        spreads=[np.asarray(run(noisy.with_vertices(jnp.asarray(nudged(noisy.v, seed)))).v)
                 for seed in SPREAD_SEEDS])


@pytest.fixture(scope="module")
def port(ref):
    mesh = TriMesh.from_numpy(np.asarray(ref.noisy.v), np.asarray(ref.noisy.f))
    model = dgcnn_from_state_dict(load_dgcnn_state_dict(ASSETS / "dgcnn_mesh.npz"))
    pre = tgd.centroid_knn(mesh, 64)
    patches = tpt.extract_mesh_patches(mesh, pre_nbh=pre, device="cpu")
    # The relative eigen gap of each patch's voting tensor, in float64.
    normals, areas, centroids = face_normals_areas_centroids(mesh.v, mesh.f)
    radius = torch.sqrt(areas * 16.0)
    dv = (centroids[pre[0]] - centroids[:, None, :]) / radius[:, None, None]
    t = tpt.voting_tensor(dv, normals[pre[0]], areas[pre[0]], patches.node_mask)
    ev = torch.linalg.eigvalsh(t.double())
    gap = torch.minimum(ev[:, 1] - ev[:, 0], ev[:, 2] - ev[:, 1]) / ev[:, 2]
    out = tgd.gcn_denoise_mesh(
        mesh, model, passes=2, variables2=load_dgcnn_state_dict(ASSETS / "dgcnn_mesh_2.npz"),
        gnf_cfg2=GNFConfig(normal_iterations=4, sigma_r=0.12, vertex_iterations=2),
        batch_size=BATCH, device="cpu")
    return SimpleNamespace(
        mesh=mesh, pre=pre, patches=patches, tensor=t, rel_gap=gap.numpy(), out=out,
        guidance=tgd.predict_face_normals(mesh, model, batch_size=BATCH, pre_nbh=pre,
                                          device="cpu").numpy())


def test_centroid_knn_is_the_reference_s(ref, port):
    np.testing.assert_array_equal(port.pre[0].numpy(), np.asarray(ref.pre[0]))
    np.testing.assert_array_equal(port.pre[1].numpy(), np.asarray(ref.pre[1]))
    np.testing.assert_allclose(port.pre[2].numpy(), np.asarray(ref.pre[2]), atol=1e-6)


def test_patch_neighbour_rows_and_masks_are_equal(ref, port):
    np.testing.assert_array_equal(port.patches.inputs[:, 17:20].numpy(),
                                  np.asarray(ref.patches.inputs[:, 17:20]))
    np.testing.assert_array_equal(port.patches.node_mask.numpy(),
                                  np.asarray(ref.patches.node_mask))


def test_patch_frames_match_where_the_eigen_gap_is_clear(ref, port):
    d_r = np.abs(port.patches.rotations.numpy() - np.asarray(ref.patches.rotations)).max(
        axis=(1, 2))
    d_f = np.abs(port.patches.inputs[:, :17].numpy()
                 - np.asarray(ref.patches.inputs[:, :17])).max(axis=(1, 2))
    clear = port.rel_gap > CLEAR_GAP
    assert clear.mean() > 0.5
    assert d_r[clear].max() <= 1e-5 and d_f[clear].max() <= 1e-5
    # Everywhere: the float32 eigenvector law, error x relative gap.
    assert (d_r * port.rel_gap).max() <= 2e-5 and (d_f * port.rel_gap).max() <= 2e-5
    d_y = np.abs(port.patches.y.numpy() - np.asarray(ref.patches.y)).max(axis=1)
    assert d_y[clear].max() <= 1e-5 and (d_y * port.rel_gap).max() <= 2e-5
    # The cause: on the worst frame the reference's own float32 solve of
    # (nearly) this tensor is as far from the float64 eigenvectors.
    worst = int(np.argmax(d_r))
    t = port.tensor[worst].numpy()
    _, v32 = j_eigh3x3(jnp.asarray(t))
    _, v64 = np.linalg.eigh(t.astype(np.float64))
    v32 = np.asarray(v32)
    err = max(min(np.abs(v32[:, c] - v64[:, c]).max(), np.abs(v32[:, c] + v64[:, c]).max())
              for c in range(3))
    assert port.rel_gap[worst] < CLEAR_GAP and err >= 0.25 * d_r[worst], (err, d_r[worst])
    off = d_r > 1e-5
    print("frames beyond 1e-5:", int(off.sum()), "of", len(d_r), "largest", d_r.max(),
          "relative gaps", port.rel_gap[off].min(), "-", port.rel_gap[off].max(),
          "reference's float32 frame off float64 on the worst", err)


def test_unrotate_predictions_match(ref):
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(ref.noisy.num_faces, 3)).astype(np.float32)
    rot = np.array(ref.patches.rotations)
    want = jpt.unrotate_predictions(jnp.asarray(pred), jnp.asarray(rot))
    got = tpt.unrotate_predictions(torch.as_tensor(pred), torch.as_tensor(rot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_world_normals_after_pass_one(ref, port):
    d = np.abs(port.guidance - ref.guidance).max(axis=1)
    assert d[port.rel_gap >= NORMAL_GAP].max() <= 1e-3, np.sort(d)[-5:]
    # The rest: ill-conditioned frames (their cause shown above).
    assert (d > 1e-3).sum() <= 3 and d.max() <= 1e-2
    print("world normals beyond 1e-3:", int((d > 1e-3).sum()), "largest", d.max())


def test_pass_two_frames_are_ill_conditioned(ref):
    """Pass 2 builds its patches on the nearly clean mesh, where a patch is
    nearly planar and its voting tensor's two small eigenvalues nearly
    coincide: the reference's own frames turn under one ulp of input, and
    the port's frames differ from the reference's by as much."""
    p1 = jfl.guided_normal_filter(ref.noisy, jnp.asarray(ref.guidance), JGNF(),
                                  pre_nbh=ref.pre)
    frames = np.asarray(jpt.extract_mesh_patches(p1).rotations)
    nudged_p1 = p1.with_vertices(jnp.asarray(nudged(p1.v, SPREAD_SEEDS[0])))
    turned = np.abs(np.asarray(jpt.extract_mesh_patches(nudged_p1).rotations)
                    - frames).max(axis=(1, 2))
    got = tpt.extract_mesh_patches(TriMesh.from_numpy(np.asarray(p1.v), np.asarray(p1.f)),
                                   device="cpu").rotations.numpy()
    d = np.abs(got - frames).max(axis=(1, 2))
    print("pass-2 frames turned by one ulp beyond 1e-5:", (turned > 1e-5).mean(),
          "beyond 1e-3:", (turned > 1e-3).mean(), "largest", turned.max(),
          "; port against reference beyond 1e-5:", (d > 1e-5).mean(), "beyond 1e-3:",
          (d > 1e-3).mean(), "largest", d.max())
    assert (turned > 1e-5).mean() > 0.5
    assert (d > 1e-3).mean() <= 2.0 * (turned > 1e-3).mean()


def test_two_pass_cascade_matches(ref, port):
    rec = within_spread(port.out.v.numpy(), ref.out, ref.spreads)
    assert rec["ok"], rec
    ea_t = float(tmm.mean_angular_error(port.out, TriMesh.from_numpy(
        np.asarray(ref.clean.v), np.asarray(ref.clean.f))))
    ea_j = float(jmm.mean_angular_error(ref.noisy.with_vertices(jnp.asarray(ref.out)),
                                        ref.clean))
    assert abs(ea_t - ea_j) <= MESH_EA_TOL and ea_t < float(jmm.mean_angular_error(
        ref.noisy, ref.clean)) / 2, (ea_t, ea_j)
    print("final vertices:", rec, "Ea", ea_t, ea_j)
