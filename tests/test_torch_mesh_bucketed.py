"""The two-pass mesh cascade with ``bucketed=True`` (the mesh padded to
power-of-two shape buckets) against ngpd_tpu's bucketed run on a noisy
icosphere(2), on the CPU, with both committed checkpoints.

Bounds and their cause as in tests/test_torch_mesh_cascade.py: Ea within
0.01 degrees; the final vertices, in place of a fixed 2e-4, within the
reference's own spread under a one-ulp change of its input
(``bench.within_spread``), because the cascade's patch frames are
ill-conditioned in float32 where a voting tensor's eigenvalues lie close.
The spread is measured on the reference's bucketed path.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.config import GNFConfig as JGNF
from ngpd_tpu.learn.weights import load_dgcnn_npz
from ngpd_tpu.meshproc import metrics as jmm
from ngpd_tpu.meshproc.gcn_denoiser import gcn_denoise_mesh as j_gcn
from ngpd_tpu.meshproc.synthetic import icosphere
from ngpd_tpu.meshproc.trimesh import add_mesh_noise
from ngpd_tpu.models.dgcnn import dgcnn_from_variables
from ngpd_tpu_torch.bench import MESH_EA_TOL, SPREAD_SEEDS, nudged, within_spread
from ngpd_tpu_torch.config import GNFConfig
from ngpd_tpu_torch.learn.weights import load_dgcnn_state_dict
from ngpd_tpu_torch.meshproc import metrics as tmm
from ngpd_tpu_torch.meshproc.gcn_denoiser import gcn_denoise_mesh
from ngpd_tpu_torch.meshproc.trimesh import TriMesh
from ngpd_tpu_torch.models.dgcnn import dgcnn_from_state_dict


torch.set_num_threads(2)

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BATCH = 64  # divides 320 and 512: the reference pads no batch


@pytest.fixture(scope="module")
def runs():
    clean = icosphere(subdiv=2)
    noisy = add_mesh_noise(clean, jax.random.PRNGKey(1), 0.3)
    v1 = load_dgcnn_npz(ASSETS / "dgcnn_mesh.npz")
    v2 = load_dgcnn_npz(ASSETS / "dgcnn_mesh_2.npz")
    model = dgcnn_from_variables(v1)

    def ref(mesh):
        return np.asarray(j_gcn(
            mesh, model, v1, passes=2, variables2=v2,
            gnf_cfg2=JGNF(normal_iterations=4, sigma_r=0.12, vertex_iterations=2),
            batch_size=BATCH, bucketed=True).v)

    mesh = TriMesh.from_numpy(np.asarray(noisy.v), np.asarray(noisy.f))
    got = gcn_denoise_mesh(
        mesh, dgcnn_from_state_dict(load_dgcnn_state_dict(ASSETS / "dgcnn_mesh.npz")),
        passes=2, variables2=load_dgcnn_state_dict(ASSETS / "dgcnn_mesh_2.npz"),
        gnf_cfg2=GNFConfig(normal_iterations=4, sigma_r=0.12, vertex_iterations=2),
        batch_size=BATCH, bucketed=True, device="cpu")
    return (clean, noisy, got, ref(noisy),
            [ref(noisy.with_vertices(jnp.asarray(nudged(noisy.v, seed)))) for seed in SPREAD_SEEDS])


def test_bucketed_cascade_matches(runs):
    clean, noisy, got, want, spreads = runs
    assert got.num_vertices == noisy.num_vertices and got.num_faces == noisy.num_faces
    rec = within_spread(got.v.numpy(), want, spreads)
    assert rec["ok"], rec
    ea_t = float(tmm.mean_angular_error(got, TriMesh.from_numpy(np.asarray(clean.v),
                                                                np.asarray(clean.f))))
    ea_j = float(jmm.mean_angular_error(noisy.with_vertices(jnp.asarray(want)), clean))
    assert abs(ea_t - ea_j) <= MESH_EA_TOL and ea_t < float(jmm.mean_angular_error(noisy, clean)) / 2
    print("final vertices:", rec, "Ea", ea_t, ea_j)
