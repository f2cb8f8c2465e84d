"""The rule that holds a run of the two-pass mesh cascade to its
reference's own spread (``bench.within_spread``), read on the noisy
icosphere(2) of tests/test_torch_mesh_cascade.py with both committed
checkpoints, on the CPU.

The final vertices cannot be held to a fixed 2e-4: the cascade's patch
frames are ill-conditioned in float32, and the reference itself, given its
input with every coordinate moved by one ulp, moves its vertices further
(tests/test_torch_mesh_cascade.py shows the cause). So a run is held to the
reference's moves under two such nudges (seeds 9 and 10): the median move
to at most ``SPREAD_MEDIAN`` times theirs, the largest to at most
``SPREAD_MAX`` times. This file reads the rule and shows that it is neither
tighter than the reference's own rounding nor blind to a wrong cascade:

* the reference's cascade on further nudges (seeds 11-13) passes it and
  the Ea bound;
* four wrong stand-ins of the port each fail it or the Ea bound: TF32 in
  every float32 product (emulated: both operands of each product rounded to
  10 mantissa bits, as the card's TF32 mode rounds them), pass 2 with pass
  1's weights, pass 2 with pass 1's filter settings, and a ``feature_knn``
  that keeps the higher index among equal distances;
* one vertex moved further than ``SPREAD_MAX`` allows fails it, where the
  median alone would pass.

``-s`` prints each run's figures.
"""

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
from ngpd_tpu.meshproc import metrics as jmm
from ngpd_tpu.meshproc.synthetic import icosphere
from ngpd_tpu.meshproc.trimesh import add_mesh_noise
from ngpd_tpu.models.dgcnn import dgcnn_from_variables
from ngpd_tpu_torch.bench import (MESH_EA_TOL, SPREAD_MAX, SPREAD_SEEDS, nudged,
                                  within_spread)
from ngpd_tpu_torch.config import GNFConfig
from ngpd_tpu_torch.learn.weights import load_dgcnn_state_dict
from ngpd_tpu_torch.meshproc import gcn_denoiser as tgd
from ngpd_tpu_torch.meshproc import metrics as tmm
from ngpd_tpu_torch.meshproc.trimesh import TriMesh
from ngpd_tpu_torch.models import dgcnn as tdg

torch.set_num_threads(2)

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BATCH = 64  # divides 320 and 512: the reference pads no batch
NATURAL_SEEDS = (11, 12, 13)


@pytest.fixture(scope="module")
def ref():
    clean = icosphere(subdiv=2)
    noisy = add_mesh_noise(clean, jax.random.PRNGKey(0), 0.3)
    v1 = load_dgcnn_npz(ASSETS / "dgcnn_mesh.npz")
    v2 = load_dgcnn_npz(ASSETS / "dgcnn_mesh_2.npz")
    model = dgcnn_from_variables(v1)

    def run(seed=None):
        mesh = noisy if seed is None else noisy.with_vertices(jnp.asarray(nudged(noisy.v, seed)))
        return np.asarray(jgd.gcn_denoise_mesh(
            mesh, model, v1, passes=2, variables2=v2, batch_size=BATCH,
            gnf_cfg2=JGNF(normal_iterations=4, sigma_r=0.12, vertex_iterations=2)).v)

    out = run()
    return SimpleNamespace(
        clean=clean, noisy=noisy, out=out, spreads=[run(s) for s in SPREAD_SEEDS],
        natural={s: run(s) for s in NATURAL_SEEDS},
        ea=float(jmm.mean_angular_error(noisy.with_vertices(jnp.asarray(out)), clean)))


def judge(ref, v) -> dict:
    rec = within_spread(v, ref.out, ref.spreads)
    ea = float(tmm.mean_angular_error(
        TriMesh.from_numpy(np.asarray(v), np.asarray(ref.noisy.f)),
        TriMesh.from_numpy(np.asarray(ref.clean.v), np.asarray(ref.clean.f))))
    rec["ea_diff"] = ea - ref.ea
    return rec


@pytest.mark.parametrize("seed", NATURAL_SEEDS)
def test_the_reference_s_own_nudges_pass(ref, seed):
    rec = judge(ref, ref.natural[seed])
    print("reference nudged by seed", seed, rec)
    assert rec["ok"] and abs(rec["ea_diff"]) <= MESH_EA_TOL, rec


def _tf32(x):
    """float32 -> the nearest value with 10 mantissa bits (ties to even)."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    return ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _tf32_products(monkeypatch):
    matmul, op, linear, einsum = (torch.matmul, torch.Tensor.__matmul__,
                                  torch.nn.functional.linear, torch.einsum)
    monkeypatch.setattr(torch, "matmul", lambda a, b: matmul(_tf32(a), _tf32(b)))
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda a, b: op(_tf32(a), _tf32(b)))
    monkeypatch.setattr(torch.nn.functional, "linear",
                        lambda x, w, b=None: linear(_tf32(x), _tf32(w), b))
    monkeypatch.setattr(torch, "einsum", lambda eq, *ops: einsum(eq, *map(_tf32, ops)))


def _higher_index_first(monkeypatch):
    knn = tdg.feature_knn
    monkeypatch.setattr(tdg, "feature_knn",
                        lambda x, k: x.shape[1] - 1 - knn(torch.flip(x, [1]), k))


GENTLE = GNFConfig(normal_iterations=4, sigma_r=0.12, vertex_iterations=2)
STAND_INS = {
    "tf32_products": (_tf32_products, {}),
    "pass2_with_pass1_weights": (None, {"variables2": None}),
    "pass2_with_pass1_filter": (None, {"gnf_cfg2": None}),
    "feature_knn_higher_index_first": (_higher_index_first, {}),
}


@pytest.mark.parametrize("name", list(STAND_INS))
def test_a_wrong_stand_in_fails(ref, name, monkeypatch):
    patch, change = STAND_INS[name]
    if patch is not None:
        patch(monkeypatch)
    kwargs = {"variables2": load_dgcnn_state_dict(ASSETS / "dgcnn_mesh_2.npz"),
              "gnf_cfg2": GENTLE, **change}
    model = tdg.dgcnn_from_state_dict(load_dgcnn_state_dict(ASSETS / "dgcnn_mesh.npz"))
    mesh = TriMesh.from_numpy(np.asarray(ref.noisy.v), np.asarray(ref.noisy.f))
    out = tgd.gcn_denoise_mesh(mesh, model, passes=2, batch_size=BATCH, device="cpu",
                               **kwargs)
    rec = judge(ref, out.v.numpy())
    print("stand-in", name, rec)
    assert not (rec["ok"] and abs(rec["ea_diff"]) <= MESH_EA_TOL), rec


def test_a_lone_far_vertex_fails(ref):
    v = ref.out.copy()
    v[0, 0] += 1.1 * SPREAD_MAX * within_spread(ref.out, ref.out, ref.spreads)["spread_max"]
    rec = within_spread(v, ref.out, ref.spreads)
    assert rec["median"] == 0.0 and not rec["ok"], rec
