"""The port's DGCNN, its weights and the ``denoise-mesh`` CLI against
ngpd_tpu on the CPU.

The forward with the committed checkpoints is held to 2e-4 on 64 patches
of a noisy icosphere(2), the reference's own torch-interop bound; the
feature kNN equal, ties included (lower index first, as
``jax.lax.top_k``); the weights converted from the ``.npz`` archives equal
to the reference's torch export and loaded strictly; a ``.t7`` written
from them reloads equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngpd_tpu.learn.torch_interop import torch_state_dict_from_variables
from ngpd_tpu.learn.weights import load_dgcnn_npz
from ngpd_tpu.meshproc import metrics as jmm
from ngpd_tpu.meshproc.patches import extract_mesh_patches
from ngpd_tpu.meshproc.synthetic import icosphere
from ngpd_tpu.meshproc.trimesh import add_mesh_noise
from ngpd_tpu.models import dgcnn as jdg
from ngpd_tpu_torch.apps import cli
from ngpd_tpu_torch.io.obj import read_obj, save_obj
from ngpd_tpu_torch.learn import weights as tw
from ngpd_tpu_torch.models import dgcnn as tdg

torch.set_num_threads(2)

ASSETS = Path(__file__).resolve().parents[1] / "assets"
CKPTS = [str(ASSETS / "dgcnn_mesh.npz"), str(ASSETS / "dgcnn_mesh_2.npz")]


@pytest.fixture(scope="module")
def patch_inputs():
    """(64, 20, 64) inputs of a noisy icosphere(2), and the whole mesh."""
    clean = icosphere(subdiv=2)
    noisy = add_mesh_noise(clean, jax.random.PRNGKey(0), 0.3)
    return extract_mesh_patches(noisy).inputs[:64], clean, noisy


@pytest.mark.parametrize("ckpt", CKPTS, ids=["stage1", "stage2"])
def test_forward_matches_with_committed_weights(patch_inputs, ckpt):
    x = patch_inputs[0]
    variables = load_dgcnn_npz(ckpt)
    want = np.asarray(jdg.dgcnn_from_variables(variables).apply(variables, x, train=False))
    model = tdg.dgcnn_from_state_dict(tw.load_dgcnn_state_dict(ckpt))
    with torch.no_grad():
        got = model(torch.as_tensor(np.array(x))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("dup", [False, True])
def test_feature_knn_is_equal_ties_included(dup):
    """Small-integer features make every distance exact on both sides, so
    ties are everywhere; repeated rows (as masked patch nodes carry) tie
    at every distance."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, size=(5, 64, 24)).astype(np.float32)
    if dup:
        x[:, 40:] = 0.0
    want = np.asarray(jdg.feature_knn(jnp.asarray(x), 8))
    got = tdg.feature_knn(torch.as_tensor(x), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_feature_knn_chunks_the_batch(monkeypatch):
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(7, 64, 16)).astype(np.float32))
    whole = tdg.feature_knn(x, 8)
    monkeypatch.setattr(tdg, "KNN_BLOCK_BYTES", 2 * 64 * 64 * 16 * 4)
    assert torch.equal(tdg.feature_knn(x, 8), whole)


@pytest.mark.parametrize("ckpt", CKPTS, ids=["stage1", "stage2"])
def test_npz_weights_load_strictly_and_equal_the_reference_export(ckpt):
    sd = tw.load_dgcnn_state_dict(ckpt)
    want = torch_state_dict_from_variables(load_dgcnn_npz(ckpt))
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, k)
    model = tdg.DGCNN()
    model.load_state_dict(sd, strict=True)  # every key, aliases included
    assert set(model.state_dict()) == set(sd)


def test_t7_written_from_the_state_dict_reloads_equal(tmp_path):
    sd = tw.load_dgcnn_state_dict(CKPTS[0])
    path = tmp_path / "model.t7"
    torch.save(sd, path)
    back = tw.load_dgcnn_state_dict(path)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    module = tdg.dgcnn_from_state_dict(sd)
    torch.save(module, tmp_path / "module.t7")  # a pickled module needs the opt-in
    with pytest.raises(RuntimeError, match="NGPD_UNSAFE_TORCH_LOAD"):
        tw.load_torch_checkpoint(tmp_path / "module.t7")


def test_denoise_mesh_cli_lowers_ea(patch_inputs, tmp_path, capsys):
    """``denoise-mesh --ckpt`` on a 320-face OBJ, and without a checkpoint
    (the GT normals guide the filter)."""
    _, clean, noisy = patch_inputs
    save_obj(tmp_path / "noisy.obj", np.asarray(noisy.v), faces=np.asarray(noisy.f))
    save_obj(tmp_path / "clean.obj", np.asarray(clean.v), faces=np.asarray(clean.f))
    ea_in = float(jmm.mean_angular_error(noisy, clean))
    for name, extra in (("ckpt", ["--ckpt", CKPTS[0], "--batch-size", "160"]),
                        ("gt", ["--normal-iterations", "4", "--error-map"])):
        out = tmp_path / f"{name}.obj"
        cli.main(["denoise-mesh", str(tmp_path / "noisy.obj"), "-o", str(out), "--gt",
                  str(tmp_path / "clean.obj"), "--device", "cpu", *extra])
        said = capsys.readouterr().out
        ea = {ln.split()[1]: float(ln.split()[2]) for ln in said.splitlines()
              if ln.startswith("Ea ")}
        assert abs(ea["before:"] - ea_in) < 1e-3 and ea["after:"] < ea_in / 2, said
        data = read_obj(out)
        assert data.v.shape == (clean.num_vertices, 3) and len(data.fv) == clean.num_faces
