"""The port's ``make-dataset`` and ``train`` subcommands on the CPU, then
``predict-normals --ckpt`` with the checkpoint ``train`` kept.

``make-dataset`` on two small OBJ clouds writes one shard per cloud and
noise level (TrainConfig's six) and the manifest; ``train --epochs 1``
fits the full-width Patch2Normal and keeps its checkpoint (``scores.json``,
``step_0/variables.npz``); ``predict-normals --ckpt <dir>`` serves the best
step's weights, and ngpd_tpu's reader and model give the same forward on
that archive (raw outputs within 2e-4, tests/test_torch_patch2normal.py's
bound; the normals' unit length to 1e-5).
"""

import json

import jax.numpy as jnp
import numpy as np
import torch

from ngpd_tpu.config import ModelConfig as JModelConfig
from ngpd_tpu.learn.weights import load_dgcnn_npz
from ngpd_tpu.models.patch2normal import Patch2NormalModel as JPatch2NormalModel
from ngpd_tpu_torch.apps import cli
from ngpd_tpu_torch.config import PatchConfig
from ngpd_tpu_torch.core.normals import estimated_normals
from ngpd_tpu_torch.core.patches import extract_patches
from ngpd_tpu_torch.io.obj import save_obj
from ngpd_tpu_torch.learn.checkpoints import CheckpointManager
from ngpd_tpu_torch.learn.weights import load_dgcnn_npz as tload_npz
from ngpd_tpu_torch.learn.weights import patch2normal_state_dict_from_variables
from ngpd_tpu_torch.models.patch2normal import Patch2NormalModel

from fixtures import sphere_cloud

torch.set_num_threads(2)


def test_make_dataset_train_and_serve(tmp_path, capsys):
    for i, n in enumerate((48, 56)):
        save_obj(tmp_path / f"raw{i}.obj", sphere_cloud(n, seed=i)[0])
    cli.main(["make-dataset", str(tmp_path / "raw0.obj"), str(tmp_path / "raw1.obj"),
              "-o", str(tmp_path / "ds"), "--device", "cpu"])
    said = capsys.readouterr().out
    assert "wrote 12 shards," in said
    manifest = json.loads((tmp_path / "ds" / "manifest.json").read_text())
    assert len(manifest["train"]) == 7 and len(manifest["val"]) == 2

    cli.main(["train", str(tmp_path / "ds"), "-o", str(tmp_path / "run"), "--epochs", "1",
              "--device", "cpu"])
    said = capsys.readouterr().out.splitlines()
    assert said[0].startswith("train ") and said[0].endswith(" patches, val " + said[0].split()[-1])
    assert any(ln.startswith("epoch 0: train ") for ln in said)
    assert said[-1] == f"done; checkpoints under {tmp_path / 'run'}/ckpts"
    ckpts = tmp_path / "run" / "ckpts"
    scores = json.loads((ckpts / "scores.json").read_text())
    assert list(scores) == ["step_0"] and np.isfinite(scores["step_0"])
    logs = (tmp_path / "run" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(ln)["split"] for ln in logs] == ["train", "val"]

    pts = sphere_cloud(70, seed=5)[0]
    save_obj(tmp_path / "q.obj", pts)
    cli.main(["predict-normals", str(tmp_path / "q.obj"), "-o", str(tmp_path / "n.xyz"),
              "--ckpt", str(ckpts), "--device", "cpu"])
    got = np.loadtxt(tmp_path / "n.xyz", dtype=np.float32)
    assert got.shape == (70, 6) and np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:], axis=1), 1.0, atol=1e-5)

    # The archive in ngpd_tpu: the same forward on the query's patches.
    path = CheckpointManager(ckpts).variables_path()
    variables = load_dgcnn_npz(path)
    model = Patch2NormalModel()
    model.load_state_dict(patch2normal_state_dict_from_variables(tload_npz(path)), strict=True)
    t = torch.as_tensor(pts)
    b = extract_patches(t, estimated_normals(t), cfg=PatchConfig(), device="cpu")
    args = (b.x, b.nbr_idx, b.nbr_mask, b.node_mask)
    with torch.no_grad():
        mine = model.eval()(*args).numpy()
    want = np.asarray(JPatch2NormalModel(JModelConfig()).apply(
        variables, *(jnp.asarray(a.numpy()) for a in args), train=False))
    assert np.abs(mine - want).max() <= 2e-4
