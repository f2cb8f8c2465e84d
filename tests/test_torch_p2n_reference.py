"""``predict_cloud_normals`` of the port against the benchmark's plain
reference, ``benchmark/reference/p2n_normals.py``, on the CPU with seeded
random weights (the configuration's draw, ``draw_variables``).

The whole path (normal estimation, orientation, MD patches, the model) is
held to the reference's own spread under a one-step nudge of the input
(``bench.within_spread`` with the point track's factors), at the
configuration's published widths on a small noisy roof and at a narrow
width. The model alone, given identical patches, is held to a fixed
tolerance. Three wrong stand-ins fail the rule: TF32 in the products
(emulated), one BatchNorm left out, and the mean over a node's edges
replaced by their max.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.entries import p2n_normals as entry
from benchmark.gen import shapes
from benchmark.reference import p2n_normals as ref
from ngpd_tpu_torch.bench import (NORMAL_SPREAD_MAX, NORMAL_SPREAD_MEDIAN, nudged,
                                  within_spread)
from ngpd_tpu_torch.config import ModelConfig, PatchConfig
from ngpd_tpu_torch.learn.predict import predict_cloud_normals
from ngpd_tpu_torch.learn.weights import (patch2normal_state_dict_from_variables,
                                          unflatten_variables)
from ngpd_tpu_torch.models import edgeconv
from ngpd_tpu_torch.models.patch2normal import Patch2NormalModel

torch.set_num_threads(2)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs"
                     / "patch2normal_md64.json").read_text())
NARROW = dict(CONFIG, hidden=[16, 16, 32, 32, 32, 32, 64, 32, 16], num_nodes=32, patch_k=8)
FULL_POINTS, NARROW_POINTS = 289, 400  # 17 x 17 and 20 x 20 roofs
NUDGES = (3, 4)
# The model alone on identical patches: the products are the same float32
# products as the reference's, summed in another order by another matrix
# routine, so the outputs may differ by rounding in a 1,024-long sum; TF32
# moves them by about a thousandth.
MODEL_RTOL = 1e-5


def cloud(n: int, seed: int) -> torch.Tensor:
    return shapes.roof_cloud(n, 0.02, torch.Generator().manual_seed(seed), "cpu")[0]


class Case:
    def __init__(self, cfg, n, seed):
        self.cfg, self.points = cfg, cloud(n, seed)
        self.variables = ref.draw_variables(cfg, cfg["weights_seed"])
        self.want = ref.predict(self.points, self.variables, cfg).numpy()
        self.spreads = [ref.predict(torch.as_tensor(nudged(self.points.numpy(), s)),
                                    self.variables, cfg).numpy() for s in NUDGES]

    def port(self):
        return predict_cloud_normals(
            entry.load_model(self.cfg, "cpu"), self.points,
            patch_cfg=PatchConfig(num_nodes=self.cfg["num_nodes"], patch_k=self.cfg["patch_k"],
                                  k_patch_radius=self.cfg["k_patch_radius"]),
            batch_size=self.cfg["batch"], device="cpu").numpy()

    def judge(self, got):
        return within_spread(got, self.want, self.spreads, median=NORMAL_SPREAD_MEDIAN,
                             largest=NORMAL_SPREAD_MAX)


@pytest.fixture(scope="module")
def full():
    return Case(CONFIG, FULL_POINTS, 5)


@pytest.fixture(scope="module")
def narrow():
    return Case(NARROW, NARROW_POINTS, 6)


def test_the_draw_loads_strictly_into_the_command_s_model():
    model = Patch2NormalModel()
    tree = unflatten_variables(ref.draw_variables(CONFIG, CONFIG["weights_seed"]))
    model.load_state_dict(patch2normal_state_dict_from_variables(tree), strict=True)
    # The configuration's widths are the command's defaults.
    assert entry.model_config(CONFIG) == ModelConfig()
    assert PatchConfig(num_nodes=CONFIG["num_nodes"], patch_k=CONFIG["patch_k"],
                       k_patch_radius=CONFIG["k_patch_radius"]) == PatchConfig()
    # No BatchNorm is the identity and no bias is zero.
    sd = model.state_dict()
    for name, value in sd.items():
        if name.endswith(("bn.weight", "_bn.weight")):
            assert not torch.all(value == 1.0), name
        if name.endswith(("bias", "running_mean")):
            assert torch.any(value != 0.0), name
    first, again = (ref.draw_variables(CONFIG, CONFIG["weights_seed"]) for _ in range(2))
    assert all(np.array_equal(v, again[k]) for k, v in first.items())


@pytest.mark.parametrize("case", ["full", "narrow"])
def test_the_port_is_within_the_reference_s_spread(case, request):
    c = request.getfixturevalue(case)
    got = c.port()
    rec = c.judge(got)
    print(case, rec)
    assert rec["ok"] and np.isfinite(got).all(), rec
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def _patches(c):
    x, member, g_idx, g_mask, _ = ref.md_patches(
        c.points, torch.as_tensor(c.want), c.cfg["num_nodes"], c.cfg["patch_k"],
        c.cfg["feature_k"], c.cfg["k_patch_radius"])
    return x, g_idx, g_mask, member


def test_the_model_alone_matches_the_reference_on_identical_patches(full):
    x, g_idx, g_mask, member = _patches(full)
    var = {k: torch.as_tensor(v) for k, v in full.variables.items()}
    want = ref.model(x, member, g_idx, g_mask, var, ref.layer_names(CONFIG), 0.2)
    with torch.no_grad():
        got = entry.load_model(CONFIG, "cpu")(x, g_idx, g_mask, member)
    scale = float(want.abs().max())
    assert scale > 0.1
    torch.testing.assert_close(got, want, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale)


def _tf32(x):
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    return ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _tf32_products(monkeypatch):
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: matmul(_tf32(a), _tf32(b)))


def _one_batchnorm_skipped(monkeypatch):
    forward = edgeconv.MaskedBatchNorm.forward

    def skip_the_128_wide(self, x, mask, group=None):  # layer2's, the only one
        return x if self.weight.shape[0] == 128 else forward(self, x, mask, group)

    monkeypatch.setattr(edgeconv.MaskedBatchNorm, "forward", skip_the_128_wide)


def _max_over_edges(monkeypatch):
    def forward(self, x, nbr_idx, nbr_mask, node_mask, group=None):
        h = torch.matmul(edgeconv._edge_block(x, nbr_idx), self.lin.weight.T)
        m = (nbr_mask & node_mask[:, :, None])[..., None]
        agg = torch.amax(torch.where(m, h, -torch.inf), dim=2)
        agg = torch.where(torch.isfinite(agg), agg, 0.0)
        return torch.nn.functional.leaky_relu(self.bn(agg, node_mask, group),
                                              self.negative_slope)

    monkeypatch.setattr(edgeconv.EdgeConv, "forward", forward)


STAND_INS = {"tf32_products": _tf32_products, "one_batchnorm_skipped": _one_batchnorm_skipped,
             "max_over_edges": _max_over_edges}


@pytest.mark.parametrize("name", list(STAND_INS))
def test_a_wrong_stand_in_fails(full, name, monkeypatch):
    STAND_INS[name](monkeypatch)
    rec = full.judge(full.port())
    print("stand-in", name, rec)
    assert not rec["ok"], rec
