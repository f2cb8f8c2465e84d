"""Plain reference of Patch2Normal's training (Ruubje/Normal-Guided-
Pointcloud-Denoiser: ``Pointcloud/Modules/Model.py`` ``Patch2NormalModel``,
its ``training_step`` l.150-169 and Adam at lr 1e-3 l.225-226;
``Config.py`` l.7-24; ``Manager.py`` l.47-107, the trainer over
``SimpleDataset``'s splits), as the repository's ``make-dataset`` and
``train`` commands compute it on one clean cloud: a number of steps from
a seeded start.

  * the data set, from the clean cloud: PVT normals over the 12 nearest
    other points and their wavefront orientation (``p2n_normals.orient``),
    the ground truth; the mean edge length, the mean distance from every
    point to its 6 nearest, itself included; standard-normal (N, 3) draws
    from a generator on the cloud's device seeded with ``data_seed`` (the
    permutation drawn after them moves no Gaussian noise); the noisy
    cloud, each point moved along its ground-truth normal by its first
    draw times ``noise_level`` mean edges; the noisy cloud's normals the
    same way; its MD patches (``p2n_normals.md_patches``); each target the
    ground-truth normal turned into its patch's frame, y = n R_inv;
  * the splits: ``numpy.random.default_rng(data_seed)`` permutes the
    patches, the first ``split[0]`` of them are the training split; an
    epoch's batches are ``default_rng(batch_seed)``'s permutation of the
    training split, in order;
  * dropout: per step a keep mask for each post-pool block, (batch, 256)
    then (batch, 64), ``torch.rand(...) < 1 - rate`` from one generator on
    the data's device seeded with ``dropout_seed``;
  * the train-mode forward, as ``p2n_normals``'s module docstring has the
    model, except that every BatchNorm normalises with its batch's
    statistics over the valid nodes (the post-pool ones over the batch's
    rows): the mean and the biased variance sum(m (h - mean)^2) / count,
    eps 1e-5; it moves its running statistics to 0.9 old + (1 - 0.9)
    batch; after each post-pool block's BatchNorm, dropout: h / (1 - rate)
    where kept, 0 elsewhere;
  * the loss ``custom_val_loss``, the batch's mean of min(mean((p + y)^2),
    mean((p - y)^2)), the sign of a normal being free; its gradients by
    ``torch.autograd``;
  * Adam in optax's form: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).

Departures from the thesis code, each as the repository's packages have
it: float32 with TF32 off where the thesis trainer ran Lightning at
``16-mixed``; the data are one cloud's patches with no feature balancing
(the thesis's ``SimpleDataset``; its mesh corpus is not in the
repository); BatchNorm in Flax's convention over the valid nodes; the
EdgeConv's mean over the valid edges right after its linear map, before
BatchNorm and LeakyReLU; as many post-pool blocks as ``hidden`` has
widths left (two), a linear map and BatchNorm with no activation; the
patch graph and the orientation of ``p2n_normals``; a constant learning
rate.

The linear maps are ``torch.matmul`` of the activations by each weight
held (out, in) and transposed, the bias added after, as the repository's
modules hold and apply them (the flat Flax kernels are their
transposes). The lower-precision control (``train(tf32=True)``) runs
every product at TF32: each map's operands rounded to TF32
(``numerics.round_tf32``, the gradient passed through as is) and, on the
card, the backward's products on TF32 tensor cores. The data set is
built at float32 either way.

The MD frames of a flat patch turn with the last bit of their input, so
the data set is written in the repository's orders: the PVT mean and the
mean edge length divide a sum by a count held on the device, where a
Python divisor would be, on the card, a product with its rounded
reciprocal and give other bits (``md_patches``' mean over 16 neighbours
is exact either way).
"""

from __future__ import annotations

import numpy as np
import torch

from .gcn_train import _tensor_cores
from .numerics import eigh3x3, round_tf32
from .p2n_normals import knn, layer_names, md_patches, orient

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


# --- data --------------------------------------------------------------------

def _count(n: int, like: torch.Tensor) -> torch.Tensor:
    """``n`` as a tensor on ``like``'s device: a division by it is a true
    division there, where a Python divisor is, on the card, a product with
    its rounded reciprocal."""
    return torch.full((), float(n), dtype=like.dtype, device=like.device)


def pvt_normals(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """PVT normals over the neighbours ``idx``: the eigenvector of the
    smallest eigenvalue of their covariance about their own mean, the mean
    a sum over a count."""
    vj = points[idx]
    dv = vj - vj.sum(dim=1, keepdim=True) / _count(idx.shape[1], vj)
    return eigh3x3(torch.sum(dv[..., :, None] * dv[..., None, :], dim=1))[1][..., :, 0]


def data_set(clean: torch.Tensor, config: dict) -> dict:
    """Every point's patch of the noisy cloud made from ``clean``: ``x``
    (N, P, 8), ``member`` (N, P), ``g_idx`` and ``g_mask`` (N, P, K), and the
    target ``y`` (N, 3), float32 on ``clean``'s device."""
    pts = clean.to(torch.float32)
    dev, n = pts.device, pts.shape[0]
    k = int(config["normal_k"])
    with torch.no_grad():
        idx, _ = knn(pts, k, exclude_self=True)
        gt = orient(pts, pvt_normals(pts, idx), idx)
        near, _ = knn(pts, 6)
        edge = (torch.sum(torch.linalg.norm(pts[near] - pts[:, None, :], dim=-1))
                / _count(near.numel(), pts))
        gen = torch.Generator(device=dev).manual_seed(int(config["data_seed"]))
        draws = torch.randn((n, 3), generator=gen, device=dev, dtype=torch.float32)
        noisy = pts + gt * (draws * (edge * float(config["noise_level"])))[:, 0:1]
        idx, _ = knn(noisy, k, exclude_self=True)
        normals = orient(noisy, pvt_normals(noisy, idx), idx)
        x, member, g_idx, g_mask, r_inv = md_patches(
            noisy, normals, int(config["num_nodes"]), int(config["patch_k"]),
            int(config["feature_k"]), float(config["k_patch_radius"]))
        y = torch.sum(gt[:, :, None] * r_inv, dim=1)
    return {"x": x, "member": member, "g_idx": g_idx, "g_mask": g_mask, "y": y}


def batch_rows(n: int, config: dict, steps: int) -> np.ndarray:
    """(steps, batch) patch rows of the first ``steps`` batches of an
    epoch."""
    train = np.random.default_rng(config["data_seed"]).permutation(n)[
        : int(config["split"][0] * n)]
    order = np.random.default_rng(config["batch_seed"]).permutation(len(train))
    b = int(config["batch"])
    if steps * b > len(train):
        raise ValueError(f"{steps} batches of {b} need more than {len(train)} training patches")
    return train[order[: steps * b]].reshape(steps, b)


# --- the network -------------------------------------------------------------

def forward(data: dict, p: dict, keep: list, config: dict, tf32: bool = False):
    """The train-mode forward of a batch of patches (``data_set``'s keys)
    with the parameters ``p`` (flat Flax names, each kernel (out, in)) and
    the keep masks: the (B, 3) outputs and each BatchNorm's batch (mean,
    biased variance), by its name. ``tf32``: every map's operands rounded
    to TF32."""
    slope, rate = float(config["leaky_slope"]), float(config["dropout"])
    names = layer_names(config)
    x, member, g_idx = data["x"], data["member"], data["g_idx"]
    stats = {}

    def rounded(t):
        return t + (round_tf32(t.detach()) - t.detach()) if tf32 else t

    def linear(h, name, bias=False):
        out = torch.matmul(rounded(h), rounded(p[f"params/{name}/kernel"]).T)
        return out + p[f"params/{name}/bias"] if bias else out

    def bn(h, mask, name):
        m = mask.to(h.dtype)[..., None]
        dims = tuple(range(h.dim() - 1))
        count = torch.clamp(torch.sum(m), min=1.0)
        mean = torch.sum(h * m, dim=dims) / count
        var = torch.sum((h - mean) ** 2 * m, dim=dims) / count
        stats[name] = (mean.detach(), var.detach())
        return (h - mean) * torch.rsqrt(var + BN_EPS) * p[f"params/{name}/scale"] \
            + p[f"params/{name}/bias"]

    def act(h):
        return torch.nn.functional.leaky_relu(h, slope)

    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    edge = (data["g_mask"] & member[:, :, None]).to(x.dtype)[..., None]
    h, outs = x, []
    for name in names["convs"]:
        xi = h[:, :, None, :].expand(-1, -1, g_idx.shape[2], -1)
        z = linear(torch.cat([xi, h[rows, g_idx] - xi], dim=-1), f"{name}/lin")
        mean = torch.sum(z * edge, dim=2) / torch.clamp(torch.sum(edge, dim=2), min=1.0)
        h = act(bn(mean, member, f"{name}/bn"))
        outs.append(h)
    h = torch.cat(outs, dim=-1)
    for name in names["prepool"]:
        h = act(bn(linear(h, f"{name}_lin"), member, f"{name}_bn"))
    m = member[..., None]
    mx = torch.amax(torch.where(m, h, -torch.inf), dim=1)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    total = torch.sum(torch.where(m, h, 0.0), dim=1)
    h = torch.cat([mx, total / torch.clamp(torch.sum(member, dim=1, keepdim=True), min=1.0)],
                  dim=-1)
    every = torch.ones(h.shape[:1], dtype=torch.bool, device=h.device)
    for q, name in enumerate(names["postpool"]):
        h = bn(linear(h, f"{name}_lin", bias=True), every, f"{name}_bn")
        h = torch.where(keep[q], h / (1.0 - rate), 0.0)
    return linear(h, names["head"], bias=True), stats


def custom_val_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.minimum(torch.mean((pred + target) ** 2, dim=-1),
                                    torch.mean((pred - target) ** 2, dim=-1)))


# --- training ----------------------------------------------------------------

def _torch_layout(key: str, v: np.ndarray) -> np.ndarray:
    return v.T if key.endswith("/kernel") else v


def train(data: dict, variables: dict, config: dict, steps: int, tf32: bool = False):
    """``steps`` optimizer steps from ``variables`` on the patches ``data``
    (``data_set``'s), in ``x``'s dtype and on its device: the (steps,)
    losses, every parameter after the last step (the Flax layout), every
    running statistic, and every parameter after the first step, each
    flattened and concatenated in the order of ``variables``' keys.
    ``tf32``: the lower-precision control."""
    dev, dt = data["x"].device, data["x"].dtype
    p = {k: torch.tensor(np.ascontiguousarray(_torch_layout(k, v)), dtype=dt, device=dev,
                         requires_grad=True)
         for k, v in variables.items() if k.startswith("params/")}
    stats = {k: torch.tensor(v, dtype=dt, device=dev)
             for k, v in variables.items() if k.startswith("batch_stats/")}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = config["betas"]
    lr, eps, rate = config["learning_rate"], config["eps"], config["dropout"]
    widths = [p[f"params/{name}_lin/kernel"].shape[0]
              for name in layer_names(config)["postpool"]]
    gen = torch.Generator(device=dev).manual_seed(int(config["dropout_seed"]))
    rows = batch_rows(data["x"].shape[0], config, steps)
    losses, first = [], None

    def flat():
        return torch.cat([(w.T if k.endswith("/kernel") else w).detach().reshape(-1)
                          for k, w in p.items()])

    for t in range(1, steps + 1):
        sel = torch.as_tensor(rows[t - 1], device=dev)
        keep = [torch.rand((len(sel), c), generator=gen, device=dev) < 1.0 - rate
                for c in widths]
        batch = {k: v[sel] for k, v in data.items()}
        with _tensor_cores(tf32):
            pred, moments = forward(batch, p, keep, config, tf32)
            loss = custom_val_loss(pred, batch["y"])
            grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for name, (mean, var) in moments.items():
                for key, value in ((f"batch_stats/{name}/mean", mean),
                                   (f"batch_stats/{name}/var", var)):
                    stats[key] = BN_MOMENTUM * stats[key] + (1 - BN_MOMENTUM) * value
            for (k, w), g in zip(p.items(), grads):
                m[k] = (1.0 - b1) * g + b1 * m[k]
                s[k] = (1.0 - b2) * g * g + b2 * s[k]
                m_hat, s_hat = m[k] / (1.0 - b1 ** t), s[k] / (1.0 - b2 ** t)
                w -= lr * (m_hat / (torch.sqrt(s_hat) + eps))
        losses.append(loss.detach())
        if t == 1:
            first = flat()
    return (torch.stack(losses), flat(), torch.cat([v.reshape(-1) for v in stats.values()]),
            first)
