"""Plain reference of GCN-Denoiser's patch-network training (Shen et al.,
"GCN-Denoiser: Mesh Denoising with Graph Convolutional Networks", TOG
41(1), 2022; the upstream ``DenoisingGCN/train.py:63-171`` with
``parsers.py:3-23``): the DGCNN regressing each patch's centre normal in
the patch frame, Adam on 0 x cosine + 1 x MSE, a number of steps from a
seeded start.

  * data: a 64-face patch around every face of the noisy mesh
    (``gcn_mesh.patches``), its target the clean twin's face normal turned
    into the patch frame;
  * batches: ``numpy.random.default_rng(data_seed)`` permutes the patches,
    the first ``int(n x val_fraction)`` are the validation split, the next
    permutation of the rest gives the batches in order (the collector's
    store, ``ShardStore``);
  * dropout: per step a keep mask for each dropout site, (batch, 512) then
    (batch, 256), ``torch.rand(...) < 1 - rate`` from one generator on the
    data's device seeded with ``dropout_seed`` (``draw_keep_masks``);
  * the train-mode forward: three edge convolutions over the patch's 3
    neighbour rows, three over the self-inclusive 8 nearest in feature
    space (ties to the lower index), edge feature (x_j - x_i, x_i), a
    linear map, BatchNorm, LeakyReLU 0.2, the max over the neighbours;
    the 1x1 map of the six outputs to emb_dims, BatchNorm, LeakyReLU; max
    and mean over the nodes; the head 2 emb_dims -> 512 -> 256 -> 64 -> 3,
    BatchNorm and LeakyReLU after each of the first three, dropout after
    the first two;
  * the loss's gradients by ``torch.autograd`` over those operations;
  * Adam in optax's form: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).

Departures from the upstream scripts, each as the repository's models
have it: BatchNorm in Flax's convention (normalised with the batch's mean
and biased variance, the variance computed max(mean(h^2) - mean(h)^2, 0),
eps 1e-5; running statistics 0.9 x old + 0.1 x the batch's, the biased
variance kept) where upstream uses torch's (two-pass variance, the
unbiased one kept); fixed 64-node patches where upstream's vary with the
ring; a constant learning rate, as upstream ``train.py`` has it (the
port's optional cosine decay is off).

The linear maps are torch's (``torch.nn.functional.linear``, each weight
(out, in) as upstream's ``nn.Conv2d`` and ``nn.Linear`` hold it; the flat
Flax kernels are their transposes), and a feature-space distance adds its
squared differences channel by channel from the first, each product and
sum rounded on its own: float32 sums in one documented order, so that
equal features give equal distances. The lower-precision control
(``train(tf32=True)``) runs every product at TF32: each map's operands
rounded to TF32 (``numerics.round_tf32``, the gradient passed through as
is) and, on the card, the backward's products on TF32 tensor cores
(``allow_tf32``). The patches are built at float32 either way.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import gcn_mesh
from .numerics import round_tf32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated at +-2


# --- data --------------------------------------------------------------------

def mesh_patches(v, f, clean, radius_factor: float, nodes: int):
    """((F, 20, P) network inputs, (F, 3) targets) of every face of the
    noisy mesh ``v``, ``f``; the targets are ``clean``'s face normals in
    each patch's frame."""
    ff = tuple(torch.as_tensor(a, device=v.device)
               for a in gcn_mesh.face_faces(f.cpu().numpy()))
    _, _, centroids = gcn_mesh.face_data(v, f)
    nb_idx, d2 = gcn_mesh.knn(centroids, nodes)
    inputs, rot = gcn_mesh.patches(v, f, ff, nb_idx, torch.ones_like(nb_idx, dtype=torch.bool),
                                   d2, radius_factor)
    gt, _, _ = gcn_mesh.face_data(clean, f)
    return inputs, torch.einsum("fij,fj->fi", rot, gt)


def batch_rows(n: int, config: dict, steps: int) -> np.ndarray:
    """(steps, batch) patch rows of the first ``steps`` training batches."""
    rng = np.random.default_rng(config["data_seed"])
    perm = rng.permutation(n)
    train = perm[int(n * config["val_fraction"]):]
    order = rng.permutation(len(train))
    b = int(config["batch"])
    if steps * b > len(train):
        raise ValueError(f"{steps} batches of {b} need more than {len(train)} training patches")
    return train[order[: steps * b]].reshape(steps, b)


# --- weights -----------------------------------------------------------------

def draw_variables(config: dict, seed: int) -> dict:
    """The flat Flax variables of the DGCNN (``params/conv1/Dense_0/kernel``,
    ..., ``batch_stats/bn10/var``; numpy float32) at the configuration's
    widths, drawn from ``seed``: every kernel lecun-normal (a normal
    truncated at two deviations, scaled to sqrt(1 / fan_in)); every bias
    N(0, 0.1); each BatchNorm's scale U(0.8, 1.2), bias N(0, 0.1), mean
    N(0, 0.1), variance U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 64))
    lo = 0.5 * math.erfc(math.sqrt(2.0))
    out = {}

    def kernel(name, fan_in, fan_out):
        u = lo + torch.rand((fan_in, fan_out), generator=g, dtype=torch.float64) * (1 - 2 * lo)
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        out[f"params/{name}/kernel"] = z * (math.sqrt(1.0 / fan_in) / TRUNC_STD)

    def normal(key, width):
        out[key] = 0.1 * torch.randn(width, generator=g, dtype=torch.float64)

    def uniform(key, width, a, b):
        out[key] = a + (b - a) * torch.rand(width, generator=g, dtype=torch.float64)

    def bn(name, width):
        uniform(f"params/{name}/scale", width, 0.8, 1.2)
        normal(f"params/{name}/bias", width)
        normal(f"batch_stats/{name}/mean", width)
        uniform(f"batch_stats/{name}/var", width, 0.5, 1.5)

    width = int(config["init_dims"])
    for i, c in enumerate(config["edge_channels"], start=1):
        kernel(f"conv{i}/Dense_0", 2 * width, c)
        bn(f"conv{i}/BatchNorm_0", c)
        width = c
    emb = int(config["emb_dims"])
    kernel("conv7", sum(config["edge_channels"]), emb)
    bn("bn7", emb)
    width, head = 2 * emb, list(config["head"])
    for j, c in enumerate(head, start=1):
        kernel(f"linear{j}", width, c)
        if j > 1:
            normal(f"params/linear{j}/bias", c)
        if j < len(head):
            bn(f"bn{j + 7}", c)
        width = c
    return {k: v.numpy().astype(np.float32) for k, v in out.items()}


# --- the network -------------------------------------------------------------

def feature_knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-inclusive kNN in feature space, (B, P, C) -> (B, P, k): d(i, j)
    = ((t_0^2 + t_1^2) + t_2^2) + ..., t_c = x_ic - x_jc, then the k
    smallest by a stable sort, so equal distances keep the lower index."""
    d = torch.zeros(x.shape[:2] + x.shape[1:2], dtype=x.dtype, device=x.device)
    for c in range(x.shape[2]):
        t = x[:, :, None, c] - x[:, None, :, c]
        d = d + t * t
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def forward(inputs, p: dict, keep: list, config: dict, tf32: bool = False):
    """The train-mode forward of (B, 20, P) inputs with the parameters
    ``p`` (flat Flax names, each kernel (out, in)) and the keep masks: the
    (B, 3) outputs and each BatchNorm's batch (mean, biased variance), by
    its name. ``tf32``: every map's operands rounded to TF32."""
    slope, rate = config["leaky_slope"], config["dropout"]
    init, fixed = int(config["init_dims"]), int(config["fixed_graph_convs"])
    x = inputs[:, :init, :].transpose(1, 2)
    idx = inputs[:, init : init + 3, :].to(torch.int64).transpose(1, 2)
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    stats = {}

    def rounded(t):
        return t + (round_tf32(t.detach()) - t.detach()) if tf32 else t

    def linear(h, name, bias=None):
        b = None if bias is None else p[bias]
        return torch.nn.functional.linear(rounded(h), rounded(p[name]), b)

    def act(h):
        return torch.nn.functional.leaky_relu(h, slope)

    def bn(h, name):
        dims = tuple(range(h.dim() - 1))
        mean = torch.mean(h, dim=dims)
        var = torch.clamp(torch.mean(h * h, dim=dims) - mean * mean, min=0.0)
        stats[name] = (mean.detach(), var.detach())
        return (h - mean) * (torch.rsqrt(var + BN_EPS) * p[f"params/{name}/scale"]) \
            + p[f"params/{name}/bias"]

    outs = []
    for i in range(1, len(config["edge_channels"]) + 1):
        nbr = idx if i <= fixed else feature_knn(x.detach(), int(config["k"]))
        xj = x[rows, nbr]
        xi = x[:, :, None, :].expand_as(xj)
        h = linear(torch.cat([xj - xi, xi], dim=-1), f"params/conv{i}/Dense_0/kernel")
        x = torch.amax(act(bn(h, f"conv{i}/BatchNorm_0")), dim=2)
        outs.append(x)
    h = act(bn(linear(torch.cat(outs, dim=-1), "params/conv7/kernel"), "bn7"))
    h = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
    last = len(config["head"])
    for j in range(1, last + 1):
        h = linear(h, f"params/linear{j}/kernel", f"params/linear{j}/bias" if j > 1 else None)
        if j < last:
            h = act(bn(h, f"bn{j + 7}"))
        if j <= len(keep):
            h = torch.where(keep[j - 1], h / (1.0 - rate), 0.0)
    return h, stats


def loss_of(pred, target, config: dict):
    """alpha x the cosine-embedding loss (mean of 1 - cos) + beta x the
    MSE; the cosine term only where alpha is not 0."""
    loss = config["loss_beta"] * torch.mean((pred - target) ** 2)
    if config["loss_alpha"]:
        pn = pred / torch.clamp(torch.linalg.norm(pred, dim=-1, keepdim=True), min=1e-12)
        tn = target / torch.clamp(torch.linalg.norm(target, dim=-1, keepdim=True), min=1e-12)
        loss = loss + config["loss_alpha"] * torch.mean(1.0 - torch.sum(pn * tn, dim=-1))
    return loss


# --- training ----------------------------------------------------------------

@contextlib.contextmanager
def _tensor_cores(on: bool):
    """The card's float32 matrix products on TF32 tensor cores inside the
    block where ``on``."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _torch_layout(key: str, v: np.ndarray) -> np.ndarray:
    return v.T if key.endswith("/kernel") else v


def train(inputs, targets, variables: dict, config: dict, steps: int, tf32: bool = False):
    """``steps`` optimizer steps from ``variables`` on the patches
    ``inputs`` (F, 20, P) and ``targets`` (F, 3), in their dtype and on
    their device: the (steps,) losses, every parameter after the last step
    (the Flax layout), every running statistic, and every parameter after
    the first step, each flattened and concatenated in the order of
    ``variables``' keys. ``tf32``: the lower-precision control."""
    dev, dt = inputs.device, inputs.dtype
    p = {k: torch.tensor(np.ascontiguousarray(_torch_layout(k, v)), dtype=dt, device=dev,
                         requires_grad=True)
         for k, v in variables.items() if k.startswith("params/")}
    stats = {k: torch.tensor(v, dtype=dt, device=dev)
             for k, v in variables.items() if k.startswith("batch_stats/")}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = config["betas"]
    lr, eps, rate = config["learning_rate"], config["eps"], config["dropout"]
    gen = torch.Generator(device=dev).manual_seed(int(config["dropout_seed"]))
    rows = batch_rows(inputs.shape[0], config, steps)
    losses, first = [], None

    def flat():
        return torch.cat([(w.T if k.endswith("/kernel") else w).detach().reshape(-1)
                          for k, w in p.items()])
    for t in range(1, steps + 1):
        sel = torch.as_tensor(rows[t - 1], device=dev)
        keep = [torch.rand((len(sel), c), generator=gen, device=dev) < 1.0 - rate
                for c in config["head"][:2]]
        with _tensor_cores(tf32):
            pred, batch = forward(inputs[sel], p, keep, config, tf32)
            loss = loss_of(pred, targets[sel], config)
            grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for name, (mean, var) in batch.items():
                for key, value in ((f"batch_stats/{name}/mean", mean),
                                   (f"batch_stats/{name}/var", var)):
                    stats[key] = 0.9 * stats[key] + 0.1 * value
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
