"""Plain reference of Patch2Normal's learned normals over a whole cloud
(Ruubje/Normal-Guided-Pointcloud-Denoiser, ``Pointcloud/Modules/Model.py``
``Patch2NormalModel`` and ``Processor.getMDPatches``), as the
``predict-normals`` command computes them on a cloud without normals.

  * normals: PVT over the 12 nearest other points (the eigenvector of the
    smallest eigenvalue of their covariance about their mean), oriented
    by wavefront sign propagation from the highest point (its normal made
    to point up): each sweep, every unvisited point with a visited
    neighbour takes the sign of sum_j s_j |n_i.n_j| (n_i.n_j) over its
    visited neighbours, until the visited set stops growing or
    4 ceil(sqrt(n)) + 16 sweeps;
  * MD selection: each point's mass pi d_16^2 / 16 from its 16th
    neighbour (itself the first), the ball radius 4 sqrt(mean mass of its
    16 neighbours), the patch its 64 nearest within that ball;
  * MD frame: the patch scaled to unit radius, each member's normal
    reflected about the plane of its offset, n' = 2 (n.w) w - n with
    w = normalize((dv x n) x dv), weighted by (area / max area)
    exp(-3 |dv|), the outer products summed; R's rows the eigenvectors by
    descending eigenvalue, the first signed by the point's normal, the
    last flipped where det R < 0; R_inv = R^T;
  * node features [c, n, a, deg] (8): the offset from the members' mean
    scaled and rotated by R_inv, the rotated normal, the scaled mass, the
    member count of the member's own patch; non-members zero;
  * the patch graph: each member's 12 nearest other members over c;
  * the model: six EdgeConvs, each a gather, [x_i, x_j - x_i], a linear
    map without bias, the mean over the node's valid edges, BatchNorm on
    running statistics and LeakyReLU 0.2; the six outputs concatenated
    (1,024), a linear map to 512 without bias, BatchNorm, LeakyReLU; the
    max and the mean over the valid nodes (1,024); two blocks of a linear
    map and BatchNorm (256, 64); the head to 3; L2 normalisation (norm
    clamped at 1e-12); the normal turned back, n = R_inv y.

Departures from SURVEY.md's description of the thesis code, as the
repository's packages run it: the EdgeConv takes the mean over the edges
right after the linear map, so BatchNorm and LeakyReLU act on the node's
mean and not on each edge (``ngpd_tpu/models/edgeconv.py``); the post-pool
stack has as many blocks as ``hidden`` has widths left (two, not the
configuration's NUM_POSTPOOL 3), each linear map and BatchNorm with no
activation, dropout off in eval; the 2-ring of the MD selection is the
16 nearest neighbours and the ragged ball a 64-nearest list capped by it;
the orientation is the wavefront above, not the minimum spanning tree's
flips; the patch graph is the 12 nearest members, not the cloud's graph
relabelled.

Squared distances between points are float32 |q|^2 + |p|^2 - 2 q.p
clamped at 0; within a patch the sum of squared coordinate differences;
equal distances keep the lower index. The model's linear maps go through
``numerics.contract`` (TF32 operands in the lower-precision control); every
other product has length 3 or is a sum over neighbours, written out. TF32
is off for matrix products and cuDNN. The variables are the flat Flax dict
that ``draw_variables`` draws, the one the program's entry loads.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .numerics import contract, eigh3x3

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated at +-2
QUERY_BLOCK = 2048  # queries a block of the brute-force kNN
PATCH_BLOCK = 1024  # patches a block of the patch graph and the model


# --- weights ---------------------------------------------------------------

def layer_names(config: dict) -> dict:
    """The Flax module names: ``convs`` (each with ``lin`` and ``bn``),
    ``prepool`` and ``postpool`` (``<name>_lin``, ``<name>_bn``), ``head``."""
    convs = int(config["edgeconvs"])
    pre = int(config["prepool"])
    n = len(config["hidden"])
    return {"convs": [f"layer{i}" for i in range(convs)],
            "prepool": [f"layer{i}" for i in range(convs, convs + pre)],
            "postpool": [f"layer{i}" for i in range(convs + pre, n)],
            "head": "lastLayer"}


def draw_variables(config: dict, seed: int) -> dict:
    """The flat Flax variables (``params/...``, ``batch_stats/...``, numpy
    float32) of the configuration's widths, drawn from ``seed``: every
    kernel lecun-normal (a normal truncated at two deviations, scaled to
    sqrt(1 / fan_in)); every bias N(0, 0.1); each BatchNorm's scale
    U(0.8, 1.2), bias N(0, 0.1), mean N(0, 0.1), variance U(0.5, 1.5)."""
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

    names, hidden = layer_names(config), list(config["hidden"])
    width = int(config["input_size"])
    for i, name in enumerate(names["convs"]):
        kernel(f"{name}/lin", 2 * width, hidden[i])
        bn(f"{name}/bn", hidden[i])
        width = hidden[i]
    width = sum(hidden[:len(names["convs"])])
    i = len(names["convs"])
    for name in names["prepool"]:
        kernel(f"{name}_lin", width, hidden[i])
        bn(f"{name}_bn", hidden[i])
        width, i = hidden[i], i + 1
    width *= 2
    for name in names["postpool"]:
        kernel(f"{name}_lin", width, hidden[i])
        normal(f"params/{name}_lin/bias", hidden[i])
        bn(f"{name}_bn", hidden[i])
        width, i = hidden[i], i + 1
    kernel(names["head"], width, int(config["output_size"]))
    normal(f"params/{names['head']}/bias", int(config["output_size"]))
    return {k: v.numpy().astype(np.float32) for k, v in out.items()}


# --- neighbours --------------------------------------------------------------

def knn(points: torch.Tensor, k: int, exclude_self: bool = False):
    """(idx (N, k) int64, squared distances (N, k)) of every point's k
    nearest points, ascending, equal distances to the lower index (the
    selection on the key distance bits << 32 | index); with
    ``exclude_self`` each point's own row is left out."""
    n = points.shape[0]
    sq = points[:, 0] * points[:, 0] + points[:, 1] * points[:, 1] + points[:, 2] * points[:, 2]
    cols = torch.arange(n, dtype=torch.int64, device=points.device)
    idx, dist = [], []
    for q0 in range(0, n, QUERY_BLOCK):
        q = points[q0:q0 + QUERY_BLOCK]
        ab = (q[:, 0:1] * points[:, 0][None, :] + q[:, 1:2] * points[:, 1][None, :]
              + q[:, 2:3] * points[:, 2][None, :])
        d = torch.clamp(sq[q0:q0 + QUERY_BLOCK, None] + sq[None, :] - 2.0 * ab, min=0.0)
        if exclude_self:
            rows = torch.arange(q.shape[0], device=points.device)
            d[rows, q0 + rows] = float("inf")
        key = ((d + 0.0).view(torch.int32).to(torch.int64) << 32) | cols[None, :]
        pos = torch.topk(key, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
        idx.append(pos)
        dist.append(torch.gather(d, 1, pos))
    return torch.cat(idx), torch.cat(dist)


def _normalize(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _outer_sum(a, b):
    """sum over axis 1 of a_k b_k^T: (N, K, 3) x (N, K, 3) -> (N, 3, 3)."""
    return torch.sum(a[..., :, None] * b[..., None, :], dim=1)


# --- normals -----------------------------------------------------------------

def pvt_normals(points, idx):
    vj = points[idx]
    dv = vj - vj.sum(dim=1, keepdim=True) / idx.shape[1]
    return eigh3x3(_outer_sum(dv, dv))[1][..., :, 0]


def orient(points, normals, idx):
    """The wavefront orientation of the module docstring."""
    n = points.shape[0]
    z = points[:, 2]
    seed = torch.argmax(torch.where(torch.isfinite(z), z, float("-inf")))
    sign = torch.ones(n, dtype=points.dtype, device=points.device)
    sign[seed] = torch.where(normals[seed, 2] < 0, -1.0, 1.0)
    visited = torch.zeros(n, dtype=torch.bool, device=points.device)
    visited[seed] = True
    dots = torch.sum(normals[idx] * normals[:, None, :], dim=-1)
    weighted = torch.abs(dots) * dots
    for _ in range(4 * math.ceil(math.sqrt(n)) + 16):
        vis = visited[idx]
        vote = torch.sum(torch.where(vis, weighted * sign[idx], 0.0), dim=1)
        front = ~visited & vis.any(dim=1)
        if not bool(front.any()):
            break
        sign = torch.where(front & (vote < 0), -sign, sign)
        visited = visited | front
    return normals * sign[:, None]


# --- MD patches ----------------------------------------------------------------

def md_patches(points, normals, nodes: int, patch_k: int, feature_k: int, radius_k: float):
    """(x (N, P, 8), members (N, P), graph idx and mask (N, P, K), R_inv
    (N, 3, 3)) of every point's patch."""
    idx_f, d_f = knn(points, feature_k)
    mass = math.pi * d_f[:, -1] / feature_k
    radii = radius_k * torch.sqrt(torch.clamp(mass[idx_f].mean(dim=1), min=0.0))
    idx, d = knn(points, nodes)
    member = d <= (radii * radii)[:, None]

    dv = points[idx] - points[:, None, :]
    scale = 1.0 / torch.clamp(torch.where(member, torch.linalg.norm(dv, dim=-1), 0.0)
                              .amax(dim=1), min=1e-30)
    dv = dv * scale[:, None, None]
    nj = normals[idx]
    w = _normalize(torch.linalg.cross(torch.linalg.cross(dv, nj), dv))
    reflected = 2.0 * torch.sum(nj * w, dim=-1, keepdim=True) * w - nj
    area = mass[idx] * (scale * scale)[:, None]
    max_area = torch.where(member, area, 0.0).amax(dim=1)
    mu = area / torch.clamp(max_area, min=1e-30)[:, None] * torch.exp(
        -3.0 * torch.linalg.norm(dv, dim=-1))
    mu = torch.where(member, mu, 0.0)
    vecs = eigh3x3(_outer_sum(reflected * mu[..., None], reflected))[1]
    rows = torch.flip(vecs.transpose(1, 2), dims=(1,))  # by descending eigenvalue
    rows = rows * torch.where(torch.sum(rows[:, 0] * normals, dim=1) < 0, -1.0, 1.0)[:, None, None]
    det = torch.sum(rows[:, 0] * torch.linalg.cross(rows[:, 1], rows[:, 2]), dim=1)
    rows = torch.cat([rows[:, :2], rows[:, 2:] * torch.where(det < 0, -1.0, 1.0)[:, None, None]],
                     dim=1)
    r_inv = rows.transpose(1, 2)

    def turn(v):  # v R_inv, row by row
        return torch.sum(v[..., :, None] * r_inv[:, None, :, :], dim=-2)

    pj = points[idx]
    mf = member.to(points.dtype)[..., None]
    centre = torch.sum(pj * mf, dim=1) / torch.clamp(mf.sum(dim=1), min=1.0)
    c = turn((pj - centre[:, None, :]) * scale[:, None, None])
    deg = member.sum(dim=1).to(points.dtype)[idx]
    x = torch.cat([c, turn(nj), (mass[idx] * scale[:, None])[..., None], deg[..., None]], dim=-1)
    x = torch.where(member[..., None], x, 0.0)

    k = min(patch_k, nodes - 1)
    g_idx, g_mask = [], []
    eye = torch.eye(nodes, dtype=torch.bool, device=points.device)
    cols = torch.arange(nodes, dtype=torch.int64, device=points.device)
    for b0 in range(0, points.shape[0], PATCH_BLOCK):
        cb, mb = c[b0:b0 + PATCH_BLOCK], member[b0:b0 + PATCH_BLOCK]
        dd = torch.sum((cb[:, :, None, :] - cb[:, None, :, :]) ** 2, dim=-1)
        dd = torch.where(mb[:, :, None] & mb[:, None, :] & ~eye, dd, float("inf"))
        key = ((dd + 0.0).view(torch.int32).to(torch.int64) << 32) | cols
        pos = torch.topk(key, k, dim=2, largest=False, sorted=True).values & 0xFFFFFFFF
        ok = torch.isfinite(torch.gather(dd, 2, pos))
        g_idx.append(torch.where(ok, pos, 0))
        g_mask.append(ok)
    return x, member, torch.cat(g_idx), torch.cat(g_mask), r_inv


# --- the model -------------------------------------------------------------------

def _batchnorm(h, var: dict, name: str):
    return ((h - var[f"batch_stats/{name}/mean"])
            * torch.rsqrt(var[f"batch_stats/{name}/var"] + BN_EPS)
            * var[f"params/{name}/scale"] + var[f"params/{name}/bias"])


def model(x, member, g_idx, g_mask, var: dict, names: dict, slope: float):
    """The raw outputs (B, 3) of a block of patches."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    edge = (g_mask & member[:, :, None]).to(x.dtype)[..., None]
    h, outs = x, []
    for name in names["convs"]:
        xi = h[:, :, None, :].expand(-1, -1, g_idx.shape[2], -1)
        e = torch.cat([xi, h[rows, g_idx] - xi], dim=-1)
        z = contract("bpkc,co->bpko", e, var[f"params/{name}/lin/kernel"])
        mean = torch.sum(z * edge, dim=2) / torch.clamp(edge.sum(dim=2), min=1.0)
        h = torch.nn.functional.leaky_relu(_batchnorm(mean, var, f"{name}/bn"), slope)
        outs.append(h)
    h = torch.cat(outs, dim=-1)
    for name in names["prepool"]:
        h = contract("bpc,co->bpo", h, var[f"params/{name}_lin/kernel"])
        h = torch.nn.functional.leaky_relu(_batchnorm(h, var, f"{name}_bn"), slope)
    m = member[..., None]
    mx = torch.where(m, h, float("-inf")).amax(dim=1)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    mean = torch.where(m, h, 0.0).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1).to(h.dtype)
    h = torch.cat([mx, mean], dim=-1)
    for name in names["postpool"]:
        h = contract("bc,co->bo", h, var[f"params/{name}_lin/kernel"]) + var[
            f"params/{name}_lin/bias"]
        h = _batchnorm(h, var, f"{name}_bn")
    head = names["head"]
    return contract("bc,co->bo", h, var[f"params/{head}/kernel"]) + var[f"params/{head}/bias"]


def predict(points: torch.Tensor, variables: dict, config: dict) -> torch.Tensor:
    """The cloud's world-frame unit normals (N, 3), float32 on ``points``'
    device."""
    dev = points.device
    points = points.to(torch.float32)
    var = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in variables.items()}
    with torch.no_grad():
        idx, _ = knn(points, int(config["normal_k"]), exclude_self=True)
        normals = orient(points, pvt_normals(points, idx), idx)
        x, member, g_idx, g_mask, r_inv = md_patches(
            points, normals, int(config["num_nodes"]), int(config["patch_k"]),
            int(config["feature_k"]), float(config["k_patch_radius"]))
        names = layer_names(config)
        pred = torch.cat([model(x[s:s + PATCH_BLOCK], member[s:s + PATCH_BLOCK],
                                g_idx[s:s + PATCH_BLOCK], g_mask[s:s + PATCH_BLOCK], var, names,
                                float(config["leaky_slope"]))
                          for s in range(0, points.shape[0], PATCH_BLOCK)])
        pred = pred / torch.clamp(torch.linalg.norm(pred, dim=-1, keepdim=True), min=1e-12)
        return torch.sum(r_inv * pred[:, None, :], dim=-1)
