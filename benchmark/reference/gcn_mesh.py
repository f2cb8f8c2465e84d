"""Plain reference of the GCN-Denoiser mesh cascade (Shen et al.,
"GCN-Denoiser: Mesh Denoising with Graph Convolutional Networks", TOG
2022): per pass, a 64-face patch around every face, the legacy DGCNN's
normal of each patch, and guided normal filtering with vertex updates.

Per pass:
  * the 64 nearest face centroids of every face (itself first), shared by
    the patches and the filter;
  * patch membership: those within r = sqrt(16 x area) of the centre;
    the patch frame from the reflected-normal voting tensor with weights
    (area / max area) exp(-3 |dc| / r), rows its eigenvectors by descending
    eigenvalue, the first signed by the centre normal, det > 0;
  * 17 node features in the frame (centroid, normal, area / r^2, degree,
    corners) and up to 3 edge-adjacent faces as patch-local indices;
  * the DGCNN (three edge convs over those faces, three over the
    feature-space 8 nearest, 1x1 conv to 1024, max and mean pool, MLP to
    3), eval-mode BatchNorm (eps 1e-5), LeakyReLU 0.2, from the committed
    Flax weights; its normal rotated back to the world;
  * the filter: per round, every face normal the normalized sum over its
    neighbourhood within 2 x the mean adjacent-centroid distance of
    area x exp(-|dc|^2 / 2 sigma_s^2) x exp(-|dg|^2 / 2 sigma_r^2) x the
    guidance (first round) or the last round's normal, then the vertex
    flow p += mean over incident faces of n (n . (c - p)).

Products over patches, channels and neighbours go through
``numerics.contract``.
"""

from __future__ import annotations

import numpy as np
import torch

from .numerics import contract, eigh3x3
from .nvt_dense import knn

BN_EPS = 1e-5


# --- mesh ------------------------------------------------------------------

def face_data(v, f):
    """(F, 3) unit normals, (F,) areas, (F, 3) centroids."""
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cr = torch.linalg.cross(p1 - p0, p2 - p0, dim=1)
    nrm = torch.linalg.norm(cr, dim=1)
    return cr / torch.clamp(nrm, min=1e-30)[:, None], 0.5 * nrm, (p0 + p1 + p2) / 3.0


def vertex_faces(f: np.ndarray, nv: int):
    """(V, max degree) incident faces in face order and their mask."""
    vi = f.ravel().astype(np.int64)
    fi = np.repeat(np.arange(len(f), dtype=np.int64), 3)
    order = np.argsort(vi, kind="stable")
    vi_s, fi_s = vi[order], fi[order]
    counts = np.bincount(vi_s, minlength=nv)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(vi_s)) - starts[vi_s]
    idx = np.zeros((nv, int(counts.max())), np.int64)
    mask = np.zeros(idx.shape, bool)
    idx[vi_s, pos] = fi_s
    mask[vi_s, pos] = True
    return idx, mask


def face_faces(f: np.ndarray):
    """(F, 3) the face across each edge (the first other face that shares
    it, in slot order); a boundary edge gives the face itself, masked."""
    nf = len(f)
    a = f.astype(np.int64)
    b = a[:, [1, 2, 0]]
    key = (np.minimum(a, b) * (int(f.max()) + 1) + np.maximum(a, b)).ravel()
    order = np.argsort(key, kind="stable").astype(np.int64)
    sk = key[order]
    new = np.concatenate([[True], sk[1:] != sk[:-1]])
    gid = np.cumsum(new) - 1
    gstart = np.flatnonzero(new)
    gsize = np.diff(np.concatenate([gstart, [len(sk)]]))
    first = order[gstart][gid]
    second = order[np.minimum(gstart + 1, len(sk) - 1)][gid]
    partner = np.where(order == first, second, first)
    idx = np.empty(nf * 3, np.int64)
    mask = np.zeros(nf * 3, bool)
    idx[order] = np.where(gsize[gid] >= 2, partner // 3, order // 3)
    mask[order] = gsize[gid] >= 2
    return idx.reshape(nf, 3), mask.reshape(nf, 3)


# --- patches -------------------------------------------------------------

def _normalize(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def _frame(dv, nj, a_j, mask, center_normal):
    w = _normalize(torch.linalg.cross(torch.linalg.cross(dv, nj, dim=-1), dv, dim=-1))
    n_ref = 2.0 * torch.sum(nj * w, dim=-1, keepdim=True) * w - nj
    max_area = torch.amax(torch.where(mask, a_j, 0.0), dim=1)
    mu = (a_j / torch.clamp(max_area, min=1e-30)[:, None]) * torch.exp(
        -3.0 * torch.linalg.norm(dv, dim=-1))
    mu = torch.where(mask, mu, 0.0)
    _, vec = eigh3x3(contract("fpi,fpj->fij", n_ref * mu[..., None], n_ref))
    rows = torch.flip(vec.transpose(1, 2), dims=(1,))
    sign0 = torch.where(torch.sum(rows[:, 0, :] * center_normal, dim=1) < 0, -1.0, 1.0)
    rows = rows * sign0[:, None, None]
    det = torch.sum(rows[:, 0, :] * torch.linalg.cross(rows[:, 1, :], rows[:, 2, :], dim=-1),
                    dim=-1)
    flip2 = torch.where(det < 0, -1.0, 1.0)
    return torch.cat([rows[:, :2, :], rows[:, 2:, :] * flip2[:, None, None]], dim=1)


def patches(v, f, ff, nb_idx, nb_mask, d2, radius_factor):
    """((F, 20, 64) network inputs, (F, 3, 3) frames)."""
    ff_idx, ff_mask = ff
    normals, areas, centroids = face_data(v, f)
    radius = torch.sqrt(areas * radius_factor)
    mask = nb_mask & (d2 <= (radius ** 2)[:, None])
    deg = torch.sum(mask, dim=1).to(torch.float32)
    member = nb_idx
    nf, p = member.shape
    c_j, n_j, a_j = centroids[member], normals[member], areas[member]
    dv = (c_j - centroids[:, None, :]) / radius[:, None, None]
    r = _frame(dv, n_j, a_j, mask, normals)
    rel = (v[f[member]] - centroids[:, None, None, :]) / radius[:, None, None, None]
    corners = contract("fij,fpcj->fpci", r, rel)
    normals_al = contract("fij,fpj->fpi", r, n_j)
    feats = torch.cat([
        (torch.mean(corners, dim=2) + 1.0) / 2.0,
        (normals_al + 1.0) / 2.0,
        (a_j / torch.clamp(radius ** 2, min=1e-30)[:, None])[..., None],
        ((((deg[member] - 12.0) / 6.0) + 1.0) / 2.0)[..., None],
        (corners.reshape(nf, p, 9) + 1.0) / 2.0,
    ], dim=-1)
    feats = torch.where(mask[..., None], feats, 0.0)
    adj = ff_idx[member]
    eq = adj[..., None] == member[:, None, None, :]
    ok = ff_mask[member] & torch.any(eq & mask[:, None, None, :], dim=-1)
    local = torch.where(ok, torch.argmax(eq.to(torch.uint8), dim=-1).to(torch.float32),
                        torch.nan)
    order = torch.argsort(torch.where(ok, 0, 1), dim=-1, stable=True)
    local = torch.take_along_dim(local, order, dim=-1)
    n_ok = torch.sum(ok, dim=-1)
    self_idx = torch.arange(p, dtype=torch.float32, device=v.device)[None, :].expand(nf, p)
    fill0 = torch.where(n_ok >= 1, local[..., 0], self_idx)
    fill1 = torch.where(n_ok >= 2, local[..., 1], fill0)
    fill2 = torch.where(n_ok >= 3, local[..., 2], fill1)
    inputs = torch.cat([feats, torch.stack([fill0, fill1, fill2], dim=-1)], dim=-1)
    return inputs.transpose(1, 2), r


# --- the network -----------------------------------------------------------

def load_weights(path, device) -> dict:
    """The flat Flax archive ("params/conv1/Dense_0/kernel", ...) as
    float32 tensors on ``device``."""
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], dtype=torch.float32, device=device) for k in z.files}


def _bn(h, w, name):
    scale, bias = w[f"params/{name}/scale"], w[f"params/{name}/bias"]
    mean, var = w[f"batch_stats/{name}/mean"], w[f"batch_stats/{name}/var"]
    return (h - mean) * (torch.rsqrt(var + BN_EPS) * scale) + bias


def _act(h):
    return torch.where(h >= 0, h, 0.2 * h)


def feature_knn(x, k):
    """Self-inclusive kNN in feature space, (B, P, C) -> (B, P, k), ties
    to the lower index."""
    b, p, _ = x.shape
    d = torch.sum((x[:, :, None, :] - x[:, None, :, :]) ** 2, dim=-1).reshape(-1, p)
    cols = torch.arange(p, dtype=torch.int64, device=x.device)[None, :]
    key = ((d + 0.0).view(torch.int32).to(torch.int64) << 32) | cols
    return (torch.topk(key, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF).reshape(b, p, k)


def dgcnn(inputs, w, k: int = 8, fixed: int = 3, feature_chunk: int = 256):
    """(B, 20, P) patch inputs -> (B, 3) normals in the patch frame."""
    x = inputs[:, :17, :].transpose(1, 2)
    idx = inputs[:, 17:20, :].to(torch.int64).transpose(1, 2)
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    outs = []
    for i in range(1, 7):
        if i <= fixed:
            nbr = idx
        else:
            nbr = torch.cat([feature_knn(xc, k) for xc in torch.split(x, feature_chunk)])
        xj = x[b, nbr]
        xi = x[:, :, None, :].expand_as(xj)
        h = contract("bpkc,co->bpko", torch.cat([xj - xi, xi], dim=-1),
                     w[f"params/conv{i}/Dense_0/kernel"])
        x = torch.amax(_act(_bn(h, w, f"conv{i}/BatchNorm_0")), dim=2)
        outs.append(x)
    h = _act(_bn(contract("bpc,co->bpo", torch.cat(outs, dim=-1), w["params/conv7/kernel"]),
                 w, "bn7"))
    h = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
    h = _act(_bn(contract("bc,co->bo", h, w["params/linear1/kernel"]), w, "bn8"))
    for j, bn in ((2, "bn9"), (3, "bn10")):
        h = _act(_bn(contract("bc,co->bo", h, w[f"params/linear{j}/kernel"])
                     + w[f"params/linear{j}/bias"], w, bn))
    return contract("bc,co->bo", h, w["params/linear4/kernel"]) + w["params/linear4/bias"]


# --- the filter ----------------------------------------------------------

def _mean_adjacent(centroids, ff):
    ff_idx, ff_mask = ff
    d = torch.linalg.norm(centroids[ff_idx] - centroids[:, None, :], dim=-1)
    m = ff_mask.to(d.dtype)
    return torch.sum(torch.where(m > 0, d, 0.0)) / torch.clamp(torch.sum(m), min=1.0)


def vertex_update(v, f, vf, normals, iterations):
    vf_idx, vf_mask = vf
    nf = normals[vf_idx]
    m = vf_mask[..., None]
    deg = torch.clamp(torch.sum(m.to(v.dtype), dim=1), min=1.0)
    pts = v
    for _ in range(iterations):
        cf = ((pts[f[:, 0]] + pts[f[:, 1]] + pts[f[:, 2]]) / 3.0)[vf_idx]
        dot = torch.sum(nf * (cf - pts[:, None, :]), dim=-1)
        pts = pts + torch.sum(torch.where(m, nf * dot[..., None], 0.0), dim=1) / deg
    return pts


def guided_filter(v, f, ff, vf, guidance, gnf: dict, nb_idx, nb_mask, d2):
    """Vertices after ``normal_iterations`` rounds of guided filtering."""
    _, _, c0 = face_data(v, f)
    radius = gnf["radius_scale"] * _mean_adjacent(c0, ff)
    in_radius = nb_mask & (d2 <= radius ** 2)
    g_j = guidance[nb_idx]
    range_w = torch.exp(-0.5 * torch.sum((guidance[:, None, :] - g_j) ** 2, dim=-1)
                        / (gnf["sigma_r"] ** 2))
    cur = v
    for it in range(gnf["normal_iterations"]):
        normals, areas, centroids = face_data(cur, f)
        sigma_s = gnf["sigma_s_scale"] * _mean_adjacent(centroids, ff)
        sp2 = torch.sum((centroids[:, None, :] - centroids[nb_idx]) ** 2, dim=-1)
        wgt = areas[nb_idx] * torch.exp(-0.5 * sp2 / torch.clamp(sigma_s ** 2, min=1e-30)) * range_w
        wgt = torch.where(in_radius, wgt, 0.0)
        src = g_j if it == 0 else normals[nb_idx]
        filt = contract("fk,fki->fi", wgt, src)
        nrm = torch.linalg.norm(filt, dim=1, keepdim=True)
        filt = torch.where(nrm > 1e-12, filt / torch.clamp(nrm, min=1e-12), normals)
        cur = vertex_update(cur, f, vf, filt, gnf["vertex_iterations"])
    return cur


def cascade(v, f, weights: list, gnfs: list, radius_factor: float, batch: int,
            nodes: int = 64):
    """The denoised vertices after one pass per entry of ``weights``."""
    fn = f.cpu().numpy()
    ff = tuple(torch.as_tensor(a, device=v.device) for a in face_faces(fn))
    vf = tuple(torch.as_tensor(a, device=v.device) for a in vertex_faces(fn, v.shape[0]))
    cur = v
    for w, gnf in zip(weights, gnfs):
        _, _, centroids = face_data(cur, f)
        nb_idx, d2 = knn(centroids, nodes)
        nb_mask = torch.ones_like(nb_idx, dtype=torch.bool)
        inputs, rot = patches(cur, f, ff, nb_idx, nb_mask, d2, radius_factor)
        pred = torch.cat([dgcnn(x, w) for x in torch.split(inputs, batch)])
        pred = _normalize(pred)
        guidance = _normalize(contract("fji,fj->fi", rot, pred))
        cur = guided_filter(cur, f, ff, vf, guidance, gnf, nb_idx, nb_mask, d2)
    return cur

