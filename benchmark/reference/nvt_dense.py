"""Plain reference of the normal-voting denoise on dense (N, k)
neighbourhoods, recomputed every iteration from exact brute-force kNN.

Per iteration (Processor.denoise of the thesis code): the k nearest
neighbours (feature_k and step_k, each point its own first neighbour);
the filtered normal voting tensor (NVT) over the feature neighbours with
weight [acos(|normalize(p_j - p_i) . n_j|) > angle] and the zero-weight
rescue; VU-smoothed normals; a second filtered NVT of the smoothed
normals; classes by argmax of (scale x planarity, linearity, sphericity);
each class's step over the step neighbours, damped by its alpha and
rejected where it reaches d = d_scale x the mean 6-NN edge length (the
6-NN query counts the point itself as a zero-length edge), computed once
on the input; the smoothed normals carried to the next iteration.

Squared distances are float32 |q|^2 + |p|^2 - 2 q.p clamped at 0, and
equal distances keep the lower index. Sums over the neighbour axis go
through ``numerics.contract``.
"""

from __future__ import annotations

import torch

from .numerics import classes_c, contract, eigh3x3, solve3x3_guarded


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Qa, 3) x (Qb, 3) -> (Qa, Qb) squared distances, clamped at 0."""
    aa = (a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1] + a[:, 2] * a[:, 2])[:, None]
    bb = (b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1] + b[:, 2] * b[:, 2])[None, :]
    ab = (a[:, 0:1] * b[:, 0][None, :] + a[:, 1:2] * b[:, 1][None, :]
          + a[:, 2:3] * b[:, 2][None, :])
    return torch.clamp(aa + bb - 2.0 * ab, min=0.0)


def knn(points: torch.Tensor, k: int, chunk: int = 2048):
    """(idx (N, k) int64, sqdist (N, k)): the k nearest points of every
    point, ascending, ties to the lower index (selection on the key
    distance bits << 32 | index)."""
    n = points.shape[0]
    cols = torch.arange(n, dtype=torch.int64, device=points.device)[None, :]
    idx, dist = [], []
    for q0 in range(0, n, chunk):
        d = sqdist(points[q0 : q0 + chunk], points)
        key = ((d + 0.0).view(torch.int32).to(torch.int64) << 32) | cols
        pos = torch.topk(key, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
        idx.append(pos)
        dist.append(torch.gather(d, 1, pos))
    return torch.cat(idx), torch.cat(dist)


def _sum_outer(a, b):
    return contract("nki,nkj->nij", a, b)


def _normalize(v, eps=1e-12):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def filtered_nvt(points, idx, normals, angle):
    """Eigenpairs of the filtered NVT of ``normals`` over ``idx``."""
    vj, nj = points[idx], normals[idx]
    dv = _normalize(vj - points[:, None, :])
    ang = torch.acos(torch.clamp(torch.abs(torch.sum(dv * nj, dim=-1)), -1.0, 1.0))
    w = ang > angle
    w = torch.where((torch.sum(w, dim=1) == 0)[:, None], torch.ones_like(w), w)
    wf = w.to(nj.dtype)
    t = _sum_outer(nj * wf[..., None], nj) / torch.clamp(wf.sum(dim=1), min=1.0)[:, None, None]
    return eigh3x3(t)


def vu_smoothed(eigval, eigvec, n, tau, damping):
    """normalize(damping n + sum over eigenvalues above tau of (e.n) e)."""
    lam = torch.flip(eigval, dims=(1,))
    vecs = torch.flip(eigvec, dims=(2,))
    keep = (lam > tau).to(n.dtype)
    proj = torch.sum(vecs * n[:, :, None], dim=1)
    return _normalize(damping * n + torch.sum((keep * proj)[:, None, :] * vecs, dim=2))


def _clamp(vi, opt, alpha, d):
    di = (opt - vi) * alpha
    return torch.where((torch.linalg.norm(di, dim=-1) < d)[:, None], vi + di, vi)


def _system(njw, nj, vj):
    a = contract("nki,nkj->nij", njw, nj)
    b = contract("nki,nk->ni", njw, torch.sum(nj * vj, dim=-1))
    return a, b


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _matvec(m, v):
    return torch.sum(m * v[..., None, :], dim=-1)


def flat_step(p, idx, n, d, alpha, delta):
    vj, nj = p[idx], n[idx]
    dist = vj - p[:, None, :]
    d2 = torch.clamp(delta * delta, min=1e-30)
    sim = torch.exp(-16.0 * torch.sum((n[:, None, :] - nj) ** 2, dim=-1) / d2)
    close = torch.exp(-4.0 * torch.sum(dist ** 2, dim=-1) / d2)
    wij = sim * close
    dot = torch.sum(nj * dist, dim=-1)
    summed = contract("nk,ni->ni", wij * dot, n)
    di = summed / torch.clamp(torch.sum(wij, dim=1), min=1e-30)[:, None] * alpha
    di = torch.where((torch.linalg.norm(di, dim=-1) <= d)[:, None], di, 0.0)
    return p + di


def edge_step(p, idx, n, y, d, alpha):
    vj, nj = p[idx], n[idx]
    yk = y[:, None, :]
    vj_pi = vj - torch.sum((vj - p[:, None, :]) * yk, dim=-1, keepdim=True) * yk
    nj_pi = nj - torch.sum(nj * yk, dim=-1, keepdim=True) * yk
    deg = float(idx.shape[1])
    y_o = _outer(y, y)
    a, b = _system(nj_pi, nj_pi, vj_pi)
    a = a + deg * y_o
    b = b + deg * _matvec(y_o, p)
    opt, _ = solve3x3_guarded(a, b, p)
    return _clamp(p, opt, alpha, d)


def corner_step(p, idx, n, d, alpha):
    vj, nj = p[idx], n[idx]
    a, b = _system(nj, nj, vj)
    opt, _ = solve3x3_guarded(a, b, p)
    return _clamp(p, opt, alpha, d)


def _three_term(p, idx, n, w):
    vj, nj = p[idx], n[idx]
    ni_o = _outer(n, n)
    s_o, s_o_vj = _system(nj * w[..., None], nj, vj)
    s_vj = contract("nk,nki->ni", w, vj)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    a = eye[None] + ni_o + s_o + float(idx.shape[1]) * ni_o
    b = p + _matvec(ni_o, p) + _matvec(ni_o, s_vj) + s_o_vj
    return a, b


def feature_step(p, idx, n, d, alpha):
    a, b = _three_term(p, idx, n, torch.ones(idx.shape, dtype=p.dtype, device=p.device))
    opt, _ = solve3x3_guarded(a, b, p)
    return _clamp(p, opt, alpha, d)


def new_step(p, idx, n, d, alpha, delta):
    vj, nj = p[idx], n[idx]
    d2 = torch.clamp(delta * delta, min=1e-30)
    plane = torch.sum(nj * (vj - p[:, None, :]), dim=-1)
    a, b = _three_term(p, idx, n, torch.exp(-9.0 * plane ** 2 / d2))
    opt, _ = solve3x3_guarded(a, b, p)
    return _clamp(p, opt, alpha, d)


def class_delta(p, idx, rows):
    """The largest distance of the rows' gathered neighbours from those
    neighbours' mean."""
    vj = p[idx]
    m = rows[:, None].expand(idx.shape).to(p.dtype)
    center = contract("nk,nki->i", m, vj) / torch.clamp(torch.sum(m), min=1.0)
    dist = torch.linalg.norm(vj - center, dim=-1)
    return torch.max(torch.where(m > 0, dist, 0.0))


def iteration(p, n, idx_f, idx_s, d, cfg):
    """One iteration: (positions, smoothed normals, classes int32)."""
    w1, v1 = filtered_nvt(p, idx_f, n, cfg["angle"])
    f_n = vu_smoothed(w1, v1, n, cfg["vu_tau"], cfg["vu_damping"])
    w2, v2 = filtered_nvt(p, idx_f, f_n, cfg["angle"])
    cls = classes_c((w2[:, 0], w2[:, 1], w2[:, 2]), cfg["class_scale"]).to(torch.int32)
    out = []
    for c, name in enumerate(cfg["strategy"]):
        alpha = cfg["alphas"][c]
        if name in ("flat", "new"):
            delta = class_delta(p, idx_s, cls == c)
            step = flat_step if name == "flat" else new_step
            out.append(step(p, idx_s, f_n, d, alpha, delta))
        elif name == "edge":
            out.append(edge_step(p, idx_s, f_n, v2[..., 0], d, alpha))
        elif name == "corner":
            out.append(corner_step(p, idx_s, f_n, d, alpha))
        elif name == "feature":
            out.append(feature_step(p, idx_s, f_n, d, alpha))
        else:
            out.append(p)
    new = torch.where((cls == 0)[:, None], out[0],
                      torch.where((cls == 1)[:, None], out[1], out[2]))
    return new, f_n, cls


def denoise(points, normals, cfg: dict, iterations: int):
    """(positions, normals, classes) after ``iterations`` iterations."""
    p = points.to(torch.float32)
    n = normals.to(torch.float32)
    idx6, _ = knn(p, 6)
    edge = torch.mean(torch.linalg.norm(p[idx6] - p[:, None, :], dim=-1))
    d = cfg["d_scale"] / 2.0 * 2.0 * edge
    cls = None
    for _ in range(iterations):
        idx_f, _ = knn(p, cfg["feature_k"])
        idx_s, _ = knn(p, cfg["step_k"])
        p, n, cls = iteration(p, n, idx_f, idx_s, d, cfg)
    return p, n, cls

