"""MD patch extraction (torch), as ``ngpd_tpu/core/patches.py``: the
inputs of the Patch2Normal model, one fixed-shape patch per point.

  * Patch membership: kNN(P) masked by the MD ball radius
    r = k_patch_radius * sqrt(mean mass over the feature-k neighbourhood).
  * Per-point mass: pi * r_k^2 / k from the k-th neighbour distance.
  * Node features x = [c(3), n(3), a(1), deg(1)]: c centred, scaled by the
    patch scale factor and rotated by R_inv; target y = gt_n @ R_inv.
  * Intra-patch graph: each node's ``patch_k`` nearest nodes within its
    patch, over the rotated coordinates.

Ties. The intra-patch kNN selects with ``ops/knn.py``'s stable rule (an
int64 key of the distance's bits above the column), so among equal
distances the lower node comes first, as ``jax.lax.top_k`` keeps it.

Frames. ``R_inv`` holds the eigenvectors of the MD voting tensor, a sum of
outer products of reflected normals. On a smooth surface that tensor is
nearly rank 1 and its two small eigenvalues lie close, so the tangent axes
turn under a rounding change, in the reference's solver as in this one
(tests/test_torch_point_patches.py reads how far).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import PatchConfig
from ..device import exact_float32, resolve_device
from ..ops.knn import _topk_smallest, knn
from ..utils import prof
from . import voting

# Bytes of one (chunk, P, P, 3) difference block of the intra-patch kNN;
# at 100k patches of 64 nodes the whole block would take 4.9 GB.
PAIR_BLOCK_BYTES = 1 << 30


class PatchBatch(NamedTuple):
    """Fixed-shape patch batch, consumed by ``Patch2NormalModel``."""

    x: torch.Tensor  # (B, P, 8)
    nbr_idx: torch.Tensor  # (B, P, K) intra-patch indices, int64
    nbr_mask: torch.Tensor  # (B, P, K)
    node_mask: torch.Tensor  # (B, P)
    y: torch.Tensor  # (B, 3) rotated GT normal
    r_inv: torch.Tensor  # (B, 3, 3) to un-rotate predictions


def point_masses(dists: torch.Tensor, k: int) -> torch.Tensor:
    """Area-per-point estimate from the k-th NN squared distance."""
    return math.pi * dists[:, -1] / k


def md_selection(points: torch.Tensor, cfg: PatchConfig = PatchConfig(),
                 feature_k: int = 16, num_valid: Optional[int] = None):
    """Patch membership: kNN(P) capped by the MD ball radius.

    Returns (Neighborhood (N, P), mass (N,), radii (N,))."""
    nbh_k, d_k = knn(points, feature_k, num_valid=num_valid)
    mass = point_masses(d_k, feature_k)
    mean_mass = nbh_k.mean(nbh_k.gather(mass))
    radii = cfg.k_patch_radius * torch.sqrt(torch.clamp(mean_mass, min=0.0))
    nbh_p, d_p = knn(points, cfg.num_nodes, num_valid=num_valid)
    return nbh_p.and_mask(d_p <= (radii**2)[:, None]), mass, radii


def masked_pair_knn(x: torch.Tensor, node_mask: torch.Tensor, k: int):
    """Each node's k nearest other valid nodes of its patch by the sum of
    squared coordinate differences: (B, P, C), (B, P) -> (idx, mask), each
    (B, P, k). Equal distances resolve to the lower node; slots without a
    valid node are masked and carry index 0."""
    b, p, c = x.shape
    chunk = max(1, PAIR_BLOCK_BYTES // (p * p * c * x.element_size()))
    cols = torch.arange(p, device=x.device).expand(p, p)
    eye = torch.eye(p, dtype=torch.bool, device=x.device)
    idx_out, mask_out = [], []
    for xc, mc in zip(torch.split(x, chunk), torch.split(node_mask, chunk)):
        diff = xc[:, :, None, :] - xc[:, None, :, :]
        d = torch.sum(diff.square_(), dim=-1)
        d = torch.where(mc[:, :, None] & mc[:, None, :], d, torch.inf)
        d = d + torch.where(eye, torch.inf, 0.0)
        dk, idx = _topk_smallest(d.reshape(-1, p), cols.repeat(xc.shape[0], 1), k)
        keep = torch.isfinite(dk)
        idx_out.append(torch.where(keep, idx, 0).reshape(xc.shape[0], p, k))
        mask_out.append(keep.reshape(xc.shape[0], p, k))
    return torch.cat(idx_out), torch.cat(mask_out)


def _rotate(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """einsum('n...i,nij->n...j'): rows of v times each point's 3x3."""
    r = r.reshape(r.shape[:1] + (1,) * (v.dim() - 2) + (3, 3))
    return torch.sum(v[..., :, None] * r, dim=-2)


def extract_patches(points: torch.Tensor, normals: torch.Tensor,
                    gt_normals: Optional[torch.Tensor] = None,
                    cfg: PatchConfig = PatchConfig(), feature_k: int = 16,
                    num_valid: Optional[int] = None, device=None,
                    selection=None) -> PatchBatch:
    """One patch per point, all N at once (getMDPatches semantics).
    ``selection`` is ``md_selection``'s result for these points, computed
    here when not given. Spans: ``ngpd.normals.select`` (that selection),
    ``.frames`` (the MD transform, ``R_inv`` and the node features) and
    ``.pair_knn`` (the intra-patch graph)."""
    dev = resolve_device(device)
    exact_float32()
    points = torch.as_tensor(points, dtype=torch.float32).to(dev)
    normals = torch.as_tensor(normals, dtype=torch.float32).to(dev)
    gt_n = normals if gt_normals is None else torch.as_tensor(
        gt_normals, dtype=torch.float32).to(dev)
    if selection is None:
        with prof.span("ngpd.normals.select", dev):
            selection = md_selection(points, cfg, feature_k, num_valid)
    nbh, mass, _ = selection

    with prof.span("ngpd.normals.frames", dev):
        dec, scale = voting.md_transformation(points, nbh, normals, mass)
        r_inv = voting.r_inv(dec, normals)  # (N, 3, 3)

        pj = nbh.gather(points)  # (N, P, 3)
        nj = nbh.gather(normals)
        aj = nbh.gather(mass)
        node_mask = nbh.mask
        # The membership count of each member's own patch (mask-aware degree).
        dj = nbh.gather(torch.sum(nbh.mask, dim=1).to(torch.float32))

        m = node_mask.to(points.dtype)[..., None]
        centers = torch.sum(pj * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
        c = _rotate((pj - centers[:, None, :]) * scale[:, None, None], r_inv)
        n_rot = _rotate(nj, r_inv)
        a = (aj * scale[:, None])[..., None]
        x = torch.cat([c, n_rot, a, dj[..., None]], dim=-1)  # (N, P, 8)
        x = torch.where(node_mask[..., None], x, 0.0)
        y = _rotate(gt_n, r_inv)

    with prof.span("ngpd.normals.pair_knn", dev):
        nbr_idx, nbr_mask = masked_pair_knn(c, node_mask,
                                            min(cfg.patch_k, cfg.num_nodes - 1))
    return PatchBatch(x=x, nbr_idx=nbr_idx, nbr_mask=nbr_mask, node_mask=node_mask,
                      y=y, r_inv=r_inv)
