"""Automatic denoise-recipe selection from the noisy mesh alone (torch), as
``ngpd_tpu/meshproc/autorecipe.py``, thresholds and branch order copied.

The reference app leaves the regime knobs to the user: noise level and
type are spinboxes (GCNDenoiser.cpp:25-33), and its filter constants
(MeshNormalFiltering.cpp:29-40) are one-size-fits-all. ngpd_tpu's
golden/held-out record (docs/GOLDEN.md) shows the best knobs are
regime-dependent:

* heavy-noise CAD inputs (fandisk gaus n6) want the WIDE spatial
  kernel (radius_scale 4.0, sigma_s_scale 1.8) and a full-strength
  second cascade pass — Ea 3.47 vs the reference's 3.95;
* crease-free ORGANICS want the guidance-smoothing pre-pass and an
  early-stopped filter (fertility Ea 3.95 vs 4.01 at CD ratio 0.88;
  the round-5 sweep shows one smoothing round is the lever and the
  full iteration budget rides guidance residue into the positions);
* everything else wants the tuned default kernel and the GENTLE
  second pass (4:0.12:2) — over-smoothing is the failure mode.

This module estimates the regime from the noisy mesh itself — no
ground truth, no user input — so the per-regime wins become default
behavior. Two statistics, both from one pass over the face graph:

* ``noise_deg`` — mean angle between edge-adjacent face normals on
  the raw mesh. Vertex noise decorrelates adjacent normals, so this
  tracks noise severity (clean meshes sit well under 15 deg; the
  golden heavy-noise inputs sit above 38).
* ``crease_frac`` — fraction of adjacent-face pairs whose angle still
  exceeds ``crease_deg`` after an ANNEALED BILATERAL normal smoothing
  (area x spatial-Gaussian x range weights over the guided filter's
  centroid-kNN neighborhoods, with the range bandwidth tightened each
  round and the range distance compared on the CURRENT normals).
  Noise averages out under the early wide bandwidth; by the tight
  final rounds crease-crossing pairs have decoupled, so surviving
  large dihedrals are geometry. (A spatial-only probe fails here: it
  blurs the creases along with the noise — measured in docs/GOLDEN.md's
  probe table.)
* ``crease_density`` = crease_frac x sqrt(num_faces) — the decision
  signal. True crease sets are 1-D CURVES, so their adjacent-pair
  fraction scales like 1/sqrt(F) and the density is tessellation-
  invariant (measured: fandisk 3.9, wedge 2.4, cylinder 2.6,
  trim-star 3.4 — all curve-like). Smoothing residue that survives on
  coarse curved meshes under heavy noise is AREA-like, so its density
  grows with sqrt(F) (teapot-g6 20.3, cow-i6 10.2, stairs-g6 11.9),
  and organics sit near 0 (fertility 0.6, nicolo 1.0). The wide-kernel
  recipe wins exactly on the curve-like band — the A/B table in
  docs/GOLDEN.md is the evidence.

Thresholds are fixed from the measured tables in docs/GOLDEN.md
(goldens + the held-out A/B suite) — see ``pick_recipe``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import GNFConfig
from ..device import resolve_device
from ..ops.knn import knn
from .filtering import _gnf_radius_sigma
from .trimesh import TriMesh


@dataclasses.dataclass(frozen=True)
class MeshStats:
    """Regime statistics of a (possibly noisy) mesh."""

    noise_deg: float
    crease_frac: float
    crease_density: float


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A complete denoise-mesh parameterization."""

    label: str
    passes: int
    gnf_cfg: GNFConfig
    gnf_cfg2: GNFConfig
    stats: MeshStats


def _adjacent_angles_deg(mesh: TriMesh, normals: torch.Tensor):
    """(F, 3) angles between each face's normal and its edge-adjacent
    neighbours', with the adjacency mask."""
    ff_idx, ff_mask = mesh.face_face_adjacency()
    cos = torch.sum(normals[:, None, :] * normals[ff_idx], dim=-1)
    ang = torch.rad2deg(torch.acos(torch.clamp(cos, -1.0, 1.0)))
    return ang, ff_mask


def smoothed_face_normals(
    mesh: TriMesh,
    iterations: int = 8,
    neighbors: int = 32,
    sigma_r_start: float = 0.7,
    sigma_r_end: float = 0.25,
    device=None,
) -> torch.Tensor:
    """Annealed bilateral normal smoothing — the crease probe.

    The guided filter's accumulation with no vertex updates, the range
    distance compared on the CURRENT normals (self-guided), and the range
    bandwidth annealed wide -> tight: the early wide rounds average the
    noise down, the tight late rounds decouple crease-crossing pairs so
    real dihedrals re-sharpen. Bandwidths are unit-normal distances
    (0.7 ~ a 41-deg angle, 0.25 ~ 14 deg).
    """
    mesh = mesh.to(resolve_device(device))
    normals, areas, centroids = mesh.face_data()
    sigma_s = _gnf_radius_sigma(mesh, 2.0)
    nbh, d2 = knn(centroids, neighbors)
    w_sp = areas[nbh.idx] * torch.exp(-0.5 * d2 / torch.clamp(sigma_s**2, min=1e-30))
    w_sp = torch.where(nbh.mask, w_sp, 0.0)
    n = normals
    for it in range(iterations):
        t = it / max(iterations - 1, 1)
        sigma_r = sigma_r_start + (sigma_r_end - sigma_r_start) * t
        nj = n[nbh.idx]
        r2 = torch.sum((n[:, None, :] - nj) ** 2, dim=-1)
        w = w_sp * torch.exp(-0.5 * r2 / (sigma_r**2))
        acc = torch.sum(w[..., None] * nj, dim=1)
        nrm = torch.linalg.norm(acc, dim=1, keepdim=True)
        n = torch.where(nrm > 1e-12, acc / torch.clamp(nrm, min=1e-12), n)
    return n


def mesh_statistics(
    mesh: TriMesh,
    crease_deg: float = 30.0,
    iterations: int = 8,
    neighbors: int = 32,
    device=None,
) -> MeshStats:
    """Estimate noise severity and crease-curve density (no GT), on
    ``device``."""
    mesh = mesh.to(resolve_device(device))
    normals, _, _ = mesh.face_data()
    raw_ang, mask = _adjacent_angles_deg(mesh, normals)
    m = mask.to(raw_ang.dtype)
    denom = torch.clamp(torch.sum(m), min=1.0)
    noise_deg = float(torch.sum(torch.where(mask, raw_ang, 0.0)) / denom)

    smooth = smoothed_face_normals(mesh, iterations, neighbors, device=mesh.v.device)
    sm_ang, _ = _adjacent_angles_deg(mesh, smooth)
    crease = torch.where(mask, sm_ang > crease_deg, False)
    crease_frac = float(torch.sum(crease) / denom)
    return MeshStats(
        noise_deg=noise_deg,
        crease_frac=crease_frac,
        crease_density=crease_frac * float(mesh.num_faces) ** 0.5,
    )


# Regime thresholds, fixed from the measured probe + A/B tables
# (docs/GOLDEN.md "Auto-recipe" + the round-5 three-arm A/B,
# examples/recipe_ab3.py). The curve-like crease-density band:
# measured true-CAD inputs land in [2.4, 4.0], area-like smoothing
# residue at >= 6.2, organics <= 1.0 — the band edges sit in the gaps.
HEAVY_NOISE_DEG = 38.0
CREASE_DENSITY_LO = 1.5
CREASE_DENSITY_HI = 5.5
# Catastrophic-noise regime: above this raw adjacent-normal angle the
# guidance is too degraded for any specialist recipe and the plain
# tuned filter has the best Ea (measured: stairs-g6 at 65.9 is the
# only such case; teapot-g6 at 52.8 still prefers organic-heavy — the
# gate sits in the gap).
EXTREME_NOISE_DEG = 55.0

# The deployment recipes (docs/GOLDEN.md round-4 tables).
_WIDE = dict(radius_scale=4.0, sigma_s_scale=1.8)
_GENTLE2 = GNFConfig(normal_iterations=4, sigma_r=0.12,
                     vertex_iterations=2)
HEAVY_CAD_RECIPE = dict(
    label="heavy-cad",
    passes=2,
    gnf_cfg=GNFConfig(**_WIDE),
    gnf_cfg2=GNFConfig(**_WIDE),
)
DEFAULT_RECIPE = dict(
    label="default",
    passes=2,
    gnf_cfg=GNFConfig(),
    gnf_cfg2=_GENTLE2,
)
# Crease-free organics: the guidance residue — not feature blur — is
# the whole error, so average it (one bilateral smoothing round of the
# guidance field) and STOP EARLY (the full 20-iteration budget rides
# the residue into the positions; fertility's 1.4x CD gap was exactly
# this, docs/GOLDEN.md organic tables). Light noise converges in 4
# normal iterations; heavy noise still needs ~12.
ORGANIC_RECIPE = dict(
    label="organic",
    passes=2,
    gnf_cfg=GNFConfig(normal_iterations=4,
                      guidance_smooth_iterations=1,
                      guidance_smooth_sigma=0.5),
    gnf_cfg2=_GENTLE2,
)
ORGANIC_HEAVY_RECIPE = dict(
    label="organic-heavy",
    passes=2,
    gnf_cfg=GNFConfig(normal_iterations=12,
                      guidance_smooth_iterations=1,
                      guidance_smooth_sigma=0.5),
    gnf_cfg2=_GENTLE2,
)


def pick_recipe(mesh: TriMesh, stats: MeshStats | None = None, device=None) -> Recipe:
    """Choose the deployment recipe for a noisy mesh.

    The round-5 three-arm A/B (every deployment recipe on 15 cases:
    4 goldens + 11 held-out, `examples/recipe_ab3.py` +
    `organic_ab.py`, tables in docs/GOLDEN.md) made the rule simple:

    * heavy noise on a CURVE-LIKE crease set (the crease-density band
      — true sparse CAD creases: wedge/cylinder/fandisk) -> the
      wide-kernel full-strength cascade;
    * CATASTROPHIC noise (raw disorder >= 55 deg — stairs-g6) -> the
      plain tuned filter; the guidance is too degraded for any
      specialist treatment;
    * everything else -> the guidance-smoothed early-stop ORGANIC
      recipe (noise severity picks the iteration budget). This branch
      won 8 of its 10 A/B cases outright on angular error and ALL of
      them on chamfer distance — per-face guidance errors are nearly
      independent off sharp creases, so averaging them is the lever,
      while the range term (sigma 0.5 ~ 29 deg) protects creases
      sharp enough to matter.

    The round-4 router gated the organic branch on crease density
    <= 1.25 — fixed from two golden datapoints; the held-out A/B
    showed that misroutes spot/homer/teapot (regret up to 1.25 deg),
    while the rule above loses at most 0.14-0.38 deg anywhere
    (trim-star/cow, where the organic route still IMPROVES chamfer
    distance). All branches use the two-stage cascade (stage-2
    checkpoint) — the held-out-validated deployment default.
    """
    if stats is None:
        stats = mesh_statistics(mesh, device=device)
    if (
        stats.noise_deg >= HEAVY_NOISE_DEG
        and CREASE_DENSITY_LO <= stats.crease_density <= CREASE_DENSITY_HI
    ):
        chosen = HEAVY_CAD_RECIPE
    elif stats.noise_deg >= EXTREME_NOISE_DEG:
        chosen = DEFAULT_RECIPE
    else:
        chosen = (
            ORGANIC_HEAVY_RECIPE
            if stats.noise_deg >= HEAVY_NOISE_DEG
            else ORGANIC_RECIPE
        )
    return Recipe(stats=stats, **chosen)
