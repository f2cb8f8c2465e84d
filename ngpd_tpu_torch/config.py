"""Centralized typed configuration (the port's own copy).

Field for field the same frozen dataclasses, with the same defaults, as
``ngpd_tpu/config.py``; the port keeps its own copy so that it never
imports the JAX package. ``tests/test_torch_config.py`` holds the two
equal.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    """Classical (tensor-voting) denoise parameters.

    Defaults mirror Processor.denoise() / denoiseUntilMinimumError()
    (Processor.py:110-185).
    """

    # Neighborhood size for the feature decomposition (Processor.py:110).
    feature_k: int = 16
    # Neighborhood size for the vertex-update steps (Processor.py:126 uses 8,
    # denoiseUntilMinimumError defaults to 7 at Processor.py:141).
    step_k: int = 8
    # Binary filter angle for BetterFilteredNVT (Processor.py:111).
    angle: float = math.pi * 5.0 / 12.0
    # Per-class diffusion speeds [flat, edge, corner] (Processor.py:122).
    alphas: tuple[float, float, float] = (1.0, 0.2, 1.0)
    # Displacement rejection threshold as a multiple of the mean 6-NN edge
    # length (Processor.py:120-121: d = 2 * l).
    d_scale: float = 2.0
    # Planarity down-weighting in getClasses (Decompositionor.py:65-69).
    class_scale: float = 0.2
    # VU normal smoothing (Decompositionor.py:92-106).
    vu_tau: float = 0.3
    vu_damping: float = 3.0
    # Number of fixed iterations for denoise() (Processor.py:123).
    iterations: int = 2
    # Max iterations for the until-minimum-error driver.
    max_iterations: int = 64


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Synthetic corruption parameters (Noise.py:33-59)."""

    level: float = 0.3
    # 0: gaussian, 1: impulsive (Noise.py:55-57).
    noise_type: int = 0
    # 0: along vertex normal, 1: random direction (Noise.py:54).
    direction: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Patch2Normal EdgeConv stack (Config.py:6-17, Model.py:53-148)."""

    input_size: int = 8
    output_size: int = 3
    num_edgeconv: int = 6
    num_dynamic_edgeconv: int = 0
    num_prepool: int = 1
    num_postpool: int = 3
    hidden: tuple[int, ...] = (64, 64, 128, 256, 256, 256, 512, 256, 64)
    dynamic_edgeconv_k: int = 8
    dropout_rate: float = 0.5
    leaky_slope: float = 0.2
    # Fixed patch size (nodes per patch) — the TPU-side replacement for the
    # reference's ragged per-patch graphs (Processor.py:50-81). 64 matches
    # the legacy pipeline's padded patch size (DataUtils.py:40-70) and
    # PatchConfig.num_nodes.
    patch_size: int = 64
    # Fixed intra-patch neighbor count carried with each patch.
    patch_k: int = 12


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (Config.py:19-37, Manager.py:47-86)."""

    batch_size: int = 64
    learning_rate: float = 1e-3
    min_epochs: int = 20
    num_epochs: int = 100
    early_stopping_patience: int = 10
    monitor: str = "val_custom_val_loss"
    checkpoint_top_k: int = 5
    split: tuple[float, float, float] = (0.6, 0.2, 0.2)
    gaussian_noise_levels: tuple[float, ...] = (0.01, 0.02, 0.03)
    impulsive_noise_levels: tuple[float, ...] = (0.01, 0.02, 0.03)
    # Feature/non-feature balancing ratio (FileDataset.py:173-182).
    balance_ratio: float = 1.5
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class GNFConfig:
    """Guided normal filtering (MeshNormalFiltering.cpp:29-40).

    Defaults are the round-4 bi-objective operating point tuned for
    THIS repo's guidance network (docs/GOLDEN.md): picked on the four
    golden meshes under a 1.5x chamfer cap and validated to win on
    both Ea and CD on seven held-out shapes (examples/
    validate_heldout.py). The reference app's own constants
    (MeshNormalFiltering.cpp:29-40, tuned for ITS network) are kept as
    ``REFERENCE_GNF``."""

    radius_scale: float = 2.0
    sigma_s_scale: float = 1.0
    normal_iterations: int = 20
    sigma_r: float = 0.12
    vertex_iterations: int = 8
    # Guidance-normal smoothing pre-pass (no reference counterpart —
    # MeshNormalFiltering.cpp consumes the network's predictions raw).
    # On crease-free organics the per-face prediction errors are nearly
    # independent, so a few rounds of bilateral averaging of the
    # GUIDANCE field cancels them ~sqrt(K) while the true normal field
    # varies slowly; the range term (bandwidth ``guidance_smooth_sigma``
    # in unit-normal distance, 0.5 ~ 29 deg) keeps any sharp feature
    # from mixing. Off (0 iterations) in the default recipe; the
    # organic auto-recipe turns it on (docs/GOLDEN.md). The sigma
    # default is the measured organic-recipe value (round-5 sweep) and
    # matches the CLI/--guidance-smooth-sigma default.
    guidance_smooth_iterations: int = 0
    guidance_smooth_sigma: float = 0.5


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Mesh-patch construction (PatchData.cpp:91,161-162; Config.py:49-50)."""

    ring: int = 2
    radius_factor: float = 16.0
    num_nodes: int = 64
    num_features: int = 17
    k_patch_radius: float = 4.0
    # Intra-patch neighbor count for the point-cloud patch graphs.
    patch_k: int = 12
    # Tensor-vote falloff (RotationMatrix.py:12 uses sigma=1/3, i.e. the
    # exponent -d/sigma == -3d; PatchData.cpp:262-290 uses exp(-3*d)).
    sigma_inv: float = 3.0


DEFAULT_DENOISE = DenoiseConfig()
DEFAULT_NOISE = NoiseConfig()
DEFAULT_MODEL = ModelConfig()
DEFAULT_TRAIN = TrainConfig()
DEFAULT_GNF = GNFConfig()
# The reference app's shipped constants (MeshNormalFiltering.cpp:29-40).
REFERENCE_GNF = GNFConfig(
    normal_iterations=12, sigma_r=0.3, vertex_iterations=16
)
DEFAULT_PATCH = PatchConfig()
