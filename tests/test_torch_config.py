"""The port's config dataclasses equal ngpd_tpu.config field for field."""

import dataclasses

import pytest
import torch

import ngpd_tpu.config as ref
import ngpd_tpu_torch.config as port

torch.set_num_threads(2)

CLASSES = ["DenoiseConfig", "NoiseConfig", "ModelConfig", "TrainConfig",
           "GNFConfig", "PatchConfig"]
CONSTANTS = ["DEFAULT_DENOISE", "DEFAULT_NOISE", "DEFAULT_MODEL", "DEFAULT_TRAIN",
             "DEFAULT_GNF", "REFERENCE_GNF", "DEFAULT_PATCH"]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults(name):
    a, b = getattr(ref, name), getattr(port, name)
    fa = [(f.name, f.default) for f in dataclasses.fields(a)]
    fb = [(f.name, f.default) for f in dataclasses.fields(b)]
    assert fa == fb
    assert b.__dataclass_params__.frozen


@pytest.mark.parametrize("name", CONSTANTS)
def test_module_constants(name):
    assert dataclasses.asdict(getattr(ref, name)) == dataclasses.asdict(getattr(port, name))
