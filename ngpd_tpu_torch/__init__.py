"""ngpd_tpu_torch — the PyTorch / CUDA port of ngpd_tpu for one NVIDIA H100.

The JAX package ``ngpd_tpu`` stays the reference; this package never
imports it (nor JAX). Ported so far: the large-cloud hybrid denoise
(``core.cuda_fused.denoise_hybrid``) with its window kernels K0/K1/K2 as
hand-written CUDA C++ (``kernels/``), the IO it needs, the Chamfer-family
metrics, the ``denoise``/``eval`` CLI and the throughput bench; and the
four-pass engine in exact-delta mode (``core.cuda_fused.denoise_passes``)
with its passes A-D as CUDA C++.
"""

from .config import DenoiseConfig
from .core.cloud import PointCloud
from .core.cuda_fused import denoise_hybrid, denoise_passes
from .io.obj import load_obj, save_obj

__all__ = ["DenoiseConfig", "PointCloud", "denoise_hybrid", "denoise_passes",
           "load_obj", "save_obj"]
