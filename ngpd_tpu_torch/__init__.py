"""ngpd_tpu_torch — the PyTorch / CUDA port of ngpd_tpu for one NVIDIA H100.

The JAX package ``ngpd_tpu`` stays the reference; this package never
imports it (nor JAX). Ported so far: the large-cloud hybrid denoise
(``core.cuda_fused.denoise_hybrid``) with its window kernels K0/K1/K2, and
the pass engine (``core.cuda_fused.denoise_passes``) with passes A-D
(exact delta) and the fused pass BD (lagged delta), all hand-written CUDA
C++ (``kernels/``); the dense ``(N, k)`` pipeline in plain torch
(``core.pipeline.denoise`` and the until-minimum-error loops, kNN,
voting, the six steps, normal estimation); the IO, the metrics, the
``denoise``/``eval`` CLI and the throughput bench; the mesh cascade in
plain torch (``meshproc``, ``models.dgcnn``, ``learn.weights``: the guided
normal filter, the DGCNN patch network, the two-pass ``gcn_denoise_mesh``,
the recipe router, the ``denoise-mesh`` CLI and ``bench --mesh``); the
learned point track (``models.patch2normal``, ``learn.predict``, the
``predict-normals`` and ``add-noise`` CLI); and training, both learned
tracks (``learn.train``, ``learn.train_dgcnn``, ``learn.dataset``,
``learn.checkpoints``, ``learn.export``, ``meshproc.collector``, the
``make-dataset`` and ``train`` CLI), in plain torch; the sharded layer on
``torch.distributed`` (``parallel``); and the host side: the native OBJ
parser and exact grid kNN (``native``, C++ built with g++ at first use),
``apps.viz`` and ``utils`` (timing, tracing, the build cache).
"""

from .config import DenoiseConfig
from .core.cloud import PointCloud
from .core.cuda_fused import denoise_hybrid, denoise_passes
from .core.pipeline import denoise, denoise_until_minimum_error
from .io.obj import load_obj, save_obj

__all__ = ["DenoiseConfig", "PointCloud", "denoise", "denoise_hybrid", "denoise_passes",
           "denoise_until_minimum_error", "load_obj", "save_obj"]
