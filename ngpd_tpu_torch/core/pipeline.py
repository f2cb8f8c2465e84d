"""Pipeline constants shared with the reference (``ngpd_tpu/core/pipeline.py``).

Only the default class strategy is ported so far (the step names are in
``ops/steps.py``); the dense ``(N, k)`` denoise path is still to be
ported (see ROADMAP.md).
"""

DEFAULT_STRATEGY = ("flat", "edge", "feature")
