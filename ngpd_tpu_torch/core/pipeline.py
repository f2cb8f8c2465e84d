"""Pipeline constants shared with the reference (``ngpd_tpu/core/pipeline.py``).

Only the default class strategy is ported so far; the dense ``(N, k)``
denoise path is still to be ported (see ROADMAP.md).
"""

STEP_NAMES = ("flat", "edge", "corner", "feature", "new", "dummy")
DEFAULT_STRATEGY = ("flat", "edge", "feature")
