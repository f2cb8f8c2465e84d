"""The benchmark of ngpd_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Loads the cell that ``BENCHMARK.json``
names, draws its inputs from the seed, warms up one job, runs the cell's
jobs in a closed loop for ``--seconds``, compares a sample of the outputs
with the plain reference, and prints one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
from a profiled slice of the window), ``device`` and, last, ``checks``:
each number compared beside its limit, also printed as the last lines of
standard error. Exits non-zero with no result line where the card or the
cell's chips are missing, or where jax, jaxlib, flax or ngpd_tpu were
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The program's kernel builds stay inside the checkout, at a fixed path.
os.environ["NGPD_TORCH_BUILD_DIR"] = str(ROOT / "build")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import catalog, harness

    cell = catalog.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import ngpd_tpu_torch  # noqa: F401  the program under test; fails where it is absent

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.loaded_forbidden()
    if bad:
        print("loaded modules of the JAX package or JAX: " + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
