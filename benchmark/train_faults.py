"""The readings that the training cell's comparison limits are set from,
sound and broken (``benchmark/limits/ico6_dgcnn_train.json``).

    python3 benchmark/train_faults.py --seeds 1,2,... [--workload ico6_dgcnn_train]

For each seed: the cell's input drawn from the seed; the program's timed
path once after a warm-up job, then once under each fault of ``FAULTS``,
planted through the wrapper the harness takes (``harness.run_cell``'s
``faults``); and the reference at TF32 in the program's place (the
control). Each compared with the float32 reference the way a run's
sample is. One JSON line each. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _flat(tensors):
    import torch

    return torch.cat([t.reshape(-1) for t in tensors])


def unchanged(run):
    """The state left where it started: the job's losses, then the start's
    parameters and running statistics in place of every state."""
    system = run.__self__

    def f(job):
        losses = run(job)[0]
        system.model.load_state_dict(system.start["model"])
        return losses, _flat(system.params), _flat(system.stats), _flat(system.params)
    return f


def lr_doubled(run):
    """Adam at twice the configuration's learning rate."""
    for group in run.__self__.start["train"]["optimizer"]["param_groups"]:
        group["lr"] *= 2
    return run


def no_bias_correction(run):
    """Adam without its bias correction: every job starts from empty
    moments at a step count so large that 1 - beta^t is 1."""
    import torch

    system = run.__self__
    system.start["train"]["optimizer"]["state"] = {
        i: {"step": torch.tensor(1e9), "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)}
        for i, p in enumerate(system.model.parameters())}
    return run


FAULTS = {"unchanged": unchanged, "lr_doubled": lr_doubled,
          "no_bias_correction": no_bias_correction}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/train_faults.py")
    ap.add_argument("--workload", default="ico6_dgcnn_train")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ["NGPD_TORCH_BUILD_DIR"] = str(ROOT / "build")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import catalog
    from benchmark.gen import pool

    cell = catalog.load_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    entry = cell.entry
    system = entry.System(cell.config, cell.traffic, dev)
    start = copy.deepcopy(system.start)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",") if s):
        job = pool.make_pool(cell.traffic, seed, dev)[0]
        if n == 0:
            system.run(job)  # warm-up: kernels built, graphs captured
        ref = entry.reference(cell.config, cell.traffic, job)
        for side, fault in [("program", None), *FAULTS.items()]:
            run = system.run if fault is None else fault(system.run)
            out = tuple(t.detach().clone() for t in run(job))
            system.start = copy.deepcopy(start)
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "numbers": entry.compare(out, ref)}), flush=True)
        control = entry.reference(cell.config, cell.traffic, job, control=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": "control_tf32",
                          "numbers": entry.compare(control, ref)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
