"""The readings that a training cell's comparison limits are set from,
where its traffic draws nothing from the run's seed
(``benchmark/limits/roof102k_p2n_train.json``: a clean cloud, the data
set's noise drawn from the configuration's ``data_seed``).

    python3 benchmark/train_seeds.py --workload roof102k_p2n_train --seeds 1,2,...

For each seed: the configuration's ``data_seed``, ``batch_seed`` and
``dropout_seed`` set to it, so that the data set, the batch order and the
keep masks change as another seed's would; then, as
``benchmark/train_faults.py`` reads a cell, the program's timed path once
after a warm-up job, once under each fault of its ``FAULTS``, and the
reference at TF32 in the program's place (the control), each compared
with the float32 reference. One JSON line each. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEEDS = ("data_seed", "batch_seed", "dropout_seed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/train_seeds.py")
    ap.add_argument("--workload", default="roof102k_p2n_train")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.environ["NGPD_TORCH_BUILD_DIR"] = str(ROOT / "build")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import catalog, train_faults
    from benchmark.gen import pool

    cell = catalog.load_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    entry = cell.entry
    job = pool.make_pool(cell.traffic, 0, dev)[0]
    for seed in (int(s) for s in args.seeds.split(",") if s):
        config = dict(cell.config, **{k: seed for k in SEEDS if k in cell.config})
        system = entry.System(config, cell.traffic, dev)
        start = copy.deepcopy(system.start)
        system.run(job)  # warm-up: the data set built, the graphs captured
        ref = entry.reference(config, cell.traffic, job)
        for side, fault in [("program", None), *train_faults.FAULTS.items()]:
            run = system.run if fault is None else fault(system.run)
            out = tuple(t.detach().clone() for t in run(job))
            system.start = copy.deepcopy(start)
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "numbers": entry.compare(out, ref)}), flush=True)
        control = entry.reference(config, cell.traffic, job, control=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": "control_tf32",
                          "numbers": entry.compare(control, ref)}), flush=True)
        del system, ref, control
    return 0


if __name__ == "__main__":
    sys.exit(main())
