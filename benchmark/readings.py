"""The readings that a cell's comparison limits are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9]

For each of ``--seeds``: the cell's inputs drawn from the seed, the
program's timed path once on each input that a run's sample reaches (the
traffic's ``sample``, after one warm-up job), and the comparison with the
reference, the worst over those inputs: the lower readings. For each of
``--control-seeds``: the reference computed at TF32 in the program's
place, compared with the float32 reference the same way: the upper
readings. One JSON line each. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["NGPD_TORCH_BUILD_DIR"] = str(ROOT / "build")
sys.path.insert(0, str(ROOT))


def worst(rows: list) -> dict:
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a number of the traffic mix, for a diagnosis")
    args = ap.parse_args(argv)

    import torch

    from benchmark import catalog
    from benchmark.gen import pool

    cell = catalog.load_cell(ROOT, args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        cell.traffic[key] = json.loads(value)
    dev = torch.device(args.device)
    count = min(int(cell.traffic["sample"]), int(cell.traffic["pool"]))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    system = cell.entry.System(cell.config, cell.traffic, dev) if seeds else None
    warm = False
    for seed in seeds:
        inputs = pool.make_pool(cell.traffic, seed, dev)[:count]
        if not warm:
            system.run(inputs[0])
            warm = True
        rows = []
        for job in inputs:
            t0 = time.perf_counter()
            out = system.run(job)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            ref = cell.entry.reference(cell.config, cell.traffic, job)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            rows.append(cell.entry.compare(out, ref))
            print(json.dumps({"seed": seed, "side": "program_job", "job_s": t1 - t0,
                              "reference_s": time.perf_counter() - t1}), flush=True)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": "program",
                          "numbers": worst(rows)}), flush=True)
    for seed in controls:
        inputs = pool.make_pool(cell.traffic, seed, dev)[:count]
        rows = [cell.entry.compare(cell.entry.reference(cell.config, cell.traffic, job, True),
                                   cell.entry.reference(cell.config, cell.traffic, job))
                for job in inputs]
        print(json.dumps({"workload": cell.name, "seed": seed, "side": "control_tf32",
                          "numbers": worst(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
