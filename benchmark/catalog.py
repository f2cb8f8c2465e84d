"""Everything the harness runs, found by name from data files.

``BENCHMARK.json`` at the root of a checkout names the cells, their
configurations and traffic mixes, and the metrics. A configuration is
``benchmark/configs/<name>.json`` (its file as ``BENCHMARK.json`` gives
it), which names its entry, ``benchmark/entries/<entry>.py``. A traffic
mix is ``benchmark/traffic/<name>.json``, a cell's comparison limits
``benchmark/limits/<cell>.json``, and every metric a reader of its own:
``benchmark/end_to_end/<metric>.py`` or ``benchmark/layer_metrics/<metric>.py``.
Nothing here names a cell.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # the configuration's file, with "name"
    traffic: dict  # the mix's file, with "name"
    limits: dict  # number name -> limit
    entry: object  # the module of benchmark/entries/<entry>.py
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path  # where its files were found


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_name(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric of BENCHMARK.json is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with the files it
    names read from ``bench_dir``."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cell = _by_name(bench["workloads"], workload, "workload")
    conf = _by_name(bench["configs"], cell["config"], "config")
    config = dict(json.loads((Path(root) / conf["file"]).read_text()), name=conf["name"],
                  root=str(root))
    traffic = dict(json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text()),
                   name=cell["traffic"])
    limits = json.loads((bench_dir / "limits" / f"{workload}.json").read_text())["limits"]
    entry = load_module(bench_dir / "entries" / f"{config['entry']}.py",
                        f"benchmark_entry_{config['entry']}")
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(workload, int(cell["chips"]), config, traffic, limits, entry, e2e, layer,
                Path(bench_dir))


def reader(kind: str, metric: str, bench_dir: Path = HERE) -> Callable:
    """``read`` of ``bench_dir/<kind>/<metric>.py``."""
    mod = load_module(bench_dir / kind / f"{metric}.py",
                      f"benchmark_{kind}_{metric.replace('.', '_')}")
    return mod.read
