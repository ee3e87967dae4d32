"""Finds a cell's pieces by name, from `BENCHMARK.json` and the benchmark's
folders alone, so that a new cell, traffic mix or per-layer metric is new
files and entries, never an edit:

- `configs/<config>.json`: the configuration as it is run ("config"), its
  data sets ("data"), its source, and its reference module ("reference");
- `traffic/<traffic>.json`: the mix's parameters, and the general job that
  reads them ("job": a module of `jobs/`);
- `metrics/<metric>.py`: a per-layer metric's reader, `read(r)`, and
  beside it, where it has one, its data, `metrics/<metric>.json`;
- `limits/<cell>.json`: the limit of each number the cell's check compares;
- `reference/<reference>_<job>.py`, where a job needs what
  `reference/<reference>.py` lacks, else `reference/<reference>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, dict]
    bench_dir: str

    @property
    def job(self) -> str:
        return self.traffic["job"]


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def find(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    spec = load_benchmark(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_load(os.path.join(root, conf["file"])), traffic_name=w["traffic"],
        traffic=_load(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
        end_to_end=e2e, per_layer=per_layer,
        limits=_load(os.path.join(bench_dir, "limits", name + ".json")), bench_dir=bench_dir)


def job_module(cell: Cell) -> ModuleType:
    return importlib.import_module(f"benchmark.jobs.{cell.job}")


def reference_module(cell: Cell) -> ModuleType:
    ref = cell.config["reference"]
    for stem in (f"{ref}_{cell.job}", ref):
        if os.path.exists(os.path.join(cell.bench_dir, "reference", stem + ".py")):
            return importlib.import_module(f"benchmark.reference.{stem}")
    raise FileNotFoundError(f"no reference module {ref!r} for the {cell.job} job")


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """(read, data) of the per-layer metric `name`: the `read` function of
    metrics/<name>.py and the contents of metrics/<name>.json, or None."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    data_path = os.path.join(bench_dir, "metrics", name + ".json")
    data: Optional[dict] = _load(data_path) if os.path.exists(data_path) else None
    return module.read, data
