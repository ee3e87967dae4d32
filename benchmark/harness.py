"""One run of one cell of the benchmark of `mmvae_tpu_torch` (see
README.md): set-up, the measured window, the check of what the window
produced against the plain reference, and the result line.

stdout carries, on earlier lines, one JSON object each of what the run
saw (the card, the set-up split, the window, the route counts of the
ar_solve kernels), and as its last line the result: "correct",
"attempted", "failed", "metrics", "device", with --trace 1 "breakdown",
and last "compared", each number the check compared beside its limit.
stderr ends with the same numbers and limits, one a line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from . import cells

NOT_IN_THE_PROCESS = ("jax", "jaxlib", "flax", "mmvae_tpu")


class Run:
    """What one run holds: its cell, seed, device and reference module, the
    set-up split it times and the notes it prints."""

    def __init__(self, cell: cells.Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.ref = cells.reference_module(cell)
        self.split: Dict[str, float] = {}
        self.notes: List[dict] = []

    @contextlib.contextmanager
    def timed(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.split[key] = self.split.get(key, 0.0) + time.perf_counter() - t0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def note(self, kind: str, **values):
        self.notes.append({"note": kind, **values})


def loaded_forbidden() -> List[str]:
    """The modules of JAX or of the JAX package in this process, compared by
    their whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(NOT_IN_THE_PROCESS))


def card_notes() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
                              "temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def route_counts() -> Dict[str, int]:
    from mmvae_tpu_torch.ops import ar_flow

    return {k: int(getattr(ar_flow.ar_solve, k)) for k in ar_flow.COUNTS}


def per_layer(cell: cells.Cell, r: dict) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        read, data = cells.metric_reader(m["name"], cell.bench_dir)
        value = read({**r, "data": data})
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
            t_start: float) -> dict:
    """Runs the cell once and returns the result object (with "notes" and
    "compared"), or raises."""
    run = Run(cell, seed, device)
    run.split["imports_s"] = time.perf_counter() - t_start
    job = cells.job_module(cell)
    if device.type == "cuda":
        from mmvae_tpu_torch.cli.common import torch_device

        with run.timed("cuda_init_s"):
            torch_device(device)  # float32 with TF32 off, as the configuration states
            torch.ones(1, device=device).add_(1)
        run.note("card", name=torch.cuda.get_device_name(device), smi=card_notes())
        counts0 = route_counts()
    with run.timed("job_setup_s"):
        state = job.setup(run)
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        from mmvae_tpu_torch.ops import build

        run.note("build", seconds={k: v[0] for k, v in build.build_log.items()})
        counts1 = route_counts()
    win = job.window(run, state, seconds, trace)
    if device.type == "cuda":
        counts2 = route_counts()
        run.note("route_counts", setup={k: counts1[k] - counts0[k] for k in counts1 if counts1[k] - counts0[k]},
                 window={k: counts2[k] - counts1[k] for k in counts2 if counts2[k] - counts1[k]})
        mem_peak = torch.cuda.max_memory_allocated(device)
    else:
        mem_peak = 0
    run.note("setup", setup_s=setup_s, **run.split)
    run.note("window", seconds=win["seconds"], units=win["units"], memory_peak_bytes=mem_peak,
             **win["notes"])

    summary = None
    if trace and win["subs"]:
        from . import trace as tr

        summary = tr.reduce(win["subs"][0], win["subs"][1] if len(win["subs"]) > 1 else None,
                            win["spans"])
    metrics: Dict[str, dict] = {}
    if trace:
        from .flops import PEAK_FLOPS

        # the window's seconds without the profiler's start and stop
        seconds = win["seconds"] - sum(sub.overhead_s for sub in win["subs"])
        r = {"trace": summary, "window": {"seconds": seconds, "units": win["units"]},
             "flops": job.work(run), "peak_flops": PEAK_FLOPS[cell.config["precision"]]}
        metrics = per_layer(cell, r)
    else:
        values = {**win["metrics"], "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    t_check = time.perf_counter()
    compared = job.check(run, state, win)
    run.note("check", seconds=time.perf_counter() - t_check)
    compared = {k: v for k, v in compared.items() if k in cell.limits}
    limits = {k: cell.limits[k]["limit"] for k in compared}
    correct = bool(win["sound"]) and all(
        math.isfinite(v) and v <= limits[k] for k, v in compared.items())

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": correct, "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if trace:
        if summary is None:
            raise RuntimeError("the traced sub-window holds no device operation")
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["compared"] = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    result["notes"] = run.notes
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="one run of one cell of the benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = cells.find(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = execute(cell, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0), t_start)
    return report(result)


def report(result: dict) -> int:
    """Prints the notes, the compared numbers and the result line; refuses
    (no result, exit 3) where JAX or the JAX package is in the process."""
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for note in result.pop("notes"):
        print(json.dumps(note), flush=True)
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
