"""The traced sub-window of a `--trace 1` run and its reduction.

`SubWindow` brackets a few units of work (train steps, test batches) by
device synchronisations and records them with torch.profiler; the
profiler's own start and stop, which collect the record, are timed apart
so that the window's rates can leave them out. `reduce`
turns the record into what the per-layer readers and the result line read:
the device's busy seconds (the union of its operations' intervals), the
window's seconds, the operations launched, the device seconds of each
kernel name, and the longest idle gaps, each named by the innermost of the
benchmark's own spans (`record_function` ranges) open at its middle.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

TOP = 10


def span(name: str):
    """A benchmark span around a call into a layer of the program."""
    return record_function(name)


class SubWindow:
    """`spans` False records the device alone (CUPTI's kernel records, which
    cost the host little: its busy share and kernel times); True records
    the host's operations and the benchmark's spans beside it (what the
    host did in each idle gap, at a higher cost to the host)."""

    def __init__(self, device: torch.device, spans: bool = False):
        self.device, self.spans = device, spans
        self.prof: Optional[profile] = None
        self.seconds = 0.0
        self.units = 0
        self.overhead_s = 0.0  # the profiler's own start and stop

    def __enter__(self):
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.spans else [])
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        self.overhead_s = self._t0 - t
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.seconds = t - self._t0
        self.prof.__exit__(*exc)
        self.overhead_s += time.perf_counter() - t
        return False


def _union(intervals: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def _device_events(window: SubWindow, names):
    # the spans' own device-side ranges are annotations, not operations
    return [e for e in window.prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in names and not getattr(e, "is_user_annotation", False)
            and e.time_range.end > e.time_range.start]


def reduce(device: SubWindow, host: Optional[SubWindow], span_names: Iterable[str]) -> Optional[Dict]:
    """The summary of a traced run: the device's busy seconds, launches and
    kernel seconds from the `device` sub-window, and the idle gaps of the
    `host` sub-window, each named by the innermost benchmark span open at
    its middle. None where the device sub-window holds no operation."""
    names = set(span_names)
    dev = _device_events(device, names)
    if not dev:
        return None
    kernel_s: Dict[str, float] = {}
    for e in dev:
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    gaps = []
    if host is not None:
        spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host.prof.events()
                        if e.device_type == DeviceType.CPU and e.name in names),
                       key=lambda s: s[1] - s[0])
        host_busy = _union([(e.time_range.start, e.time_range.end) for e in _device_events(host, names)])
        for (_, a), (b, _) in zip(host_busy, host_busy[1:]):
            mid = 0.5 * (a + b)
            inner = next((s[2] for s in spans if s[0] <= mid <= s[1]), "outside the spans")
            gaps.append([inner, (b - a) * 1e-6])
        gaps.sort(key=lambda g: -g[1])
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": device.seconds,
        "units": device.units,
        "launches": len(dev),
        "kernel_s": kernel_s,
        "device_ops": sorted(([k[:160], v] for k, v in kernel_s.items()), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": gaps[:TOP],
    }


def idle_share(r) -> Optional[float]:
    """The share of the traced window in which no device operation ran, %."""
    t = r["trace"]
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
