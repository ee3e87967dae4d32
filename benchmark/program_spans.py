"""The program's own spans in a --trace 1 run, for the per-layer readers
that read them: the records of `mmvae_tpu_torch.utils.trace`, which the
program appends in memory while a profiler session is active, with host
start and end in Unix ns and, for a span timed on the device, a pair of
CUDA events.

Both jobs trace the device alone first and then the host beside it
(`jobs/train.py`: `for spans in (False, True)`; `jobs/likelihood.py`:
`spans=b == traced[1]`), so a run's records hold two sub-windows' spans.
The readers take the first, the device-only sub-window's: it carries no
recording of the host's operations, which inflates the host's times (the
train cell read 30-48 % idle under that recording against 18-26 % without,
PERF.md §6). `window` keeps the records up to the end of the `units`-th
unit span (`trainer.step`, `likelihood.protocol`), and nothing where the
record does not hold exactly twice `units` unit spans: were one sub-window
unrecorded (a profiler session that left the program's spans off), its
place would otherwise go silently to the other.

Every reader returns None, and never raises, on a program without the
recorder (the import fails), on a record that does not hold both
sub-windows, and, for a device time, on spans without device events.
"""

from __future__ import annotations

from typing import List, Optional


def program_records() -> Optional[list]:
    """The program's span records, or None where it has no recorder."""
    try:
        from mmvae_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records()


def window(r: dict, unit: str) -> Optional[List]:
    """The device-only sub-window's records: those that start by the end of
    its last `unit` span. None as the module says."""
    t = r.get("trace")
    recs = program_records()
    if t is None or not t.get("units") or recs is None:
        return None
    units = [rec for rec in recs if rec.name == unit]
    if len(units) != 2 * t["units"]:
        return None
    end = units[t["units"] - 1].end_ns
    return [rec for rec in recs if rec.start_ns <= end]


def host_ms_per_unit(r: dict, unit: str, names) -> Optional[float]:
    """The host ms of the spans named in `names` in the device-only
    sub-window, over its units."""
    recs = window(r, unit)
    if recs is None:
        return None
    ns = sum(rec.end_ns - rec.start_ns for rec in recs if rec.name in names)
    return ns / 1e6 / r["trace"]["units"]


def mean_device_ms(r: dict, unit: str, name: str) -> Optional[float]:
    """The mean device ms of the spans named `name` in the device-only
    sub-window, by their CUDA events; None where any has none."""
    recs = window(r, unit)
    if recs is None:
        return None
    mine = [rec for rec in recs if rec.name == name]
    if not mine or any(rec.events is None for rec in mine):
        return None
    return sum(rec.device_ms() for rec in mine) / len(mine)
