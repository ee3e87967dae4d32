"""Spans inside the program, on the profiler's clock.

`span(name)` marks a stretch of host code. It is off unless a
`torch.profiler` session is active, and off it returns one shared no-op
context: no clock is read, nothing is allocated or launched. On, it opens
`torch.profiler.record_function(name)`, so that the span lands in the
profiler's own trace on the timeline of the device's kernels, and appends a
`Record` to an in-memory list: the name, the index of the enclosing record,
the host start and end in Unix ns (the base of the profiler's own events:
`kineto_results.trace_start_ns()` plus an event's `time_range` in us), and
with `device=True` a pair of CUDA events recorded on the current stream
around the span, whose elapsed time is read only when asked. The list holds
at most `LIMIT` records; later ones are dropped and counted. Nothing is
written to disk: a benchmark reads `records()` in memory, and an operator
sees the spans in the trace of their own profiler session.

The spans (README.md, "Profiling a run"):

    trainer.step         Trainer.train_step, whole
    trainer.forward      the objective's forward in Trainer.loss_and_grads
    trainer.backward     torch.autograd.grad and the zero fill of unused gradients
    trainer.guard        nan_guard: the BatchNorm clone, the finite flag, the BatchNorm select
    optimizer.step       Adam.step (train/optim.py)
    pipeline.gather      DeviceDataPipeline.gather
    likelihood.protocol  eval.likelihoods.protocol_chunked, whole
    likelihood.is_call   one model call of an importance-sampling chunk (device=True)
    mesh.all_reduce      Mesh.all_sum_ across ranks

The program's launch counters are `ops.ar_flow.COUNTS`, the attributes of
`ops.ar_flow.ar_solve` that count each route's launches.

Spans are opened and closed on one thread (the caller's); `clear()` is
called between spans, not inside one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

LIMIT = 200_000

_OFF = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Record:
    name: str
    parent: int  # index of the enclosing record, -1 for none
    start_ns: int
    end_ns: int = 0
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    def device_ms(self) -> Optional[float]:
        """The device time between the span's CUDA events, ms (waits for the
        end event); None for a span opened without device=True."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class Recorder:
    def __init__(self, limit: int = LIMIT):
        self.limit = limit
        self.records: List[Record] = []
        self.dropped = 0
        self._open = -1  # index of the innermost open record

    def span(self, name: str, device: bool = False):
        """A context over a span named `name`: the shared no-op context
        unless a profiler session is active. `device`: also time the span
        on the device, on a CUDA path."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name, device)

    def clear(self) -> None:
        self.records = []
        self.dropped = 0
        self._open = -1


class _Span:
    __slots__ = ("_rec", "_name", "_device", "_fn", "_record")

    def __init__(self, rec: Recorder, name: str, device: bool):
        self._rec, self._name, self._device = rec, name, device

    def __enter__(self):
        self._fn = _profiler.record_function(self._name)
        self._fn.__enter__()
        rec, self._record = self._rec, None
        if len(rec.records) < rec.limit:
            self._record = Record(self._name, rec._open, time.time_ns())
            if self._device:
                self._record.events = (torch.cuda.Event(enable_timing=True),
                                       torch.cuda.Event(enable_timing=True))
                self._record.events[0].record()
            rec.records.append(self._record)
            rec._open = len(rec.records) - 1
        else:
            rec.dropped += 1
        return self

    def __exit__(self, *exc):
        r = self._record
        if r is not None:
            if r.events is not None:
                r.events[1].record()
            r.end_ns = time.time_ns()
            self._rec._open = r.parent
        self._fn.__exit__(*exc)
        return False


RECORDER = Recorder()
span = RECORDER.span


def records() -> List[Record]:
    """The records of every span opened under a profiler since the last
    `clear()`, in the order they opened."""
    return RECORDER.records


def clear() -> None:
    RECORDER.clear()
