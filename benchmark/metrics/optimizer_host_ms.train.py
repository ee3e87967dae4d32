"""optimizer_host_ms.train: the host's ms a train step in nan_guard and the
AMSGrad update, the program's spans `trainer.guard` and `optimizer.step`,
over the steps of the traced device-only sub-window
(benchmark/program_spans.py). Nothing on a program without the spans."""

from benchmark.program_spans import host_ms_per_unit


def read(r):
    return host_ms_per_unit(r, "trainer.step", ("trainer.guard", "optimizer.step"))
