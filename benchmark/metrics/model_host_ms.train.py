"""model_host_ms.train: the host's ms a train step in the objective's
forward and autograd's backward, the program's spans `trainer.forward` and
`trainer.backward`, over the steps of the traced device-only sub-window
(benchmark/program_spans.py). Nothing on a program without the spans."""

from benchmark.program_spans import host_ms_per_unit


def read(r):
    return host_ms_per_unit(r, "trainer.step", ("trainer.forward", "trainer.backward"))
