"""is_call_ms.likelihood: the mean device ms of one importance-sampling
model call (at most ROWS_PER_CALL rows) in the traced test batch, by the
CUDA events of the program's span `likelihood.is_call` in the device-only
sub-window (benchmark/program_spans.py). Nothing on a program without the
spans or where they carry no device events."""

from benchmark.program_spans import mean_device_ms


def read(r):
    return mean_device_ms(r, "likelihood.protocol", "likelihood.is_call")
