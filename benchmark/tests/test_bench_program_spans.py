"""The readers of the program's spans (benchmark/program_spans.py and the
four metrics that use it) on synthetic records of a traced run: two
sub-windows, the device-only one first, whose spans differ so that a reader
of the wrong one shows. Each reader gives nothing, and raises nothing, on a
program without the recorder, on a record without both sub-windows, and,
for a device time, on spans without device events."""

import sys

import pytest

from benchmark import cells, program_spans
from mmvae_tpu_torch import utils
from mmvae_tpu_torch.utils import trace

UNITS = 3
HOST = {"model_host_ms.train": ("trainer.forward", "trainer.backward"),
        "optimizer_host_ms.train": ("trainer.guard", "optimizer.step"),
        "gather_host_ms.train": ("pipeline.gather",)}
# ms of each span in a train step of the device-only sub-window
STEP_MS = {"pipeline.gather": 0.25, "trainer.forward": 3.0, "trainer.backward": 5.0,
           "trainer.guard": 0.3, "optimizer.step": 2.0}


class FakeEvent:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


class Log:
    """Appends records as the recorder does, at a clock it advances."""

    def __init__(self):
        self.recs, self.ns = [], 10 ** 18

    def span(self, name, ms, parent=-1, device_ms=None):
        rec = trace.Record(name, parent, self.ns)
        if device_ms is not None:
            rec.events = (FakeEvent(0.0), FakeEvent(device_ms))
        self.recs.append(rec)
        self.ns += round(ms * 1e6)
        rec.end_ns = self.ns
        return len(self.recs) - 1


def train_record(sub_windows=2):
    """Sub-windows of UNITS steps; the second's spans take ten times as long."""
    log = Log()
    for w in range(sub_windows):
        scale = 1 if w == 0 else 10
        for _ in range(UNITS):
            log.span("pipeline.gather", STEP_MS["pipeline.gather"] * scale)
            step = log.span("trainer.step", 0.0)
            for name in ("trainer.guard", "trainer.forward", "trainer.backward", "trainer.guard",
                         "trainer.guard", "optimizer.step"):
                share = 1 / 3 if name == "trainer.guard" else 1
                log.span(name, STEP_MS[name] * share * scale, parent=step)
            log.recs[step].end_ns = log.ns
        log.ns += 10 ** 9
    return log.recs


def likelihood_record(sub_windows=2, events=True, calls=7):
    """Sub-windows of one test batch; is_call i of the first takes 1 + i ms
    on the device, of the second ten times as long."""
    log = Log()
    for w in range(sub_windows):
        log.span("gather", 0.1)
        top = log.span("likelihood.protocol", 0.0)
        for i in range(calls):
            dev = (1.0 + i) * (1 if w == 0 else 10)
            log.span("likelihood.is_call", 0.5, parent=top, device_ms=dev if events else None)
        log.recs[top].end_ns = log.ns
        log.ns += 10 ** 9
    return log.recs


@pytest.fixture(name="recorded")
def _recorded(monkeypatch):
    def put(recs):
        monkeypatch.setattr(trace.RECORDER, "records", recs)
    return put


def _r(units):
    return {"trace": {"units": units}}


def test_the_window_is_the_first_sub_windows_records(recorded):
    recs = train_record()
    recorded(recs)
    got = program_spans.window(_r(UNITS), "trainer.step")
    assert got == recs[:len(recs) // 2]
    recorded(train_record(sub_windows=1))
    assert program_spans.window(_r(UNITS), "trainer.step") is None


@pytest.mark.parametrize("name", sorted(HOST))
def test_a_host_reader_reads_the_device_only_sub_window(recorded, name):
    recorded(train_record())
    read, _ = cells.metric_reader(name)
    assert read(_r(UNITS)) == pytest.approx(sum(STEP_MS[n] for n in HOST[name]))


def test_the_is_call_reader_reads_the_mean_device_ms(recorded):
    recorded(likelihood_record())
    read, _ = cells.metric_reader("is_call_ms.likelihood")
    assert read(_r(1)) == pytest.approx(4.0)  # the mean of 1..7 ms


READERS = sorted(HOST) + ["is_call_ms.likelihood"]


def _record_of(name, **kw):
    return likelihood_record(**kw) if name == "is_call_ms.likelihood" else train_record(**kw)


def _units(name):
    return 1 if name == "is_call_ms.likelihood" else UNITS


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no recorder", "one sub-window", "no trace", "no records"])
def test_a_reader_gives_nothing_without_its_spans(recorded, monkeypatch, name, case):
    recorded(_record_of(name, sub_windows=1) if case == "one sub-window" else
             [] if case == "no records" else _record_of(name))
    if case == "no recorder":  # as on a program that has no utils/trace.py
        monkeypatch.delattr(utils, "trace")
        monkeypatch.setitem(sys.modules, "mmvae_tpu_torch.utils.trace", None)
        assert program_spans.program_records() is None
    read, _ = cells.metric_reader(name)
    assert read({"trace": None} if case == "no trace" else _r(_units(name))) is None


@pytest.mark.parametrize("events", [False, True])
def test_is_call_needs_device_events_and_host_readers_do_not(recorded, events):
    recorded(likelihood_record(events=events))
    read, _ = cells.metric_reader("is_call_ms.likelihood")
    assert (read(_r(1)) is None) == (not events)
    for name in HOST:
        recorded(train_record())
        read, _ = cells.metric_reader(name)
        assert read(_r(UNITS)) is not None
