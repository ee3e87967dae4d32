"""The program's spans (mmvae_tpu_torch/utils/trace.py): off without a
profiler, on under any torch.profiler session, on the profiler's own time
base, nested as the code nests, bounded, and changing no number the
program computes. The flagship's train step at B=4, K=3 (the
mmvae_synth.json setup of test_torch_mmvae.py) and a tiny likelihood
protocol, on the CPU."""

import contextlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.data.device_pipeline import DeviceDataPipeline
from mmvae_tpu_torch.eval import likelihoods as L
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.train import Trainer
from mmvae_tpu_torch.utils import trace

CONFIG = "configs/mnist_svhn/mmvae_synth.json"
B, K, N = 4, 3, 12
STEP_CHILDREN = ("trainer.forward", "trainer.backward", "trainer.guard", "optimizer.step")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _cleared():
    trace.clear()
    yield
    trace.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _trainer():
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.K, cfg.batch_size = K, B
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu", log_fn=lambda s: None)
    trainer.init_parameters(0)
    trainer.init_opt_state(past_warmup=True)
    return trainer


def _pipeline():
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size=(N, 1, 28, 28)).astype(np.float32) / 255,
              rng.integers(0, 256, size=(N, 3, 32, 32)).astype(np.float32) / 255]
    return DeviceDataPipeline(images, [np.arange(N), np.arange(N)[::-1].copy()], B,
                              shuffle=False, device="cpu")


@pytest.fixture(scope="module")
def traced_step():
    """One flagship train step, its batch gathered by the device pipeline,
    under a CPU profiler: (records, the profile's events, its start in
    Unix ns). The profiler's first range in a process starts slowly, so a
    range is opened once before."""
    trainer, pipeline = _trainer(), _pipeline()
    with _profiled():
        with torch.profiler.record_function("warm"):
            pass
    trace.clear()
    with _profiled() as prof:
        xs = pipeline.gather(torch.arange(B))
        trainer.train_step(xs, 1e-3)
    recs = list(trace.records())
    return recs, prof.events(), prof.profiler.kineto_results.trace_start_ns()


@pytest.mark.parametrize("name,device", [("trainer.step", False), ("optimizer.step", False),
                                         ("likelihood.is_call", True)])
def test_off_without_a_profiler(name, device):
    """No profiler: the shared no-op context, and no record."""
    ctx = trace.span(name, device=device)
    assert ctx is trace.span("other")
    with ctx:
        pass
    assert trace.records() == [] and trace.RECORDER.dropped == 0


def test_off_train_step_records_nothing():
    trainer, pipeline = _trainer(), _pipeline()
    trainer.train_step(pipeline.gather(torch.arange(B)), 1e-3)
    assert trace.records() == []


@pytest.mark.parametrize("child", STEP_CHILDREN)
def test_step_spans_nest(traced_step, child):
    """trainer.step encloses each of its parts, by the parent index; the
    gather before it and the step are top-level."""
    recs = traced_step[0]
    names = [r.name for r in recs]
    assert names.count("trainer.step") == 1 and names.count("pipeline.gather") == 1
    step = names.index("trainer.step")
    assert recs[step].parent == -1 and recs[names.index("pipeline.gather")].parent == -1
    mine = [r for r in recs if r.name == child]
    assert mine and all(r.parent == step for r in mine)
    assert all(recs[step].start_ns <= r.start_ns <= r.end_ns <= recs[step].end_ns for r in mine)
    assert all(r.events is None for r in recs)


def test_step_span_order(traced_step):
    """The step's parts in the order the step runs them: nan_guard's
    BatchNorm clone, forward, backward, its finite flag and BatchNorm
    select, the optimizer."""
    names = [r.name for r in traced_step[0]]
    assert names == ["pipeline.gather", "trainer.step", "trainer.guard", "trainer.forward",
                     "trainer.backward", "trainer.guard", "trainer.guard", "optimizer.step"]


@pytest.mark.parametrize("name", ("pipeline.gather", "trainer.step") + STEP_CHILDREN)
def test_spans_on_the_profilers_clock(traced_step, name):
    """Each record matches its range in the profile, start and end, within
    0.5 ms on the profile's own time base."""
    recs, events, t0 = traced_step
    mine = [r for r in recs if r.name == name]
    ranges = sorted((t0 + int(e.time_range.start * 1e3), t0 + int(e.time_range.end * 1e3))
                    for e in events if e.name == name)
    assert len(ranges) == len(mine)
    for r, (start, end) in zip(mine, ranges):
        assert abs(r.start_ns - start) < 5e5 and abs(r.end_ns - end) < 5e5, (r, start, end)


@pytest.mark.parametrize("part", ["loss_and_grads", "train_step"])
def test_profiler_changes_no_number(part):
    """Loss, gradients and the stepped parameters, bit for bit, with the
    profiler on and off."""
    out = []
    for on in (False, True):
        trainer, pipeline = _trainer(), _pipeline()
        xs = pipeline.gather(torch.arange(B))
        with _profiled() if on else contextlib.nullcontext():
            if part == "loss_and_grads":
                loss, _, tensors, _ = trainer.loss_and_grads(xs)
            else:
                loss, _ = trainer.train_step(xs, 1e-3)
                tensors = [p.detach() for p in trainer.model.parameters()]
        out.append([loss] + list(tensors))
    assert bool(trace.records())
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("on", [False, True])
def test_protocol_is_calls(monkeypatch, on):
    """protocol_chunked records one likelihood.is_call a model call: K /
    batch_size_K chunks times the row groups of each estimator call, all
    inside one likelihood.protocol; none without a profiler."""
    cfg = ExperimentConfig.from_json(CONFIG)
    bundle = registry.build(cfg)
    torch.manual_seed(0)
    model = bundle.model.eval()
    rng = np.random.default_rng(1)
    xs = [torch.tensor(rng.uniform(size=(3, 1, 28, 28)), dtype=torch.float32),
          torch.tensor(rng.uniform(size=(3, 3, 32, 32)), dtype=torch.float32)]
    k, bk = 4, 2
    monkeypatch.setattr(L, "ROWS_PER_CALL", 4)  # 2 pairs a call, so 2 groups of 3 pairs
    calls = []
    chunked = L._chunked_is

    def counted(draw, log_w, n, K, bk):
        calls.append(K // bk * len(L._groups(n, bk)))
        return chunked(draw, log_w, n, K, bk)

    monkeypatch.setattr(L, "_chunked_is", counted)
    with _profiled() if on else contextlib.nullcontext():
        L.protocol_chunked(model, bundle.spec, [xs], [torch.Generator().manual_seed(2)], K=k,
                           batch_size_K=bk, joint_fn=L.joint_likelihood_mmvae, bis=True)
    recs = trace.records()
    if not on:
        assert recs == []
        return
    assert len(calls) > 3 and all(c == k // bk * 2 for c in calls)
    assert [r.name for r in recs].count("likelihood.protocol") == 1 and recs[0].parent == -1
    is_calls = [r for r in recs if r.name == "likelihood.is_call"]
    assert len(is_calls) == sum(calls) and all(r.parent == 0 for r in is_calls)
    assert all(r.events is None and r.device_ms() is None for r in is_calls)
    assert all(r.name in ("likelihood.protocol", "likelihood.is_call") for r in recs)


@pytest.mark.parametrize("limit", [0, 2, 5])
def test_bound_drops_and_counts(limit):
    """Past the bound no record is kept, each span opened is counted, and
    the parent index of a kept record still names its enclosing span."""
    rec = trace.Recorder(limit=limit)
    with _profiled():
        with rec.span("outer"):
            for _ in range(4):
                with rec.span("inner"):
                    pass
    kept = min(limit, 5)
    assert len(rec.records) == kept and rec.dropped == 5 - kept
    assert [r.parent for r in rec.records] == [-1, 0, 0, 0, 0][:kept]
    rec.clear()
    assert rec.records == [] and rec.dropped == 0


def test_off_span_costs_under_a_microsecond():
    """Without a profiler a span is one module attribute read and the
    shared no-op context: well under 1 us a span on any host."""
    n = 20_000

    def spans():
        for _ in range(n):
            with trace.span("trainer.step"):
                pass

    def bare():
        for _ in range(n):
            pass

    best = min(_timed(spans) - _timed(bare) for _ in range(5)) / n
    assert best < 1e-6, best


def _timed(fn):
    """The thread's CPU seconds in fn: no other process's load counts."""
    t = time.thread_time()
    fn()
    return time.thread_time() - t
