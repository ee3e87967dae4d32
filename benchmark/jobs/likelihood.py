"""The likelihood job: the importance-sampled likelihood protocol of the
program's `eval.likelihoods.protocol_chunked`, with the family's joint
estimator and, with "bis", the bis conditionals, over consecutive test
batches, one call and one generator a batch, as the likelihood CLI runs
them with --steps-per-dispatch 1 (its default of 16 batches a call would
outlast the window).

Traffic parameters: "test_batch" (pairs a batch), "K" and "batch_size_K"
(importance samples a pair, in chunks), "bis", "warmup_K" (the samples a
pair of the one set-up call, which makes every model call of the window's
shapes once), "rows_per_call" (the rows a model call of the reference
takes: its memory, not its values), "check_batches" (the window's batches
the reference recomputes, drawn from the seed) and "trace_batch" (the
batch whose device a --trace 1 run traces; the next one it traces with
the host).

The window ends at the first batch boundary after --seconds; the rate is
every pair of the completed batches over the time they took. peak_mem_gib
is the device's allocated peak over the window.

The check: for each sampled batch the reference computes every
estimator's per-pair values from the same pairs, weights and noise (the
batch's generator, drawn in the protocol's order). The program's per-pair
values are kept as its estimators return them, before the protocol takes
their float32 batch mean, whose rounding (about 1e-7 of a mean near -3,000)
would hide the gaps the check is for. Compared, each the largest over the
estimators and the sampled batches: "mean_gap", the relative gap between
the two sides' float64 means of those values; and "pair_gap", the float64
mean of each pair's absolute gap over the mean of the reference's absolute
values, which no mix-up between pairs and no gap of either sign can
average away. Every batch's answers must be finite.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict

import numpy as np
import torch

from .. import flops as F
from .. import inputs
from ..reference import common
from ..trace import SubWindow, span

ESTIMATORS = ("compute_conditional_likelihood", "compute_uni_ll_from_prior",
              "joint_ll_from_uni_jmvae_nf", "joint_ll_from_uni_gaussian")
# the estimators whose per-pair values the protocol averages into its answers
CAPTURED = ("compute_conditional_likelihood", "compute_conditional_likelihood_bis")
SPANS = ("gather", "protocol_chunked", "joint_estimator") + ESTIMATORS


def _batch_rows(b: int, size: int) -> np.ndarray:
    return np.arange(b * size, (b + 1) * size)


def setup(run):
    from mmvae_tpu_torch.cli.compute_likelihoods import joint_fn_for
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.data.device_pipeline import DeviceDataPipeline
    from mmvae_tpu_torch.eval import likelihoods
    from mmvae_tpu_torch.models import registry

    cfg, traffic, dev = run.cell.config["config"], run.cell.traffic, run.device
    size = traffic["test_batch"]
    with run.timed("data_s"):
        data = inputs.make_data(run.seed, run.cell.config["data"], "test", dev)
    with run.timed("model_s"):
        bundle = registry.build(ExperimentConfig.from_dict(cfg))
        model = bundle.model.to(dev).eval()
    with run.timed("weights_s"):
        with torch.device("meta"):
            shapes = run.ref.build(cfg)
        inputs.load_weights(model, inputs.make_weights(shapes, run.seed, dev))
    with run.timed("pipeline_s"):
        pipeline = DeviceDataPipeline(data.images, data.tables, size, shuffle=False, device=dev)
    state = {"model": model, "spec": bundle.spec, "pipeline": pipeline, "data": data,
             "joint_fn": joint_fn_for(model), "likelihoods": likelihoods}
    with run.timed("warmup_s"):
        _protocol(run, state, _batch(run, state, 0),
                  inputs.generator(dev, run.seed, inputs.STREAM_WARMUP), traffic["warmup_K"])
    return state


def _protocol(run, state, xs, g, K):
    t = run.cell.traffic
    return state["likelihoods"].protocol_chunked(
        state["model"], state["spec"], [xs], [g], K=K, batch_size_K=t["batch_size_K"],
        joint_fn=state["joint_fn"], bis=t["bis"])


def _batch(run, state, b):
    """Test batch b % batches: consecutive pairs, gathered on the device."""
    pipeline, size = state["pipeline"], run.cell.traffic["test_batch"]
    rows = _batch_rows(b % len(pipeline), size)
    return pipeline.gather(torch.from_numpy(rows).to(run.device))


def _around_estimators(state, trace: bool):
    """Wraps the program's estimators at its module boundary, from here:
    each call's per-pair values are kept in state["record"] (the
    conditionals, the bis conditionals, the joint), and in a traced run
    each estimator also opens a span. Returns the undo."""
    mod, joint = state["likelihoods"], state["joint_fn"]
    names = CAPTURED + (ESTIMATORS if trace else ())
    saved = {name: getattr(mod, name) for name in dict.fromkeys(names)}

    def wrap(name, fn):
        keep = name in CAPTURED or name == "joint_estimator"

        def wrapped(*a, **k):
            with span(name) if trace else contextlib.nullcontext():
                out = fn(*a, **k)
            if keep:
                state["record"].update(out)
            return out
        return wrapped

    for name, fn in saved.items():
        setattr(mod, name, wrap(name, fn))
    if joint is not None:
        state["joint_fn"] = wrap("joint_estimator", joint)

    def undo():
        for name, fn in saved.items():
            setattr(mod, name, fn)
        state["joint_fn"] = joint

    return undo


def _generator(run, b):
    return inputs.generator(run.device, run.seed, inputs.STREAM_LIKELIHOOD, b)


def window(run, state, seconds: float, trace: bool):
    traffic = run.cell.traffic
    size = traffic["test_batch"]
    undo = _around_estimators(state, trace)
    results, pairs_log, subs = [], [], []
    traced = (traffic["trace_batch"], traffic["trace_batch"] + 1) if trace else ()
    run.sync()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    t0 = time.perf_counter()
    try:
        while True:
            b = len(results)
            state["record"] = {}
            if b in traced:
                with SubWindow(run.device, spans=b == traced[1]) as sub:
                    with span("gather"):
                        xs = _batch(run, state, b)
                    with span("protocol_chunked"):
                        results.append(_protocol(run, state, xs, _generator(run, b), traffic["K"]))
                sub.units = 1
                subs.append(sub)
            else:
                xs = _batch(run, state, b)
                results.append(_protocol(run, state, xs, _generator(run, b), traffic["K"]))
            pairs_log.append(state["record"])
            if time.perf_counter() - t0 >= seconds and len(subs) == len(traced):
                break
    finally:
        undo()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    bad = sum(1 for r in results if not all(math.isfinite(v[0]) for v in r.values()))
    state["results"], state["per_pair"] = results, pairs_log
    pairs = len(results) * size
    return {"seconds": elapsed, "units": len(results), "attempted": pairs, "failed": bad * size,
            "sound": bad == 0, "subs": subs, "spans": SPANS,
            "metrics": {"likelihood_pairs_per_s": pairs / elapsed,
                        "peak_mem_gib": peak / 2 ** 30},
            "notes": {"batches": len(results), "pairs": pairs, "window_peak_bytes": peak,
                      "first_batch": results[0]}}


def checked_batches(run, n_done: int):
    """The window's batches the reference recomputes, drawn from the seed."""
    rng = np.random.default_rng(inputs.derived_seed(run.seed, inputs.STREAM_CHECK))
    k = min(run.cell.traffic["check_batches"], n_done)
    return sorted(int(b) for b in rng.choice(n_done, size=k, replace=False))


def reference_values(run, state, b: int) -> Dict[str, torch.Tensor]:
    """The reference's per-pair values of test batch b, in the precision
    torch is set to, from the batch's own generator."""
    t, dev, data = run.cell.traffic, run.device, state["data"]
    model = state.get("ref_model")
    if model is None:
        model = state["ref_model"] = inputs.reference_model(run.ref, run.cell.config["config"],
                                                            run.seed, dev)
    rows = _batch_rows(b % (data.pairs // t["test_batch"]), t["test_batch"])
    xs = [common.gather(img, tab, rows, dev) for img, tab in zip(data.images, data.tables)]
    g = _generator(run, b)
    with torch.no_grad():
        return run.ref.likelihood(model, xs,
                                  lambda kind, shape: common.draw_noise(kind, shape, g, dev),
                                  t["K"], t["batch_size_K"], t["rows_per_call"])


def compare(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The largest over the estimators, all in float64, of the relative gap
    between the mean of the program's per-pair values and the mean of the
    reference's ("mean_gap"), and of the mean absolute gap pair by pair
    over the mean absolute reference value ("pair_gap"). Every estimator
    must be on both sides, with one value a pair."""
    if set(prog) != set(ref) or any(prog[k].shape != r.shape for k, r in ref.items()):
        return {"mean_gap": math.inf, "pair_gap": math.inf}
    mean_gap = pair_gap = 0.0
    for k, r in ref.items():
        p, r = prog[k].double().cpu(), r.double().cpu()
        mean_gap = max(mean_gap, float(abs(p.mean() - r.mean()) / abs(r.mean())))
        pair_gap = max(pair_gap, float((p - r).abs().mean() / r.abs().mean()))
    return {"mean_gap": mean_gap, "pair_gap": pair_gap}


def release(state) -> None:
    for key in ("model", "pipeline", "joint_fn"):
        state.pop(key, None)


def check(run, state, win) -> Dict[str, float]:
    release(state)
    run.free()
    gaps = [compare(state["per_pair"][b], reference_values(run, state, b))
            for b in checked_batches(run, len(state["results"]))]
    return {k: max(g[k] for g in gaps) for k in gaps[0]}


def work(run) -> Dict[str, float]:
    """Flops of one unit (a test batch), from the reference's shapes."""
    t = run.cell.traffic
    c = F.likelihood_batch(run.ref, run.cell.config["config"], t["test_batch"], t["K"],
                           t["batch_size_K"], run.cell.config["data"]["modalities"])
    return {"per_unit": c["forward"], "solve_per_unit": c["solve"]}
