"""The training job: closed-loop optimizer steps of the program's Trainer,
back to back, over the benchmark's data in the program's device pipeline,
with epoch reshuffles where they fall.

Traffic parameters: "checked_steps" (the steps the reference follows),
"warmup_steps" (all set-up steps, the checked ones among them), "epoch"
(the Trainer's epoch, which sets the warmup phase), "trace_steps" and
"trace_after_s" (the two traced sub-windows of a --trace 1 run, the
device's and the host's: that many steps each, that many seconds into the
window). The batch, K and learning rate are the
configuration's.

Set-up builds one Trainer from the configuration, gives it the run's
weights, and drives it from the seed through its first steps by the
window's own call and feed; the window then goes on with the same Trainer.
A step's loss is summed on the device, and the host reads it once, after
the window's last step: the rate is every pair of the window over the time
to that synchronisation. A run is sound only where the loss sum is finite
and no window step was skipped by the program's nan_guard (a skipped step
updates nothing, so its pairs would count at no cost).

The check: the reference follows the first `checked_steps` steps from the
same weights, rows and noise. Compared, each by the worst case: each step's
loss; the first gradient of each parameter, as the optimizer got it (its
first moment after one step over 1 - b1), by the gap between its norm and
the reference's; each parameter's change after the checked steps, by the
same gap, over the parameters whose reference gradient is at least 1e-3 of
the median parameter's (others move by round-off alone). A gap is measured
against the reference's norm of that parameter or the median parameter's,
whichever is larger.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import numpy as np
import torch

from .. import flops as F
from .. import inputs
from ..reference import common
from ..trace import SubWindow, span

SPANS = ("feed", "train_step", "sum")
MOVED_SHARE = 1e-3


class Feed:
    """The window's feed: each step's pair rows in the pipeline's epoch
    order, the pairs gathered on the device, and the step's noise."""

    def __init__(self, pipeline, noise_kinds, g, device):
        self.pipeline, self.kinds, self.g, self.device = pipeline, noise_kinds, g, device
        self._epoch = iter(())

    def __next__(self):
        rows = next(self._epoch, None)
        if rows is None:
            self._epoch = self.pipeline.epoch_index_batches()
            rows = next(self._epoch)
        xs = self.pipeline.gather(torch.from_numpy(rows).to(self.device))
        return rows, xs, inputs.noise(self.kinds, self.g, self.device)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def setup(run):
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.data.device_pipeline import DeviceDataPipeline
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer

    cfg, traffic, dev = run.cell.config["config"], run.cell.traffic, run.device
    with run.timed("data_s"):
        data = inputs.make_data(run.seed, run.cell.config["data"], "train", dev)
    with run.timed("model_s"):
        ecfg = ExperimentConfig.from_dict(cfg)
        bundle = registry.build(ecfg)
        trainer = Trainer(bundle.model, bundle.spec, ecfg, device=dev, log_fn=lambda s: None)
    with run.timed("weights_s"):
        with torch.device("meta"):
            shapes = run.ref.build(cfg)
        inputs.load_weights(trainer.model, inputs.make_weights(shapes, run.seed, dev))
        trainer.init_opt_state(past_warmup=traffic["epoch"] >= ecfg.warmup, amsgrad=True)
    with run.timed("pipeline_s"):
        pipeline = DeviceDataPipeline(data.images, data.tables, ecfg.batch_size, shuffle=True,
                                      seed=inputs.derived_seed(run.seed, inputs.STREAM_ORDER),
                                      device=dev)
    feed = Feed(pipeline, run.ref.train_noise(cfg, ecfg.batch_size),
                inputs.generator(dev, run.seed, inputs.STREAM_NOISE), dev)
    lr, beta_kl, epoch = ecfg.learning_rate, float(ecfg.beta_kl), int(traffic["epoch"])

    def step(xs, noise):
        return trainer.train_step(xs, lr, beta_kl, epoch, noise=noise)

    with run.timed("warmup_s"):
        named = dict(trainer.model.named_parameters())
        opt_names = [n for n, p in named.items() if any(p is q for q in trainer.opt.params)]
        p0 = {n: p.detach().clone() for n, p in named.items()}
        rows_log, noise_log, losses = [], [], []
        for k in range(traffic["warmup_steps"]):
            rows, xs, noise = next(feed)
            loss, _ = step(xs, noise)
            if k < traffic["checked_steps"]:
                rows_log.append(rows)
                noise_log.append([t.clone() for t in noise])
                losses.append(loss)
            if k == 0:
                g1 = {n: mu / (1.0 - trainer.opt.b1) for n, mu in zip(opt_names, trainer.opt.mu)}
                g1_norms = _norms(g1)
                del g1
            if k == traffic["checked_steps"] - 1:
                change = _norms({n: p.detach() - p0[n] for n, p in named.items()})
                del p0
        readings = {"losses": [float(l) for l in losses], "grad_norms": g1_norms,
                    "change_norms": change}
    return {"trainer": trainer, "pipeline": pipeline, "feed": feed, "step": step, "data": data,
            "rows": rows_log, "noise": noise_log, "readings": readings, "lr": lr,
            "batch": ecfg.batch_size}


def window(run, state, seconds: float, trace: bool):
    feed, step, dev = state["feed"], state["step"], run.device
    traffic = run.cell.traffic
    total = torch.zeros((), device=dev)
    skipped = torch.zeros((), device=dev)
    subs = []

    def one():
        nonlocal total, skipped
        with span("feed"):
            _, xs, noise = next(feed)
        with span("train_step"):
            loss, details = step(xs, noise)
        with span("sum"):
            total = total + loss
            skipped = skipped + details.get("nan_skipped", 0.0)

    run.sync()
    t0 = time.perf_counter()
    steps, marks = 0, []
    while time.perf_counter() - t0 < seconds:
        if trace and not subs and time.perf_counter() - t0 >= traffic["trace_after_s"]:
            for spans in (False, True):
                with SubWindow(dev, spans) as sub:
                    for _ in range(traffic["trace_steps"]):
                        one()
                sub.units = traffic["trace_steps"]
                steps += sub.units
                subs.append(sub)
            continue
        one()
        steps += 1
        if steps % 100 == 0:
            marks.append(round(time.perf_counter() - t0, 4))
    run.sync()
    elapsed = time.perf_counter() - t0
    total, skipped = float(total), int(round(float(skipped)))
    pairs = steps * state["batch"]
    return {"seconds": elapsed, "units": steps, "attempted": steps, "failed": skipped,
            "sound": bool(np.isfinite(total)) and skipped == 0, "subs": subs, "spans": SPANS,
            "metrics": {"train_pairs_per_s": pairs / elapsed},
            "notes": {"steps": steps, "pairs": pairs, "loss_mean": total / max(steps, 1),
                      "nan_skipped_steps": skipped, "seconds_at_each_100_steps": marks}}


def reference_readings(run, state) -> Dict:
    """The reference's readings of the checked steps, run on the device in
    the precision torch is set to."""
    cfg, dev = run.cell.config["config"], run.device
    model = inputs.reference_model(run.ref, cfg, run.seed, dev)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    data = state["data"]
    batches = [([common.gather(img, tab, rows, dev) for img, tab in zip(data.images, data.tables)],
                noise, cfg) for rows, noise in zip(state["rows"], state["noise"])]
    losses, g1, p_end = common.train_steps(model, run.ref.train_loss, batches, state["lr"])
    return {"losses": losses, "grad_norms": _norms(g1),
            "change_norms": _norms({n: p_end[n] - w0[n] for n in p_end})}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers the check compares: the worst step's loss gap, and the
    worst parameter's gap of first-gradient norms and of change norms."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(prog["grad_norms"].get(n, 0.0) - g) / max(g, g_med) for n, g in g_ref.items())
    moved = [n for n, g in g_ref.items() if g >= MOVED_SHARE * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[n] for n in moved)
    change_gap = max(abs(prog["change_norms"][n] - c_ref[n]) / max(c_ref[n], c_med) for n in moved)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap}


def release(state) -> None:
    """Frees the program's state before the reference runs."""
    for key in ("trainer", "pipeline", "feed", "step"):
        state.pop(key, None)


def check(run, state, win) -> Dict[str, float]:
    release(state)
    run.free()
    return compare(state["readings"], reference_readings(run, state))


def work(run) -> Dict[str, float]:
    """Flops of one unit (a train step), from the reference's shapes."""
    cfg = run.cell.config["config"]
    return {"per_unit": F.train_step(run.ref, cfg, cfg["batch_size"],
                                     run.cell.config["data"]["modalities"]),
            "solve_per_unit": 0}
