#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mmvae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi). No CUDA, no run.
2. build: nvcc builds every kernel of the port from csrc/.
3. ar_solve: the Hopper kernel against its plain PyTorch version at the
   main path's shape (N=128) and a larger one (N=3840), D=20, H=128,
   3 hidden layers, real MADE masks, sign +-1, s_bound 0 and 8, TF32 off.
   Kernel and plain times (CUDA events around 10 back-to-back calls,
   median of 20 runs), the bound, and one forward+backward through the
   autograd Function.
4. slice: one full-width MMVAE-NF epoch on MNIST-SVHN through the port's
   CLI (`mmvae_tpu_torch.cli.train.main`, device cuda): 68 train steps and
   7 val batches at B=128, latent 20, 2 MADE blocks of 3x128. Checks the
   kernel launch count (4 per train step and per val batch), the
   parameters' device and finite losses; then times steady-state steps.
5. parity: one float32 training step on cuda against the same step on the
   CPU in float64 (the reference; the CPU float32 step is reported beside
   it), same weights and noise, TF32 off.
6. The kernels line, and last the contract line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "mnist_svhn", "mmvae_nf_synth.json")

# Published peaks of an H100 SXM (dense, no sparsity) at 700 W: float32 on
# the CUDA cores and HBM3 bandwidth. A card set to a lower power limit may
# run below them; the limit is printed beside every number.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Tolerances, TF32 off. Kernel vs plain version, both float32: the same
# arithmetic in another summation order, through a 20-step exp chain.
# CUDA float32 step vs the CPU float64 step: float32 round-off, accumulated
# over the batch sum of the objective (measured about 1.5e-6 of a gradient
# leaf's largest entry on an H100; the bound leaves a wide margin).
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
STEP_OBJ_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4  # max |g_cuda - g_ref| / max |g_ref| per parameter


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, reps=10, rounds=20, warmup=3):
    """Time of one call: CUDA events around `reps` back-to-back calls, over
    the count; the median of `rounds` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_build():
    from mmvae_tpu_torch.ops import build

    sources = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    for source in sources:
        build.load(source)
    wall = time.perf_counter() - t0
    ptxas = {s: [l.strip() for l in log.splitlines() if "Used" in l or "spill" in l]
             for s, (_, log) in build.build_log.items()}
    emit({"phase": "build", "sources": sources, "seconds": round(wall, 3), "ptxas": ptxas})


def solve_flops(n, d, h, n_hidden):
    """Flops one ar_solve call needs: at each of the D steps the hidden
    layers of the masked MLP and the two head columns (mu_i, s_i) that the
    step uses, 2*n*d*(d*h + (L-1)*h*h + 2*h). This is the bound's count. The
    TPU kernel computed the full 2D-wide head; that larger count,
    2*n*d*(d*h + (L-1)*h*h + 2*d*h), is reported beside it."""
    two_cols = 2 * n * d * (d * h + (n_hidden - 1) * h * h + 2 * h)
    full_head = 2 * n * d * (d * h + (n_hidden - 1) * h * h + h * 2 * d)
    return two_cols, full_head


def phase_ar_solve():
    import torch

    from mmvae_tpu_torch.flows import MADE
    from mmvae_tpu_torch.nets import init_parameters
    from mmvae_tpu_torch.ops import ar_flow

    d, h, n_hidden = 20, 128, 3
    gen = torch.Generator().manual_seed(0)
    made = MADE(d, (h,) * n_hidden)
    init_parameters(made, gen)
    with torch.no_grad():
        for layer in [*made.hidden, made.out]:
            layer.bias.copy_(torch.empty(layer.bias.shape).uniform_(-0.1, 0.1, generator=gen))
    made = made.cuda()
    with torch.no_grad():
        ws, bs = made.masked_layer_params()
        ws = [w.contiguous() for w in ws]
    results, max_err = {}, 0.0
    for n in (128, 3840):
        x = torch.randn(n, d, generator=gen).cuda()
        for sign in (1, -1):
            for s_bound in (0.0, 8.0):
                with torch.no_grad():
                    y_k, ld_k = ar_flow.kernel_forward(x, ws, bs, sign, s_bound)
                    y_p, ld_p = ar_flow.unrolled_solve(x, ws, bs, sign, s_bound)
                torch.cuda.synchronize()
                err = max((y_k - y_p).abs().max().item(), (ld_k - ld_p).abs().max().item())
                ref = max(y_p.abs().max().item(), ld_p.abs().max().item())
                ok = (torch.allclose(y_k, y_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
                      and torch.allclose(ld_k, ld_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL))
                emit({"phase": "ar_solve_check", "n": n, "sign": sign, "s_bound": s_bound,
                      "max_abs_err": err, "max_rel_err": err / max(ref, 1e-30),
                      "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "ok": ok})
                if not ok:
                    raise AssertionError(f"ar_solve kernel disagrees at n={n} sign={sign} "
                                         f"s_bound={s_bound}: max abs err {err}")
                if n == 128:
                    max_err = max(max_err, err)
        with torch.no_grad():
            k_ms = cuda_time_ms(lambda: ar_flow.kernel_forward(x, ws, bs, 1, 0.0))
            p_ms = cuda_time_ms(lambda: ar_flow.unrolled_solve(x, ws, bs, 1, 0.0))
        flops, flops_full_head = solve_flops(n, d, h, n_hidden)
        # each input read once (x, masked weights, biases), each output
        # written once (y, logdet)
        n_bytes = 4 * (2 * n * d + n + sum(w.numel() for w in ws) + sum(b.numel() for b in bs))
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= n_bytes / PEAK_BYTES else "bytes"
        bound_ms = max(flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES) * 1e3
        results[n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "ar_solve_time", "n": n, "kernel_ms": k_ms, "plain_ms": p_ms,
              "flops": flops, "flops_full_head": flops_full_head, "bytes": n_bytes,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "achieved_tflops": flops / (k_ms * 1e-3) / 1e12,
              "roofline_share": bound_ms / k_ms})

    # one forward + backward through the autograd Function at N=128
    x = torch.randn(128, d, generator=gen).cuda().requires_grad_(True)
    params = [p.detach().clone().requires_grad_(True) for p in (*ws, *bs)]

    def fwd_bwd():
        y, ld = ar_flow.ar_solve(x, params[:len(ws)], params[len(ws):], 1, 0.0)
        (y.sum() + ld.sum()).backward()

    fb_ms = cuda_time_ms(fwd_bwd)
    emit({"phase": "ar_solve_fwd_bwd", "n": 128, "ms": fb_ms})
    return dict(results=results, max_err=max_err, fwd_bwd_ms=fb_ms)


def _slice_config(tmp):
    with open(CONFIG) as f:
        raw = json.load(f)
    # an empty data directory of the run's own: the loaders take the
    # synthetic stand-in and read nothing outside the run
    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir, exist_ok=True)
    raw.update(synthetic_n=2048, epochs=1, no_analytics=True, data_path=data_dir)
    path = os.path.join(tmp, "mmvae_nf_smoke.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path, raw


def phase_slice(tmp):
    import torch

    from mmvae_tpu_torch.cli.train import main as train_main
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.data import get_dataloaders
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.ops import ar_flow
    from mmvae_tpu_torch.train import Trainer

    cfg_path, raw = _slice_config(tmp)
    cfg = ExperimentConfig.from_json(cfg_path)
    bsz = cfg.batch_size
    data_kw = dict(batch_size=bsz, data_path=cfg.data_path, synthetic_n=raw["synthetic_n"])
    train_loader, _, val_loader = get_dataloaders("mnist_svhn", **data_kw)
    steps, val_batches = train_loader.num_examples // bsz, val_loader.num_examples // bsz

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ar_flow.ar_solve.launches = 0
    t0 = time.perf_counter()
    run_path = train_main(["--config-path", cfg_path, "--experiments-dir",
                           os.path.join(tmp, "experiments"), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ar_flow.ar_solve.launches
    peak = torch.cuda.max_memory_allocated()

    state = torch.load(os.path.join(run_path, "model.pt"), weights_only=True)
    on_cuda = all(t.is_cuda for t in state.values())
    with open(os.path.join(run_path, "losses.json")) as f:
        losses = json.load(f)
    with open(os.path.join(run_path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    finite = all(math.isfinite(v) for v in losses["train_loss"] + losses["test_loss"])
    # the trainer normalizes nan_skipped by all pairs, as the JAX package does
    skipped_steps = metrics[-1].get("train_nan_skipped", 0.0) * train_loader.num_examples
    expected = 4 * (steps + val_batches)
    emit({"phase": "slice", "run_path": run_path, "train_pairs": train_loader.num_examples,
          "val_pairs": val_loader.num_examples, "train_steps": steps,
          "val_batches": val_batches, "ar_solve_launches": launches,
          "expected_launches": expected, "params_on_cuda": on_cuda,
          "train_loss": losses["train_loss"], "val_loss": losses["test_loss"],
          "losses_finite": finite, "nan_skipped_fraction": skipped_steps / steps,
          "epoch_wall_s_incl_setup": wall, "peak_mem_bytes": peak})
    if launches != expected or (steps, val_batches) != (68, 7):
        raise AssertionError(f"ar_solve launched {launches} times for {steps} train steps and "
                             f"{val_batches} val batches (expected {expected}, 68+7)")
    if not on_cuda or not finite:
        raise AssertionError(f"params on cuda: {on_cuda}, finite losses: {finite}")

    # steady-state step time at the same shapes, outside the counted run
    bundle = registry.build(cfg)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cuda")
    trainer.init_parameters()
    trainer.init_opt_state()
    pipeline = trainer.make_device_pipeline(train_loader)
    batches = [pipeline.gather(torch.from_numpy(r).cuda())
               for r in list(pipeline.epoch_index_batches())[:25]]
    for xs in batches[:5]:
        trainer.train_step(xs, cfg.learning_rate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for xs in batches[5:]:
        trainer.train_step(xs, cfg.learning_rate)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (len(batches) - 5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    eval_ms = cuda_time_ms(lambda: trainer.eval_step(batches[0], generator=gen))
    prof = profile_steps(trainer, batches[5:10], cfg.learning_rate)
    emit({"phase": "slice_time", "train_step_ms": step_s * 1e3, "steps_per_s": 1.0 / step_s,
          "eval_batch_ms": eval_ms, **prof})
    return dict(launches=launches, steps_per_s=1.0 / step_s, peak=peak)


def profile_steps(trainer, batches, lr):
    """Device busy time and the top kernels over a few train steps, from
    torch.profiler; "not measured" when the tracer cannot start or the trace
    holds no device time. Errors of the steps themselves propagate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:  # probe the tracer alone; the timings above stand without it
        with profile(activities=activities):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    except RuntimeError as e:
        return {"profile": f"not measured ({e})"[:200]}

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for xs in batches:
            trainer.train_step(xs, lr)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()

    def dev_us(e):
        # the attribute's name changed across torch versions
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in averages
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in events)
    if busy_us <= 0:
        return {"profile": "not measured"}
    top = sorted(events, key=dev_us, reverse=True)[:10]
    solve = [e for e in events if "ar_solve_kernel" in e.key]
    return {"profiled_steps": len(batches), "device_busy_share": busy_us / wall_us,
            "device_us_per_step": busy_us / len(batches),
            "ar_solve_device_us_per_launch":
                sum(dev_us(e) for e in solve) / max(1, sum(e.count for e in solve)),
            "kernel_launches_per_step": sum(e.count for e in events) / len(batches),
            "top_kernels": [[e.key[:80], dev_us(e) / len(batches), e.count] for e in top]}


def phase_parity(tmp):
    """One training step on cuda (float32) against the same step on the
    CPU, from the same bridged weights and noise. The reference is the CPU
    step in float64; the CPU float32 step is reported beside it."""
    import numpy as np
    import torch

    from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.data import get_dataloaders
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer

    cfg_path, raw = _slice_config(tmp)
    cfg = ExperimentConfig.from_json(cfg_path)
    train_loader, _, _ = get_dataloaders("mnist_svhn", batch_size=cfg.batch_size,
                                         data_path=cfg.data_path,
                                         synthetic_n=raw["synthetic_n"])
    xs_np, _ = next(iter(train_loader))
    rng = np.random.default_rng(0)
    eps_np = [rng.standard_normal((cfg.batch_size, cfg.latent_dim)).astype(np.float32)
              for _ in xs_np]

    out, weights, names = {}, None, None
    for run, dev, dtype in (("cpu_f64", "cpu", torch.float64), ("cpu_f32", "cpu", torch.float32),
                            ("cuda_f32", "cuda", torch.float32)):
        bundle = registry.build(cfg)
        trainer = Trainer(bundle.model.to(dtype), bundle.spec, cfg, device=dev)
        if weights is None:
            trainer.init_parameters()
            weights = export_jax_params(trainer.model)
            names = [n for n, _ in trainer.model.named_parameters()]
        else:
            load_jax_params(trainer.model, weights)
        trainer.init_opt_state()
        xs = [torch.tensor(x).to(dev, dtype) for x in xs_np]
        eps = [torch.tensor(e).to(dev, dtype) for e in eps_np]
        obj, _ = trainer.obj_fn(trainer.model, xs, trainer.spec, eps=eps)
        grads = torch.autograd.grad(obj, list(trainer.model.parameters()))
        loss, details = trainer.train_step(xs, cfg.learning_rate, eps=eps)
        out[run] = dict(obj=obj.item(), grads=[g.double().cpu() for g in grads],
                        loss=loss.item(), skipped=details["nan_skipped"].item(),
                        stepped=trainer.opt.count.item())

    ref = out["cpu_f64"]

    def errors(run):
        r = out[run]
        leaf = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for a, b in zip(r["grads"], ref["grads"])]
        worst = max(range(len(leaf)), key=leaf.__getitem__)
        return {"objective_rel_err": abs(r["obj"] - ref["obj"]) / abs(ref["obj"]),
                "loss_rel_err": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                "grad_max_rel_err": leaf[worst], "worst_leaf": names[worst]}

    cuda, cpu32 = errors("cuda_f32"), errors("cpu_f32")
    ok = (cuda["objective_rel_err"] <= STEP_OBJ_RTOL and cuda["loss_rel_err"] <= STEP_OBJ_RTOL
          and cuda["grad_max_rel_err"] <= STEP_GRAD_TOL
          and all(r["skipped"] == 0.0 and r["stepped"] == 1 for r in out.values()))
    emit({"phase": "parity", "reference": "cpu float64", "objective_ref": ref["obj"],
          "objective_cuda": out["cuda_f32"]["obj"], "cuda_f32": cuda, "cpu_f32": cpu32,
          "objective_rtol": STEP_OBJ_RTOL, "grad_tol": STEP_GRAD_TOL, "ok": ok})
    if not ok:
        raise AssertionError("the cuda training step disagrees with the float64 cpu step")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import mmvae_tpu_torch  # noqa: F401  (fails where the checkout is missing)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": card,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    solve = phase_ar_solve()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        sl = phase_slice(tmp)
        phase_parity(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    main_path = solve["results"][128]
    emit({"kernels": [{
        "name": "ar_solve",
        "route": "cuda",
        "source": "mmvae_tpu_torch/csrc/ar_flow.cu",
        "replaces": "mmvae_tpu/ops/ar_flow.py:96",
        "launches": sl["launches"],
        "max_abs_err": solve["max_err"],
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
