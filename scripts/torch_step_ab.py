#!/usr/bin/env python3
"""Steady train-step time of the PyTorch port in several checkouts, in
turns, on one CUDA card: the way to compare two versions of the port
within one run.

    python3 scripts/torch_step_ab.py --trees OLD NEW NEW OLD \
        --configs configs/mnist_svhn/mmvae_nf_synth.json configs/mnist_svhn/mmvae_synth.json

Each (tree, config) runs in its own process, which imports
`mmvae_tpu_torch` from that tree (an unpacked `git archive` of another
commit, or the repo itself). The config runs at full width on its model's
dataset's synthetic stand-in at synthetic_n=2048, as `chip_smoke.py` runs
it, TF32 off. A process builds the model from `--seed`, runs `--warmup`
train steps, then times `--steps` steps on the host clock, ending in a
synchronize, `--repeats` times, and prints one JSON line: the median and
every repeat, and the peak device memory of the timed steps
(`torch.cuda.max_memory_allocated`), with the card's name and power limit. A config the tree's registry does
not know is reported as such. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def measure(tree, config, seed, warmup, steps, repeats):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import mmvae_tpu_torch
    from mmvae_tpu_torch.cli.common import loader_kwargs
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.data import get_dataloaders
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ExperimentConfig.from_json(config)
    cfg.seed = seed
    row = {"tree": tree, "package": os.path.dirname(mmvae_tpu_torch.__file__), "config": config}
    try:
        bundle = registry.build(cfg)
    except NotImplementedError as e:
        return {**row, "skipped": str(e)}
    with tempfile.TemporaryDirectory() as data_dir:  # synthetic stand-in
        cfg.data_path = data_dir
        kw = {**loader_kwargs(cfg, bundle.dataset), "synthetic_n": 2048}
        train_loader, _, _ = get_dataloaders(bundle.dataset, batch_size=cfg.batch_size, **kw)
    trainer = Trainer(bundle.model, bundle.spec, cfg, device="cuda")
    trainer.init_parameters()
    trainer.init_opt_state()
    pipeline = trainer.make_device_pipeline(train_loader)
    rows = list(pipeline.epoch_index_batches())
    batches = [pipeline.gather(torch.from_numpy(rows[i % len(rows)]).cuda())
               for i in range(warmup + steps)]
    for xs in batches[:warmup]:
        trainer.train_step(xs, cfg.learning_rate)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for xs in batches[warmup:]:
            trainer.train_step(xs, cfg.learning_rate)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps * 1e3)
    return {**row, "train_step_ms": statistics.median(times), "repeats_ms": times,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "batch": cfg.batch_size,
            "K": cfg.K}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--configs", nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_step_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.measure:
        print(json.dumps(measure(args.trees[0], args.configs[0], args.seed, args.warmup,
                                 args.steps, args.repeats)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    for config in args.configs:
        for tree in args.trees:
            out = subprocess.run(
                [sys.executable, __file__, "--measure", "--trees", tree, "--configs", config,
                 "--seed", str(args.seed), "--warmup", str(args.warmup),
                 "--steps", str(args.steps), "--repeats", str(args.repeats)],
                capture_output=True, text=True, timeout=600, check=True)
            row = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
