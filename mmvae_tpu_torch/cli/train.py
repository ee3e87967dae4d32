"""Train entry point (mmvae_tpu/cli/train.py; the reference's main.py).

Usage: python -m mmvae_tpu_torch.cli.train --config-path path/to/config.json
    [--experiments-dir DIR] [--device cuda|cpu]

Takes the same JSON configs and writes the same run-dir layout:
<experiments-dir>/<experiment>/<date>/<runId>/ with args.json, metrics.jsonl,
losses.json and the best-val checkpoint (model.pt here).

Precision is float32 throughout: on CUDA, TF32 is switched off for both
matrix products and cuDNN convolutions (cuDNN's default is on).
"""

from __future__ import annotations

import argparse
import datetime
import inspect
import json
import os
import time
from pathlib import Path
from tempfile import mkdtemp

import numpy as np
import torch


def _not_yet_ported(cfg):
    """Config features of the JAX CLI this port does not run yet."""
    if not cfg.no_analytics:
        return "analytics not yet ported: set \"no_analytics\": true"
    for key in ("use_pretrain", "skip_warmup", "use_gen", "dcca"):
        if getattr(cfg, key):
            return f"{key} not yet ported"
    if cfg.extra.get("compute_dtype") or cfg.extra.get("activation_dtype"):
        return "reduced-precision compute_dtype/activation_dtype not yet ported"
    if cfg.mesh_data not in (None, 1) or cfg.mesh_k != 1:
        return "multi-device meshes not yet ported"
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(description="Multi-Modal VAEs (PyTorch/CUDA)")
    parser.add_argument("--config-path", type=str, default="")
    parser.add_argument("--experiments-dir", type=str, default="experiments",
                        help="where run dirs go (default ./experiments)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    info = parser.parse_args(argv)

    from ..core.config import ExperimentConfig
    from ..data import get_dataloaders
    from ..data.loaders import DATASETS
    from ..models import registry
    from ..train import Trainer

    cfg = ExperimentConfig.from_json(info.config_path)
    problem = _not_yet_ported(cfg)
    if problem:
        raise NotImplementedError(problem)
    device = torch.device(info.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    np.random.seed(cfg.seed)

    bundle = registry.build(cfg)
    run_id = datetime.datetime.now().isoformat()
    experiment = cfg.experiment or bundle.model_name
    exp_dir = Path(info.experiments_dir) / experiment / datetime.date.today().isoformat()
    exp_dir.mkdir(parents=True, exist_ok=True)
    run_path = mkdtemp(prefix=run_id, dir=str(exp_dir))
    print("Expt:", run_path)
    with open(os.path.join(run_path, "args.json"), "w") as f:
        json.dump(cfg.to_dict(), f)

    kw = dict(batch_size=cfg.batch_size, data_path=cfg.data_path)
    if cfg.len_train and bundle.dataset == "mnist_svhn":
        kw["len_train"] = cfg.len_train
    # forward unknown config keys that the dataset constructor accepts
    sig = inspect.signature(DATASETS[bundle.dataset]).parameters
    kw.update({k: v for k, v in cfg.extra.items() if k in sig})
    train_loader, test_loader, val_loader = get_dataloaders(bundle.dataset, **kw)
    print(f"Train: {train_loader.num_examples}, Test: {test_loader.num_examples}, "
          f"Val: {val_loader.num_examples}")

    trainer = Trainer(bundle.model, bundle.spec, cfg, run_path=run_path, device=device)
    print(f"objective: {trainer.obj_name} on {device}"
          + (f" (TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
             f"cuDNN {torch.backends.cudnn.allow_tf32})" if device.type == "cuda" else ""))

    metrics_path = os.path.join(run_path, "metrics.jsonl")

    def track(trainer_, epoch, tr_det, va_det, **metrics):
        payload = {"train_loss": metrics.get("tr_loss"), "val_loss": metrics.get("va_loss"),
                   "lr": metrics.get("lr")}
        payload.update({f"train_{k}": v for k, v in (tr_det or {}).items()})
        payload.update({f"val_{k}": v for k, v in (va_det or {}).items()})
        payload.update(epoch=epoch, _t=time.time())
        with open(metrics_path, "a") as f:
            f.write(json.dumps({k: float(v) for k, v in payload.items()}) + "\n")

    use_dp = bool(cfg.extra.get("device_pipeline", True))
    trainer.fit(train_loader, val_loader, callbacks=[track], use_device_pipeline=use_dp)

    with open(os.path.join(run_path, "losses.json"), "w") as f:
        json.dump(trainer._history, f)
    print("done; best checkpoints in", run_path)
    return run_path


if __name__ == "__main__":
    main()
