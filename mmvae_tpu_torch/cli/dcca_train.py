"""DCCA pretraining entry point (mmvae_tpu/cli/dcca_train.py; the
reference's dcca/trainings/main_*.py).

Usage: python -m mmvae_tpu_torch.cli.dcca_train [--dataset mnist_svhn]
    [--epochs 20] [--batch-size 800] [--out experiments/dcca]
    [--device cuda|cpu] [--backend eigh|chol]

Trains the dataset's DCCA trunk pair, fits the linear CCA and writes
<out>/<dataset>/dcca.npz, which the `*_dcca` models of the train CLI graft
(default `dcca_path`: <experiments-dir>/dcca/<dataset>/dcca.npz).

The loss follows the device, as the JAX package's follows its platform:
on the CPU the reference eigh loss in float64, on cuda the Cholesky loss in
float32 (TF32 off). `--backend` overrides the loss. The SVM probe and the
embedding plot of the JAX CLI need scikit-learn and umap; they are not yet
ported (the evaluation slice), and the CLI says so instead of running them.
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="DCCA pretraining (PyTorch/CUDA)")
    parser.add_argument("--dataset", type=str, default="mnist_svhn",
                        help="a key of dcca.nets.DCCA_BUILDERS (mnist_svhn is ported)")
    parser.add_argument("--outdim", type=int, default=0,
                        help="trunk embedding dim (0 = per-dataset default)")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=800)
    parser.add_argument("--data-path", type=str, default="../data")
    parser.add_argument("--synthetic-n", type=int, default=0,
                        help="synthetic stand-in scale (0 = dataset default); match the "
                        "downstream model's synthetic_n")
    parser.add_argument("--difficulty", type=float, default=0.0)
    parser.add_argument("--confound-max", type=float, default=None)
    parser.add_argument("--fold", type=float, default=0.0)
    parser.add_argument("--out", type=str, default=os.path.join("experiments", "dcca"))
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    parser.add_argument("--backend", type=str, default="", choices=["", "eigh", "chol"],
                        help="CCA loss (default: eigh on the CPU, chol on cuda)")
    info = parser.parse_args(argv)

    from ..data import get_dataloaders
    from ..dcca.nets import DCCA_BUILDERS
    from ..dcca.train import Solver

    device = torch.device(info.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    on_cpu = device.type == "cpu"
    dtype = torch.float64 if on_cpu else torch.float32
    backend = info.backend or ("eigh" if on_cpu else "chol")

    builder, default_dim = DCCA_BUILDERS[info.dataset]
    outdim = info.outdim or default_dim
    extra = {"synthetic_n": info.synthetic_n} if info.synthetic_n else {}
    if info.difficulty:
        extra["difficulty"] = info.difficulty
    if info.confound_max is not None:
        extra["confound_max"] = info.confound_max
    if info.fold:
        extra["fold"] = info.fold
    train_l, _, val_l = get_dataloaders(info.dataset, batch_size=info.batch_size,
                                        data_path=info.data_path, **extra)
    print(f"DCCA {info.dataset}: trunk dim {outdim}, {backend} loss in "
          f"{str(dtype).removeprefix('torch.')} on {device}; train {train_l.num_examples}, "
          f"val {val_l.num_examples}")

    solver = Solver(builder(outdim), outdim, backend=backend, device=device, dtype=dtype)
    solver.fit(train_l, val_l, epochs=info.epochs)
    out_path = os.path.join(info.out, info.dataset, "dcca.npz")
    solver.save(out_path)
    print("saved", out_path)
    print("SVM probe and embedding plot: not yet ported (they need scikit-learn and umap; "
          "the evaluation slice)")
    return out_path


if __name__ == "__main__":
    main()
