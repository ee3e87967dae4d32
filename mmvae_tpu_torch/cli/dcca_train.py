"""DCCA pretraining entry point (mmvae_tpu/cli/dcca_train.py; the
reference's dcca/trainings/main_*.py).

Usage: python -m mmvae_tpu_torch.cli.dcca_train [--dataset mnist_svhn]
    [--epochs 20] [--batch-size 800] [--out experiments/dcca]
    [--device cuda|cpu] [--backend eigh|chol]

Trains the dataset's DCCA trunks (three views on MNIST-SVHN-Fashion, on the
pairwise mcca loss), fits the linear CCA on the first two views and writes
<out>/<dataset>/dcca.npz, which the `*_dcca` models of the train CLI graft
(default `dcca_path`: <experiments-dir>/dcca/<dataset>/dcca.npz).

The loss follows the device, as the JAX package's follows its platform:
on the CPU the reference eigh loss in float64, on cuda the Cholesky loss in
float32 (TF32 off). `--backend` overrides the loss.

Then, as the JAX CLI (mmvae_tpu/cli/dcca_train.py:88-147), on the trunks'
test features, the linear CCA applied to views 0 and 1 (the trimodal third
view stays raw):
- the SVM probe of each view (dcca/utils.py:33; the reference's
  dcca/validate/main_{celeba,msf}.py protocol): a linear SVC
  (eval/linear.py, scikit-learn's LinearSVC solved exactly, on the device)
  fitted on the first half of the test rows and scored on the second, on
  the class label, or on CelebA one per attribute bit, a column that takes
  one value in the first half skipped; it prints JAX's lines,
  "SVM probe view v: acc a" (and "SVM probe view v attribute i: acc a");
- the embedding figure of each view, <out>/<dataset>/embedding_{v}.png
  with its .json (vis.visualize_umap, the in-repo UMAP on the device): 300
  test rows drawn with default_rng(0), colored by class (uncolored on
  CelebA, whose targets are the 40 attribute bits).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# test rows in each embedding figure: a scatter needs no more
N_PLOT = 300


def main(argv=None):
    parser = argparse.ArgumentParser(description="DCCA pretraining (PyTorch/CUDA)")
    parser.add_argument("--dataset", type=str, default="mnist_svhn",
                        help="a key of dcca.nets.DCCA_BUILDERS")
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
    train_l, test_l, val_l = get_dataloaders(info.dataset, batch_size=info.batch_size,
                                             data_path=info.data_path, **extra)
    print(f"DCCA {info.dataset}: trunk dim {outdim}, {backend} loss in "
          f"{str(dtype).removeprefix('torch.')} on {device}; train {train_l.num_examples}, "
          f"val {val_l.num_examples}")

    solver = Solver(builder(outdim), outdim, backend=backend, device=device, dtype=dtype)
    solver.fit(train_l, val_l, epochs=info.epochs)
    out_path = os.path.join(info.out, info.dataset, "dcca.npz")
    solver.save(out_path)
    print("saved", out_path)
    feats, labels = probe_features(solver, test_l, info.dataset, device)
    svm_probe(feats, labels, device)
    embedding_figures(feats, labels, os.path.join(info.out, info.dataset), device)
    return out_path


def probe_features(solver, test_loader, dataset, device):
    """The trunks' features of the test set, linear-CCA projected on views
    0 and 1 (the trimodal third view stays raw; main_mnist_svhn.py:218-221),
    and its targets: ([numpy (rows, dim) per view], labels (rows,) or, on
    CelebA, the 40 attribute bits (rows, 40))."""
    solver.model.eval()
    feats, labels = None, []
    with torch.no_grad():
        for xs, labs in test_loader:
            outs = solver.model([torch.as_tensor(x).to(device, solver.dtype) for x in xs])
            feats = [[] for _ in outs] if feats is None else feats
            for v, out in enumerate(outs):
                feats[v].append(out.cpu().numpy())
            # celeba: the targets are the 40 attribute bits, not one label
            labels.append(np.asarray(xs[1]).reshape(len(xs[1]), -1) if dataset == "celeba"
                          else np.asarray(labs[0]))
    feats = [np.concatenate(chunks) for chunks in feats]
    return [solver.lcca.transform(h, v) if v < 2 else h for v, h in enumerate(feats)], \
        np.concatenate(labels)


def svm_probe(feats, labels, device):
    """The SVM probe of each view (mmvae_tpu/cli/dcca_train.py:101-127): a
    LinearSVC per target column fitted on the first half of the rows and
    scored on the second; a column with one value in the first half is
    skipped. Prints JAX's lines; returns {view: [accuracy per column]}."""
    from ..eval.linear import LinearSVC

    cols = labels.reshape(len(labels), -1).T if labels.ndim > 1 else labels[None]
    out = {}
    for v, h in enumerate(feats):
        n = len(h) // 2
        accs = []
        for ci, col in enumerate(cols):
            if len(np.unique(col[:n])) < 2:
                continue
            accs.append(LinearSVC(device=device).fit(h[:n], col[:n]).score(h[n:], col[n:]))
            if len(cols) > 1:
                print(f"SVM probe view {v} attribute {ci}: acc {accs[-1]:.4f}")
        print(f"SVM probe view {v}: acc {float(np.mean(accs)):.4f}")
        out[v] = accs
    return out


def embedding_figures(feats, labels, out_dir, device):
    """embedding_{v}.png of each view (mmvae_tpu/cli/dcca_train.py:129-147)
    from `probe_features`: N_PLOT rows of a default_rng(0) permutation, so
    that a class-ordered test set shows every class, colored by class where
    the targets are one label. Returns the files written."""
    from ..vis import visualize_umap

    classes = None if labels.ndim > 1 else labels
    paths = []
    for v, h in enumerate(feats):
        sel = np.random.default_rng(0).permutation(len(h))[:N_PLOT]
        paths.append(os.path.join(out_dir, f"embedding_{v}.png"))
        visualize_umap(h[sel], None if classes is None else classes[sel], save_file=paths[-1],
                       device=device)
    return paths


if __name__ == "__main__":
    main()
