"""Metrics entry point (mmvae_tpu/cli/validate.py; the reference's
validate.py).

    python -m mmvae_tpu_torch.cli.validate --model jmvae_nf/mnist_svhn \\
        --experiments-dir DIR [--fid-encoder inception|classifier]
        [--fid-weights pt_inception-2015-12-05-6726825d.pth] [--device cuda|cpu]

Reloads the latest run of the experiment (or --run-path), then over the
full test set, in --repeats repeats (validate.py:98-154): the
cross-coherences acc_i_j and the joint coherence from the eval classifiers
(trained into <experiments-dir>/classifiers on first use), and the
conditional FID fid_j, and with --prd the PRD pair prd_f8_j / prd_f1_8_j
from the same activations, its curves prd_curve_j.npz, .png and .png.json
written on repeat 0. The FID's activations (validate.py:34-46, 89-99) are
the InceptionV3 FID net's pool3 features (--fid-encoder inception, the
default; eval/fid.py), at flax's random init drawn from seed 0 unless
--fid-weights names pytorch-fid's checkpoint, which is hash-checked and
loaded strictly, or the eval classifiers' penultimate features
(--fid-encoder classifier).
On circles-squares also `neg_entropy`, the negative entropy of the
conditional radius distribution on the first test batch (min(100, batch)
rows, min(100, 10 ns) samples each; its histogram hist_000.png on repeat
0), and for models with a joint encoder the product-of-posteriors figure
product_of_posteriors.png from Hamiltonian Monte Carlo (4 test rows, 30
chains, 100 steps). A failure of that sampling stops the run, where the JAX
CLI prints it and goes on. On the trimodal MNIST-SVHN-Fashion, for models
with a product of experts (MVAE, JMVAE-NF), also the PoE-subset accuracies
cond_acc_m (and for JMVAE-NF's Hamiltonian Monte Carlo, of --mcmc-steps
steps, hmc_acc_rate_m) on the first test batch, min(32, batch) rows and 8
samples each; a failure stops the run here too. On CelebA the
coherences are the attribute
metrics instead (eval/modalities.py, `BATCH_COHERENCE`): accuracy1,
accuracy2 and joint_coherence, always from the per-batch loop, even at
--n-data all.
Writes metrics.json (mean and std per metric over the repeats), one
metrics.jsonl row per repeat, and with two modalities the grids
generate_val.png and gen_from_cond_{0,1}.png.

Each test batch's noise comes from a generator of its own, seeded from
(seed, repeat, batch). Runs on cuda unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="Coherence and FID of a trained run")
    parser.add_argument("--model", type=str, default="",
                        help="experiment subdir, e.g. mmvae/mnist_svhn")
    parser.add_argument("--run-path", type=str, default="")
    parser.add_argument("--experiments-dir", type=str, default="experiments")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--n-data", type=str, default="all",
                        help="datapoints per batch to score; 'all' = every pair in the batch")
    parser.add_argument("--ns", type=int, default=1, help="conditional samples per datapoint")
    parser.add_argument("--batch-size", type=int, default=500, help="eval batch size")
    parser.add_argument("--skip-fid", action="store_true")
    parser.add_argument("--fid-batches", type=int, default=0,
                        help="cap FID on the first N test batches; 0 = the full test loader")
    parser.add_argument("--fid-weights", type=str, default="",
                        help="pytorch-fid's inception weights "
                        "(pt_inception-2015-12-05-6726825d.pth), hash-checked before use")
    parser.add_argument("--prd", action="store_true",
                        help="also the per-direction PRD f8/f1_8 from the FID activations")
    parser.add_argument("--fid-encoder", type=str, default="inception",
                        choices=["inception", "classifier"],
                        help="activation network for FID: the Inception FID net or the eval "
                        "classifiers' penultimate features")
    parser.add_argument("--mcmc-steps", type=int, default=100,
                        help="HMC chain length of the trimodal PoE-subset accuracies")
    parser.add_argument("--device", type=str, default="cuda")
    info = parser.parse_args(argv)

    from ..eval.classifiers import make_feature_fn
    from ..eval.coherence import compute_accuracies, compute_accuracies_dataset
    from ..eval.fid import cross_modal_fid, make_inception_fn
    from ..eval.generation import Noise, generate, generate_from_conditional
    from ..eval.latent_analysis import conditional_rdist_metrics, visualize_poe
    from ..eval.modalities import BATCH_COHERENCE, poe_subset_accuracy
    from ..utils import Tracker
    from ..vis import save_samples
    from .common import (
        STREAM_COHERENCE, STREAM_FID, STREAM_GRIDS, STREAM_POE, STREAM_POE_SUBSET, STREAM_PRD,
        STREAM_RADIUS, find_latest_run, generator, get_or_train_classifiers, reload_model,
        torch_device,
    )

    device = torch_device(info.device)
    t_start = time.time()

    def _mark(msg):
        print(f"[{time.time() - t_start:8.3f}s] {msg}", flush=True)

    run_path = info.run_path or find_latest_run(info.experiments_dir, info.model)
    print("Validating", run_path)
    cfg, bundle, (train_l, test_l, val_l) = reload_model(run_path, info.batch_size, device)
    model, spec = bundle.model, bundle.spec
    dtype = next(model.parameters()).dtype
    _mark("model reloaded")
    classifiers = get_or_train_classifiers(bundle, (train_l, test_l, val_l),
                                           info.experiments_dir, cfg.seed, cfg=cfg, device=device)
    _mark("classifiers ready")
    encoders = None
    if not info.skip_fid and info.fid_encoder == "classifier":
        encoders = [make_feature_fn(c.model) for c in classifiers]
    elif not info.skip_fid:
        encoders = make_inception_fn(info.fid_weights or None, device=device)
        _mark("inception initialized")

    def noise(*keys):
        return Noise([generator(device, cfg.seed, *keys)], dtype=dtype)

    circles = bundle.dataset == "circles_squares"
    batch_only = BATCH_COHERENCE.get(bundle.dataset)
    batch_coherence = batch_only or compute_accuracies

    def radius_metrics(xs, r):
        """neg_entropy on one test batch (jmvae_nf_circles.py:107-129)."""
        return conditional_rdist_metrics(
            model, xs, noise(STREAM_RADIUS, r), run_path=run_path if r == 0 else None,
            n=min(100, info.ns * 10), n_data=min(100, len(xs[0])))

    def batch(xs):
        return [torch.as_tensor(np.asarray(x)).to(device, dtype) for x in xs]

    # the trimodal PoE-subset accuracies (validate.py:101-136), for models
    # with a product of experts
    poe_subsets = len(model.vaes) == 3 and (hasattr(model, "poe_density")
                                            or hasattr(model, "poe_subset_params"))

    def subset_metrics(xs, labs, r):
        return poe_subset_accuracy(model, classifiers, xs, [np.asarray(l) for l in labs],
                                   generator(device, cfg.seed, STREAM_POE_SUBSET, r),
                                   n_data=min(32, len(xs[0])), ns=8, mcmc_steps=info.mcmc_steps)

    all_metrics = []
    with torch.no_grad():
        for r in range(info.repeats):
            if info.n_data == "all" and batch_only is None:
                metrics = compute_accuracies_dataset(
                    model, classifiers, test_l, lambda bi: noise(STREAM_COHERENCE, r, bi), spec,
                    ns=info.ns)
                if circles or poe_subsets:
                    xs0, labs0 = next(iter(test_l))
                    xs0 = batch(xs0)
                if poe_subsets:
                    _mark(f"repeat {r}: coherence done")
                    metrics.update(subset_metrics(xs0, labs0, r))
                if circles:
                    metrics.update(radius_metrics(xs0, r))
            else:
                # explicit subsets and batch-only coherences (CelebA's):
                # per-batch means weighted by the rows scored, so that a ragged last batch counts as its
                # rows; a metric of the first batch alone (neg_entropy) is
                # its value
                sums, weights = {}, {}
                for bi, (xs, labs) in enumerate(test_l):
                    xs = batch(xs)
                    n_data = len(xs[0])
                    if info.n_data != "all":
                        n_data = min(int(info.n_data), n_data)
                    m = batch_coherence(model, classifiers, xs, labs,
                                        noise(STREAM_COHERENCE, r, bi), spec,
                                        n_data=n_data, ns=info.ns)
                    if poe_subsets and bi == 0:
                        m.update(subset_metrics(xs, labs, r))
                    if circles and bi == 0:
                        m.update(radius_metrics(xs, r))
                    for k, v in m.items():
                        sums[k] = sums.get(k, 0.0) + v * n_data
                        weights[k] = weights.get(k, 0) + n_data
                metrics = {k: v / weights[k] for k, v in sums.items()}
            _mark(f"repeat {r}: accuracies done")
            if encoders is not None:
                metrics.update(cross_modal_fid(
                    model, test_l, lambda bi: noise(STREAM_FID, r, bi), encoders,
                    n_batches=info.fid_batches or None, verbose=(r == 0),
                    compute_prd=info.prd, prd_curve_dir=run_path if r == 0 else None,
                    prd_generator=generator(device, cfg.seed, STREAM_PRD, r)))
                _mark(f"repeat {r}: fid done")
            all_metrics.append(metrics)
            print(f"repeat {r}: {metrics}")

        # per-repeat tracking (validate.py:153-154)
        tracker = Tracker(run_path)
        for r, m in enumerate(all_metrics):
            tracker.log({f"val/{k}": v for k, v in m.items()}, step=r)
        tracker.close()

        summary = {k: {"mean": float(np.mean([m[k] for m in all_metrics])),
                       "std": float(np.std([m[k] for m in all_metrics]))}
                   for k in all_metrics[0]}
        print(json.dumps(summary, indent=2))
        with open(os.path.join(run_path, "metrics.json"), "w") as f:
            json.dump(summary, f)

        # sample grids of two modalities (validate.py:178-190): prior
        # samples, and the chained p(x) p(y|x) generations gen_from_cond_{0,1}
        # (multi_vaes.py:105-126)
        if len(model.vaes) == 2:
            gen = generate(model, noise(STREAM_GRIDS, 0), spec, N=32)
            save_samples([g.cpu().numpy() for g in gen],
                         os.path.join(run_path, "generate_val.png"))
            data, cond = generate_from_conditional(model, noise(STREAM_GRIDS, 1), spec, N=32)
            save_samples([data[0].cpu().numpy(), cond[0][1][0].cpu().numpy()],
                         os.path.join(run_path, "gen_from_cond_0.png"))
            save_samples([cond[1][0][0].cpu().numpy(), data[1].cpu().numpy()],
                         os.path.join(run_path, "gen_from_cond_1.png"))
        if circles and hasattr(model, "joint_encoder"):
            # the PoE figure (jmvae_nf_circles.py:138-214), JAX's defaults
            visualize_poe(model, batch(next(iter(test_l))[0]), run_path,
                          generator(device, cfg.seed, STREAM_POE))
            _mark("product of posteriors done")
    return summary


if __name__ == "__main__":
    main()
