"""Likelihood entry point (mmvae_tpu/cli/compute_likelihoods.py; the
reference's compute_likelihoods.py).

    python -m mmvae_tpu_torch.cli.compute_likelihoods --model jmvae_nf/mnist_svhn \\
        --experiments-dir DIR [--bis] [--device cuda|cpu]

Per test batch, with K importance samples in chunks of --batch-size-k
(compute_likelihoods.py:95-122): the conditional likelihoods
cond_likelihood_i_j, the family's joint likelihood `likelihood` (MMVAE's
and MoE-PoE's Bernoulli-mixture proposal, JMVAE-NF's joint posterior,
MVAE's PoE with the prior; MMVAE-NF has none),
and with --bis conditional_likelihood_bis_i_j (MMVAE-NF has no estimator
for it, as in the reference). Each repeat's value is the mean over the test
batches weighted by their sizes; likelihoods.json holds each metric's mean
and std over the repeats.

Test batches go through the estimators --steps-per-dispatch at a time, a
ragged last batch alone; each batch's noise comes from a generator seeded
from (seed, repeat, batch), so the grouping changes no value. It fills the
estimators' model calls of `likelihoods.ROWS_PER_CALL` rows where the
batches are smaller than a call (--n-data, --batch-size): on an H100, ten
test batches of 50 took 1.05 s in one call against 1.19 s in ten
(chip_smoke.py, phase eval_memory).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def joint_fn_for(model):
    """The family's joint-likelihood estimator (compute_likelihoods.py:65-77).
    Bimodal MoE-PoE takes MMVAE's mixture proposal: the reference's own
    MoE-PoE estimator is broken (moepoe.py:217-249 holds a deliberate 1/0)."""
    from ..eval import likelihoods as L
    from ..models import JMVAE_NF, MMVAE, MOEPOE, MVAE

    if isinstance(model, JMVAE_NF):
        return L.joint_likelihood_jmvae_nf
    if isinstance(model, MVAE):
        return L.joint_likelihood_mvae
    if isinstance(model, MMVAE) or (isinstance(model, MOEPOE) and model.n_mod == 2):
        return L.joint_likelihood_mmvae
    return None


def group_batches(batches, steps: int):
    """(groups of `steps` full-size batches, the rest one by one): the
    ragged last batch and the leftover full ones run alone."""
    full_bs = batches[0][1][0].shape[0] if batches else 0
    groups, run = [], []
    for bi, xs in batches:
        if steps > 1 and xs[0].shape[0] == full_bs:
            run.append((bi, xs))
            if len(run) == steps:
                groups.append(run)
                run = []
        else:
            groups.append([(bi, xs)])
    return groups + [[b] for b in run]


def main(argv=None):
    parser = argparse.ArgumentParser(description="IS likelihoods of a trained run")
    parser.add_argument("--model", type=str, default="")
    parser.add_argument("--run-path", type=str, default="")
    parser.add_argument("--experiments-dir", type=str, default="experiments")
    parser.add_argument("--k", type=int, default=1000)
    parser.add_argument("--batch-size-k", type=int, default=100)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--n-data", type=str, default="all",
                        help="datapoints per test batch; 'all' = the full test set")
    parser.add_argument("--max-batches", type=int, default=0,
                        help="cap on test batches per repeat (0 = no cap)")
    parser.add_argument("--batch-size", type=int, default=500, help="test batch size")
    parser.add_argument("--bis", action="store_true",
                        help="also ln p(x|y) = joint_ll_from_uni - uni_from_prior "
                        "(multi_vaes.py:253-268) for every ordered pair")
    parser.add_argument("--steps-per-dispatch", type=int, default=16,
                        help="test batches per estimator call")
    parser.add_argument("--device", type=str, default="cuda")
    info = parser.parse_args(argv)

    from ..eval import likelihoods as L
    from .common import STREAM_LIKELIHOOD, find_latest_run, generator, reload_model, torch_device

    device = torch_device(info.device)
    run_path = info.run_path or find_latest_run(info.experiments_dir, info.model)
    print("Computing likelihoods for", run_path)
    cfg, bundle, (_, test_l, _) = reload_model(run_path, info.batch_size, device)
    model = bundle.model
    dtype = next(model.parameters()).dtype
    joint_fn = joint_fn_for(model)

    use_bis = info.bis
    if use_bis:
        try:
            L.joint_ll_from_uni_for(model)
        except NotImplementedError as e:
            # MMVAE-NF: the reference's own estimator is a stub (mmvae_nf.py:85-89)
            print(f"bis protocol unavailable: {e}")
            use_bis = False

    batches = []
    for bi, (xs, _) in enumerate(test_l):
        if info.max_batches and bi >= info.max_batches:
            break
        if info.n_data != "all":
            xs = [x[: int(info.n_data)] for x in xs]
        batches.append((bi, [torch.as_tensor(x).to(device, dtype) for x in xs]))
    groups = group_batches(batches, max(1, info.steps_per_dispatch))

    all_metrics = []
    for r in range(info.repeats):
        per_batch: dict = {}
        for group in groups:
            out = L.protocol_chunked(
                model, bundle.spec, [xs for _, xs in group],
                [generator(device, cfg.seed, STREAM_LIKELIHOOD, r, bi) for bi, _ in group],
                K=info.k, batch_size_K=info.batch_size_k, joint_fn=joint_fn, bis=use_bis)
            for k, vs in out.items():
                for (bi, xs), v in zip(group, vs):
                    per_batch.setdefault(k, []).append((bi, v, xs[0].shape[0]))
        # batch means weighted by batch size, summed in batch order whatever
        # the grouping (compute_likelihoods.py:102-107)
        metrics = {k: float(sum(v * w for _, v, w in sorted(vw)) / sum(w for _, _, w in vw))
                   for k, vw in per_batch.items()}
        all_metrics.append(metrics)
        print(f"repeat {r}: {metrics}")

    summary = {k: {"mean": float(np.mean([m[k] for m in all_metrics])),
                   "std": float(np.std([m[k] for m in all_metrics]))}
               for k in all_metrics[0]}
    print(json.dumps(summary, indent=2))
    with open(os.path.join(run_path, "likelihoods.json"), "w") as f:
        json.dump(summary, f)
    return summary


if __name__ == "__main__":
    main()
