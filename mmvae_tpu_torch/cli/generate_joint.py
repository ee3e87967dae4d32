"""Joint-generation entry point (mmvae_tpu/cli/generate_joint.py; the
reference's generate_joint.py:50-114).

    python -m mmvae_tpu_torch.cli.generate_joint --run-path RUN [--n 1000]
        [--experiments-dir DIR] [--device cuda|cpu]

Reloads a trained run (or the latest run of --model), takes the latent of
every train batch (the joint encoder's mean for the families with one, else
the first modality's posterior mean), fits a 10-component full-covariance
Gaussian mixture on them (eval/gmm.py, float64 on the device), draws --n
latents, decodes them in every modality, saves generated_modality_{i}.npy
into the run and into the joint-encoder pool
<experiments-dir>/joint_encoders/<experiment> (where a use_gen retrain reads
them, main.py:123-127), and prints the joint coherence of the samples.
The mixture's k-means start and its samples draw from generators seeded
from the config's seed. Runs on cuda unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def latent_fn(model, device, dtype):
    """The family's latent of a batch (JAX's `_infer`): the joint encoder's
    mean where the model has one, else the first modality's posterior mean
    from `encode_all`."""
    if hasattr(model, "joint_encoder"):
        def infer(xs):
            return model.encode_joint(xs)[0]
    else:
        def infer(xs):
            return model.encode_all(xs)[0][0]

    @torch.no_grad()
    def fn(xs):
        return infer([torch.as_tensor(np.asarray(x)).to(device, dtype) for x in xs])

    return fn


def main(argv=None):
    parser = argparse.ArgumentParser(description="GMM joint generation from a trained run")
    parser.add_argument("--model", type=str, default="")
    parser.add_argument("--run-path", type=str, default="")
    parser.add_argument("--experiments-dir", type=str, default="experiments")
    parser.add_argument("--n", type=int, default=1000)
    parser.add_argument("--device", type=str, default="cuda")
    info = parser.parse_args(argv)

    from ..eval.coherence import compute_joint_accuracy
    from ..eval.generation import Noise, generate
    from ..eval.gmm import fit_sampler_on_train_latents
    from .common import (
        STREAM_GMM, find_latest_run, generator, get_or_train_classifiers, reload_model,
        torch_device,
    )

    device = torch_device(info.device)
    t0 = time.perf_counter()

    def _mark(msg):
        print(f"[{time.perf_counter() - t0:8.3f}s] {msg}", flush=True)

    run_path = info.run_path or find_latest_run(info.experiments_dir, info.model)
    cfg, bundle, loaders = reload_model(run_path, device=device)
    model = bundle.model
    dtype = next(model.parameters()).dtype
    _mark("model reloaded")

    infer = latent_fn(model, device, dtype)
    sampler, latents, _ = fit_sampler_on_train_latents(
        loaders[0], infer, generator=generator(device, cfg.seed, STREAM_GMM, 0))
    fit = sampler.fit_result
    print(f"GMM fitted on {len(latents)} train latents ({fit.n_iter} EM iterations, "
          f"converged {fit.converged})")
    _mark("gmm fitted")

    with torch.no_grad():
        gen = generate(model, Noise([generator(device, cfg.seed, STREAM_GMM, 1)], dtype=dtype),
                       bundle.spec, N=info.n, sampler=sampler)
    _mark("sampled and decoded")
    # into the run dir and the joint-encoder pool: the use_gen retrain reads
    # generated_modality_i from the pool (main.py:123-127)
    pool = os.path.join(info.experiments_dir, "joint_encoders",
                        (cfg.experiment or "default").split("/")[-1])
    os.makedirs(pool, exist_ok=True)
    for i, g in enumerate(gen):
        arr = g.float().cpu().numpy()
        np.save(os.path.join(run_path, f"generated_modality_{i}.npy"), arr)
        np.save(os.path.join(pool, f"generated_modality_{i}.npy"), arr)

    classifiers = get_or_train_classifiers(bundle, loaders, info.experiments_dir, cfg.seed,
                                           cfg=cfg, device=device)
    with torch.no_grad():
        joint_acc = compute_joint_accuracy(classifiers, gen)
    _mark("joint coherence")
    print(f"joint coherence of GMM samples: {joint_acc:.4f}")
    return joint_acc


if __name__ == "__main__":
    main()
