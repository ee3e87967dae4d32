"""Train entry point (mmvae_tpu/cli/train.py; the reference's main.py).

Usage: python -m mmvae_tpu_torch.cli.train --config-path path/to/config.json
    [--experiments-dir DIR] [--device cuda|cpu] [--dist-backend nccl|gloo]

Data-parallel over N ranks, as the JAX CLI trains over all of a host's chips:
    torchrun --standalone --nproc_per_node=N -m mmvae_tpu_torch.cli.train \
        --config-path path/to/config.json
The config's "mesh_data" (null: every rank) and "mesh_k" lay the ranks out
as the JAX package lays out its devices (parallel/mesh.py); rank r trains on
cuda:r over NCCL. Ranks that share a card name `--dist-backend gloo`. Rank 0
alone writes the run dir; every rank holds the same parameters.

Takes the same JSON configs and writes the same run-dir layout:
<experiments-dir>/<experiment>/<date>/<runId>/ with args.json, metrics.jsonl,
losses.json and the best-val checkpoint (model.pt here).

JMVAE-NF-DCCA configs ("dcca": true) graft the pretrained trunks of
`python -m mmvae_tpu_torch.cli.dcca_train` from the config's "dcca_path"
(default <experiments-dir>/dcca/<dataset>/dcca.npz); without an artifact
the trunks stay random and frozen, with a warning, as in the JAX package.
"skip_warmup" starts from the shared joint-encoder pool
<experiments-dir>/joint_encoders/<experiment> that "save_joint" publishes;
with "use_gen" the `generate_joint` samples in that pool
(generated_modality_{i}.npy, the first "len_gen" of them) are appended to
the train set with label 0. "use_pretrain": RUN resumes RUN: its args.json
is adopted, with the epochs and warmup of both configs added, and its
model.pt is reloaded before training.
With "no_analytics": false, as every published config has it, image grids
are written every "freq_analytics" epochs and at epoch 1
(`analytics_callback`); on circles-squares, with the radius analytics
(rayon_corr_01, rayon_corr_10 and their histograms).

Float32 by default: on CUDA, TF32 is switched off for both matrix products
and cuDNN convolutions (cuDNN's default is on). The config keys
"compute_dtype" and "activation_dtype" select the JAX package's
mixed-precision policy (core/precision.py); the startup line prints it.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import json
import os
import traceback
from pathlib import Path
from tempfile import mkdtemp

import numpy as np
import torch


def analytics_callback(cfg, bundle, val_loader, run_path, device):
    """The per-epoch image grids (main.py:195-209), every `freq_analytics`
    epochs and at epoch 1: cond_samples_{r}x{o}_{epoch:03d}.png, 8
    conditional samples of modality o for each of the first 8 val rows of
    modality r beside those rows, and generate_{epoch:03d}.png, 32 prior
    samples. Where the val set has the true radii (circles-squares), also
    the radius analytics on its first 64 rows (jmvae_nf_circles.py:82-132):
    rayon_corr_01 and rayon_corr_10, printed, and
    hist_rayon_{ij}_{epoch:03d}.png. The noise comes from generators seeded
    from (seed, epoch). A failure to write the images is reported and does
    not stop training, as in the JAX CLI; a failure of the sampling itself
    (a kernel's launch among them) does."""
    from ..eval.generation import Noise, generate, sample_from_conditional
    from ..eval.latent_analysis import rayon_metrics, write_rayon_hists
    from ..vis import adjust_shape, save_image, save_samples
    from .common import STREAM_ANALYTICS, STREAM_RADIUS, generator

    xs, _ = next(iter(val_loader))
    val_xs = [torch.as_tensor(x[:8]).to(device, torch.float32) for x in xs]
    ds = val_loader.dataset
    radii_rows = None
    if {"r_squares", "r_circles"} <= set(ds.extras):
        n_an = min(64, len(ds))
        radii_rows = ([torch.as_tensor(np.asarray(m[:n_an])).to(device, torch.float32)
                       for m in ds.modalities],
                      ds.extras["r_squares"][:n_an], ds.extras["r_circles"][:n_an])

    @torch.no_grad()
    def analytics(trainer, epoch, *args, **kwargs):
        if epoch % cfg.freq_analytics != 0 and epoch != 1:
            return
        model = trainer.model
        noise = Noise([generator(device, cfg.seed, STREAM_ANALYTICS, epoch)])
        model.eval()
        samples = sample_from_conditional(model, val_xs, noise, n=8)
        cond = {(r, o): (x.cpu().numpy(), samples[r][o].reshape(-1, *samples[r][o].shape[2:])
                         .cpu().numpy())
                for r, x in enumerate(val_xs) for o in range(len(val_xs))}
        gen = [g.cpu().numpy() for g in generate(model, noise, bundle.spec, N=32)[:2]]
        radii = None
        if radii_rows is not None:
            rm, radii = rayon_metrics(
                model, *radii_rows, Noise([generator(device, cfg.seed, STREAM_RADIUS, epoch)]))
            print(f"[analytics] rayon metrics epoch {epoch}: {rm}")
        try:
            for (r, o), (x, recon) in cond.items():
                save_image(np.concatenate(adjust_shape(x, recon)),
                           os.path.join(run_path, f"cond_samples_{r}x{o}_{epoch:03d}.png"))
            save_samples(gen, os.path.join(run_path, f"generate_{epoch:03d}.png"))
            if radii is not None:
                write_rayon_hists(radii, run_path, epoch)
        except Exception as e:  # writing the grids must never kill training
            traceback.print_exc()
            print(f"[analytics] skipped at epoch {epoch}: {e!r}")

    return analytics


def main(argv=None):
    parser = argparse.ArgumentParser(description="Multi-Modal VAEs (PyTorch/CUDA)")
    parser.add_argument("--config-path", type=str, default="")
    parser.add_argument("--experiments-dir", type=str, default="experiments",
                        help="where run dirs go (default ./experiments)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    parser.add_argument("--dist-backend", type=str, default="", choices=["", "nccl", "gloo"],
                        help="torch.distributed backend under torchrun (default nccl on cuda, "
                        "gloo on the CPU); gloo where ranks share a card")
    info = parser.parse_args(argv)

    from ..core.config import ExperimentConfig
    from ..parallel import make_mesh
    from .common import torch_device

    cfg = ExperimentConfig.from_json(info.config_path)
    np.random.seed(cfg.seed)
    # use_pretrain resume (main.py:54-62, 88-91): adopt the old run's args,
    # extend the epoch budget, reload its checkpoint below
    pretrained_path = cfg.use_pretrain
    if pretrained_path:
        new_cfg = cfg
        cfg = ExperimentConfig.from_json(os.path.join(pretrained_path, "args.json"))
        prev_epochs = cfg.epochs
        cfg.epochs = prev_epochs + new_cfg.epochs
        cfg.warmup = prev_epochs + new_cfg.warmup
        cfg.freq_analytics = new_cfg.freq_analytics
        cfg.use_pretrain = pretrained_path

    device = torch_device(info.device)
    owns_group = not (torch.distributed.is_available() and torch.distributed.is_initialized())
    mesh = make_mesh(cfg.mesh_data, cfg.mesh_k, device=device,
                     backend=info.dist_backend or None)
    try:
        return _train(info, cfg, mesh, mesh.device if mesh.collective else device)
    finally:
        if mesh.collective and owns_group:
            torch.distributed.destroy_process_group()


def _train(info, cfg, mesh, device):
    """The run on this rank of `mesh`; rank 0 alone writes."""
    from ..data import get_dataloaders
    from ..data.loaders import ArrayLoader, PairedDataset
    from ..models import registry
    from ..train import Trainer, checkpoints
    from ..utils import Tracker
    from .common import loader_kwargs

    lead = mesh.rank == 0

    def say(*args):
        if lead:
            print(*args)

    pretrained_path = cfg.use_pretrain
    bundle = registry.build(cfg)
    run_path = None
    if lead:
        run_id = datetime.datetime.now().isoformat()
        experiment = cfg.experiment or bundle.model_name
        exp_dir = Path(info.experiments_dir) / experiment / datetime.date.today().isoformat()
        exp_dir.mkdir(parents=True, exist_ok=True)
        run_path = mkdtemp(prefix=run_id, dir=str(exp_dir))
        print("Expt:", run_path)
        with open(os.path.join(run_path, "args.json"), "w") as f:
            json.dump(cfg.to_dict(), f)
    run_path = mesh.from_rank0(run_path)

    train_loader, test_loader, val_loader = get_dataloaders(
        bundle.dataset, batch_size=cfg.batch_size, **loader_kwargs(cfg, bundle.dataset))

    # use_gen warm start: append the joint-encoder pool's generated samples
    # to the train set (main.py:123-127)
    if cfg.skip_warmup and cfg.use_gen:
        pool = os.path.join(info.experiments_dir, "joint_encoders",
                            (cfg.experiment or "default").split("/")[-1])
        gen = [np.load(os.path.join(pool, f"generated_modality_{i}.npy"))
               for i in range(len(bundle.shape_mods))]
        if cfg.len_gen:
            gen = [g[: cfg.len_gen] for g in gen]
        ds = train_loader.dataset
        merged = PairedDataset(
            [np.concatenate([m, g]) for m, g in zip(ds.modalities, gen)],
            [np.concatenate([l, np.zeros(len(gen[0]), dtype=l.dtype)]) for l in ds.labels])
        train_loader = ArrayLoader(merged, cfg.batch_size, shuffle=True)
        say(f"use_gen: appended {len(gen[0])} generated pairs")
    say(f"Train: {train_loader.num_examples}, Test: {test_loader.num_examples}, "
        f"Val: {val_loader.num_examples}" + (f"; {mesh.world} ranks, mesh (data={mesh.n_data}, "
                                             f"k={mesh.n_k}) over {mesh.backend}"
                                             if mesh.collective else ""))

    hooks = []
    if pretrained_path:
        def load_pretrained(model):
            say(f"Loading model from {pretrained_path}")
            checkpoints.load_model(model, pretrained_path)

        hooks.append(load_pretrained)
    if cfg.dcca:
        dcca_path = cfg.extra.get("dcca_path", os.path.join(info.experiments_dir, "dcca",
                                                            bundle.dataset, "dcca.npz"))
        if os.path.exists(dcca_path):
            say(f"grafting pretrained DCCA trunks from {dcca_path}")
            hooks.append(functools.partial(registry.graft_dcca_params, dcca_npz_path=dcca_path))
        else:
            say(f"WARNING: dcca=true but no artifacts at {dcca_path}; "
                "trunks stay randomly initialized (frozen)")

    def variables_hook(model):
        for hook in hooks:
            hook(model)

    trainer = Trainer(bundle.model, bundle.spec, cfg, run_path=run_path, device=device,
                      experiments_dir=info.experiments_dir, mesh=mesh, log_fn=say)
    compute = str(trainer.compute_dtype or torch.float32).removeprefix("torch.")
    stored = str(trainer.activation_dtype or "as computed").removeprefix("torch.")
    say(f"objective: {trainer.obj_name} on {device} (compute {compute}, activations {stored}"
        + (f"; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
           f"cuDNN {torch.backends.cudnn.allow_tf32}" if device.type == "cuda" else "") + ")")

    # rank 0 alone writes: the metrics, the grids, the losses
    tracker = Tracker(run_path if lead else None)

    def track(trainer_, epoch, tr_det, va_det, **metrics):
        payload = {"train_loss": metrics.get("tr_loss"), "val_loss": metrics.get("va_loss"),
                   "lr": metrics.get("lr")}
        payload.update({f"train_{k}": v for k, v in (tr_det or {}).items()})
        payload.update({f"val_{k}": v for k, v in (va_det or {}).items()})
        tracker.log(payload, step=epoch)

    callbacks = [track] if lead else []
    if lead and not cfg.no_analytics:
        callbacks.append(analytics_callback(cfg, bundle, val_loader, run_path, device))
    use_dp = bool(cfg.extra.get("device_pipeline", True))
    trainer.fit(train_loader, val_loader, callbacks=callbacks,
                variables_hook=variables_hook if hooks else None, use_device_pipeline=use_dp)
    tracker.close()

    if lead:
        with open(os.path.join(run_path, "losses.json"), "w") as f:
            json.dump(trainer._history, f)
    say("done; best checkpoints in", run_path)
    return run_path


if __name__ == "__main__":
    main()
