"""What the eval entry points share (mmvae_tpu/cli/common.py): the device,
locating and reloading a run, the per-batch generators, and the eval
classifier pool."""

from __future__ import annotations

import glob
import inspect
import json
import os
from typing import Optional

import numpy as np
import torch

# streams of the eval generators, the first key after the config's seed
STREAM_CLASSIFIER, STREAM_COHERENCE, STREAM_FID, STREAM_GRIDS, STREAM_LIKELIHOOD, \
    STREAM_ANALYTICS, STREAM_PRD, STREAM_GMM, STREAM_RADIUS, STREAM_POE, \
    STREAM_POE_SUBSET = range(1, 12)


def torch_device(name) -> torch.device:
    """The device `name` (a string or a torch.device) to run on. CUDA
    raises where there is none (no fallback to the CPU) and runs float32
    with TF32 off for matrix products and cuDNN convolutions."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name} but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def derived_seed(*keys: int) -> int:
    """A 63-bit seed from integer keys (numpy's SeedSequence)."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def generator(device, *keys: int) -> torch.Generator:
    """A generator on `device` seeded from `keys`: (seed, stream, repeat,
    test batch) for the eval CLIs, one per batch, so that grouping batches
    changes no value."""
    return torch.Generator(device=device).manual_seed(derived_seed(*keys))


def find_latest_run(experiments_dir: str, experiment: str) -> str:
    """Latest run dir by mtime (validate.py:26-27)."""
    pattern = os.path.join(experiments_dir, experiment, "*", "*")
    runs = [d for d in glob.glob(pattern) if os.path.isdir(d)]
    if not runs:
        raise FileNotFoundError(f"no runs under {pattern}")
    return max(runs, key=os.path.getmtime)


def loader_kwargs(cfg, dataset: str) -> dict:
    """The keyword arguments, beside batch_size, with which the train CLI
    and a reload build `dataset`'s loaders from `cfg`: its data_path, the
    config's other keys that the dataset's constructor takes, and len_train
    where it takes one (the reference re-reads it on reload,
    jmvae_nf_mnist_svhn_dcca.py:104-106)."""
    from ..data.loaders import DATASETS

    sig = inspect.signature(DATASETS[dataset]).parameters
    kw = {k: v for k, v in cfg.extra.items() if k in sig}
    if cfg.len_train and "len_train" in sig:
        kw["len_train"] = cfg.len_train
    return dict(data_path=cfg.data_path, **kw)


def reload_model(run_path: str, batch_size: Optional[int] = None, device="cuda"):
    """-> (cfg, bundle, loaders): the run's config, its model with the
    best-val checkpoint model.pt on `device` (`torch_device`) in eval mode,
    and the loaders rebuilt at `batch_size` (validate.py:79 reloads at 500)."""
    from ..core.config import ExperimentConfig
    from ..data.loaders import get_dataloaders
    from ..models import registry

    device = torch_device(device)
    with open(os.path.join(run_path, "args.json")) as f:
        cfg = ExperimentConfig.from_dict(json.load(f))
    bundle = registry.build(cfg)
    kw = loader_kwargs(cfg, bundle.dataset)
    bs = batch_size or cfg.batch_size
    loaders = get_dataloaders(bundle.dataset, batch_size=bs, **kw)
    # clamp the eval batch to the smallest split, so that tiny (smoke)
    # datasets still yield a batch in every split
    n_min = min(l.num_examples for l in loaders)
    if 0 < n_min < bs:
        loaders = get_dataloaders(bundle.dataset, batch_size=n_min, **kw)
    state = torch.load(os.path.join(run_path, "model.pt"), map_location=device, weights_only=True)
    bundle.model.load_state_dict(state)
    bundle.model.to(device).eval()
    return cfg, bundle, loaders


def classifier_pool_dir(experiments_dir: str = "experiments") -> str:
    return os.path.join(experiments_dir, "classifiers")


def distribution_variant(cfg) -> str:
    """Filename suffix of the synthetic data distribution the eval
    classifiers were trained on (difficulty, confound_max, fold), so that
    runs on other distributions do not share a classifier; "" for real data
    and the default synthetic distribution. difficulty=0 and fold=0 are the
    default distribution; an explicit confound_max, 0.0 included, is not."""
    if cfg is None:
        return ""
    parts = []
    vals = dict(getattr(cfg, "extra", {}) or {})
    for k, tag in (("difficulty", "d"), ("confound_max", "c"), ("fold", "f")):
        v = vals.get(k, getattr(cfg, k, None))
        if v is not None and (v or k == "confound_max"):
            parts.append(f"{tag}{float(v):g}")
    return ("_" + "_".join(parts)) if parts else ""


def get_or_train_classifiers(bundle, loaders, experiments_dir: str, seed: int, epochs: int = 2,
                             cfg=None, device="cuda"):
    """The eval classifiers of the bundle's modalities, on `device`
    (`torch_device`), from the shared pool
    <experiments_dir>/classifiers/<key><variant>.pt, each trained and
    published on first use (on the train split's deduplicated base rows
    where the data are a LazyGather). Returns `classifiers.make_apply`
    functions."""
    from ..data.loaders import LazyGather
    from ..eval import classifiers as C

    device = torch_device(device)
    pool = classifier_pool_dir(experiments_dir)
    variant = distribution_variant(cfg)
    ds = loaders[0].dataset
    fns = []
    for m, ck in enumerate(bundle.classifier_keys):
        mod = ds.modalities[m]
        model = C.ARCHS[ck](in_shape=tuple(mod.shape[1:]))
        path = os.path.join(pool, f"{ck}{variant}.pt")
        try:
            model = C.load_classifier(model, path, device)
        except FileNotFoundError:
            if isinstance(mod, LazyGather) and mod.base_labels is not None:
                imgs, labs = mod.base, mod.base_labels
            else:
                imgs, labs = np.asarray(mod), ds.labels[m]
            C.train_classifier(model, imgs, labs, derived_seed(seed, STREAM_CLASSIFIER, m),
                               epochs=epochs, device=device)
            C.save_classifier(model, path)
        fns.append(C.make_apply(model))
    return fns
