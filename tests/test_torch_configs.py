"""Which of the repo's configs the port runs: every
`configs/mnist_svhn/**/*.json` and the two `configs/ms_small/*gen*` configs
(use_gen) build their model through the port's registry and resolve their
objective; over all of `configs/**`, all 96 do. Models are built only, with no forward pass.
"""

import glob
import os

import pytest

from mmvae_tpu.models import registry as jreg
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.objectives import resolve

MNIST_SVHN = sorted(glob.glob("configs/mnist_svhn/**/*.json", recursive=True))
GEN = sorted(glob.glob("configs/ms_small/*gen*.json"))


def test_census_counts_every_mnist_svhn_config():
    assert len(MNIST_SVHN) == 56 and len(GEN) == 2


@pytest.mark.parametrize("path", MNIST_SVHN, ids=lambda p: os.path.relpath(p, "configs"))
def test_mnist_svhn_config_builds(path):
    """The config builds and resolves its objective as the Trainer does
    (multimodal, the config's `looser`)."""
    cfg = ExperimentConfig.from_json(path)
    bundle = registry.build(cfg)
    assert bundle.dataset == "mnist_svhn" and len(list(bundle.model.parameters())) > 0
    name, fn = resolve(cfg.obj, True, cfg.looser)
    assert callable(fn) and name.startswith("m_")


@pytest.mark.parametrize("path", GEN, ids=os.path.basename)
def test_gen_configs_are_refused(path):
    """The use_gen configs, refused until use_gen was ported, now build as
    the MNIST-SVHN ones do."""
    cfg = ExperimentConfig.from_json(path)
    assert cfg.use_gen and cfg.skip_warmup
    test_mnist_svhn_config_builds(path)


def _builds(path):
    try:
        cfg = ExperimentConfig.from_json(path)
        registry.build(cfg)
        resolve(cfg.obj, True, cfg.looser)
    except NotImplementedError:
        return False
    return True


def test_census_of_every_config():
    """All 96 of the repo's configs build and resolve: the
    56 MNIST-SVHN ones, the 4 of ms_small, the 3 of circles, the 9 of
    MedMNIST (mmvae_nf.json and moepoe.json name MNIST-SVHN builders), the
    2 of chest-SVHN, the 11 of CelebA and the 11 trimodal ones of
    configs/msf/; none is refused. Every model of the JAX registry has its
    builder."""
    every = sorted(glob.glob("configs/**/*.json", recursive=True))
    built = [p for p in every if _builds(p)]
    assert len(every) == 96
    assert len(built) == 96, sorted(set(every) - set(built))
    for ds in ("circles", "medmnist", "chest_svhn", "celeba", "msf"):
        assert {p for p in every if p.startswith(f"configs/{ds}/")} <= set(built), ds
    assert len(glob.glob("configs/msf/*.json")) == 11
    assert sorted(registry.REGISTRY) == sorted(jreg.REGISTRY)
