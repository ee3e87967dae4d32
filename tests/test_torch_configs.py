"""Which of the repo's MNIST-SVHN configs the port runs: every
`configs/mnist_svhn/**/*.json` passes the train CLI's check of unported
features, builds its model through the port's registry and resolves its
objective. Models are built only, with no forward pass. The two
`configs/ms_small/*gen*` configs are still refused, for `use_gen`.
"""

import glob
import os

import pytest

from mmvae_tpu_torch.cli.train import _not_yet_ported
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.objectives import resolve

MNIST_SVHN = sorted(glob.glob("configs/mnist_svhn/**/*.json", recursive=True))
GEN = sorted(glob.glob("configs/ms_small/*gen*.json"))


def test_census_counts_every_mnist_svhn_config():
    assert len(MNIST_SVHN) == 56 and len(GEN) == 2


@pytest.mark.parametrize("path", MNIST_SVHN, ids=lambda p: os.path.relpath(p, "configs"))
def test_mnist_svhn_config_builds(path):
    """The config passes `_not_yet_ported`, builds, and resolves its
    objective as the Trainer does (multimodal, the config's `looser`)."""
    cfg = ExperimentConfig.from_json(path)
    assert _not_yet_ported(cfg) is None
    bundle = registry.build(cfg)
    assert bundle.dataset == "mnist_svhn" and len(list(bundle.model.parameters())) > 0
    name, fn = resolve(cfg.obj, True, cfg.looser)
    assert callable(fn) and name.startswith("m_")


@pytest.mark.parametrize("path", GEN, ids=os.path.basename)
def test_gen_configs_are_refused(path):
    assert _not_yet_ported(ExperimentConfig.from_json(path)) == "use_gen not yet ported"
