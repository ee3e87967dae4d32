"""bridge.py: a JAX `mmvae_nf_mnist_svhn` params tree survives
JAX -> port -> JAX bit-exactly, and the port's layouts are the ones the
bridge documents (Linear transposed, convs as they are)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.models import registry as jreg
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.models import registry

CONFIG = "configs/mnist_svhn/mmvae_nf_synth.json"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These sizes need no intra-op threads; under several test workers they
    only oversubscribe the cores (a CLI epoch here took 50 times as long
    beside five other workers as alone)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JCfg.from_json(CONFIG)
    cfg.latent_dim = 4
    model = jreg.build(cfg).model
    xs = [jnp.zeros((2, 1, 28, 28)), jnp.zeros((2, 3, 32, 32))]
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    params = jax.jit(lambda k, x: model.init(k, x)["params"])(keys, xs)
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_roundtrip_bit_exact(jax_params):
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.latent_dim = 4
    model = registry.build(cfg).model
    load_jax_params(model, jax_params)
    back = export_jax_params(model)
    theirs, ours = dict(_flat(jax_params)), dict(_flat(back))
    assert sorted(theirs) == sorted(ours)
    for path, arr in theirs.items():
        assert ours[path].dtype == arr.dtype and ours[path].shape == arr.shape, path
        np.testing.assert_array_equal(ours[path], arr, err_msg="/".join(path))

    enc = model.vaes[0].encoder.Linear_0.weight.detach().numpy()
    np.testing.assert_array_equal(enc, jax_params["vaes_0"]["encoder"]["Linear_0"]["kernel"].T)
    conv = model.vaes[1].decoder.ConvTranspose2d_1.weight.detach().numpy()
    np.testing.assert_array_equal(conv, jax_params["vaes_1"]["decoder"]["ConvTranspose2d_1"]["kernel"])
    made = model.vaes[1].flow.made[1].hidden[2].kernel.detach().numpy()
    np.testing.assert_array_equal(made, jax_params["vaes_1"]["flow"]["made_1"]["hidden_2"]["kernel"])


def test_export_owns_its_memory(jax_params):
    """An exported tree is a snapshot: training the model afterwards (in
    place, as the optimizer does) leaves it unchanged."""
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.latent_dim = 4
    model = registry.build(cfg).model
    load_jax_params(model, jax_params)
    ours = dict(_flat(export_jax_params(model)))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    for path, arr in _flat(jax_params):
        np.testing.assert_array_equal(ours[path], arr, err_msg="/".join(path))


def test_mismatched_trees_raise(jax_params):
    cfg = ExperimentConfig.from_json(CONFIG)
    cfg.latent_dim = 5  # every latent-sized leaf has the wrong shape
    with pytest.raises(ValueError):
        load_jax_params(registry.build(cfg).model, jax_params)
    cfg.latent_dim, cfg.n_made_blocks = 4, 1  # made_1 has no port parameter
    with pytest.raises(KeyError):
        load_jax_params(registry.build(cfg).model, jax_params)
