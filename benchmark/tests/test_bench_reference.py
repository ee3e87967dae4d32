"""The plain reference against mmvae_tpu_torch on the CPU at small sizes,
through the harness's own check: the DReG-looser steps with AMSGrad, and
the JMVAE-NF and MMVAE likelihood estimators on the same pairs, weights
and noise; and each estimator's per-pair values directly."""

import math

import pytest
import torch

from benchmark import inputs
from benchmark.reference import common, jmvae_nf, mmvae_dreg


def test_dreg_looser_steps_with_amsgrad_match(run_small):
    r = run_small("mmvae_dreg.train")
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 4 and r["failed"] == 0
    for c in r["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["jmvae_nf.likelihood", "mmvae_dreg.likelihood"])
def test_the_likelihood_protocol_matches(run_small, cell):
    r = run_small(cell)
    assert r["correct"], r["compared"]
    assert r["compared"]["mean_gap"]["value"] <= 1e-6
    assert r["compared"]["pair_gap"]["value"] <= 1e-6


@pytest.mark.parametrize("ref,cfg_name", [(jmvae_nf, "jmvae_nf"), (mmvae_dreg, "mmvae_dreg")])
def test_each_estimator_pair_by_pair(small_cell, ref, cfg_name):
    """The program's estimators, called as the protocol calls them, against
    the reference's per-pair values from the same generator."""
    from mmvae_tpu_torch.cli.compute_likelihoods import joint_fn_for
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.eval import likelihoods as L
    from mmvae_tpu_torch.eval.generation import Noise
    from mmvae_tpu_torch.models import registry

    cell = small_cell(f"{cfg_name}.likelihood")
    cfg, dev, seed = cell.config["config"], torch.device("cpu"), 77
    bundle = registry.build(ExperimentConfig.from_dict(cfg))
    model = bundle.model.eval()
    with torch.device("meta"):
        shapes = ref.build(cfg)
    inputs.load_weights(model, inputs.make_weights(shapes, seed, dev))
    data = inputs.make_data(seed, cell.config["data"], "test", dev)
    rows = torch.arange(6).numpy()
    xs = [common.gather(img, tab, rows, dev) for img, tab in zip(data.images, data.tables)]
    K, bk = 20, 10

    g = torch.Generator().manual_seed(5)
    noise = Noise([g], [6])
    with torch.no_grad():
        prog = L.compute_conditional_likelihoods(model, xs, bundle.spec, noise, K, bk)
        prog.update(joint_fn_for(model)(model, xs, bundle.spec, noise, K, bk))
        prog.update(L.compute_conditional_likelihoods_bis(model, xs, bundle.spec, noise, K, bk))
        g = torch.Generator().manual_seed(5)
        refm = inputs.reference_model(ref, cfg, seed, dev)
        want = ref.likelihood(refm, xs, lambda kind, shape: common.draw_noise(kind, shape, g, dev),
                              K, bk, 30)
    assert list(prog) == list(want)
    for k, v in want.items():
        assert torch.allclose(prog[k], v, rtol=1e-5, atol=0), k
        assert all(math.isfinite(float(t)) for t in v)
