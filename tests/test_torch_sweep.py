"""The port's sweep CLI (mmvae_tpu_torch/cli/sweep.py) against the JAX
package's (mmvae_tpu/cli/sweep.py, tests/test_sweep.py:10-60):

- for one seed, the same trial overrides as JAX over random, grid and
  bayes, the trials' scores handed to both by a stand-in `run_trial`, so
  that bayes moves from the same incumbents;
- two random trials through the train CLI on the CPU on JAX's tiny
  circles config, ranked and written to sweep_results.json, from a YAML
  spec and from the same spec as .json;
- the fallback score -min(val loss) takes no sign.
"""

import json
import os

import pytest
import torch
import yaml

from mmvae_tpu.cli import sweep as jax_sweep
from mmvae_tpu_torch.cli import sweep

BASE = {
    "llik_scaling": 0.0, "batch_size": 16, "learning_rate": 1e-3,
    "num_hidden_layers": 1, "use_pretrain": "", "seed": 1,
    "data_path": "", "skip_warmup": False, "warmup": 0, "beta_prior": 1,
    "beta_kl": 1, "decrease_beta_kl": 1, "fix_decoders": True,
    "fix_jencoder": True, "no_recon": False, "freq_analytics": 100,
    "dcca": False, "experiment": "", "model": "circles_squares",
    "obj": "elbo", "K": 1, "recon_losses": ["normal", "normal"],
    "looser": False, "epochs": 1, "latent_dim": 2, "dist": "normal",
    "no_nf": True, "dataset_size": 40, "n_repeat": 2,
    "no_analytics": True,
}
SPEC = {
    "method": "random",
    "metric": {"name": "", "goal": "maximize"},
    "parameters": {"beta-kl": {"min": 0.1, "max": 1.0}, "model": {"value": "circles_squares"}},
}
DRAW_SPEC = {
    "metric": {"name": "acc_0_1", "goal": "maximize"},
    "parameters": {"beta-kl": {"min": 0.0, "max": 1.0},
                   "decrease_beta_kl": {"min": 0.7, "max": 1.0},
                   "latent-dim": {"values": [2, 5, 8]}, "obj": {"values": ["elbo", "dreg"]},
                   "warmup": {"value": 15}},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _overrides(module, spec, tmp_path, seed, monkeypatch, trials=9):
    """The overrides `module`'s sweep runs, each trial scored by a fixed
    sequence, with no training."""
    scores = iter([0.3, 0.1, 0.5, 0.2, 0.9, 0.4, 0.6, 0.8, 0.7, 0.05, 0.95, 0.35])
    seen = []

    def run_trial(base_cfg, overrides, *args, **kwargs):
        seen.append(overrides)
        return next(scores)

    monkeypatch.setattr(module, "run_trial", run_trial)
    path = tmp_path / f"spec_{module.__name__.split('.')[0]}.yaml"
    path.write_text(yaml.safe_dump(spec))
    base = tmp_path / "base.json"
    base.write_text(json.dumps(BASE))
    out = module.main(["--spec", str(path), "--base-config", str(base), "--trials", str(trials),
                       "--experiments-dir", str(tmp_path / "exp"), "--seed", str(seed)])
    assert [t["overrides"] for t in out["trials"]] == seen
    return seen, out["best"]


@pytest.mark.parametrize("method", ["random", "grid", "bayes"])
@pytest.mark.parametrize("seed", [0, 7])
def test_same_trial_overrides_as_jax(method, seed, tmp_path, monkeypatch):
    spec = dict(DRAW_SPEC, method=method)
    if method == "grid":
        spec["parameters"] = {k: v for k, v in spec["parameters"].items() if "min" not in v}
    want, want_best = _overrides(jax_sweep, spec, tmp_path, seed, monkeypatch)
    got, best = _overrides(sweep, spec, tmp_path, seed, monkeypatch)
    assert got == want and best == want_best
    assert len(got) == (6 if method == "grid" else 9)


def test_sweep_random_two_trials(tmp_path):
    """tests/test_sweep.py's two trials, through the port's train CLI on the
    CPU, once from the YAML spec and once from the same spec as .json."""
    base_path = tmp_path / "base.json"
    base_path.write_text(json.dumps(BASE))
    (tmp_path / "spec.yaml").write_text(yaml.safe_dump(SPEC))
    (tmp_path / "spec.json").write_text(json.dumps(SPEC))
    results = []
    for ext in ("yaml", "json"):
        exp_dir = str(tmp_path / f"exp_{ext}")
        out = sweep.main(["--spec", str(tmp_path / f"spec.{ext}"), "--base-config",
                          str(base_path), "--trials", "2", "--experiments-dir", exp_dir,
                          "--device", "cpu"])
        assert len(out["trials"]) == 2
        assert out["best"]["score"] >= max(t["score"] for t in out["trials"]) - 1e-9
        assert 0.1 <= out["best"]["overrides"]["beta_kl"] <= 1.0
        assert os.path.exists(os.path.join(exp_dir, "sweep_results.json"))
        results.append(out)
    assert results[0] == results[1]


def test_fallback_score_is_sign_invariant(tmp_path):
    """With no metric the score is -min(val loss), not negated again for
    goal=minimize (which would rank the worst trial best)."""
    s_min = sweep.run_trial(BASE, {}, str(tmp_path / "exp"), "", 0, sign=-1.0, device="cpu")
    assert s_min < 0


def test_yaml_spec_without_pyyaml(tmp_path, monkeypatch):
    """Where PyYAML is missing a YAML spec raises and names the .json form."""
    import sys

    (tmp_path / "spec.yaml").write_text(yaml.safe_dump(SPEC))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match=".json"):
        sweep._load_spec(str(tmp_path / "spec.yaml"))
    (tmp_path / "spec.json").write_text(json.dumps(SPEC))
    assert sweep._load_spec(str(tmp_path / "spec.json")) == SPEC
