"""Hyperparameter sweep (mmvae_tpu/cli/sweep.py; the reference's wandb bayes
sweep, src/bivae/sweeps/sweep_mnist.yaml), in process:

- the spec: wandb's shape (method, metric {name, goal}, parameters, each
  with `value`, `values` or `min`/`max`), read from YAML, or from a .json
  file of the same schema where PyYAML is missing (it is imported only for
  a YAML spec);
- method 'random' or 'grid'; 'bayes' explores at random for its first
  max(3, trials // 3) trials, then perturbs the incumbent by a Gaussian of
  0.15 of each range;
- draws from numpy's default_rng(--seed): for one seed the same trial
  overrides as the JAX package;
- each trial trains through the train CLI on the base config updated by
  its overrides, under <experiment or model>/sweep_<i>, and scores the
  sweep metric from the run's metrics.json, else a 1-repeat validate
  (--skip-fid), else -min(val loss);
- sweep_results.json in --experiments-dir.

    python -m mmvae_tpu_torch.cli.sweep --spec sweeps/sweep_mnist.yaml \\
        --base-config configs/mnist_svhn/jmvae_nf.json --trials 10 [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np


def _sample_params(spec_params, rng, incumbent=None, explore=True):
    """One trial's overrides from the spec's parameter table."""
    out = {}
    for name, p in spec_params.items():
        key = name.replace("-", "_")
        if "value" in p:
            out[key] = p["value"]
        elif "values" in p:
            out[key] = p["values"][int(rng.integers(len(p["values"])))]
        elif "min" in p and "max" in p:
            lo, hi = float(p["min"]), float(p["max"])
            if incumbent is not None and not explore and key in incumbent:
                # bayes: a Gaussian step from the incumbent
                v = incumbent[key] + rng.normal(0, 0.15 * (hi - lo))
                out[key] = float(np.clip(v, lo, hi))
            else:
                out[key] = float(rng.uniform(lo, hi))
        else:
            raise ValueError(f"unsupported parameter spec for {name}: {p}")
    return out


def _grid(spec_params):
    keys, choices = [], []
    for name, p in spec_params.items():
        key = name.replace("-", "_")
        if "value" in p:
            keys.append(key)
            choices.append([p["value"]])
        elif "values" in p:
            keys.append(key)
            choices.append(list(p["values"]))
        else:
            raise ValueError(f"grid sweeps need discrete 'value(s)' for {name}")
    for combo in itertools.product(*choices):
        yield dict(zip(keys, combo))


def _load_spec(path: str) -> dict:
    """The sweep spec of a .json file, or of a YAML file through PyYAML."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        try:
            import yaml
        except ImportError as e:
            raise ImportError(f"{path}: a YAML spec needs PyYAML; give the same spec as a "
                              ".json file") from e
        return yaml.safe_load(f)


def run_trial(base_cfg: dict, overrides: dict, experiments_dir: str, metric_name: str,
              trial_id: int, sign: float = 1.0, device: str = "cuda") -> float:
    """Train one config and return a score to maximise: the sweep metric
    times `sign` (+1 maximise, -1 minimise), from metrics.json or a
    1-repeat validate without FID; with no metric, -min(val loss), which
    is a score to maximise already and takes no `sign`."""
    import tempfile

    from .train import main as train_main

    cfg = dict(base_cfg)
    cfg.update(overrides)
    cfg["experiment"] = os.path.join(cfg.get("experiment") or cfg["model"], f"sweep_{trial_id}")
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(cfg, f)
        cfg_path = f.name
    try:
        run_path = train_main(["--config-path", cfg_path, "--experiments-dir", experiments_dir,
                               "--device", device])
    finally:
        os.unlink(cfg_path)
    score = None
    mpath = os.path.join(run_path, "metrics.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            metrics = json.load(f)
        if metric_name in metrics:
            v = metrics[metric_name]
            score = v["mean"] if isinstance(v, dict) else float(v)
    if score is None and metric_name:
        try:
            from .validate import main as validate_main

            summary = validate_main(["--run-path", run_path, "--experiments-dir",
                                     experiments_dir, "--repeats", "1", "--skip-fid",
                                     "--device", device])
            if metric_name in summary:
                score = summary[metric_name]["mean"]
        except Exception as e:  # a broken trial's evaluation must not end the sweep
            print(f"sweep: validate for metric '{metric_name}' failed: {e}")
    if score is None:
        with open(os.path.join(run_path, "losses.json")) as f:
            hist = json.load(f)
        return -float(min(hist["test_loss"]))
    return sign * float(score)


def _trials(spec: dict, trials: int, seed: int, incumbent):
    """Yield each trial's overrides; `incumbent()` is the best trial so far
    ({"overrides", "score"} or None), read before each bayes draw."""
    method = spec.get("method", "random")
    if method == "grid":
        yield from list(_grid(spec["parameters"]))[:trials]
        return
    rng = np.random.default_rng(seed)
    for i in range(trials):
        best = incumbent()
        explore = method != "bayes" or i < max(3, trials // 3) or best is None
        yield _sample_params(spec["parameters"], rng, incumbent=best and best["overrides"],
                             explore=explore)


def main(argv=None):
    parser = argparse.ArgumentParser(description="In-process hyperparameter sweep")
    parser.add_argument("--spec", type=str, required=True,
                        help="sweep spec (sweep_mnist.yaml's schema), YAML or .json")
    parser.add_argument("--base-config", type=str, required=True,
                        help="base JSON config; sweep parameters override it")
    parser.add_argument("--trials", type=int, default=10)
    parser.add_argument("--experiments-dir", type=str, default="experiments")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    info = parser.parse_args(argv)

    spec = _load_spec(info.spec)
    with open(info.base_config) as f:
        base_cfg = json.load(f)
    method = spec.get("method", "random")
    metric = spec.get("metric", {})
    metric_name = metric.get("name", "")
    sign = 1.0 if metric.get("goal", "maximize") == "maximize" else -1.0

    trials, best = [], None
    for i, overrides in enumerate(_trials(spec, info.trials, info.seed, lambda: best)):
        score = run_trial(base_cfg, overrides, info.experiments_dir, metric_name, i, sign,
                          device=info.device)
        trials.append({"overrides": overrides, "score": score})
        if best is None or score > best["score"]:
            best = trials[-1]
        print(f"trial {i}: score {score:.4f} overrides "
              f"{ {k: v for k, v in overrides.items() if 'min' not in str(v)} }")

    out = {"method": method, "metric": metric, "best": best, "trials": trials}
    os.makedirs(info.experiments_dir, exist_ok=True)
    with open(os.path.join(info.experiments_dir, "sweep_results.json"), "w") as f:
        json.dump(out, f, indent=2)
    print("best:", json.dumps(best))
    return out


if __name__ == "__main__":
    main()
