"""Evaluation of MVAE and MoE-PoE in the port against the JAX package:
generation, coherence, the conditional likelihoods, MVAE's joint
likelihood (the PoE of every expert with the prior as proposal), MoE-PoE's
(MMVAE's mixture proposal, as the JAX CLI dispatches it) and the bis
protocol on the raw encoder posteriors; then the train CLI with the
configs' own analytics, `validate` and `compute_likelihoods --bis` on the
CPU at a tiny size, for both families.

The registry's nets at latent 4, float64. Noise is drawn with numpy and
injected on the JAX side by replacing the package's samplers
(`mmvae_tpu.core.distributions.sample` and `.normal_sample`, which MVAE's
PoE samples go through) with functions that hand out the draws in turn;
the port takes the same arrays through a `Noise` stand-in. JAX traces each
estimator once under vmap and lax.map, so the estimators are held at one
IS chunk and ns = 1, as in tests/test_torch_eval.py, whose helpers this
file shares.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import distributions as JD
from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.eval import coherence as JC
from mmvae_tpu.eval import generation as JG
from mmvae_tpu.eval import likelihoods as JL
from mmvae_tpu.models import registry as jreg
from mmvae_tpu_torch.bridge import load_jax_params
from mmvae_tpu_torch.cli import compute_likelihoods, train, validate
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.eval import classifiers as Cl
from mmvae_tpu_torch.eval import coherence as C
from mmvae_tpu_torch.eval import generation as G
from mmvae_tpu_torch.eval import likelihoods as L
from mmvae_tpu_torch.models import registry
from test_torch_eval import GivenNoise, _bern_u, _classifiers, _close, _data, _jax_dtype

CONFIGS = {"mvae": "configs/mnist_svhn/mvae_synth.json",
           "moepoe": "configs/mnist_svhn/moepoe_synth.json"}
LATENT, K_IS, B_LL = 4, 5, 3
DTYPE = "float64"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_jax_caches(monkeypatch):
    """JAX's eval programs are cached per model: each test traces anew."""
    monkeypatch.setattr(JG, "_JIT_CACHE", {})
    monkeypatch.setattr(JC, "_ACC_CACHE", {})
    monkeypatch.setattr(JC, "_DS_CACHE", {})


@pytest.fixture(scope="module")
def jax_models():
    """{family: (JAX bundle, float32 numpy params)} at latent 4."""
    out = {}
    for fam, path in CONFIGS.items():
        jcfg = JCfg.from_json(path)
        jcfg.latent_dim = LATENT
        jb = jreg.build(jcfg)
        xs = [jnp.zeros((2, 1, 28, 28)), jnp.zeros((2, 3, 32, 32))]
        params = jax.jit(lambda k, x, jb=jb: jb.model.init(
            {"params": k, "sample": k}, x, K=1)["params"])(jax.random.PRNGKey(0), xs)
        out[fam] = (jb, jax.tree.map(np.asarray, params))
    return out


def _port(jax_models, fam):
    cfg = ExperimentConfig.from_json(CONFIGS[fam])
    cfg.latent_dim = LATENT
    bundle = registry.build(cfg)
    bundle.model.to(torch.float64).eval()
    load_jax_params(bundle.model, jax_models[fam][1])
    return bundle


def _jparams(jax_models, fam):
    return {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jax_models[fam][1])}


def _inject(monkeypatch, noise):
    """Both JAX samplers, `sample` and `normal_sample`, take `noise` in turn."""
    calls = []

    def normal_sample(p, key, sample_shape=()):
        e = jnp.asarray(noise[len(calls)], p.loc.dtype)
        calls.append(e.shape)
        return p.loc + e * p.scale

    def sample(dist, p, key, sample_shape=()):
        assert dist == "normal"
        return normal_sample(p, key, sample_shape)

    monkeypatch.setattr(JD, "sample", sample)
    monkeypatch.setattr(JD, "normal_sample", normal_sample)
    return calls


def _eps(rng, n, shape=(K_IS, LATENT)):
    return [rng.standard_normal(shape) for _ in range(n)]


# ---------------------------------------------------------------------------
# generation and coherence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", list(CONFIGS))
def test_generation_matches_jax(jax_models, monkeypatch, fam):
    """sample_from_conditional (ns = 1) and sample_latents_from_mod: MVAE's
    conditional rule samples the PoE of one expert with the prior,
    MoE-PoE's the unimodal posterior; float64 to 1e-10."""
    jb = jax_models[fam][0]
    rng = np.random.default_rng(1)
    xs = _data(3)
    e_cond = _eps(rng, 2, (3, LATENT))
    bundle = _port(jax_models, fam)
    with _jax_dtype(DTYPE, monkeypatch):
        v = _jparams(jax_models, fam)
        _inject(monkeypatch, e_cond)
        jcond = JG.sample_from_conditional(jb.model, v, [jnp.asarray(x) for x in xs],
                                           jax.random.PRNGKey(0), n=1)
        _inject(monkeypatch, e_cond[1:])
        jlat = JG.sample_latents_from_mod(jb.model, v, 1, jnp.asarray(xs[1]),
                                          jax.random.PRNGKey(0))
    with torch.no_grad():
        cond = G.sample_from_conditional(bundle.model, [torch.tensor(x) for x in xs],
                                         GivenNoise(e_cond, DTYPE), n=1)
        lat = G.sample_latents_from_mod(bundle.model, 1, torch.tensor(xs[1]),
                                        GivenNoise(e_cond[1:], DTYPE))
        # K > 1: the leading sample axis takes K draws of the same rule
        k_lat = bundle.model.infer_latent_from_mod(1, torch.tensor(xs[1]), K=2,
                                                   noise=torch.tensor(np.stack(e_cond)))
    _close(lat, jlat, DTYPE, "sample_latents_from_mod")
    _close(k_lat[1], jlat, DTYPE, "K=2")
    for i in range(2):
        for j in range(2):
            _close(cond[i][j], jcond[i][j], DTYPE, f"cond {i}->{j}")


@pytest.mark.parametrize("fam", list(CONFIGS))
def test_accuracies_match_jax(jax_models, monkeypatch, fam):
    """compute_accuracies on one batch (n_data 5 of 6, ns = 1): the counts
    of correct and agreeing labels equal to JAX's, float64."""
    jb = jax_models[fam][0]
    rng = np.random.default_rng(2)
    xs = _data(6, seed=4)
    labels = [rng.integers(0, 10, 6)] * 2
    jclf, pclf = _classifiers()
    bundle = _port(jax_models, fam)
    n_data = 5
    eps = _eps(rng, 3, (n_data, LATENT))
    with _jax_dtype(DTYPE, monkeypatch):
        calls = _inject(monkeypatch, eps)
        want = JC.compute_accuracies(jb.model, _jparams(jax_models, fam), jclf,
                                     [jnp.asarray(x) for x in xs], labels,
                                     jax.random.PRNGKey(0), jb.spec, n_data=n_data, ns=1)
    assert len(calls) == 3
    with torch.no_grad():
        got = C.compute_accuracies(bundle.model, pclf, [torch.tensor(x) for x in xs], labels,
                                   GivenNoise(eps, DTYPE), bundle.spec, n_data=n_data, ns=1)
    assert sorted(got) == sorted(want) == ["acc_0_1", "acc_1_0", "joint_coherence"]
    for k in want:  # JAX takes its means of labels in float32 even under x64
        assert got[k] * n_data == pytest.approx(round(want[k] * n_data), abs=1e-9), k


# ---------------------------------------------------------------------------
# likelihoods
# ---------------------------------------------------------------------------

def _cases(fam):
    """(name, JAX call, port call, the number of draws of one IS chunk)."""
    cases = [
        ("cond_likelihood_0_1",
         lambda jb, v, d, k: {"cond_likelihood_0_1": JL.compute_conditional_likelihood(
             jb.model, v, d, 0, 1, jb.spec, k, K_IS, K_IS)[1]},
         lambda b, d, n: L.compute_conditional_likelihood(b.model, d, 0, 1, b.spec, n, K_IS, K_IS),
         1),
        ("bis",
         lambda jb, v, d, k: JL.compute_conditional_likelihoods_bis(jb.model, v, d, jb.spec, k,
                                                                    K_IS, K_IS),
         lambda b, d, n: L.compute_conditional_likelihoods_bis(b.model, d, b.spec, n, K_IS, K_IS),
         4),
    ]
    if fam == "mvae":
        cases.append((
            "likelihood",
            lambda jb, v, d, k: JL.joint_likelihood_mvae(jb.model, v, d, jb.spec, k, K_IS, K_IS),
            lambda b, d, n: L.joint_likelihood_mvae(b.model, d, b.spec, n, K_IS, K_IS),
            1))
    else:
        cases.append((
            "likelihood",
            lambda jb, v, d, k: JL.joint_likelihood_mmvae(jb.model, v, d, jb.spec, k, K_IS, K_IS),
            lambda b, d, n: L.joint_likelihood_mmvae(b.model, d, b.spec, n, K_IS, K_IS),
            2))
    return cases


LL_CASES = [(fam, c[0]) for fam in CONFIGS for c in _cases(fam)]


@pytest.mark.parametrize("fam,case", LL_CASES)
def test_likelihood_estimators_match_jax(jax_models, monkeypatch, fam, case):
    """Each estimator at one IS chunk of 5 samples for 3 datapoints, float64:
    JAX's per-datapoint values (the conditional likelihood) or batch means
    to 1e-10 relative. MVAE's joint likelihood: JAX's full forward draws
    its three samples first and discards them; the port draws none of
    them. The bis protocol's proposal is the raw encoder posterior for both
    families (mvae.py:171-172)."""
    name, jcall, pcall, n_draws = next(c for c in _cases(fam) if c[0] == case)
    jb = jax_models[fam][0]
    rng = np.random.default_rng(8)
    xs = _data(B_LL, seed=9)
    eps = _eps(rng, n_draws)
    key = jax.random.PRNGKey(11)
    given, jax_draws = list(eps), list(eps)
    if fam == "mvae" and case == "likelihood":
        jax_draws = _eps(rng, 3, (B_LL, LATENT)) + eps
    bundle = _port(jax_models, fam)
    with _jax_dtype(DTYPE, monkeypatch):
        if fam == "moepoe" and case == "likelihood":  # JAX's Bernoulli draws, under x64 too
            given = [_bern_u(key, B_LL, K_IS)] + eps
        calls = _inject(monkeypatch, jax_draws)
        want = jcall(jb, _jparams(jax_models, fam), [jnp.asarray(x) for x in xs], key)
    assert len(calls) == len(jax_draws)
    with torch.no_grad():
        got = pcall(bundle, [torch.tensor(x) for x in xs], GivenNoise(given, DTYPE))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k] if np.ndim(w) else got[k].mean()
        _close(g, w, DTYPE, k)


def test_joint_likelihood_dispatch(jax_models):
    """compute_likelihoods' `likelihood`: MVAE's by joint_likelihood_mvae,
    bimodal MoE-PoE's by joint_likelihood_mmvae (the JAX CLI's dispatch);
    the bis proposal of both the raw encoder posterior."""
    mvae, moepoe = _port(jax_models, "mvae"), _port(jax_models, "moepoe")
    assert compute_likelihoods.joint_fn_for(mvae.model) is L.joint_likelihood_mvae
    assert compute_likelihoods.joint_fn_for(moepoe.model) is L.joint_likelihood_mmvae
    for b in (mvae, moepoe):
        assert L.joint_ll_from_uni_for(b.model) is L.joint_ll_from_uni_gaussian


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

VALIDATE_KEYS = ["acc_0_1", "acc_1_0", "fid_0", "fid_1", "joint_coherence"]
LL_KEYS = ["cond_likelihood_0_1", "cond_likelihood_1_0", "conditional_likelihood_bis_0_1",
           "conditional_likelihood_bis_1_0", "likelihood"]


@pytest.mark.parametrize("fam", list(CONFIGS))
def test_clis_on_cpu(tmp_path, fam):
    """One epoch of the family's synthetic config through the train CLI
    with its own analytics, then validate and compute_likelihoods --bis on
    the CPU (a pool of random classifiers, so that none trains): JAX's
    metric names, coherences in [0, 1], finite values."""
    exp = tmp_path / "exp"
    torch.manual_seed(0)
    for key, shape in (("mnist", (1, 28, 28)), ("svhn", (3, 32, 32))):
        Cl.save_classifier(Cl.ARCHS[key](in_shape=shape), str(exp / "classifiers" / f"{key}.pt"))
    with open(CONFIGS[fam]) as f:
        raw = json.load(f)
    assert raw["no_analytics"] is False
    raw.update(latent_dim=LATENT, synthetic_n=64, batch_size=16, epochs=1,
               data_path=str(tmp_path / "data"))
    cfg = tmp_path / f"{fam}.json"
    cfg.write_text(json.dumps(raw))
    run = train.main(["--config-path", str(cfg), "--experiments-dir", str(exp),
                      "--device", "cpu"])
    assert os.path.exists(os.path.join(run, "cond_samples_1x0_001.png"))
    summary = validate.main(["--run-path", run, "--experiments-dir", str(exp), "--repeats", "1",
                             "--fid-encoder", "classifier", "--batch-size", "16",
                             "--device", "cpu"])
    assert sorted(summary) == VALIDATE_KEYS
    assert all(0.0 <= summary[k]["mean"] <= 1.0 for k in ("acc_0_1", "acc_1_0",
                                                          "joint_coherence"))
    ll = compute_likelihoods.main(["--run-path", run, "--k", "6", "--batch-size-k", "3",
                                   "--repeats", "1", "--batch-size", "16", "--bis",
                                   "--device", "cpu"])
    assert sorted(ll) == LL_KEYS
    assert all(math.isfinite(v["mean"]) for v in list(ll.values()) + list(summary.values()))
    with open(os.path.join(run, "likelihoods.json")) as f:
        assert sorted(json.load(f)) == LL_KEYS
