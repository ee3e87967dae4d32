"""The small-data augmentation pipeline through the port's CLIs on the CPU,
at a tiny size (synthetic_n=64, len_train 100, batch 16, latent 4): stage 1
on `configs/ms_small/jnf_synth.json` publishes the joint-encoder pool,
`generate_joint` fits its Gaussian mixture on the train latents and writes
24 generated pairs, stage 2 on `jnf_gen_synth.json` appends them
(`use_gen`, `len_gen` 24), `validate --prd` scores stage 2, `plot_results`
draws its three figures, and a `use_pretrain` resume continues stage 2.
Then the likelihoods of `configs/mnist_svhn/hard/jnfd_hard_bern.json`, whose
MNIST side is Bernoulli, against JAX's.

The classifier pool holds randomly initialised classifiers, so that none
trains here. Follows the JAX package's tests/test_cli.py (use_gen pipeline,
generate_joint, validate --prd, plot_results).
"""

import contextlib
import io
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core.config import ExperimentConfig as JCfg
from mmvae_tpu.eval import generation as JG
from mmvae_tpu.eval import likelihoods as JL
from mmvae_tpu.models import registry as jreg
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.bridge import export_jax_params, load_jax_params
from mmvae_tpu_torch.cli import generate_joint, plot_results, train, validate
from mmvae_tpu_torch.cli.common import reload_model
from mmvae_tpu_torch.core.config import ExperimentConfig
from mmvae_tpu_torch.eval import classifiers as Cl
from mmvae_tpu_torch.eval import likelihoods as L
from mmvae_tpu_torch.models import registry
from mmvae_tpu_torch.train import Trainer
from test_torch_eval import GivenNoise, _inject, _jax_dtype
from test_torch_jmvae_nf import _fake_artifact

STAGE1 = "configs/ms_small/jnf_synth.json"
STAGE2 = "configs/ms_small/jnf_gen_synth.json"
BERN = "configs/mnist_svhn/hard/jnfd_hard_bern.json"
TINY = dict(latent_dim=4, synthetic_n=64, batch_size=16, len_train=100)
LEN_GEN = 24


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(tmp, path, **kw):
    with open(path) as f:
        raw = json.load(f)
    # an empty data dir inside tmp: the synthetic stand-in, nothing read outside
    raw.update(TINY, data_path=str(tmp / "data"), **kw)
    out = tmp / f"{len(os.listdir(tmp))}_{os.path.basename(path)}"
    out.write_text(json.dumps(raw))
    return str(out)


def _run(fn, argv):
    """fn(argv) with its standard output kept: (result, output)."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = fn(argv)
    return out, log.getvalue()


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """Stage 1 (epochs 2, warmup 2: one warmup epoch, one after),
    generate_joint --n 24, stage 2 (one epoch) and validate --prd on it,
    with their outputs."""
    tmp = tmp_path_factory.mktemp("gen_cli")
    exp = str(tmp / "exp")
    torch.manual_seed(0)
    for key, shape in (("mnist", (1, 28, 28)), ("svhn", (3, 32, 32))):
        Cl.save_classifier(Cl.ARCHS[key](in_shape=shape), os.path.join(exp, "classifiers",
                                                                       f"{key}.pt"))
    common = ["--experiments-dir", exp, "--device", "cpu"]
    run1, out1 = _run(train.main, ["--config-path", _config(tmp, STAGE1, epochs=2, warmup=2),
                                   *common])
    joint_acc, out_gen = _run(generate_joint.main, ["--run-path", run1, "--n", str(LEN_GEN),
                                                    *common])
    run2, out2 = _run(train.main, ["--config-path", _config(tmp, STAGE2, epochs=1, warmup=1,
                                                             len_gen=LEN_GEN), *common])
    summary, _ = _run(validate.main, ["--run-path", run2, "--repeats", "1", "--fid-encoder",
                                      "classifier", "--prd", "--batch-size", "500", *common])
    return dict(tmp=tmp, exp=exp, common=common, run1=run1, run2=run2, out1=out1,
                out_gen=out_gen, out2=out2, joint_acc=joint_acc, summary=summary)


def _png_ok(path):
    """(width, height) of a PNG whose chunks' CRCs hold and whose image data
    inflates to its rows."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos: pos + 4])
        kind, data = blob[pos + 4: pos + 8], blob[pos + 8: pos + 8 + n]
        assert struct.unpack(">I", blob[pos + 8 + n: pos + 12 + n])[0] == zlib.crc32(kind + data)
        chunks[kind] = chunks.get(kind, b"") + data
        pos += 12 + n
    w, h, _, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + w * (1 if color == 0 else 3))
    return w, h


def _state(run):
    return torch.load(os.path.join(run, "model.pt"), weights_only=True)


def test_use_gen_pipeline(pipeline):
    """Stage 2 appends the 24 generated pairs to the 90 train pairs of the
    len_train subset (100 less the 10-pair val split), with label 0, and
    leaves the joint encoder and the decoders bit-unchanged: stage 2's
    checkpoint holds stage 1's, as the pool does."""
    assert "Train: 90," in pipeline["out1"]
    assert f"use_gen: appended {LEN_GEN} generated pairs" in pipeline["out2"]
    assert f"Train: {90 + LEN_GEN}," in pipeline["out2"]
    assert "Loaded joint encoder/decoders" in pipeline["out2"]
    s1, s2 = _state(pipeline["run1"]), _state(pipeline["run2"])
    pool = os.path.join(pipeline["exp"], "joint_encoders", "mnist_svhn_small_synth")
    frozen = [n for n in s1 if n.startswith("joint_encoder.") or ".decoder." in n]
    assert len(frozen) > 10
    for n in frozen:
        assert torch.equal(s1[n], s2[n]), n
    joint = torch.load(os.path.join(pool, "model_joint_encoder.pt"), weights_only=True)
    for n, t in joint.items():
        assert torch.equal(t, s2["joint_encoder." + n]), n
    moved = [n for n in s1 if n.startswith("vaes.") and ".decoder." not in n
             and not torch.equal(s1[n], s2[n])]
    assert moved  # the unimodal encoders and flows trained
    with open(os.path.join(pipeline["run2"], "args.json")) as f:
        args = json.load(f)
    assert args["use_gen"] is True and args["len_gen"] == LEN_GEN


def test_generate_joint_writes_the_pool(pipeline):
    """generated_modality_{i}.npy in the run and the pool, the same arrays,
    one row per requested sample, decodes in [0, 1]; a joint coherence in
    [0, 1]; the mixture fitted on every train latent the loader yields."""
    pool = os.path.join(pipeline["exp"], "joint_encoders", "mnist_svhn_small_synth")
    for i, shape in enumerate([(1, 28, 28), (3, 32, 32)]):
        a = np.load(os.path.join(pipeline["run1"], f"generated_modality_{i}.npy"))
        b = np.load(os.path.join(pool, f"generated_modality_{i}.npy"))
        assert a.shape == (LEN_GEN,) + shape and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        assert 0.0 <= a.min() and a.max() <= 1.0
    assert 0.0 <= pipeline["joint_acc"] <= 1.0
    # the reload clamps the batch to the 10-pair val split: 9 batches of 10
    # cover the 90 train pairs (at batch 16 the shuffled loader would drop 10)
    assert "GMM fitted on 90 train latents" in pipeline["out_gen"]
    assert "joint coherence of GMM samples" in pipeline["out_gen"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("config", ["configs/ms_small/jnf_synth.json",
                                    "configs/mnist_svhn/mmvae_synth.json"])
def test_generate_joint_latents_match_jax(pipeline, monkeypatch, config, dtype):
    """The latent rule per family against JAX's `_infer` on the same
    weights: the joint encoder's mean (JMVAE-NF, stage 1's run), or the
    first modality's posterior mean from encode_all (MMVAE, random
    weights). Float32, the CLI's dtype: rtol 1e-6 with atol 1e-6 (the two
    frameworks sum the joint encoder's 3,856 inputs in other orders; 6e-7
    apart at most on latents of 0.5); float64: rtol 1e-12."""
    if "jnf" in config:
        cfg, bundle, loaders = reload_model(pipeline["run1"], device="cpu")
        xs, _ = next(iter(loaders[0]))
    else:
        cfg = ExperimentConfig.from_json(config)
        cfg.latent_dim = 4
        bundle = registry.build(cfg)
        Trainer(bundle.model, bundle.spec, cfg, device="cpu").init_parameters()
        rng = np.random.default_rng(0)
        xs = [rng.uniform(size=(5, 1, 28, 28)), rng.uniform(size=(5, 3, 32, 32))]
    tdtype = getattr(torch, dtype)
    bundle.model.to(tdtype)
    jcfg = JCfg.from_json(config)
    jcfg.latent_dim = 4
    jb = jreg.build(jcfg)
    with _jax_dtype(dtype, monkeypatch):
        v = {"params": jax.tree.map(lambda a: jnp.asarray(a, dtype),
                                    export_jax_params(bundle.model))}
        jx = [jnp.asarray(np.asarray(x, dtype)) for x in xs]
        if "jnf" in config:
            want = jb.model.apply(v, jx, method="encode_joint")[0]
        else:
            want = jb.model.apply(v, jx, method="encode_all")[0][0]
        want = np.asarray(want)
    got = generate_joint.latent_fn(bundle.model, torch.device("cpu"), tdtype)(xs)
    assert got.dtype == tdtype and tuple(got.shape) == (len(xs[0]), 4)
    assert want.dtype == np.dtype(dtype)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_validate_prd(pipeline):
    """validate --prd: prd_f8_j and prd_f1_8_j beside the FIDs, in [0, 1];
    the curves of repeat 0 as prd_curve_j.npz (1001 angles) and as PNGs
    with their figure JSON."""
    summary, run = pipeline["summary"], pipeline["run2"]
    assert sorted(summary) == ["acc_0_1", "acc_1_0", "fid_0", "fid_1", "joint_coherence",
                               "prd_f1_8_0", "prd_f1_8_1", "prd_f8_0", "prd_f8_1"]
    for k in ("prd_f1_8_0", "prd_f1_8_1", "prd_f8_0", "prd_f8_1"):
        assert 0.0 <= summary[k]["mean"] <= 1.0, k
    with open(os.path.join(run, "metrics.json")) as f:
        assert json.load(f) == summary
    for d in ("0", "1"):
        curve = np.load(os.path.join(run, f"prd_curve_{d}.npz"))
        assert curve["precision"].shape == curve["recall"].shape == (1001,)
        assert _png_ok(os.path.join(run, f"prd_curve_{d}.png")) == (480, 360)
        with open(os.path.join(run, f"prd_curve_{d}.png.json")) as f:
            fig = json.load(f)
        assert fig["xlim"] == fig["ylim"] == [0.0, 1.0] and len(fig["legend"]) == 1
        assert fig["legend"][0].startswith("F8=")
        np.testing.assert_array_equal(fig["series"][0]["y"], curve["precision"])


@pytest.mark.parametrize("mode", [["--prd-curves", "--direction", "1"],
                                  ["--metric", "acc_0_1"], ["--losses"]])
def test_plot_results_modes(pipeline, tmp_path, mode):
    """Each mode over both runs of the pipeline (stage 1 has no PRD curve,
    so --prd-curves draws stage 2's twice): a valid PNG and its JSON with
    one legend entry per series."""
    runs = [pipeline["run2"], pipeline["run2"]] if mode[0] == "--prd-curves" else \
        [pipeline["run1"], pipeline["run2"]]
    if mode[0] == "--metric":
        with open(os.path.join(pipeline["run1"], "metrics.json"), "w") as f:
            json.dump({"acc_0_1": {"mean": 0.25, "std": 0.05}}, f)
    out = str(tmp_path / "figure.png")
    assert plot_results.main(["--runs", *runs, "--labels", "a", "b", "--out", out, *mode]) == out
    assert _png_ok(out) == (480, 360)
    with open(out + ".json") as f:
        fig = json.load(f)
    if mode[0] == "--losses":
        assert fig["legend"] == ["a train", "a val", "b train", "b val"]
        assert [s["dashed"] for s in fig["series"]] == [False, True, False, True]
    elif mode[0] == "--metric":
        assert fig["legend"] == ["acc_0_1"] and fig["xticklabels"] == ["a", "b"]
        assert fig["series"][0]["y"][0] == 0.25 and fig["series"][0]["yerr"][0] == 0.05
    else:
        assert fig["legend"] == ["a", "b"] and fig["xlim"] == [0.0, 1.0]
    with pytest.raises(SystemExit):
        plot_results.main(["--runs", *runs, "--labels", "a", "--out", out])


def test_use_pretrain_resume(pipeline, monkeypatch):
    """use_pretrain: the resumed run adopts stage 2's args.json with epochs
    1 + 1 and warmup 1 + 1, reloads stage 2's checkpoint (the parameters at
    the start of its first epoch are stage 2's last) and trains epoch 2."""
    starts = []
    init_opt_state = Trainer.init_opt_state

    def probe(self, *args, **kwargs):
        if not starts:
            starts.append({n: t.detach().clone() for n, t in self.model.state_dict().items()})
        return init_opt_state(self, *args, **kwargs)

    monkeypatch.setattr(Trainer, "init_opt_state", probe)
    cfg = _config(pipeline["tmp"], STAGE2, epochs=1, warmup=1, len_gen=LEN_GEN,
                  use_pretrain=pipeline["run2"], freq_analytics=3)
    run3, out = _run(train.main, ["--config-path", cfg, *pipeline["common"]])
    with open(os.path.join(run3, "args.json")) as f:
        args = json.load(f)
    assert (args["epochs"], args["warmup"], args["freq_analytics"]) == (2, 2, 3)
    assert args["use_pretrain"] == pipeline["run2"]
    assert f"Loading model from {pipeline['run2']}" in out and "use_gen: appended" in out
    s2 = _state(pipeline["run2"])
    assert sorted(starts[0]) == sorted(s2)
    for n, t in s2.items():
        assert torch.equal(starts[0][n], t), n
    with open(os.path.join(run3, "losses.json")) as f:
        assert len(json.load(f)["train_loss"]) == 1
    assert "Epoch 002" in out and "Epoch 001" not in out


# ---------------------------------------------------------------------------
# the Bernoulli config's likelihoods
# ---------------------------------------------------------------------------

K_IS, B_LL = 5, 3


def test_bern_config_likelihoods_match_jax(tmp_path, monkeypatch):
    """jnfd_hard_bern.json (JMVAE-NF-DCCA, recon_losses bernoulli and
    normal; a fake linear-CCA artifact, latent 4, dim_dcca 3): both
    conditional likelihoods and the joint likelihood at one IS chunk of 5
    samples for 3 datapoints, float64, against JAX's: rtol 1e-10."""
    path = str(tmp_path / "dcca.npz")
    _fake_artifact(path)
    jcfg, cfg = JCfg.from_json(BERN), ExperimentConfig.from_json(BERN)
    for c in (jcfg, cfg):
        c.latent_dim, c.dim_dcca = 4, 3
        c.extra["dcca_path"] = path
    jb = jreg.build(jcfg)
    assert jb.spec.recon_dists[0] == "bernoulli"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)  # init needs shapes only
        xs0 = [jnp.zeros((2, 1, 28, 28)), jnp.zeros((2, 3, 32, 32))]
        params = jax.jit(lambda k, x: jb.model.init({"params": k, "sample": k}, x, K=1,
                                                    method="init_all")["params"])(
            jax.random.PRNGKey(0), xs0)
    params = jax.tree.map(np.asarray, params)
    bundle = registry.build(cfg)
    assert bundle.spec.recon_dists[0] == "bernoulli"
    bundle.model.to(torch.float64).eval()
    load_jax_params(bundle.model, params)

    rng = np.random.default_rng(22)
    xs = [rng.uniform(size=(B_LL, 1, 28, 28)), rng.uniform(size=(B_LL, 3, 32, 32))]
    eps = rng.standard_normal((K_IS, 4))
    monkeypatch.setattr(JG, "_JIT_CACHE", {})
    cases = [(f"cond_likelihood_{c}_{g}",
              lambda v, d, k, c=c, g=g: JL.compute_conditional_likelihood(
                  jb.model, v, d, c, g, jb.spec, k, K_IS, K_IS)[1],
              lambda d, n, c=c, g=g: L.compute_conditional_likelihood(
                  bundle.model, d, c, g, bundle.spec, n, K_IS, K_IS)[f"cond_likelihood_{c}_{g}"])
             for c, g in ((0, 1), (1, 0))]
    cases.append(("likelihood",
                  lambda v, d, k: JL.joint_likelihood_jmvae_nf(jb.model, v, d, jb.spec, k, K_IS,
                                                               K_IS)["likelihood"],
                  lambda d, n: L.joint_likelihood_jmvae_nf(bundle.model, d, bundle.spec, n, K_IS,
                                                           K_IS)["likelihood"]))
    for name, jcall, pcall in cases:
        with _jax_dtype("float64", monkeypatch):
            _inject(monkeypatch, [eps])
            v = {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)}
            want = np.asarray(jcall(v, [jnp.asarray(x) for x in xs], jax.random.PRNGKey(3)))
        with torch.no_grad():
            got = pcall([torch.tensor(x) for x in xs], GivenNoise([eps], "float64"))
        got = got.numpy() if want.ndim else float(got.mean())
        assert np.all(np.isfinite(want)), name
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0, err_msg=name)
