"""The port's nets, MADE and MAF/IAF against the JAX modules at the same
weights (copied over with mmvae_tpu_torch.bridge), on the CPU in float32.
The two sides differ only in summation order: rtol/atol 1e-5, 1e-4 where an
exp chain amplifies round-off (flows). Also the init distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.flows import IAF as JIAF, MAF as JMAF
from mmvae_tpu.flows.made import MADE as JMADE
from mmvae_tpu.nets import encoders as jenc
from mmvae_tpu_torch.bridge import load_jax_params
from mmvae_tpu_torch.flows import IAF, MAF, MADE
from mmvae_tpu_torch.flows.made import MaskedDense
from mmvae_tpu_torch.nets import (
    Conv2d, ConvTranspose2d, DecoderSVHN, EncoderSVHN, Linear, MLPDecoder, MLPEncoder,
    init_parameters,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These sizes need no intra-op threads; under several test workers they
    only oversubscribe the cores (a CLI epoch here took 50 times as long
    beside five other workers as alone)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_init(module, x, seed=0, **kw):
    return module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kw)["params"]


def _close(ours, theirs, tol=1e-5):
    if isinstance(ours, (tuple, list)):
        for a, b in zip(ours, theirs):
            _close(a, b, tol)
        return
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=tol, atol=tol)


NETS = {
    "mlp_encoder": (lambda: jenc.MLPEncoder(latent_dim=4, hidden_dim=32),
                    lambda: MLPEncoder(latent_dim=4, in_features=784, hidden_dim=32), (3, 1, 28, 28)),
    "mlp_decoder": (lambda: jenc.MLPDecoder(latent_dim=4, output_shape=(1, 28, 28), hidden_dim=32),
                    lambda: MLPDecoder(latent_dim=4, output_shape=(1, 28, 28), hidden_dim=32), (2, 3, 4)),
    "svhn_encoder": (lambda: jenc.EncoderSVHN(latent_dim=4, f_base=8),
                     lambda: EncoderSVHN(latent_dim=4, f_base=8), (3, 3, 32, 32)),
    "svhn_decoder": (lambda: jenc.DecoderSVHN(latent_dim=4, f_base=8),
                     lambda: DecoderSVHN(latent_dim=4, f_base=8), (2, 3, 4)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_nets_match_jax(name):
    make_jax, make_port, shape = NETS[name]
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    jmod, pmod = make_jax(), make_port()
    params = _jax_init(jmod, x)
    load_jax_params(pmod, params)
    with torch.no_grad():
        ours = pmod(torch.tensor(x))
    theirs = jmod.apply({"params": params}, jnp.asarray(x))
    _close(ours, theirs)


def test_made_matches_jax():
    x = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
    jmod, pmod = JMADE(features=5, hidden_sizes=(8, 8, 8)), MADE(5, (8, 8, 8))
    params = _jax_init(jmod, x)
    load_jax_params(pmod, params)
    with torch.no_grad():
        _close(pmod(torch.tensor(x)), jmod.apply({"params": params}, jnp.asarray(x)))
    for ours, theirs in zip(pmod.masked_layer_params()[0],
                            jmod.apply({"params": params}, method=JMADE.masked_layer_params)[0]):
        _close(ours, theirs)


@pytest.mark.parametrize("flow", ["maf", "iaf"])
@pytest.mark.parametrize("s_bound", [0.0, 8.0])
def test_flows_match_jax(flow, s_bound):
    jcls, pcls = (JMAF, MAF) if flow == "maf" else (JIAF, IAF)
    kw = dict(features=5, n_made_blocks=2, n_hidden_in_made=2, hidden_size=8, s_bound=s_bound)
    x = np.random.default_rng(2).standard_normal((2, 3, 5)).astype(np.float32)
    jmod, pmod = jcls(**kw), pcls(**kw)
    params = _jax_init(jmod, x)
    load_jax_params(pmod, params)
    xt = torch.tensor(x)
    with torch.no_grad():
        for method in ("forward", "inverse"):
            ours = getattr(pmod, method)(xt)
            theirs = jmod.apply({"params": params}, jnp.asarray(x), method=method)
            _close(ours, theirs, tol=1e-4)
        # forward and inverse are each other's inverse, log-dets opposite
        z, ld_inv = pmod.inverse(xt)
        x_back, ld_fwd = pmod.forward(z)
    _close(x_back, x, tol=1e-4)
    _close(ld_fwd, -ld_inv.numpy(), tol=1e-4)


def test_unfused_flow_equals_fused():
    kw = dict(features=5, n_made_blocks=2, n_hidden_in_made=2, hidden_size=8)
    fused, plain = MAF(**kw), MAF(use_fused=False, **kw)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for a, b in zip(fused.inverse(x), plain.inverse(x)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_init_distributions():
    """kaiming-uniform bounds of conv.py and flax's truncated lecun_normal
    for MaskedDense; a seeded generator gives the same draws twice."""
    g = torch.Generator().manual_seed(0)
    lin, conv, convt = Linear(400, 300), Conv2d(16, 32, 4), ConvTranspose2d(16, 32, 4)
    md = MaskedDense(256, 512, np.ones((256, 512), np.float32))
    for m in (lin, conv, convt, md):
        m.reset_parameters(g)
    for m, fan_in in ((lin, 400), (conv, 16 * 16), (convt, 32 * 16)):
        w, b = m.weight.detach(), m.bias.detach()
        assert w.abs().max() <= np.sqrt(3.0 / fan_in) and b.abs().max() <= 1 / np.sqrt(fan_in)
        assert abs(w.std().item() - 1 / np.sqrt(fan_in)) < 0.05 / np.sqrt(fan_in)
    k = md.kernel.detach()
    std = 1 / np.sqrt(256)
    assert abs(k.std().item() - std) < 0.02 * std
    assert k.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert torch.count_nonzero(md.bias) == 0
    a, b = MLPEncoder(4, 784, 32), MLPEncoder(4, 784, 32)
    init_parameters(a, torch.Generator().manual_seed(3))
    init_parameters(b, torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


def test_normal_distribution_matches_jax():
    """std_from_logvar, the normal log-prob and the reparametrised sample
    with injected noise, float32 on both sides: rtol/atol 1e-6."""
    from mmvae_tpu.core import distributions as JD
    from mmvae_tpu_torch.core import distributions as D

    rng = np.random.default_rng(4)
    loc, log_var, x = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(3))
    eps = rng.standard_normal((2, 3, 5)).astype(np.float32)
    jp = JD.LocScale(jnp.asarray(loc), JD.std_from_logvar(jnp.asarray(log_var)))
    p = D.LocScale(torch.tensor(loc), D.std_from_logvar(torch.tensor(log_var)))
    _close(p.scale, jp.scale, 1e-6)
    _close(D.normal_log_prob(p, torch.tensor(x)), JD.log_prob("normal", jp, jnp.asarray(x)), 1e-6)
    _close(D.sample("normal", p, (2,), noise=torch.tensor(eps)), jp.loc + jnp.asarray(eps) * jp.scale,
           1e-6)
    assert D.sample("normal", p, (4,), generator=torch.Generator().manual_seed(0)).shape == (4, 3, 5)
    with pytest.raises(ValueError):
        D.sample("normal", p, (3,), noise=torch.tensor(eps))


def test_vae_matches_jax(monkeypatch):
    """UnimodalVAE with an MLP encoder/decoder and a MAF posterior flow:
    encode_and_sample at K=3 and the full forward at K=1, with the same
    injected noise, and flow_forward undoing flow_inverse. rtol/atol 1e-4
    (two MAF blocks, an exp chain each)."""
    from mmvae_tpu.models import vae as jvae
    from mmvae_tpu_torch.models.vae import UnimodalVAE

    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, 1, 28, 28)).astype(np.float32)
    eps_k = rng.standard_normal((3, 2, 4)).astype(np.float32)
    eps_1 = eps_k[0]
    flow_kw = dict(features=4, n_made_blocks=2, n_hidden_in_made=2, hidden_size=8)
    jmod = jvae.UnimodalVAE(jenc.MLPEncoder(latent_dim=4, hidden_dim=32),
                            jenc.MLPDecoder(latent_dim=4, output_shape=(1, 28, 28), hidden_dim=32),
                            latent_dim=4, flow=JMAF(**flow_kw))
    pmod = UnimodalVAE(MLPEncoder(4, 784, 32), MLPDecoder(4, (1, 28, 28), 32), 4,
                       flow=MAF(**flow_kw))
    params = jmod.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                       jnp.asarray(x))["params"]
    load_jax_params(pmod, params)
    noise = {}
    monkeypatch.setattr(jvae.D, "sample",
                        lambda dist, p, key, sample_shape=(): p.loc + noise["eps"] * p.scale)

    def japply(method, *args, **kw):
        return jmod.apply({"params": params}, *args, method=method,
                          rngs={"sample": jax.random.PRNGKey(2)}, **kw)

    noise["eps"] = jnp.asarray(eps_k)
    (jmu, jstd), jz, jldj = japply(jvae.UnimodalVAE.encode_and_sample, jnp.asarray(x), K=3)
    noise["eps"] = jnp.asarray(eps_1)
    jout = japply(jvae.UnimodalVAE.__call__, jnp.asarray(x))
    with torch.no_grad():
        (mu, std), z, ldj = pmod.encode_and_sample(torch.tensor(x), K=3, noise=torch.tensor(eps_k))
        out = pmod(torch.tensor(x), noise=torch.tensor(eps_1))
        z0_back, ld_fwd = pmod.flow_forward(out["z"])
    _close([mu, std, z, ldj], [jmu, jstd, jz, jldj], 1e-4)
    for key in ("recon", "mu", "log_var", "std", "z0", "z", "log_abs_det_jac"):
        _close(out[key], jout[key], 1e-4)
    _close([z0_back, ld_fwd], [out["z0"], -out["log_abs_det_jac"]], 1e-4)
