"""The port's FID InceptionV3 (mmvae_tpu_torch/eval/fid.py) against the JAX
package's (mmvae_tpu/eval/fid.py), as tests/test_fid_parity.py holds JAX's
to pytorch-fid's layout: torch's default conv init with randomised
BatchNorm statistics (the default statistics would hide a layout fault), a
small input (75 px: every block, pool and padding still runs), float32,
rtol 1e-3 and atol 1e-4. The weights travel as a pytorch-fid checkpoint
written by the port (its `fc.*` head and `num_batches_tracked` included)
through JAX's `load_torch_inception_weights`, and back through
`bridge.inception_from_jax`. Then the strict loading, the hash check, the
preprocessing, flax's init in distribution and the batched activations
(`validate` with its default encoder: tests/test_torch_eval_cli.py).
"""

import hashlib

import numpy as np
import pytest
import torch

from mmvae_tpu_torch.eval import fid as F

PX = 75
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _randomize_bn(model, gen):
    """tests/test_fid_parity.py's draws: mean U(-0.1, 0.1), var U(0.5, 1.5),
    scale U(0.5, 1.5), bias U(-0.1, 0.1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, F.FrozenBatchNorm):
                n = m.weight.numel()
                m.running_mean.copy_(torch.rand(n, generator=gen) * 0.2 - 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.rand(n, generator=gen) * 0.2 - 0.1)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(the port's net, its pytorch-fid checkpoint, JAX's variables loaded
    from that file by JAX's loader)."""
    import jax
    import jax.numpy as jnp

    from mmvae_tpu.eval.fid import InceptionV3FID, load_torch_inception_weights

    with torch.random.fork_rng():
        torch.manual_seed(0)
        net = F.InceptionV3FID().eval()
    _randomize_bn(net, torch.Generator().manual_seed(0))
    sd = dict(net.state_dict())
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), torch.zeros(1008)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    path = tmp_path_factory.mktemp("fid") / "inception_port.pth"
    torch.save(sd, str(path))
    shapes = jax.eval_shape(InceptionV3FID().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, PX, PX)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables = load_torch_inception_weights(zeros, str(path))
    return net, path, variables


def test_inception_matches_jax(nets):
    """The same weights give JAX's activations, and JAX's tree carried back
    through the bridge is the port's state dict bit for bit."""
    import jax.numpy as jnp

    from mmvae_tpu.eval.fid import InceptionV3FID
    from mmvae_tpu_torch.bridge import inception_from_jax

    net, _, variables = nets
    x = np.random.default_rng(0).uniform(size=(2, 3, PX, PX)).astype(np.float32)
    want = np.asarray(InceptionV3FID().apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert np.abs(want).max() > 1e-2  # not a vanishing net: the check has teeth
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    back = inception_from_jax(variables)
    own = net.state_dict()
    assert sorted(back) == sorted(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k


def test_load_fid_weights_is_strict(nets, tmp_path):
    """The port reads its own checkpoint (fc.* and num_batches_tracked
    ignored), and refuses a file with a key the net has not, or without
    one it has."""
    net, path, _ = nets
    fresh = F.load_fid_weights(F.InceptionV3FID(), str(path))
    for k, v in net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    sd = torch.load(str(path), weights_only=False)
    extra = dict(sd, **{"Mixed_9z.bogus.weight": torch.zeros(3)})
    torch.save(extra, str(tmp_path / "extra.pth"))
    with pytest.raises(ValueError, match="unconsumed keys \\['Mixed_9z.bogus.weight'\\]"):
        F.load_fid_weights(F.InceptionV3FID(), str(tmp_path / "extra.pth"))
    short = {k: v for k, v in sd.items() if k != "Mixed_7c.branch_pool.bn.running_var"}
    torch.save(short, str(tmp_path / "short.pth"))
    with pytest.raises(ValueError, match="missing keys \\['Mixed_7c.branch_pool.bn.running_var'"):
        F.load_fid_weights(F.InceptionV3FID(), str(tmp_path / "short.pth"))


def test_verify_fid_weights_hash(tmp_path):
    """The sha256 prefix in a `-<hex>.pth` name must match; other names
    pass with their digest (tests/test_fid_parity.py's cases)."""
    data = b"fake weights bytes"
    digest = hashlib.sha256(data).hexdigest()
    good = tmp_path / f"pt_inception-2015-12-05-{digest[:8]}.pth"
    good.write_bytes(data)
    assert F.verify_fid_weights(str(good)) == digest
    bad = tmp_path / "pt_inception-2015-12-05-deadbeef.pth"
    bad.write_bytes(data)
    with pytest.raises(ValueError, match="hash mismatch"):
        F.verify_fid_weights(str(bad))
    anon = tmp_path / "custom_encoder.pth"
    anon.write_bytes(data)
    assert F.verify_fid_weights(str(anon)) == digest
    assert F.FID_WEIGHTS_NAME == "pt_inception-2015-12-05-6726825d.pth"


@pytest.mark.parametrize("channels", [1, 3])
def test_fid_preprocess_matches_jax(channels):
    """The 299 resize and the zero channels of a 1-channel input against
    JAX's fid_preprocess (jax.image.resize, held to F.interpolate by
    tests/test_fid_parity.py at rtol 1e-4 and atol 1e-5)."""
    import jax.numpy as jnp

    from mmvae_tpu.eval.fid import fid_preprocess

    x = np.random.default_rng(1).uniform(size=(2, channels, 28, 28)).astype(np.float32)
    want = np.asarray(fid_preprocess(jnp.asarray(x)))
    got = F.fid_preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 299, 299)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if channels == 1:
        assert np.all(got[:, 1:] == 0)


def test_init_follows_flax_lecun_normal():
    """flax's lecun_normal on JAX's (O, I, kh, kw) kernels: fan-in kh*O*I
    (in_axis -2, out_axis -1), a normal truncated at 2 std; the port's
    draws and flax's have the same std per layer within sampling error,
    and BatchNorm starts at scale 1, bias 0, mean 0, var 1."""
    import jax
    from flax import linen as nn

    net = F.init_inception(F.InceptionV3FID(), torch.Generator().manual_seed(0))
    convs = {"Conv2d_4a_3x3": net.Conv2d_4a_3x3, "Mixed_6b.branch7x7_2": net.Mixed_6b.branch7x7_2,
             "Mixed_7c.branch1x1": net.Mixed_7c.branch1x1}
    for name, mod in convs.items():
        w = mod.conv.weight.detach().double()
        o, i, kh, kw = w.shape
        ref = nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (o, i, kh, kw))
        ref = np.asarray(ref, np.float64)
        want_std = np.sqrt(1.0 / (kh * o * i))
        assert float(w.std()) == pytest.approx(want_std, rel=0.03), name
        assert float(ref.std()) == pytest.approx(want_std, rel=0.03), name
        assert float(w.abs().max()) <= 2 * want_std / F._TRUNC_STD * (1 + 1e-6), name
    for m in net.modules():
        if isinstance(m, F.FrozenBatchNorm):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
            assert torch.all(m.running_mean == 0) and torch.all(m.running_var == 1)


def test_make_inception_fn_batches_on_cpu(nets):
    """Activations come back (N, 2048) float32 and do not depend on how the
    images are cut into batches; a 1-channel input is padded with zero
    channels; the weights file goes through the hash check and the strict
    load, and gives its net's activations; without it the net is the
    seeded random init."""
    net, path, _ = nets
    x = torch.rand(3, 1, 20, 20, generator=torch.Generator().manual_seed(3))
    loaded = F.make_inception_fn(str(path), device="cpu", batch=2)
    got = loaded(x.numpy())
    with torch.no_grad():
        want = net(F.fid_preprocess(x)).numpy()
    assert got.shape == (3, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    fn = F.make_inception_fn(device="cpu")
    ref = F.init_inception(F.InceptionV3FID(), torch.Generator().manual_seed(F.FID_INIT_SEED))
    for k, v in ref.state_dict().items():
        assert torch.equal(fn.model.state_dict()[k], v), k
    one = fn(x[:1])
    assert one.shape == (1, 2048) and np.isfinite(one).all()
