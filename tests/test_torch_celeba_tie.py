"""CelebA's JMVAE-NF builder at the published init, in the port against
the JAX package on the CPU: zero MADE biases put hidden units of the
`ar_solve` chain at D = 64 exactly at ReLU's kink, where the two packages
take different subgradients (ROADMAP §3). Everything else of the step
must still agree with JAX; the weights, data and noise of
test_torch_celeba_jnf.py, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu.ops import ar_flow as jax_ar
from mmvae_tpu_torch.objectives import objectives as pobj

from test_torch_celeba import ReluMaximum, _data, _models, _port_grads
from test_torch_celeba_jnf import _PAST_WARMUP, _draws
from test_torch_circles import _assert_grads_close, _flat, _jax_dtype


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_jnf_celeba_at_zero_made_biases(monkeypatch):
    """jmvae_nf.json past warmup, as in test_torch_celeba_jnf.py, at the
    published init: MADE biases 0, where hidden units of the solve whose
    masked inputs are all inactive sit exactly at ReLU's kink (ROADMAP §3).
    The value and every gradient leaf but the MADEs' hidden biases agree
    with JAX as it is (float32, 1e-5 and 1e-4 of a leaf's largest entry);
    the hidden biases agree with JAX whose unrolled_solve takes ReLU's
    subgradient at a tie as the port does (its maximum(a, 0) as
    jax.nn.relu), so they differ from JAX by its half gradient at the ties
    and no more. Ties occur here: some hidden-bias leaf differs between
    the two JAX runs."""
    jb, params, bundle = _models("jmvae_nf")
    xs = _data(seed=10, dtype="float32")
    jx = [jnp.asarray(x) for x in xs]

    def jax_value_and_grads():
        _draws(monkeypatch, "float32")
        with _jax_dtype("float32", monkeypatch):
            # op by op: the unrolled solve at D = 64 compiles for a minute
            # or more under jit (test_torch_celeba_models._compare)
            value, grads = jax.value_and_grad(lambda p: jobj.m_jmvae_nf(
                jb.model, {"params": p}, jx, jax.random.PRNGKey(3), jb.spec, train=True,
                **_PAST_WARMUP)[0])(params)
        return float(value), dict(_flat(grads))

    j_value, j_grads = jax_value_and_grads()
    with monkeypatch.context() as mp:
        mp.setattr(jax_ar, "jnp", ReluMaximum())
        _, relu_grads = jax_value_and_grads()
    model = bundle.model.to(torch.float32).train()
    obj = pobj.m_jmvae_nf(model, [torch.tensor(x) for x in xs], bundle.spec,
                          noise=_draws(monkeypatch, "float32"), **_PAST_WARMUP)[0]
    np.testing.assert_allclose(obj.item(), j_value, rtol=1e-5)
    ours = _port_grads(model, obj)
    hidden_bias = {k for k in j_grads if len(k) >= 4 and k[-4] == "flow"
                   and k[-2].startswith("hidden_") and k[-1] == "bias"}
    assert hidden_bias
    tied = [k for k in hidden_bias if not np.allclose(
        j_grads[k], relu_grads[k], rtol=0, atol=1e-4 * np.abs(relu_grads[k]).max())]
    assert tied, "no ReLU tie at zero MADE biases"
    rest = set(j_grads) - hidden_bias
    _assert_grads_close({k: ours[k] for k in rest}, {k: j_grads[k] for k in rest}, 1e-4)
    _assert_grads_close({k: ours[k] for k in hidden_bias},
                        {k: relu_grads[k] for k in hidden_bias}, 1e-4)
