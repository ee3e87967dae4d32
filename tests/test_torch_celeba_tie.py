"""CelebA's JMVAE-NF builder at the published init, in the port against
the JAX package on the CPU: zero MADE biases put hidden units of the
`ar_solve` chain at D = 64 exactly at ReLU's kink, where both packages take
JAX's subgradient, one half (jnp.maximum in JAX's unrolled_solve, the
port's `hidden_relu`). The value and every gradient leaf agree with JAX
as it is; the weights, data and noise of test_torch_celeba_jnf.py, float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.objectives import objectives as jobj
from mmvae_tpu_torch.flows import autoregressive
from mmvae_tpu_torch.objectives import objectives as pobj
from mmvae_tpu_torch.ops import ar_flow

from test_torch_celeba import _data, _models, _port_grads
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
    masked inputs are all inactive sit exactly at ReLU's kink. The value and
    every gradient leaf, the MADEs' hidden biases included, agree with JAX
    as it is (float32, 1e-5 and 1e-4 of a leaf's largest entry). Ties that
    carry gradient occur here: the port's plain tape (`plain_tape`) of the
    solves the step runs holds exact zeros past step 0 (at step 0 every
    unit is tied and no head column reads one), and with the port's hidden
    ReLU taken as torch.relu (slope 0 at a tie) a hidden bias's gradient
    misses JAX's."""
    jb, params, bundle = _models("jmvae_nf")
    xs = _data(seed=10, dtype="float32")
    jx = [jnp.asarray(x) for x in xs]

    _draws(monkeypatch, "float32")
    with _jax_dtype("float32", monkeypatch):
        # op by op: the unrolled solve at D = 64 compiles for a minute or
        # more under jit (test_torch_celeba_models._compare)
        j_value, j_grads = jax.value_and_grad(lambda p: jobj.m_jmvae_nf(
            jb.model, {"params": p}, jx, jax.random.PRNGKey(3), jb.spec, train=True,
            **_PAST_WARMUP)[0])(params)
    j_grads = dict(_flat(j_grads))

    solves = []

    def recorded(x, ws, bs, sign, s_bound):
        solves.append([t.detach().reshape(-1, t.shape[-1]) if i == 0 else
                       [a.detach() for a in t] for i, t in enumerate((x, ws, bs))]
                      + [sign, s_bound])
        return ar_flow.ar_solve(x, ws, bs, sign, s_bound)

    monkeypatch.setattr(autoregressive, "ar_solve", recorded)
    model = bundle.model.to(torch.float32).train()
    obj = pobj.m_jmvae_nf(model, [torch.tensor(x) for x in xs], bundle.spec,
                          noise=_draws(monkeypatch, "float32"), **_PAST_WARMUP)[0]
    assert solves
    tied = []
    for x, ws, bs, sign, s_bound in solves:
        assert all(not b.any() for b in bs)
        _, _, tape = ar_flow.plain_tape(x, ws, bs, sign, s_bound)
        tied.append([int((z[1:] == 0).sum()) for z in tape.z])
    assert sum(map(sum, tied)) > 0, tied
    np.testing.assert_allclose(obj.item(), float(j_value), rtol=1e-5)
    hidden_bias = {k for k in j_grads if len(k) >= 4 and k[-4] == "flow"
                   and k[-2].startswith("hidden_") and k[-1] == "bias"}
    assert hidden_bias
    _assert_grads_close(_port_grads(model, obj), j_grads, 1e-4)

    monkeypatch.setattr(ar_flow, "hidden_relu", torch.relu)
    obj = pobj.m_jmvae_nf(model, [torch.tensor(x) for x in xs], bundle.spec,
                          noise=_draws(monkeypatch, "float32"), **_PAST_WARMUP)[0]
    relu = _port_grads(model, obj)
    assert any(not np.allclose(relu[k], j_grads[k], rtol=0,
                               atol=1e-4 * np.abs(j_grads[k]).max()) for k in hidden_bias)
