"""The flows that no config of the repo selects, against the JAX package in
float64: BatchNormFlow in both directions, in train and eval mode, with
its running buffers after a train-mode pass; PlanarFlow, RadialFlow and
their stack LinearNF with their log-dets; IAF and MAF with
`include_batch_norm`, in both directions; every parameter's gradient. The
port's weights (drawn by its own initialisers, then moved off their zero
and one starts so that no term vanishes) go to JAX through the bridge.
JAX's sequential solve runs as `unrolled_solve` (use_fused=False), the
port's as its plain version on the CPU.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmvae_tpu.core import precision as jprec
from mmvae_tpu.flows import IAF as JIAF
from mmvae_tpu.flows import MAF as JMAF
from mmvae_tpu.flows import BatchNormFlow as JBN
from mmvae_tpu.flows import LinearNF as JLinearNF
from mmvae_tpu.flows import PlanarFlow as JPlanar
from mmvae_tpu.flows import RadialFlow as JRadial
from mmvae_tpu_torch.bridge import export_jax_params, export_jax_variables, load_jax_variables
from mmvae_tpu_torch.flows import IAF, MAF, BatchNormFlow, LinearNF, PlanarFlow, RadialFlow
from mmvae_tpu_torch.nets import init_parameters

D, N, HIDDEN = 4, 6, 16
# float64 on both sides: values 1e-12 relative, gradients 1e-10 of each
# leaf's largest entry (a few hundred operations, no long sums)
RTOL, GRAD_TOL = 1e-12, 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with jprec.use("float64"):
            yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _port(module, seed=0):
    """`module` in float64 with its initialisers' weights, each parameter and
    running buffer then moved by uniform(-0.2, 0.2) (the variances kept
    positive), and its JAX variables."""
    gen = torch.Generator().manual_seed(seed)
    init_parameters(module, gen)
    module.double()
    stats = [b for n, b in module.named_buffers() if n.endswith(("mean", "var"))]
    with torch.no_grad():
        for t in [*module.parameters(), *stats]:
            t.add_(torch.empty(t.shape, dtype=t.dtype).uniform_(-0.2, 0.2, generator=gen))
        for t in stats[1::2]:
            t.abs_().add_(0.5)
    return module, {c: t for c, t in export_jax_variables(module).items() if t}


def _x(seed=1, shape=(N, D)):
    return np.random.default_rng(seed).standard_normal(shape)


def _grads(module, grads):
    """The port's gradients as the JAX params tree's leaves."""
    saved = [p.detach().clone() for p in module.parameters()]
    with torch.no_grad():
        for p, g in zip(module.parameters(), grads):
            p.copy_(g)
        tree = dict(_flat(export_jax_params(module)))
        for p, s in zip(module.parameters(), saved):
            p.copy_(s)
    return tree


def _compare(module, jmodule, variables, x, call, jcall, train, jax_kwargs=None):
    """Values, the gradient of sum(y) + sum(logdet) for x and every
    parameter, and (in train mode) the running buffers afterwards."""
    jax_kwargs = jax_kwargs or {}
    with _x64():
        variables = jax.tree.map(jnp.asarray, variables)

        def f(params, xj):
            vs = {**variables, "params": params}
            mutable = ["batch_stats"] if "batch_stats" in variables and train else False
            out = jmodule.apply(vs, xj, method=jcall, mutable=mutable, **jax_kwargs)
            (y, ld), state = out if mutable else (out, {})
            return jnp.sum(y) + jnp.sum(ld), (y, ld, state)

        (_, (jy, jld, jstate)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            variables["params"], jnp.asarray(x))
    module.train(train)
    xt = torch.tensor(x, requires_grad=True)
    y, ld = call(module, xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), rtol=RTOL, atol=RTOL)
    params = list(module.parameters())
    grads = torch.autograd.grad(y.sum() + ld.sum(), [xt, *params])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), rtol=GRAD_TOL,
                               atol=GRAD_TOL * np.abs(np.asarray(jgx)).max())
    ours, theirs = _grads(module, grads[1:]), dict(_flat(jgp))
    assert sorted(ours) == sorted(theirs)
    for path, g in theirs.items():
        scale = max(np.abs(g).max(), 1e-12)
        np.testing.assert_allclose(ours[path], g, rtol=GRAD_TOL, atol=GRAD_TOL * scale,
                                   err_msg="/".join(path))
    stats = dict(_flat(export_jax_variables(module)["batch_stats"]))
    want = dict(_flat(jstate.get("batch_stats", variables.get("batch_stats", {}))))
    assert sorted(stats) == sorted(want)
    for path, v in want.items():
        np.testing.assert_allclose(stats[path], v, rtol=RTOL, atol=RTOL, err_msg="/".join(path))
    return stats


@pytest.mark.parametrize("train,inverse", [(True, False), (True, True), (False, False),
                                           (False, True)])
def test_batchnorm_flow_matches_jax(train, inverse):
    """Both directions in both modes: only the train-mode forward takes the
    batch's statistics (ddof 1) and moves the running buffers."""
    module, variables = _port(BatchNormFlow(D))
    before = [b.clone() for b in module.buffers()]
    _compare(module, JBN(features=D), variables, _x(), lambda m, x: m(x, inverse=inverse),
             None, train, dict(train=train, inverse=inverse))
    moved = [not torch.equal(a, b) for a, b in zip(before, module.buffers())]
    assert moved == [train and not inverse] * 2


@pytest.mark.parametrize("kind", ["planar", "radial", "linear_nf"])
def test_linear_flows_match_jax(kind):
    """z0 -> zK and log|det J| of each flow; LinearNF's `forward` is its
    `inverse`, the JAX package's stand-in for the density direction."""
    cls, jcls = {"planar": (PlanarFlow, JPlanar), "radial": (RadialFlow, JRadial),
                 "linear_nf": (LinearNF, JLinearNF)}[kind]
    module, variables = _port(cls(D))
    call = (lambda m, x: m(x)) if kind != "linear_nf" else (lambda m, x: m.inverse(x))
    _compare(module, jcls(features=D), variables, _x(), call, None, True)
    if kind == "linear_nf":
        assert [n for n, _ in module.named_children()] == ["planar_0", "radial_1", "planar_2"]
        z = torch.tensor(_x())
        for a, b in zip(module(z), module.inverse(z)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("flow", ["iaf", "maf"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_ar_flows_with_batchnorm_match_jax(flow, direction):
    """IAF and MAF with a BatchNormFlow after each of their 2 MADE blocks, in
    train mode: the layer order [made_0, bn_0, made_1, bn_1] with a flip
    after each layer, reversed with the flip first and the BatchNorm
    inverted; the running buffers move in the forward direction only."""
    cls, jcls = (IAF, JIAF) if flow == "iaf" else (MAF, JMAF)
    module, variables = _port(cls(D, hidden_size=HIDDEN, include_batch_norm=True))
    assert sorted(n for n, _ in module.named_buffers() if "bn" in n) == [
        "bn.0.mean", "bn.0.var", "bn.1.mean", "bn.1.var"]
    jmodule = jcls(features=D, hidden_size=HIDDEN, include_batch_norm=True, use_fused=False)
    call = (lambda m, x: m(x)) if direction == "forward" else (lambda m, x: m.inverse(x))
    _compare(module, jmodule, variables, _x(), call, direction, True, dict(train=True))


def test_bridge_round_trip_of_the_flow_leaves():
    """JAX's trees of a LinearNF and of a MAF with BatchNorm (from
    jax.eval_shape of its init) have the port's leaves, 0-d ones included,
    and JAX -> port -> JAX returns the same bits."""
    for module, jmodule, kw in (
            (LinearNF(D), JLinearNF(features=D), {}),
            (MAF(D, hidden_size=HIDDEN, include_batch_norm=True),
             JMAF(features=D, hidden_size=HIDDEN, include_batch_norm=True, use_fused=False),
             dict(train=True))):
        shapes = jax.eval_shape(lambda k: jmodule.init(k, jnp.zeros((N, D)), **kw),
                                jax.random.PRNGKey(0))
        _, variables = _port(module)
        ours = {c: {p: v.shape for p, v in _flat(t)} for c, t in variables.items() if t}
        theirs = {c: {p: v.shape for p, v in _flat(jax.tree.map(lambda a: np.zeros(a.shape), t))}
                  for c, t in shapes.items()}
        assert ours == theirs
        other = jax.tree.map(lambda a: np.asarray(a, np.float32) + 1, variables)
        load_jax_variables(module.float(), other)
        back = export_jax_variables(module)
        for c in other:
            for path, v in _flat(other[c]):
                np.testing.assert_array_equal(dict(_flat(back[c]))[path], v)
