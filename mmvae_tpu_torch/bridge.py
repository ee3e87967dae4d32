"""Weight conversion between a JAX parameter tree and the port's modules.

A JAX tree is the `params` collection of the JAX package: nested dicts of
numpy arrays, e.g. params["vaes_0"]["encoder"]["Linear_0"]["kernel"]. The
port's module paths map onto it one to one: "vaes.0.flow.made.1.hidden.2"
is "vaes_0/flow/made_1/hidden_2". The layouts:

- Linear: JAX kernel (in, out) is the transpose of torch's weight (out, in).
- Conv2d: both OIHW.
- ConvTranspose2d: both (in, out, kh, kw); torch's conv_transpose2d takes
  the array unflipped where JAX flips it inside its dilated convolution.
- MaskedDense: the port keeps JAX's (in, out) kernel.
- Biases are the same vectors.
- BatchNorm: `scale` and `bias` in params, the running `mean` and `var`
  (buffers here) in the `batch_stats` collection; the port's BatchNorm2d
  sits one scope above them, as JAX wraps a flax BatchNorm named "bn".
- The flows' own layers keep JAX's leaf names: BatchNormFlow's
  `log_gamma` and `beta` (its `mean` and `var` in `batch_stats`),
  PlanarFlow's `w`, `u` and 0-d `b`, RadialFlow's `z0` and 0-d `log_alpha`
  and `beta`.

Copies are exact, so JAX -> port -> JAX returns the same bits.

`gmm_from_numpy` carries a Gaussian mixture fitted on the JAX side across
as the port's latent sampler.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .flows import BatchNormFlow, PlanarFlow, RadialFlow
from .flows.made import MaskedDense
from .nets.conv import Conv2d, ConvTranspose2d, Linear, RunningStats, _BatchNorm


def _jax_path(module_path: str) -> Tuple[str, ...]:
    if not module_path:  # the root module's own leaves sit at the top of the tree
        return ()
    return tuple(re.sub(r"\.(\d+)(?=\.|$)", r"_\1", module_path).split("."))


def _leaves(model: nn.Module) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor, bool]]:
    """(JAX path, torch parameter, transposed?) for every parameter."""
    for path, m in model.named_modules():
        if isinstance(m, (Linear, Conv2d, ConvTranspose2d)):
            yield _jax_path(path) + ("kernel",), m.weight, isinstance(m, Linear)
            if m.bias is not None:
                yield _jax_path(path) + ("bias",), m.bias, False
        elif isinstance(m, MaskedDense):
            yield _jax_path(path) + ("kernel",), m.kernel, False
            yield _jax_path(path) + ("bias",), m.bias, False
        elif isinstance(m, _BatchNorm):
            yield _jax_path(path) + m.jax_scope + ("scale",), m.scale, False
            yield _jax_path(path) + m.jax_scope + ("bias",), m.bias, False
        elif isinstance(m, (BatchNormFlow, PlanarFlow, RadialFlow)):
            for name, p in m.named_parameters(recurse=False):
                yield _jax_path(path) + (name,), p, False
        elif list(m.parameters(recurse=False)):
            raise TypeError(f"no JAX layout known for {type(m).__name__} at {path!r}")


def _stat_leaves(model: nn.Module) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor, bool]]:
    """(JAX batch_stats path, torch buffer, False) for every running statistic."""
    for path, m in model.named_modules():
        if isinstance(m, RunningStats):
            yield _jax_path(path) + m.jax_scope + ("mean",), m.mean, False
            yield _jax_path(path) + m.jax_scope + ("var",), m.var, False


def _flatten(tree: Dict[str, Any], prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@torch.no_grad()
def _load(leaves, tree: Dict[str, Any]) -> None:
    flat = _flatten(tree)
    seen = set()
    for path, p, transposed in leaves:
        if path not in flat:
            raise KeyError(f"JAX tree has no {'/'.join(path)}")
        arr = flat[path].T if transposed else flat[path]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: JAX {arr.shape} vs port {tuple(p.shape)}")
        p.copy_(torch.tensor(np.asarray(arr, dtype=np.float32)))
        seen.add(path)
    extra = set(flat) - seen
    if extra:
        raise KeyError(f"JAX leaves with no port parameter: {sorted('/'.join(e) for e in extra)}")


def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> None:
    """Copy a JAX params tree into `model` in place (any device)."""
    _load(_leaves(model), params)


def load_jax_variables(model: nn.Module, variables: Dict[str, Any]) -> None:
    """Copy JAX variables, `params` and (where the model has BatchNorm)
    `batch_stats`, into `model` in place: the eval classifiers' trees."""
    _load(_leaves(model), variables["params"])
    _load(_stat_leaves(model), variables.get("batch_stats", {}))


def _export(leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, p, transposed in leaves:
        arr = p.detach().cpu().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(arr.T if transposed else arr, order="C", copy=True)
    return tree


def export_jax_params(model: nn.Module) -> Dict[str, Any]:
    """The JAX params tree of `model`, as nested dicts of numpy arrays that
    own their memory (later updates of the model do not show through)."""
    return _export(_leaves(model))


def export_jax_variables(model: nn.Module) -> Dict[str, Any]:
    """`params` and `batch_stats` of `model` as JAX trees."""
    return {"params": export_jax_params(model), "batch_stats": _export(_stat_leaves(model))}


def gmm_from_numpy(weights, means, covariances, device=None):
    """A mixture fitted on the JAX side (scikit-learn's GaussianMixture, as
    `mmvae_tpu.eval.gmm.GaussianMixtureSampler.gmm` holds it: `weights_`,
    `means_`, `covariances_`) as the port's `GaussianMixtureSampler`, in
    float64 on `device`."""
    from .eval.gmm import GaussianMixtureSampler

    return GaussianMixtureSampler.from_params(weights, means, covariances, device=device)


def inception_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX's InceptionV3FID variables ({"params", "batch_stats"}, numpy or
    jax arrays) as the state dict of the port's `eval.fid.InceptionV3FID`,
    pytorch-fid's key names: each BasicConv2d's OIHW `kernel` is
    `<path>.conv.weight` (the same layout), its `bn` scale, bias, mean and
    var `<path>.bn.weight`, `.bn.bias`, `.bn.running_mean`,
    `.bn.running_var`."""
    stats = _flatten(variables["batch_stats"])
    out = {}
    for path, arr in _flatten(variables["params"]).items():
        head = ".".join(path[:-1])
        if path[-1] == "kernel":
            out[f"{head}.conv.weight"] = torch.from_numpy(np.array(arr))
        elif path[-2:] == ("bn", "scale"):
            out[f"{head}.weight"] = torch.from_numpy(np.array(arr))
            out[f"{head}.running_mean"] = torch.from_numpy(np.array(stats[path[:-1] + ("mean",)]))
            out[f"{head}.running_var"] = torch.from_numpy(np.array(stats[path[:-1] + ("var",)]))
        elif path[-2:] == ("bn", "bias"):
            out[f"{head}.bias"] = torch.from_numpy(np.array(arr))
        else:
            raise ValueError(f"not a leaf of JAX's InceptionV3FID: {'/'.join(path)}")
    return out
