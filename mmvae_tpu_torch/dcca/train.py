"""DCCA Solver (mmvae_tpu/dcca/train.py; reference dcca/trainings/main_*.py
Solver): RMSprop on -corr over full batches, early stop on the val loss
(patience 10), then closed-form linear CCA on the full-train deep features,
and the artifact.

The artifact `dcca.npz` keeps the JAX package's keys m0, m1, w0, w1 and D
(the linear CCA). Where JAX stores the trunk pair as flax msgpack bytes
under `params`, the port stores one float32 array per leaf under
`params/<JAX path>` (e.g. `params/encoders_0/Linear_0/kernel`), in the JAX
layout (bridge.export_jax_params), so that no flax is needed to read it.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..bridge import _flatten, export_jax_params, load_jax_params
from ..nets import init_parameters
from ..train.optim import RMSprop
from .linear_cca import LinearCCA
from .nets import DeepCCA
from .objectives import cca_loss, cca_loss_chol, mcca_loss, mcca_loss_chol

_PARAMS = "params/"


class Solver:
    def __init__(self, encoders: Sequence, outdim_size: int, learning_rate: float = 1e-3,
                 reg_par: float = 1e-5, use_all_singular_values: bool = False,
                 backend: str = "eigh", device="cuda", dtype=torch.float32):
        """backend: "eigh", the reference's loss (the float64 CPU reference),
        or "chol", Cholesky whitening with the hand-written singular-value
        backward (the float32 form for the card)."""
        if backend not in ("eigh", "chol"):
            raise ValueError(f"backend {backend!r}: eigh or chol")
        self.device = torch.device(device)
        self.dtype = dtype
        self.model = DeepCCA(encoders).to(self.device, dtype)
        self.outdim = outdim_size
        self.use_all = use_all_singular_values
        self.backend = backend
        self.learning_rate, self.reg_par = learning_rate, reg_par
        self.history: Dict[str, list] = {"train_loss": [], "val_loss": []}

    def _loss(self, outs):
        pair = cca_loss_chol if self.backend == "chol" else cca_loss
        multi = mcca_loss_chol if self.backend == "chol" else mcca_loss
        if len(outs) == 2:
            return pair(outs[0], outs[1], self.outdim, self.use_all)
        return multi(outs, self.outdim, self.use_all)

    def _inputs(self, pipeline, rows: np.ndarray):
        xs = pipeline.gather(torch.from_numpy(rows).to(self.device))
        return [x.to(self.dtype) for x in xs]

    def fit(self, train_loader, val_loader=None, epochs: int = 20, seed: int = 0,
            log=print, early_stop: int = 10, params: Optional[Dict[str, Any]] = None):
        """Solver.fit (main_mnist_svhn.py:42-106). The weights are drawn
        from `seed`, or taken from `params`, a JAX-layout tree of DeepCCA's
        parameters. Gradient steps take full batches only (the pipeline
        drops a ragged tail: a small tail batch gives a singular covariance
        estimate); the linear CCA still sees every training example."""
        from ..data.device_pipeline import from_array_loader

        if params is None:
            init_parameters(self.model, torch.Generator().manual_seed(seed))
        else:
            load_jax_params(self.model, params)
        weights = list(self.model.parameters())
        opt = RMSprop(weights, lr=self.learning_rate, weight_decay=self.reg_par)
        pipeline = from_array_loader(train_loader, device=self.device)
        if len(pipeline) == 0:
            raise ValueError(f"DCCA train split ({pipeline.num_examples} examples) is smaller "
                             f"than one batch ({pipeline.batch_size}); lower --batch-size")

        val_pipe, val_rows = None, []
        if val_loader is not None:
            vp = from_array_loader(val_loader, shuffle=False, device=self.device)
            val_rows = list(vp.epoch_index_batches())
            if val_rows:
                val_pipe = vp
            else:
                log("DCCA: val split < one batch; no validation")

        best_val, bad, best_state = math.inf, 0, None
        for epoch in range(epochs):
            self.model.train()
            losses = []
            for rows in pipeline.epoch_index_batches():
                loss = self._loss(self.model(self._inputs(pipeline, rows)))
                # the unused log_var heads get zero gradients (and decay), as in JAX
                grads = torch.autograd.grad(loss, weights, allow_unused=True)
                opt.step([torch.zeros_like(w) if g is None else g
                          for w, g in zip(weights, grads)])
                losses.append(loss.detach())
            train_loss = float(torch.stack(losses).mean())
            self.history["train_loss"].append(train_loss)
            msg = f"DCCA epoch {epoch + 1}/{epochs} train {train_loss:.4f}"
            if val_pipe is not None:
                self.model.eval()
                with torch.no_grad():
                    vl = [self._loss(self.model(self._inputs(val_pipe, r))) for r in val_rows]
                val_loss = float(torch.stack(vl).mean())
                self.history["val_loss"].append(val_loss)
                msg += f" val {val_loss:.4f}"
                if val_loss < best_val:
                    best_val, bad = val_loss, 0
                    best_state = {k: v.clone() for k, v in self.model.state_dict().items()}
                else:
                    bad += 1
            log(msg)
            if bad >= early_stop:
                break
        # the early-stop winner, where validation ran
        if best_state is not None:
            self.model.load_state_dict(best_state)

        # linear CCA on the full-train deep features (main_mnist_svhn.py:
        # 98-100): rows in order, padded to a full last batch, trimmed to n
        n, b = pipeline.num_examples, pipeline.batch_size
        order = np.arange(-(-n // b) * b, dtype=np.int32) % n
        self.model.eval()
        with torch.no_grad():
            chunks = [self.model(self._inputs(pipeline, rows)) for rows in order.reshape(-1, b)]
        feats = [torch.cat([c[v] for c in chunks])[:n].cpu().numpy()
                 for v in range(len(chunks[0]))]
        self.lcca = LinearCCA()
        self.lcca.fit(feats[0], feats[1], self.outdim)
        return self

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        flat = _flatten(export_jax_params(self.model))
        np.savez(path, m0=self.lcca.m[0], m1=self.lcca.m[1], w0=self.lcca.w[0],
                 w1=self.lcca.w[1], D=self.lcca.D,
                 **{_PARAMS + "/".join(k): v.astype(np.float32) for k, v in flat.items()})


def load_trunk_params(path: str) -> Dict[str, Any]:
    """The DeepCCA parameter tree of an artifact, {"encoders_0": {...}, ...}
    in the JAX layout. An artifact of the JAX package holds flax msgpack
    bytes instead, which the port cannot decode: it is refused."""
    with np.load(path) as npz:
        keys = [k for k in npz.files if k.startswith(_PARAMS)]
        if not keys:
            if "params" in npz.files:
                raise ValueError(
                    f"{path} is a JAX-package DCCA artifact: its trunk parameters are flax "
                    "msgpack bytes under 'params', which mmvae_tpu_torch does not decode. "
                    "Retrain with `python -m mmvae_tpu_torch.cli.dcca_train`, or rewrite "
                    "the artifact with one array per leaf under 'params/<JAX path>'.")
            raise KeyError(f"{path} holds no trunk parameters")
        tree: Dict[str, Any] = {}
        for k in keys:
            node = tree
            *parents, leaf = k[len(_PARAMS):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = npz[k]
    return tree
