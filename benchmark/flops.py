"""The work of a cell, counted once from the reference's shapes, and the
chip's peaks. Every MFU and roofline share divides this count, whatever
implements the work.

A Linear, Conv2d or ConvTranspose2d call counts 2 * multiply-adds forward;
in training the backward adds a weight gradient for every call and an
input gradient where the input needs one, so a call counts
2 * MACs * (2 + needs grad). A MADE solve counts `solve_flops`.
Elementwise work is not counted. The reference runs on the meta device
here: shapes only, no arithmetic.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from .reference import common

# Published dense peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data
# sheet), by a configuration's "precision": float32 on the CUDA cores, and
# bfloat16 on the tensor cores for a configuration run under the program's
# bfloat16 policy (this file is the yardstick, which later cells cannot edit).
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def solve_flops(n: int, widths) -> int:
    """Flops of one forward solve of n rows by a MADE of layer widths
    [D, hidden..., 2D]. Step 0 needs no product (the masks leave mu_0 and
    s_0 the head's biases); each of the other D - 1 steps takes per row a
    rank-1 term of the first layer, the other hidden layers in full and the
    two head columns it uses: 2 n (D - 1) (h_1 + sum_l h_l h_(l+1) + 2 h_L)."""
    d, hs = widths[0], list(widths[1:-1])
    return 2 * n * (d - 1) * (hs[0] + sum(a * b for a, b in zip(hs, hs[1:])) + 2 * hs[-1])


def count(run: Callable[[], object], model: nn.Module) -> Dict[str, int]:
    """Flops of `run()` over `model`'s layers: {"forward", "train",
    "solve"} ("train" = forward and backward; "solve" = the MADE solves,
    also inside "forward")."""
    counts = {"forward": 0, "train": 0, "solve": 0}

    def layer(m, inputs, out):
        x = inputs[0]
        if isinstance(m, nn.Linear):
            f = 2 * x.numel() * m.out_features
        elif isinstance(m, nn.ConvTranspose2d):  # every input element meets out * kh * kw weights
            f = 2 * x.numel() * m.weight[0].numel()
        else:
            f = 2 * out.numel() * m.weight[0].numel()
        counts["forward"] += f
        counts["train"] += f * (2 + x.requires_grad)

    def solve(m, inputs, out):
        ws, _, v = inputs
        widths = [ws[0].shape[0]] + [w.shape[1] for w in ws]
        f = solve_flops(v.numel() // v.shape[-1], widths)
        counts["solve"] += f
        counts["forward"] += f
        counts["train"] += 3 * f

    handles = []
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            handles.append(m.register_forward_hook(layer))
        elif isinstance(m, common.ARSolve):
            handles.append(m.register_forward_hook(solve))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return counts


def _meta(shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def train_step(ref, cfg: dict, batch: int, shapes) -> int:
    """Flops of one train step of `batch` pairs under the reference's loss."""
    with torch.device("meta"):
        model = ref.build(cfg)
    xs = [_meta((batch, *s)) for s in shapes]
    noise = [_meta(shape) for _, shape in ref.train_noise(cfg, batch)]
    return count(lambda: ref.train_loss(model, xs, noise, cfg), model)["train"]


def likelihood_batch(ref, cfg: dict, n: int, K: int, bk: int, shapes) -> Dict[str, int]:
    """Flops of the likelihood protocol on one test batch of n pairs at K
    samples in chunks of bk. Every term grows with the pairs and the
    chunk's terms with the chunks, so it is counted on one pair at one and
    at two chunks, and scaled."""
    with torch.device("meta"):
        model = ref.build(cfg)
    xs = [_meta((1, *s)) for s in shapes]

    def at(k):
        with torch.no_grad():
            return count(lambda: ref.likelihood(model, xs, lambda kind, shape: _meta(shape),
                                                k, bk, bk), model)

    one, two = at(bk), at(2 * bk)
    return {key: n * (one[key] + (K // bk - 1) * (two[key] - one[key]))
            for key in ("forward", "solve")}
