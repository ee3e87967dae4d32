"""Data-parallel ranks (mmvae_tpu/parallel/mesh.py) on torch.distributed.

The JAX package lays its devices out as a ('data', 'k') mesh: 'data' shards
each batch's rows, parameters and optimizer state are replicated, and XLA
inserts the gradient all-reduces. Here every device is a process, a rank,
that `torchrun` starts, and the ranks sit row-major over (n_data, n_k), as
JAX reshapes its device list, so rank r holds data index r // n_k:

- a batch whose rows n_data divides is cut into n_data contiguous blocks,
  and data index i takes block i (JAX's P("data") sharding); a ragged one
  is replicated, every rank taking all of it (`shard_batch`);
- 'k' replicates under the train CLI, as in the JAX package; only JAX's dry
  run shards the IWAE samples over 'k', and so does the mesh that `split_k`
  returns here (the Trainer hands it to MMVAE, whose sampler and
  objectives read `k_split_of`);
- the objectives are batch sums, so the gradient of the global batch is
  the sum of the ranks' gradients over the ranks that hold distinct rows:
  the Trainer all-reduces (sums) over the world and divides by the number
  of ranks that hold each row, `holders`;
- statistics of the whole batch (BatchNorm's, the per-batch draws, the
  stratified selection of MoE-PoE) read this rank's `Block`.

Without a launcher (no WORLD_SIZE in the environment) the mesh is one
process and nothing here calls torch.distributed.
"""

from __future__ import annotations

import datetime
import os
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class Mesh:
    """This process's place in the (n_data, n_k) layout. `collective`: a
    process group was set up (the program runs under a launcher), so the
    Trainer reduces over it, at a world of 1 too. `k_group`: the k ranks of
    this rank's data index, set by `split_k`: the mesh then cuts the IWAE
    sample axis K over them (JAX's MMVAE.zss_sharding, P(None, "k",
    "data")) wherever n_k divides K (`splits`)."""

    n_data: int = 1
    n_k: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    collective: bool = False
    k_group: object = None

    @property
    def world(self) -> int:
        return self.n_data * self.n_k

    @property
    def data_index(self) -> int:
        return self.rank // self.n_k

    def block(self, rows: int) -> Optional["Block"]:
        """This rank's block of a global batch of `rows` rows, or None when
        the batch is not sharded: a single data index, or rows that n_data
        does not divide (replicated, as JAX places a ragged tail)."""
        if self.n_data == 1 or rows % self.n_data:
            return None
        size = rows // self.n_data
        start = self.data_index * size
        return Block(self, start, start + size, rows)

    def holders(self, block: Optional["Block"], K: int) -> int:
        """How many ranks' shares make up each row's objective once, for K
        IWAE samples: the k replicas of its data index when sharded, every
        rank when replicated; under the K split the k ranks hold different
        samples, so 1 when sharded and n_data when replicated."""
        k = 1 if self.splits(K) else self.n_k
        return k if block is not None else k * self.n_data

    # the K split over 'k'

    def splits(self, K: int) -> bool:
        """The K split holds: a k group, and n_k dividing K (JAX's guard)."""
        return self.k_group is not None and self.n_k > 1 and K % self.n_k == 0

    def k_samples(self, K: int) -> slice:
        """Under the K split, this rank's samples of the K: k index i holds
        [i K / n_k, (i + 1) K / n_k)."""
        size = K // self.n_k
        i = self.rank % self.n_k
        return slice(i * size, (i + 1) * size)

    def gather_k(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every k rank's `t` (this data index's), concatenated in k order
        along `dim`, differentiably: the backward sums the upstream
        gradients over the k ranks and hands each its own slice, so that a
        share computed on the gathered tensor passes its part of the
        gradient to every rank's samples. The shares and their gradients
        sum over the k ranks to the one-device objective and gradient of
        the data block."""
        return _KGather.apply(t, dim, self.k_group, self.n_k, self.rank % self.n_k)

    # collectives over the whole world; each is a no-op without a group

    def all_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the world, in place, outside autograd."""
        if self.collective:
            torch.distributed.all_reduce(t)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank, in place."""
        if self.collective:
            torch.distributed.broadcast(t, 0)
        return t

    def barrier(self) -> None:
        if self.collective:
            torch.distributed.barrier()

    def from_rank0(self, obj):
        """Rank 0's picklable `obj` on every rank."""
        if not self.collective:
            return obj
        box = [obj]
        torch.distributed.broadcast_object_list(box, 0)
        return box[0]


SINGLE = Mesh()


@dataclass(frozen=True)
class Block:
    """Rows [start, stop) of a global batch of `rows` rows, this rank's."""

    mesh: Mesh
    start: int
    stop: int
    rows: int

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the world, differentiably: the backward of the
        sum is itself the sum of the ranks' upstream gradients, which, with
        the Trainer's gradient sum divided by n_k, gives the gradient of
        the global batch (as torch.nn.SyncBatchNorm's). A world sum counts
        each data block n_k times; callers divide by a count summed alike."""
        return _WorldSum.apply(t)


class _WorldSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        torch.distributed.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        torch.distributed.all_reduce(grad)
        return grad


class _KGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, n, index):
        ctx.dim, ctx.group, ctx.n, ctx.index = dim, group, n, index
        parts = [torch.empty_like(t) for _ in range(n)]
        torch.distributed.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad.tensor_split(ctx.n, ctx.dim)[ctx.index], None, None, None, None


def split_k(mesh: Mesh) -> Mesh:
    """`mesh` cutting K over its 'k' ranks: with its k group, made with
    torch.distributed.new_group (a collective: every rank calls it, in the
    same order). `mesh` itself for one k index or no process group."""
    if not mesh.collective or mesh.n_k == 1:
        return mesh
    mine = None
    for d in range(mesh.n_data):
        group = torch.distributed.new_group(list(range(d * mesh.n_k, (d + 1) * mesh.n_k)))
        if d == mesh.data_index:
            mine = group
    return replace(mesh, k_group=mine)


def k_split_of(model, K: int) -> Optional[Mesh]:
    """The mesh that cuts `model`'s K samples over 'k' (MMVAE.k_split) where
    it splits this K, else None: the model then draws only this rank's
    K / n_k samples, and every reduction over K reads all the k ranks'
    log-weights."""
    mesh = getattr(model, "k_split", None)
    return mesh if mesh is not None and mesh.splits(K) else None


def make_mesh(n_data: Optional[int] = None, n_k: int = 1, device="cuda",
              backend: Optional[str] = None, init_method: Optional[str] = None,
              timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """The mesh of the ranks `torchrun` started (RANK, WORLD_SIZE,
    LOCAL_RANK in the environment), setting up the process group; one
    process without them. n_data None is world // n_k, as in JAX.

    On cuda every rank takes the card cuda:LOCAL_RANK and the backend is
    NCCL. Ranks that share a card (more ranks on a host than cards) must
    name backend "gloo", which then places local rank l on card
    l % device_count; NCCL refuses two ranks on one card. On the CPU the
    backend is gloo. Raises when n_data * n_k is not the world size.

    `init_method` and `timeout` go to init_process_group: the rendezvous
    (default env://, the launcher's MASTER_ADDR and MASTER_PORT; a
    file://<path> store needs no port) and how long a collective waits for
    the other ranks before it raises (default the backend's)."""
    launched = "WORLD_SIZE" in os.environ
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if n_data is None:
        n_data = world // n_k
    if n_k < 1 or n_data < 1 or n_data * n_k != world:
        raise ValueError(f"a mesh of n_data={n_data} x n_k={n_k} needs {n_data * n_k} ranks; "
                         f"the launcher started {world}")
    device = torch.device(device)
    if not launched:
        return Mesh(n_data, n_k, rank, device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("a cuda mesh but no CUDA device is available")
        backend = backend or "nccl"
        if backend == "nccl" and local >= count:
            raise RuntimeError(f"local rank {local} has no card of its own ({count} on this "
                               "host); ranks that share a card need backend='gloo'")
        device = torch.device("cuda", local % count)
        torch.cuda.set_device(device)
    elif backend not in (None, "gloo"):
        raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
    else:
        backend = "gloo"
    if not torch.distributed.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        torch.distributed.init_process_group(backend, init_method=init_method, rank=rank,
                                             world_size=world, **kw)
    return Mesh(n_data, n_k, rank, device, backend, collective=True)


def shard_batch(mesh: Mesh, xs: Sequence[torch.Tensor]):
    """(this rank's rows of every array of the global batch `xs`, its
    Block), or (`xs`, None) when the batch is replicated."""
    block = mesh.block(len(xs[0]))
    if block is None:
        return list(xs), None
    return [x[block.start:block.stop] for x in xs], block


def replicate(mesh: Mesh, module: nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, in place."""
    if mesh.collective:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                mesh.broadcast_(t.data)


def rank_seed(seed: int, data_index: int) -> int:
    """The noise seed of a data index: `seed` itself at index 0, so that one
    process draws as before, and a seed derived from both elsewhere. The k
    replicas of a data index share it, so they draw alike."""
    if data_index == 0:
        return int(seed)
    state = np.random.SeedSequence([int(seed), int(data_index)]).generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


@contextmanager
def batch_stats_over(model: nn.Module, block: Optional[Block]):
    """Within: every module of `model` with a `stats_block` attribute (the
    BatchNorm layers, nets/conv.RunningStats) takes its batch statistics
    over the global batch of which `block` is this rank's part; None keeps
    them local."""
    mods = [m for m in model.modules() if hasattr(m, "stats_block")]
    for m in mods:
        m.stats_block = block
    try:
        yield
    finally:
        for m in mods:
            m.stats_block = None

