"""Device-resident input pipeline (mmvae_tpu/data/device_pipeline.py).

The deduplicated base modality arrays live on the device once, as uint8
when they are 8-bit data, beside the int32 pairing tables. Each step takes
a batch of pair-row ids: rows come out through the table with
`index_select` and are decoded to float in [0, 1]. (The JAX package uses a
one-hot matmul for the row gather, a TPU workaround; on the GPU a gather is
the plain choice and gives identical values.)

Float arrays with values <= 1 are stored as round(x*255) uint8 and decoded
as u8 * (1/255), exactly as the JAX pipeline does, so both packages feed
the model the same inputs.

Under a mesh of several ranks (parallel/mesh.py) every rank keeps the whole
data and the same permutation (the same seed), and each step yields this
rank's contiguous block of the batch's row ids, which it gathers alone: the
JAX pipeline's row batches sharded with P(None, "data").
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..utils import trace


class DeviceDataPipeline:
    """Holds base modality arrays + pairing index tables on a device and
    yields per-step index batches."""

    def __init__(self, base_arrays: Sequence[np.ndarray],
                 pair_indices: Sequence[np.ndarray],
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 store_uint8: bool = True, device="cuda", mesh=None):
        if len(base_arrays) != len(pair_indices):
            raise ValueError("one pairing table per modality")
        self.device = torch.device(device)
        self.n_mod = len(base_arrays)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.n_pairs = len(pair_indices[0])
        self.mesh = mesh

        self.device_arrays = []
        self.is_uint8 = []
        for arr in base_arrays:
            if store_uint8 and arr.dtype == np.float32 and arr.max() <= 1.0:
                arr = (arr * 255).round().astype(np.uint8)
            self.is_uint8.append(arr.dtype == np.uint8)
            self.device_arrays.append(torch.from_numpy(np.ascontiguousarray(arr)).to(self.device))
        self.pair_indices = [torch.from_numpy(i.astype(np.int32)).to(self.device)
                             for i in pair_indices]

    def __len__(self):
        return self.n_pairs // self.batch_size

    @property
    def num_examples(self):
        return self.n_pairs

    def epoch_index_batches(self):
        """Host-side: per-step arrays of pair-row ids (int32), the ragged
        tail dropped; under a mesh, this rank's block of each."""
        order = (self._rng.permutation(self.n_pairs) if self.shuffle
                 else np.arange(self.n_pairs)).astype(np.int32)
        stop = self.n_pairs - self.n_pairs % self.batch_size
        block = None if self.mesh is None else self.mesh.block(self.batch_size)
        for s in range(0, stop, self.batch_size):
            rows = order[s: s + self.batch_size]
            yield rows if block is None else rows[block.start:block.stop]

    def gather(self, pair_rows: torch.Tensor) -> List[torch.Tensor]:
        """pair_rows (B,) int on the device -> [x_m (B, *event) float32]."""
        out = []
        with trace.span("pipeline.gather"):
            for arr, table, u8 in zip(self.device_arrays, self.pair_indices, self.is_uint8):
                rows = table.index_select(0, pair_rows)
                x = arr.index_select(0, rows).to(torch.float32)
                out.append(x * (1.0 / 255.0) if u8 else x)
        return out


def from_array_loader(loader, shuffle=None, device="cuda", mesh=None) -> DeviceDataPipeline:
    """Wrap an ArrayLoader's dataset: LazyGather modalities ship their
    deduplicated base array and the real pairing table, materialized ones an
    identity table. `mesh`: as DeviceDataPipeline's."""
    from .loaders import LazyGather

    ds = loader.dataset
    n = len(ds)
    arrays, idx = [], []
    for m in ds.modalities:
        if isinstance(m, LazyGather):
            arrays.append(m.base)
            idx.append(m.idx.astype(np.int32))
        else:
            arrays.append(np.asarray(m))
            idx.append(np.arange(n, dtype=np.int32))
    return DeviceDataPipeline(
        arrays, idx, loader.batch_size,
        shuffle=loader.shuffle if shuffle is None else shuffle, device=device, mesh=mesh)
