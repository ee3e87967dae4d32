"""The port's mesh layout (mmvae_tpu_torch/parallel/mesh.py) against the
JAX package's: every rank of an (n_data, n_k) mesh holds the rows that
JAX's `shard_batch` places on the matching device of the 8-device virtual
CPU mesh (ranks row-major over (n_data, n_k), as JAX reshapes its devices),
ragged batches replicated; the device pipeline's per-rank blocks; the
stratified selection of MoE-PoE and the batch means of the objectives over
the blocks of a sharded batch. No process group: the multi-process runs are
in test_torch_ddp.py and test_torch_ddp_train.py.
"""

import jax
import numpy as np
import pytest
import torch

from mmvae_tpu.parallel import make_mesh as jax_make_mesh
from mmvae_tpu.parallel import shard_batch as jax_shard_batch
from mmvae_tpu_torch.data.device_pipeline import DeviceDataPipeline
from mmvae_tpu_torch.models.poe import mixture_component_selection
from mmvae_tpu_torch.objectives.objectives import _batch_mean
from mmvae_tpu_torch.parallel import Mesh, make_mesh, rank_seed, shard_batch

MESHES = [(4, 2), (2, 1), (8, 1)]


def _jax_rows(n_data, n_k, rows):
    """{(i, j): the row ids JAX puts on the mesh's device (i, j)}."""
    mesh = jax_make_mesh(n_data=n_data, n_k=n_k, devices=jax.devices()[:n_data * n_k])
    (arr,) = jax_shard_batch(mesh, [np.arange(rows, dtype=np.int32)])
    held = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return {(i, j): held[mesh.devices[i, j]] for i in range(n_data) for j in range(n_k)}


@pytest.mark.parametrize("rows", [16, 24, 12, 10])
@pytest.mark.parametrize("n_data,n_k", MESHES)
def test_shard_batch_matches_jax(n_data, n_k, rows):
    assert len(jax.devices()) >= 8, "conftest forces an 8-device virtual CPU mesh"
    theirs = _jax_rows(n_data, n_k, rows)
    ragged = rows % n_data != 0
    for (i, j), want in theirs.items():
        mesh = Mesh(n_data, n_k, rank=i * n_k + j)
        assert mesh.data_index == i
        (ours,), block = shard_batch(mesh, [torch.arange(rows)])
        np.testing.assert_array_equal(ours.numpy(), want)
        assert (block is None) == ragged
        # no k group: 'k' replicates at any K, n_k dividing it too
        assert mesh.holders(block, K=n_k) == (n_data * n_k if ragged else n_k)
        if block is not None:
            assert (block.start, block.stop, block.rows) == (int(want[0]), int(want[-1]) + 1, rows)


def test_make_mesh_without_a_launcher(monkeypatch):
    """No WORLD_SIZE: one process, no process group, the device as given;
    a mesh larger than the world is refused, as JAX's reshape refuses it."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_mesh(None, 1, device="cpu")
    assert (mesh.n_data, mesh.n_k, mesh.rank, mesh.world, mesh.collective) == (1, 1, 0, 1, False)
    assert mesh.device == torch.device("cpu") and mesh.block(8) is None
    for n_data, n_k in ((2, 1), (1, 2), (None, 2)):
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(n_data, n_k, device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        monkeypatch.setenv("WORLD_SIZE", "1")
        make_mesh(None, 1, device="cpu", backend="nccl")


def test_rank_seeds():
    """Data index 0 keeps the config's seed (one process draws as before);
    the others differ from it and from each other."""
    seeds = [rank_seed(1, i) for i in range(8)]
    assert seeds[0] == 1 and len(set(seeds)) == 8 and all(0 <= s < 2 ** 63 for s in seeds)
    assert Mesh(4, 2, rank=5).data_index == 2


@pytest.mark.parametrize("n_data", [2, 4])
def test_device_pipeline_blocks_concatenate_to_the_permutation(n_data):
    """Every rank keeps the one-process permutation (the same seed) and
    yields its block of each step's rows: the blocks of the ranks, in rank
    order, give back the one-process row batches; the ragged tail is
    dropped on every rank alike."""
    n, bsz = 100, 16
    base = [np.random.default_rng(0).uniform(size=(n, 3)).astype(np.float32)]
    idx = [np.arange(n, dtype=np.int32)]
    one = list(DeviceDataPipeline(base, idx, bsz, device="cpu").epoch_index_batches())
    per_rank = [list(DeviceDataPipeline(base, idx, bsz, device="cpu",
                                        mesh=Mesh(n_data, 1, rank=r)).epoch_index_batches())
                for r in range(n_data)]
    assert len(one) == n // bsz and all(len(b) == len(one) for b in per_rank)
    for step, rows in enumerate(one):
        np.testing.assert_array_equal(np.concatenate([b[step] for b in per_rank]), rows)


@pytest.mark.parametrize("rows,n_comp", [(24, 3), (16, 3), (32, 5)])
def test_stratified_selection_over_blocks(rows, n_comp):
    """MoE-PoE's stratified selection on each rank's block, concatenated
    over the ranks, is the one-process selection of the global batch, the
    tail component's extra rows included."""
    rng = np.random.default_rng(1)
    mus = [torch.tensor(rng.standard_normal((rows, 3))) for _ in range(n_comp)]
    lvs = [torch.tensor(rng.standard_normal((rows, 3))) for _ in range(n_comp)]
    want = mixture_component_selection(mus, lvs)
    for n_data in (2, 4):
        parts = []
        for r in range(n_data):
            block = Mesh(n_data, 1, rank=r).block(rows)
            parts.append(mixture_component_selection(
                [m[block.start:block.stop] for m in mus], [v[block.start:block.stop] for v in lvs],
                block))
        for k in range(2):
            torch.testing.assert_close(torch.cat([p[k] for p in parts]), want[k], rtol=0, atol=0)


def test_batch_means_over_blocks():
    """A batch mean of the objectives (over axis 0, or over every element)
    on the blocks of a sharded batch sums over the ranks to the mean of
    the global batch."""
    t = torch.tensor(np.random.default_rng(2).standard_normal((12, 4, 3)))
    for dim in (0, None):
        want = torch.mean(t, dim) if dim is not None else torch.mean(t)
        for n_data in (2, 3, 4):
            blocks = [Mesh(n_data, 1, rank=r).block(12) for r in range(n_data)]
            got = sum(_batch_mean(t[b.start:b.stop], b, dim) for b in blocks)
            torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-15)
        assert torch.equal(_batch_mean(t, None, dim), want)
