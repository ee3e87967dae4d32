"""The K split over the mesh's 'k' axis (MMVAE.k_split; JAX's zss_sharding,
mmvae_tpu/models/mmvae.py:30,55-60, set by __graft_entry__.py's dry run),
in CPU processes over gloo, against JAX's one-device float64 step.

The model is the dry run's (`__graft_entry__._build`: MNIST-SVHN MMVAE,
Laplace posteriors, latent 4) at K = 2 n_k = 4 and B = 4, on the meshes
(n_data, n_k) = (1, 2) and (2, 2); each rank draws and scores its K / n_k
samples of its rows (the global Laplace u injected on both sides and cut by
K, then by rows), and the objectives' reductions over K gather every k
rank's log-weights. Four objectives: the dry run's m_dreg_looser, m_dreg
(the softmax over M K), and the IWAE bounds m_iwae_looser and m_iwae, whose
gradients flow back through the gather. Held: the ranks' objectives summed
against JAX's at rtol 1e-12, every gradient leaf at rtol 1e-9 and atol
1e-12 of the tree's largest entry, the same gradient bits on every rank.
Then K = 3, which n_k = 2 does not divide: the split stands aside (JAX's
guard) and 'k' replicates. The ranks are spawned while JAX computes.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_ddp import (
    RANK_TIMEOUT, _flat, _inject, join_ranks, set_rank_env, start_ranks, store_method,
)

B, LATENT = 4, 4
MESHES = ((1, 2), (2, 2))
OBJECTIVES = (("dreg", True), ("dreg", False), ("iwae", True), ("iwae", False))
GUARD_K = 3  # n_k = 2 does not divide it: no split
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-12, 1e-9, 1e-12


def cases():
    """(objective, looser, K) of every step."""
    return [(obj, looser, 4) for obj, looser in OBJECTIVES] + [("dreg", True, GUARD_K)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_model(obj, looser, K):
    """The dry run's model in the port, float64, at its seed's weights."""
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.nets import init_parameters

    cfg = ExperimentConfig(model="mnist_svhn", obj=obj, looser=looser, K=K, dist="laplace",
                           recon_losses=("normal", "normal"), latent_dim=LATENT, batch_size=B,
                           warmup=0, no_nf=True)
    bundle = registry.build(cfg)
    init_parameters(bundle.model, torch.Generator().manual_seed(cfg.seed))
    bundle.model.double()
    return cfg, bundle


def inputs(K):
    """The batch and the global Laplace u (K, B, latent) per modality."""
    from mmvae_tpu_torch.core import distributions as D

    rng = np.random.default_rng(0)
    xs = [rng.uniform(size=(B,) + s) for s in [(1, 28, 28), (3, 32, 32)]]
    return xs, [rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX, (K, B, LATENT)) for _ in range(2)]


def _rank(rank, store, n_data, n_k, out_dir):
    """One rank: every case's loss_and_grads on its rows and samples."""
    set_rank_env(rank, n_data * n_k)
    torch.set_num_threads(1)
    from mmvae_tpu_torch.parallel import make_mesh, shard_batch, split_k
    from mmvae_tpu_torch.train import Trainer

    mesh = split_k(make_mesh(n_data, n_k, device="cpu", init_method=store_method(store),
                             timeout=RANK_TIMEOUT))
    out = {}
    for obj, looser, K in cases():
        cfg, bundle = port_model(obj, looser, K)
        trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu", mesh=mesh)
        xs, noise = inputs(K)
        xs, block = shard_batch(mesh, [torch.tensor(x) for x in xs])
        ks = mesh.k_samples(K) if mesh.splits(K) else slice(None)
        rows = slice(None) if block is None else slice(block.start, block.stop)
        noise = [torch.tensor(u)[ks, rows] for u in noise]
        loss, _, grads, _ = trainer.loss_and_grads(xs, noise=noise, block=block)
        out[obj, looser, K] = dict(loss=loss.item(), grads=grads,
                                   applies=mesh.splits(K), holders=mesh.holders(block, K),
                                   handed=bundle.model.k_split is mesh)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """({mesh: [each rank's steps]}, {case: JAX's (loss, grads by path)})."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from mmvae_tpu.core import precision as jprec
    from mmvae_tpu.objectives import objectives as jobj
    from mmvae_tpu_torch.bridge import export_jax_variables

    started = {}
    for n_data, n_k in MESHES:
        out_dir = tmp_path_factory.mktemp(f"ksplit_{n_data}x{n_k}")
        started[n_data, n_k] = (start_ranks(_rank, (n_data, n_k, str(out_dir)), n_data * n_k,
                                            out_dir), out_dir)
    jax_steps = {}
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp_:
            for obj, looser, K in cases():
                _, jb = graft._build(latent_dim=LATENT, K=K)
                _, bundle = port_model(obj, looser, K)
                variables = {c: t for c, t in export_jax_variables(bundle.model).items() if t}
                xs, noise = inputs(K)
                _inject("mmvae_dreg", mp_, noise)
                _, fn, custom = jobj.resolve(obj, True, looser)
                key = jax.random.PRNGKey(0)
                with jprec.use("float64"):
                    jv = jax.tree.map(jnp.asarray, variables)
                    jx = [jnp.asarray(x) for x in xs]
                    if custom:
                        value, _, _, grads = jax.jit(
                            lambda v: fn(jb.model, v, jx, key, jb.spec, K=K, train=True))(jv)
                    else:
                        value, grads = jax.jit(jax.value_and_grad(
                            lambda p: fn(jb.model, {**jv, "params": p}, jx, key, jb.spec, K=K,
                                         train=True)[0]))(jv["params"])
                jax_steps[obj, looser, K] = (-float(value), {k: -g for k, g in _flat(grads)})
    finally:
        jax.config.update("jax_enable_x64", prev)
    ranks = {}
    for mesh, (context, out_dir) in started.items():
        join_ranks(context)
        ranks[mesh] = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                       for r in range(mesh[0] * mesh[1])]
    return ranks, jax_steps


def _tree(case, grads):
    from mmvae_tpu_torch.bridge import export_jax_variables

    _, bundle = port_model(*case)
    with torch.no_grad():
        for p, g in zip(bundle.model.parameters(), grads):
            p.copy_(g)
    return dict(_flat(export_jax_variables(bundle.model)["params"]))


@pytest.mark.parametrize("case", cases(), ids=lambda c: f"{'m_' + c[0]}{'_looser' * c[1]}_K{c[2]}")
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_k_split_step_matches_jax_f64(steps, mesh, case):
    ranks, jax_steps = steps
    per_rank = [r[case] for r in ranks[mesh]]
    n_data, n_k = mesh
    j_loss, j_grads = jax_steps[case]
    split = case[2] % n_k == 0
    assert all(r["applies"] == split and r["handed"] for r in per_rank)
    # the split: each rank a share of its rows' objective; no split: the k
    # replicas alike
    assert all(r["holders"] == (1 if split else n_k) for r in per_rank)
    loss = sum(r["loss"] for r in per_rank) / (1 if split else n_k)
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
    for r in per_rank[1:]:
        for g0, g in zip(per_rank[0]["grads"], r["grads"]):
            assert torch.equal(g0, g), "the ranks' gradients differ"
    ours = _tree(case, per_rank[0]["grads"])
    assert sorted(ours) == sorted(j_grads)
    scale = max(np.abs(g).max() for g in j_grads.values())
    for path, g in j_grads.items():
        np.testing.assert_allclose(ours[path], g, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg="/".join(path))
