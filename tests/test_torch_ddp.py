"""Data-parallel train steps of the port, in CPU processes over gloo,
against the JAX package's float64 step on one device.

JAX's own tests/test_multichip_parity.py holds its (4, 2)-device mesh to one
device at float64 for two steps: the flagship MMVAE-DReG (Laplace
posteriors, K=4) and JMVAE-NF past warmup on jnf_mnist_fashion, whose conv
nets have BatchNorm, at B=8 and latent 4. Here the same two steps run in
2 and 4 processes (meshes (n_data, n_k) = (2, 1) and (2, 2); ranks started
with torch.multiprocessing's spawn, meeting at a file store of their own
under a deadline: `spawn_ranks`), every rank on its
block of the batch with its rows of the noise, and their gradients, summed
over the ranks by the Trainer (`loss_and_grads`), are held to JAX's float64
gradients on the whole batch (the port's initial weights exported through
the bridge; JAX's noise injected): the loss summed over the data index at
rtol 1e-12, every leaf at rtol 1e-9 and atol 1e-12 of the largest entry of
the tree, no leaf skipped; the gradients bitwise equal on every rank; the
BatchNorm running statistics after the JMVAE-NF step equal to JAX's.
"""

import datetime
import os
import time
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

B, K, LATENT = 8, 4, 4
KINDS = ("mmvae_dreg", "jnf_postwarmup")
MESHES = ((2, 1), (2, 2))
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-12, 1e-9, 1e-12
EPOCH = 2  # past JMVAE-NF's warmup of 1, as JAX's test sets past_warmup


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def cfg_kwargs(kind):
    """tests/test_multichip_parity.py's configs; JMVAE-NF's joint forward
    not frozen, so that every leaf has JAX's full gradient."""
    if kind == "mmvae_dreg":
        return dict(model="mnist_svhn", obj="dreg", looser=True, K=K, dist="laplace",
                    recon_losses=("normal", "normal"), latent_dim=LATENT, batch_size=B,
                    warmup=0, no_nf=True, flow="maf")
    return dict(model="jnf_mnist_fashion", obj="jmvae_nf", K=1, latent_dim=LATENT,
                batch_size=B, warmup=1, no_nf=False, flow="maf",
                recon_losses=("normal", "normal"), fix_jencoder=False, fix_decoders=False)


# a collective that waits longer than this for a rank raises
RANK_TIMEOUT = datetime.timedelta(seconds=120)
# a spawn whose ranks have not all ended by then is killed and fails
SPAWN_DEADLINE_S = 180.0


def set_rank_env(rank, world):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))


def store_method(store):
    """The init_method of a rendezvous at the file `store`: no TCP port, so
    that two tests running at once cannot draw the same one."""
    return f"file://{store}"


def start_ranks(fn, args, nprocs, store_dir):
    """torch.multiprocessing's spawn of `nprocs` ranks, fn(rank, store, *args),
    `store` a new rendezvous file in `store_dir`, not joined: `join_ranks`."""
    store = os.path.join(str(store_dir), f"store_{time.monotonic_ns()}")
    return mp.spawn(fn, args=(store, *args), nprocs=nprocs, join=False)


def join_ranks(context, deadline=SPAWN_DEADLINE_S):
    """Wait for the ranks of `start_ranks`; they are killed and the test
    fails with their exit codes once `deadline` seconds pass. A rank that
    raises fails the test at once (spawn then ends the others)."""
    end = time.monotonic() + deadline
    while not context.join(timeout=max(0.0, min(5.0, end - time.monotonic()))):
        if time.monotonic() >= end:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
            for p in context.processes:
                p.join(10)
            raise AssertionError(f"{len(context.processes)} ranks still running after "
                                 f"{deadline} s; exit codes "
                                 f"{[p.exitcode for p in context.processes]}")


def spawn_ranks(fn, args, nprocs, store_dir, deadline=SPAWN_DEADLINE_S):
    """`start_ranks` and `join_ranks`."""
    join_ranks(start_ranks(fn, args, nprocs, store_dir), deadline)


def made_biases_off_zero(model, seed=5):
    """Every MADE bias moved by uniform(-0.1, 0.1): at the zero init a hidden
    unit whose inputs are all 0 sits on its ReLU's kink, where JAX's
    unrolled_solve passes half a gradient and the port none (ROADMAP.md
    section 3)."""
    from mmvae_tpu_torch.flows import MaskedDense

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedDense):
                m.bias.add_(torch.empty(m.bias.shape).uniform_(-0.1, 0.1, generator=gen)
                            .to(m.bias.dtype))


def port_model(kind):
    """The port's model of `kind` in float64 at its seed's weights, MADE
    biases off 0: (cfg, bundle)."""
    from mmvae_tpu_torch.core.config import ExperimentConfig
    from mmvae_tpu_torch.models import registry
    from mmvae_tpu_torch.nets import init_parameters

    cfg = ExperimentConfig(**cfg_kwargs(kind))
    bundle = registry.build(cfg)
    init_parameters(bundle.model, torch.Generator().manual_seed(cfg.seed))
    made_biases_off_zero(bundle.model)
    bundle.model.double()
    return cfg, bundle


def inputs(kind):
    """(xs, noise, the noise's batch axis), float64 numpy: the batch and
    standard draws, Laplace u (K, B, latent) per modality for the DReG step,
    standard normals (B, latent) for JMVAE-NF in its draw order (the joint
    forward, compute_kld's joint sample, each unimodal VAE forward)."""
    from mmvae_tpu_torch.core import distributions as D

    rng = np.random.default_rng(0)
    shapes = [(1, 28, 28), (3, 32, 32)] if kind == "mmvae_dreg" else [(1, 28, 28)] * 2
    xs = [rng.uniform(size=(B,) + s) for s in shapes]
    if kind == "mmvae_dreg":
        return xs, [rng.uniform(D.LAPLACE_U_MIN, D.LAPLACE_U_MAX, (K, B, LATENT))
                    for _ in range(2)], 1
    return xs, [rng.standard_normal((B, LATENT)) for _ in range(4)], 0


def rows_of(block, a, axis):
    """This rank's rows of `a` along its batch axis."""
    if block is None:
        return a
    return a.narrow(axis, block.start, block.stop - block.start)


def _step_worker(rank, store, world, n_data, n_k, out_dir):
    """One rank: both kinds' loss_and_grads on this rank's block, saved."""
    set_rank_env(rank, world)
    torch.set_num_threads(1)
    from mmvae_tpu_torch.parallel import make_mesh, shard_batch
    from mmvae_tpu_torch.train import Trainer

    mesh = make_mesh(n_data, n_k, device="cpu", init_method=store_method(store),
                     timeout=RANK_TIMEOUT)
    out = {}
    for kind in KINDS:
        cfg, bundle = port_model(kind)
        trainer = Trainer(bundle.model, bundle.spec, cfg, device="cpu", mesh=mesh)
        xs, noise, axis = inputs(kind)
        xs, block = shard_batch(mesh, [torch.tensor(x) for x in xs])
        noise = [rows_of(block, torch.tensor(e), axis) for e in noise]
        loss, _, grads, finite = trainer.loss_and_grads(xs, epoch=EPOCH, noise=noise, block=block)
        out[kind] = dict(loss=loss.item(), grads=grads, finite=bool(finite),
                         stats=[t.clone() for t in trainer._bn_stats], block=block.start)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """{(n_data, n_k): (the spawned ranks, their output dir)}, every mesh's
    ranks started at once, so that they run while JAX computes."""
    res = {}
    for n_data, n_k in MESHES:
        out_dir = tmp_path_factory.mktemp(f"ddp_{n_data}x{n_k}")
        world = n_data * n_k
        res[n_data, n_k] = (start_ranks(_step_worker, (world, n_data, n_k, str(out_dir)), world,
                                        out_dir), out_dir)
    return res


@pytest.fixture(scope="module")
def ranks_out(started, jax_steps):
    """{(n_data, n_k): [each rank's saved steps]}, once JAX's steps are done."""
    res = {}
    for (n_data, n_k), (context, out_dir) in started.items():
        join_ranks(context)
        res[n_data, n_k] = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
                            for r in range(n_data * n_k)]
    return res


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _inject(kind, monkeypatch, noise):
    """JAX's samplers hand out `noise` in draw order."""
    import jax
    import jax.numpy as jnp

    from mmvae_tpu.core import distributions as JD
    from mmvae_tpu.models import vae as jvae

    calls = []
    if kind == "mmvae_dreg":
        def uniform(key, shape, dtype=None, minval=0.0, maxval=1.0):
            u = noise[len(calls) % len(noise)]
            calls.append(tuple(shape))
            assert tuple(shape) == u.shape
            return jnp.asarray(u, dtype=dtype)

        monkeypatch.setattr(JD, "jax", types.SimpleNamespace(
            random=types.SimpleNamespace(uniform=uniform), nn=jax.nn))
    else:
        def sample(dist, p, key, sample_shape=()):
            e = noise[len(calls)]
            calls.append(dist)
            return p.loc + jnp.asarray(e) * p.scale

        monkeypatch.setattr(jvae.D, "sample", sample)
    return calls


@pytest.fixture(scope="module")
def jax_steps():
    """{kind: (JAX's float64 loss, its gradients by JAX path, its batch
    statistics after the step)} on the whole batch, one device, from the
    port's weights."""
    import jax
    import jax.numpy as jnp

    from mmvae_tpu.core import precision as jprec
    from mmvae_tpu.core.config import ExperimentConfig as JCfg
    from mmvae_tpu.models import registry as jreg
    from mmvae_tpu.objectives import objectives as jobj
    from mmvae_tpu.ops import ar_flow as jax_ar
    from mmvae_tpu_torch.bridge import export_jax_variables

    res = {}
    prev = jax.config.jax_enable_x64
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jax_ar, "ar_solve", jax_ar.unrolled_solve)
        jax.config.update("jax_enable_x64", True)
        try:
            for kind in KINDS:
                kw = cfg_kwargs(kind)
                jb = jreg.build(JCfg(**{k: v for k, v in kw.items()
                                        if k not in ("fix_jencoder", "fix_decoders")}))
                _, bundle = port_model(kind)
                variables = {c: t for c, t in export_jax_variables(bundle.model).items() if t}
                xs, noise, _ = inputs(kind)
                _inject(kind, mp_, noise)
                name, fn, custom = jobj.resolve(kw["obj"], True, kw.get("looser", False))
                args = dict(K=kw["K"], warmup=kw["warmup"], beta_prior=1.0, beta=1.0,
                            past_warmup=True, beta_kl=1.0, epoch=float(EPOCH), train=True)
                with jprec.use("float64"):
                    jv = jax.tree.map(jnp.asarray, variables)
                    jx = [jnp.asarray(x) for x in xs]
                    key = jax.random.PRNGKey(0)
                    if custom:
                        obj, _, state, grads = jax.jit(
                            lambda v: fn(jb.model, v, jx, key, jb.spec, **args))(jv)
                    else:
                        def loss_fn(p):
                            o, _, st = fn(jb.model, {**jv, "params": p}, jx, key, jb.spec, **args)
                            return o, st

                        (obj, state), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                            jv["params"])
                # the port's gradients are of the loss, -obj
                res[kind] = (-float(obj), {k: -g for k, g in _flat(grads)},
                             dict(_flat((state or {}).get("batch_stats", {}))))
        finally:
            jax.config.update("jax_enable_x64", prev)
    return res


def _tree(kind, tensors, export):
    """`tensors`, one per parameter (or BatchNorm statistic), as JAX's tree."""
    from mmvae_tpu_torch.nets.conv import batchnorm_stats

    _, bundle = port_model(kind)
    model = bundle.model
    slots = list(model.parameters()) if export == "params" else batchnorm_stats(model)
    with torch.no_grad():
        for p, g in zip(slots, tensors):
            p.copy_(g)
    from mmvae_tpu_torch.bridge import export_jax_variables

    return dict(_flat(export_jax_variables(model)[export]))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_data,n_k", MESHES)
def test_ddp_step_matches_jax_f64(ranks_out, jax_steps, kind, n_data, n_k):
    ranks = [r[kind] for r in ranks_out[n_data, n_k]]
    j_loss, j_grads, _ = jax_steps[kind]
    # the data index's losses: each block once (its k replicas alike)
    assert [r["block"] for r in ranks] == [(i // n_k) * (B // n_data)
                                           for i in range(n_data * n_k)]
    loss = sum(r["loss"] for r in ranks) / n_k
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
    for r in ranks:
        assert r["finite"]
        for g0, g in zip(ranks[0]["grads"], r["grads"]):
            assert torch.equal(g0, g), "the ranks' gradients differ"
    ours = _tree(kind, ranks[0]["grads"], "params")
    assert sorted(ours) == sorted(j_grads)
    scale = max(np.abs(g).max() for g in j_grads.values())
    for path, g in j_grads.items():
        assert ours[path].dtype == np.float64
        np.testing.assert_allclose(ours[path], g, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("n_data,n_k", MESHES)
def test_ddp_batchnorm_statistics_match_jax(ranks_out, jax_steps, n_data, n_k):
    """After the JMVAE-NF step every rank's running means and variances are
    those of the one-device step over the global batch."""
    _, _, j_stats = jax_steps["jnf_postwarmup"]
    assert j_stats
    for r in ranks_out[n_data, n_k]:
        stats = _tree("jnf_postwarmup", r["jnf_postwarmup"]["stats"], "batch_stats")
        assert sorted(stats) == sorted(j_stats)
        for path, v in j_stats.items():
            np.testing.assert_allclose(stats[path], v, rtol=1e-12, atol=1e-14,
                                       err_msg="/".join(path))
