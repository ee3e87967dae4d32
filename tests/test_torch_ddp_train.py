"""Data-parallel training of the port in CPU processes over gloo (ranks
started with torch.multiprocessing's spawn at a file store, under a
deadline: `test_torch_ddp.spawn_ranks`): the
optimizer and nan_guard across ranks, and the train CLI.

- Three Trainer steps of JMVAE-NF past warmup on jnf_mnist_fashion
  (BatchNorm, MAF flows) on a (2, 2) mesh, each data index with its own
  noise: the parameters, the AMSGrad moments and the BatchNorm statistics
  are bitwise equal on every rank; a fourth step made non-finite on one
  rank only is skipped on all four.
- The train CLI on two ranks (mesh_data 2) against one process, the noise
  of every step drawn for the global batch and cut by rows on both sides,
  through the device pipeline and through the host loader (whose ragged
  val tail is replicated): the same losses.json within float32 round-off;
  rank 0 writes the run dir, rank 1 opens no file for writing.
"""

import builtins
import json
import os

import numpy as np
import pytest
import torch

from test_torch_ddp import (
    RANK_TIMEOUT, port_model, set_rank_env, spawn_ranks, store_method,
)

CONFIG = "configs/mnist_svhn/mmvae_nf_synth.json"
LATENT = 4
# the epoch's losses of one process and of two ranks: float32 sums in
# another order, through one epoch of 15 Adam steps (1.1e-7 measured)
LOSS_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _opt_worker(rank, store, world, out_dir):
    set_rank_env(rank, world)
    torch.set_num_threads(1)
    from mmvae_tpu_torch.parallel import make_mesh, shard_batch
    from mmvae_tpu_torch.train import Trainer

    mesh = make_mesh(2, 2, device="cpu", init_method=store_method(store), timeout=RANK_TIMEOUT)
    cfg, bundle = port_model("jnf_postwarmup")
    model = bundle.model.float()
    trainer = Trainer(model, bundle.spec, cfg, device="cpu", mesh=mesh)
    trainer.init_opt_state(past_warmup=True, amsgrad=True)
    rng = np.random.default_rng(0)
    losses = []
    for step in range(4):
        xs = [torch.tensor(rng.uniform(size=(cfg.batch_size, 1, 28, 28)), dtype=torch.float32)
              for _ in range(2)]
        xs, block = shard_batch(mesh, xs)
        if step == 3:
            before = [p.detach().clone() for p in model.parameters()]
            stats_before = [t.clone() for t in trainer._bn_stats]
            if rank == 3:  # this rank's objective, and so its gradients, not finite
                objective = trainer.obj_fn

                def poisoned(*args, **kwargs):
                    obj, details = objective(*args, **kwargs)
                    return obj * float("nan"), details

                trainer.obj_fn = poisoned
        loss, details = trainer.train_step(xs, 1e-3, epoch=2, block=block)
        losses.append((loss.item(), details["nan_skipped"].item()))
    out = dict(params=[p.detach() for p in model.parameters()], mu=trainer.opt.mu,
               nu=trainer.opt.nu, nu_max=trainer.opt.nu_max, count=trainer.opt.count.item(),
               stats=trainer._bn_stats, losses=losses,
               unchanged=all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
               and all(torch.equal(a, t) for a, t in zip(stats_before, trainer._bn_stats)))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_optimizer_state_equal_on_every_rank_and_poisoned_step_skipped(tmp_path):
    spawn_ranks(_opt_worker, (4, str(tmp_path)), 4, tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]
    for r in ranks:
        assert r["count"] == 3, "three steps taken, the fourth skipped"
        assert r["unchanged"]
        assert [s for _, s in r["losses"]] == [0.0, 0.0, 0.0, 1.0]
        for key in ("params", "mu", "nu", "nu_max", "stats"):
            for a, b in zip(ranks[0][key], r[key]):
                assert torch.equal(a, b), key
    # the k replicas of a data index draw alike: the same loss on its block
    for i in (0, 2):
        assert ranks[i]["losses"][:3] == ranks[i + 1]["losses"][:3]
    assert ranks[0]["losses"][0][0] != ranks[2]["losses"][0][0]


def _write_config(tmp_path, **kw):
    with open(CONFIG) as f:
        raw = json.load(f)
    raw.update(latent_dim=LATENT, synthetic_n=64, batch_size=16, epochs=1, no_analytics=True,
               data_path=str(tmp_path / "data"), **kw)
    path = tmp_path / ("cfg" + "".join(f"_{k}_{v}" for k, v in sorted(kw.items())) + ".json")
    path.write_text(json.dumps(raw))
    return str(path)


def global_noise_steps():
    """Make the Trainer's train and eval steps draw standard normals for
    the GLOBAL batch, one (rows, latent) per modality, from generators that
    every rank seeds alike, and take this rank's rows of them: one process
    and a mesh then see the same noise."""
    from mmvae_tpu_torch.train import Trainer

    train, evaluate = Trainer.train_step, Trainer.eval_step

    def draw(self, xs, block, which):
        gens = self.__dict__.setdefault("_global_noise", {})
        gen = gens.setdefault(which, torch.Generator().manual_seed(7 + which))
        rows = len(xs[0]) if block is None else block.rows
        noise = [torch.randn((rows, LATENT), generator=gen) for _ in xs]
        return noise if block is None else [e[block.start:block.stop] for e in noise]

    def train_step(self, xs, lr, beta_kl=1.0, epoch=1, noise=None, block=None):
        return train(self, xs, lr, beta_kl, epoch, noise=draw(self, xs, block, 0), block=block)

    def eval_step(self, xs, beta_kl=1.0, epoch=1, noise=None, generator=None, block=None):
        return evaluate(self, xs, beta_kl, epoch, noise=draw(self, xs, block, 1), block=block)

    Trainer.train_step, Trainer.eval_step = train_step, eval_step


def _cli_worker(rank, store, world, configs, exp_dirs, out_dir):
    set_rank_env(rank, world)
    torch.set_num_threads(1)
    # the CLI's make_mesh takes this group and leaves it to the caller
    torch.distributed.init_process_group("gloo", init_method=store_method(store), rank=rank,
                                         world_size=world, timeout=RANK_TIMEOUT)
    global_noise_steps()
    from mmvae_tpu_torch.cli import train

    writes = []
    if rank == 1:
        opened, saved = builtins.open, torch.save

        def open_(file, mode="r", *args, **kwargs):
            if any(c in mode for c in "wax+"):
                writes.append(str(file))
            return opened(file, mode, *args, **kwargs)

        builtins.open = open_
        torch.save = lambda obj, f, *a, **k: writes.append(str(f))
    runs = [train.main(["--config-path", c, "--experiments-dir", e, "--device", "cpu"])
            for c, e in zip(configs, exp_dirs)]
    if rank == 1:
        builtins.open, torch.save = opened, saved
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"runs": runs, "writes": writes}, f)
    torch.distributed.destroy_process_group()


def test_cli_two_ranks_match_one_process(tmp_path, monkeypatch):
    from mmvae_tpu_torch.cli import train
    from mmvae_tpu_torch.train import Trainer

    variants = [{}, {"device_pipeline": False}]
    one = []
    monkeypatch.setattr(Trainer, "train_step", Trainer.train_step)
    monkeypatch.setattr(Trainer, "eval_step", Trainer.eval_step)
    global_noise_steps()
    for i, kw in enumerate(variants):
        one.append(train.main(["--config-path", _write_config(tmp_path, **kw),
                               "--experiments-dir", str(tmp_path / f"one{i}"),
                               "--device", "cpu"]))
    configs = [_write_config(tmp_path, mesh_data=2, **kw) for kw in variants]
    exp_dirs = [str(tmp_path / f"two{i}") for i in range(len(variants))]
    spawn_ranks(_cli_worker, (2, configs, exp_dirs, str(tmp_path)), 2, tmp_path)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0]["runs"] == ranks[1]["runs"] and ranks[1]["writes"] == []
    for run_one, run_two, exp in zip(one, ranks[0]["runs"], exp_dirs):
        files = sorted(os.listdir(run_two))
        assert files == sorted(os.listdir(run_one)), (files, sorted(os.listdir(run_one)))
        assert {"args.json", "losses.json", "metrics.jsonl", "model.pt"} <= set(files)
        runs_made = [d for d, _, fs in os.walk(exp) if "args.json" in fs]
        assert runs_made == [run_two]
        with open(os.path.join(run_two, "metrics.jsonl")) as f:
            assert len(f.readlines()) == 1
        losses = [json.loads(open(os.path.join(r, "losses.json")).read())
                  for r in (run_one, run_two)]
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(losses[1][key], losses[0][key], rtol=LOSS_RTOL)
