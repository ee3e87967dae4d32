"""Training driver (mmvae_tpu/train/loop.py; reference main.py:147-277):
AMSGrad + ReduceLROnPlateau, warmup phases with optimizer reset and
parameter freezing, early stopping with warmup shortening, best-val
checkpointing.

The JAX package dispatches epochs in lax.scan chunks of `steps_per_dispatch`
steps; chunking computes the same math, so the port accepts the key and runs
step by step. Per-step noise comes from a `torch.Generator` on the training
device seeded from `cfg.seed`; validation re-seeds its own generator every
epoch, so the val loss of fixed parameters is the same each epoch, as in the
JAX package (one fixed val key).

Both steps run under the config's precision policy (core/precision.py:
"compute_dtype", "activation_dtype"); parameters and optimizer state stay
float32.

Under a mesh of several ranks (parallel/mesh.py) each rank steps on its
block of every batch, or on all of a batch whose rows the data axis does
not divide. The ranks' gradients are summed over the world in one flat
all-reduce a step and divided by the number of ranks that hold each row,
which gives the gradient of the global batch, since the objectives are
batch sums; the nan_guard flag is reduced with them, so that every rank
skips the same steps. BatchNorm takes the global batch's statistics. The
loss and details sums of an epoch are summed over the ranks before the
host reads them, so the schedule, the early stop and the best checkpoint
are the same on every rank. Each data index draws its noise from its own
generator (`parallel.rank_seed`), its k replicas alike; rank 0 alone
writes checkpoints.
"""

from __future__ import annotations

import math
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..core import precision
from ..core.config import ExperimentConfig
from ..nets.conv import batchnorm_stats, init_parameters
from ..objectives import objectives as obj_mod
from ..parallel import mesh as mesh_lib
from ..utils import trace
from . import checkpoints, freezing
from .optim import Adam
from .schedule import BetaKlSchedule, ReduceLROnPlateau

_VAL_SEED_OFFSET = 0x7FFFFFFF


class Trainer:
    def __init__(self, model, spec, cfg: ExperimentConfig, run_path: Optional[str] = None,
                 multimodal: bool = True, log_fn: Callable[[str], None] = print,
                 device="cuda", experiments_dir: Optional[str] = None,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.mesh = mesh if mesh is not None else mesh_lib.SINGLE
        self.device = torch.device(device)
        self.model = model.to(self.device)
        if self.mesh.k_group is not None:  # a mesh from split_k: MMVAE cuts K over 'k'
            if not hasattr(model, "k_split"):
                raise ValueError(f"the K split over 'k' is MMVAE's; {type(model).__name__} "
                                 "replicates K")
            model.k_split = self.mesh
        self.spec = spec
        self.cfg = cfg
        self.run_path = run_path
        self.experiments_dir = experiments_dir
        self.log = log_fn
        self.obj_name, self.obj_fn = obj_mod.resolve(cfg.obj, multimodal, cfg.looser)
        self.guard = bool(cfg.nan_guard)
        # BatchNorm running statistics, which a train step updates in place
        self._bn_stats = batchnorm_stats(self.model)
        self.compute_dtype = precision.parse(cfg.extra.get("compute_dtype"))
        self.activation_dtype = precision.parse(cfg.extra.get("activation_dtype"))
        self.gen = torch.Generator(device=self.device).manual_seed(
            mesh_lib.rank_seed(cfg.seed, self.mesh.data_index))
        self.opt: Optional[Adam] = None
        self._history: Dict[str, List[float]] = {}

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def init_parameters(self, seed: Optional[int] = None) -> None:
        """Draw every parameter from a CPU generator seeded with `seed`
        (default cfg.seed): the same weights on any device."""
        seed = self.cfg.seed if seed is None else seed
        init_parameters(self.model, torch.Generator().manual_seed(seed))

    def init_opt_state(self, past_warmup: bool = False, amsgrad: bool = True) -> None:
        frozen = freezing.frozen_prefixes_for_phase(
            self.obj_name, past_warmup, self.cfg.fix_jencoder, self.cfg.fix_decoders)
        params = freezing.trainable_parameters(self.model, frozen)
        self._trainable = set(params)
        self.opt = Adam(params.values(), amsgrad=amsgrad,
                        clip_grad_norm=float(self.cfg.clip_grad_norm or 0.0))

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _obj_kwargs(self, beta_kl: float, epoch: int):
        cfg = self.cfg
        return dict(K=cfg.K, warmup=cfg.warmup, beta_prior=cfg.beta_prior, beta=cfg.beta,
                    beta_kl=beta_kl, epoch=epoch, past_warmup=epoch >= cfg.warmup,
                    # lets m_jmvae_nf run the fully frozen joint forward
                    # without a gradient past warmup
                    frozen_joint=bool(cfg.fix_jencoder and cfg.fix_decoders))

    def _policy(self):
        return precision.use(self.compute_dtype, self.activation_dtype)

    def train_step(self, xs, lr: float, beta_kl: float = 1.0, epoch: int = 1, noise=None,
                   block: Optional[mesh_lib.Block] = None):
        """One optimizer step on batch `xs`. Returns (loss, details) as
        device tensors; details["nan_skipped"] is 1 when nan_guard skipped
        the step. `noise`: the sampler's noise per modality, or None to
        draw it from the trainer's generator. `block`: xs is this rank's
        block of a batch sharded over the mesh (None: all of the batch).
        Under a mesh the loss and details are this rank's."""
        with trace.span("trainer.step"):
            named = list(self.model.named_parameters())
            bn_before = []
            if self.guard:
                with trace.span("trainer.guard"):
                    bn_before = [t.clone() for t in self._bn_stats]
            loss, details, grads, finite = self.loss_and_grads(xs, beta_kl, epoch, noise, block)
            if self.guard:
                with trace.span("trainer.guard"):
                    details = {**details, "nan_skipped": 1.0 - finite.to(torch.float32)}
                    # nor the BatchNorm statistics, as the JAX Trainer keeps its batch_stats
                    with torch.no_grad():
                        for t, old in zip(self._bn_stats, bn_before):
                            t.copy_(torch.where(finite, t, old))
            self.opt.step([g for (n, _), g in zip(named, grads) if n in self._trainable], lr,
                          finite)
            return loss, details

    def loss_and_grads(self, xs, beta_kl: float = 1.0, epoch: int = 1, noise=None,
                       block: Optional[mesh_lib.Block] = None):
        """The train step's objective and gradients, in training mode, with
        no update: (loss, details, a gradient per named parameter, 0 for
        one the loss does not reach, and nan_guard's finite flag or None).
        Under a mesh the gradients are the global batch's, the same on
        every rank, and so is the flag; the loss and details are this
        rank's."""
        self.model.train()
        params = list(self.model.parameters())
        with self._policy(), mesh_lib.batch_stats_over(self.model, block):
            with trace.span("trainer.forward"):
                obj, details = self.obj_fn(self.model, xs, self.spec, noise=noise,
                                           generator=self.gen, block=block,
                                           **self._obj_kwargs(beta_kl, epoch))
                loss = -obj
            with trace.span("trainer.backward"):
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        finite = None
        if self.guard:
            with trace.span("trainer.guard"):
                # a non-finite step (MAF exp overflow, ...) must not reach the
                # params or the moments; all grads count, frozen ones included
                finite = torch.isfinite(loss.detach())
                for g in grads:
                    finite = finite & torch.isfinite(g).all()
        if self.mesh.collective:
            grads, finite = self._reduce_grads(grads, finite, block)
        return loss.detach(), details, grads, finite

    def _reduce_grads(self, grads, finite, block):
        """The gradient of the global batch on every rank: `grads` summed
        over the world in one flat all-reduce, divided by the ranks that
        hold each row. A nan_guard flag rides along as a count of the
        ranks whose step was not finite, so that all skip it or none."""
        flat = [g.reshape(-1) for g in grads]
        if finite is not None:
            flat.append((~finite).to(flat[0].dtype).reshape(1))
        flat = self.mesh.all_sum_(torch.cat(flat))
        if finite is not None:
            finite, flat = flat[-1] == 0, flat[:-1]
        flat = flat / self.mesh.holders(block, self.cfg.K)
        return [g.view_as(p) for g, p in zip(flat.split([g.numel() for g in grads]), grads)], \
            finite

    @torch.no_grad()
    def eval_step(self, xs, beta_kl: float = 1.0, epoch: int = 1, noise=None, generator=None,
                  block: Optional[mesh_lib.Block] = None):
        """The objective's value only: no gradient is recorded, so the DReG
        objectives return their surrogate's value and register no hook.
        `block`: as train_step's."""
        self.model.eval()
        with self._policy():
            obj, details = self.obj_fn(self.model, xs, self.spec, noise=noise,
                                       generator=generator, block=block,
                                       **self._obj_kwargs(beta_kl, epoch))
        return -obj, details

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def _run(self, batches: Iterable, n_norm: int, step) -> Tuple[float, Dict[str, float]]:
        """Sum loss and details over `batches`, (xs, block) pairs, on the
        device; one host read at the end, after one all-reduce under a
        mesh, each rank's sums weighted by 1 / the ranks that hold its rows.
        Returns (total / n_norm, {k: sum / n_norm})."""
        total, acc = None, {}
        for xs, block in batches:
            loss, details = step(xs, block)
            if self.mesh.collective:
                w = 1.0 / self.mesh.holders(block, self.cfg.K)
                loss, details = loss * w, {k: v * w for k, v in details.items()}
            total = loss if total is None else total + loss
            for k, v in details.items():
                acc[k] = v if k not in acc else acc[k] + v
        if total is None:
            return 0.0, {}
        if self.mesh.collective:
            sums = self.mesh.all_sum_(torch.stack(
                [torch.as_tensor(v, device=self.device).to(torch.float64)
                 for v in (total, *acc.values())]))
            total, acc = sums[0], dict(zip(acc, sums[1:]))
        return float(total) / n_norm, {k: float(v) / n_norm for k, v in acc.items()}

    def _host_batches(self, loader):
        for xs, _ in loader:
            xs, block = mesh_lib.shard_batch(self.mesh, xs)
            yield [torch.as_tensor(x).to(self.device, torch.float32) for x in xs], block

    def _device_batches(self, pipeline):
        block = self.mesh.block(pipeline.batch_size)
        for rows in pipeline.epoch_index_batches():
            yield pipeline.gather(torch.from_numpy(rows).to(self.device)), block

    def run_epoch_device(self, pipeline, lr, beta_kl, epoch: int = 1):
        """Train epoch over a device pipeline; normalized by all pairs, as
        the JAX package does."""
        return self._run(self._device_batches(pipeline), pipeline.num_examples,
                         lambda xs, block: self.train_step(xs, lr, beta_kl, epoch, block=block))

    def _val_generator(self):
        return torch.Generator(device=self.device).manual_seed(
            mesh_lib.rank_seed(self.cfg.seed + _VAL_SEED_OFFSET, self.mesh.data_index))

    def run_epoch_device_eval(self, pipeline, beta_kl, epoch: int = 1):
        """Val epoch over a device pipeline; the ragged tail batch is dropped
        and the loss normalized by the rows scored."""
        gen = self._val_generator()
        n = len(pipeline) * pipeline.batch_size
        return self._run(self._device_batches(pipeline), n,
                         lambda xs, block: self.eval_step(xs, beta_kl, epoch, generator=gen,
                                                          block=block))

    def run_epoch(self, loader, lr, beta_kl, train: bool = True, epoch: int = 1):
        """Epoch over a host ArrayLoader, normalized by its examples."""
        if train:
            def step(xs, block):
                return self.train_step(xs, lr, beta_kl, epoch, block=block)
        else:
            gen = self._val_generator()

            def step(xs, block):
                return self.eval_step(xs, beta_kl, epoch, generator=gen, block=block)
        return self._run(self._host_batches(loader), loader.num_examples, step)

    def make_device_pipeline(self, loader):
        """The loader's data on the device; under a mesh each step yields
        this rank's block of the batch, which n_data must divide (as the
        JAX Trainer asserts)."""
        from ..data.device_pipeline import from_array_loader

        if loader.batch_size % self.mesh.n_data:
            raise ValueError(f"batch_size {loader.batch_size} must divide the mesh's data axis "
                             f"({self.mesh.n_data}) for the device pipeline")
        return from_array_loader(loader, device=self.device, mesh=self.mesh)

    def fit(self, train_loader, val_loader, callbacks: Optional[List[Callable]] = None,
            min_epoch: int = 1, variables_hook: Optional[Callable[[torch.nn.Module], None]] = None,
            use_device_pipeline: bool = True):
        """Full training run (main.py:234-277). Returns the last epoch + 1.
        variables_hook, if given, changes the freshly initialized model in
        place (e.g. grafting pretrained DCCA trunks)."""
        cfg = self.cfg
        self.init_parameters()
        # what rank 0 wrote before (a use_pretrain run, the joint pool) is
        # complete before any rank reads it
        self.mesh.barrier()
        if variables_hook is not None:
            variables_hook(self.model)
        if cfg.skip_warmup and self.run_path is not None:
            pool = self._joint_pool_path()
            try:
                checkpoints.load_joint_vae(self.model, pool)
                min_epoch = cfg.warmup
                self.log(f"Loaded joint encoder/decoders from {pool}")
            except FileNotFoundError:
                self.log(f"skip_warmup: no pool at {pool}; training from scratch")
        mesh_lib.replicate(self.mesh, self.model)
        self.init_opt_state(past_warmup=min_epoch >= cfg.warmup, amsgrad=True)

        plateau = ReduceLROnPlateau(lr=cfg.learning_rate)
        beta_sched = BetaKlSchedule(cfg.beta_kl, cfg.decrease_beta_kl, cfg.warmup)
        best_loss = math.inf
        bad_epochs = 0
        warmup = cfg.warmup
        hist = defaultdict(list)
        pipeline = self.make_device_pipeline(train_loader) if use_device_pipeline else None
        val_pipeline = None
        if use_device_pipeline and val_loader.num_examples >= val_loader.batch_size:
            val_pipeline = self.make_device_pipeline(val_loader)

        epoch = min_epoch
        while epoch <= cfg.epochs:
            if epoch == warmup and cfg.fix_jencoder and epoch != min_epoch:
                # optimizer reset at warmup end (main.py:241-245)
                self.log(f"====> Epoch {epoch}: optimizer reset (post-warmup)")
                self.init_opt_state(past_warmup=True, amsgrad=False)
                plateau.reset(cfg.learning_rate)
                best_loss = math.inf

            t0 = time.time()
            if pipeline is not None:
                tr_loss, tr_details = self.run_epoch_device(pipeline, plateau.lr,
                                                            beta_sched.value, epoch)
            else:
                tr_loss, tr_details = self.run_epoch(train_loader, plateau.lr,
                                                     beta_sched.value, True, epoch)
            beta_sched.step(epoch)
            if val_pipeline is not None:
                va_loss, va_details = self.run_epoch_device_eval(val_pipeline,
                                                                 beta_sched.value, epoch)
            else:
                va_loss, va_details = self.run_epoch(val_loader, plateau.lr,
                                                     beta_sched.value, False, epoch)
            hist["train_loss"].append(tr_loss)
            hist["test_loss"].append(va_loss)
            self.log(f"====> Epoch {epoch:03d} train {tr_loss:.4f} val {va_loss:.4f} "
                     f"({time.time() - t0:.1f}s, lr {plateau.lr:g})")
            skipped = tr_details.get("nan_skipped", 0.0)
            if skipped > 0:
                self.log(f"====> Epoch {epoch:03d} WARNING: nan_guard skipped "
                         f"{skipped:.1%} of train steps")
            for cb in callbacks or []:
                cb(self, epoch, tr_details, va_details,
                   tr_loss=tr_loss, va_loss=va_loss, lr=plateau.lr)

            if va_loss < best_loss:
                bad_epochs = 0
                if self.run_path is not None and self.mesh.rank == 0:
                    checkpoints.save_model(self.model, self.run_path)
                    if cfg.save_joint and epoch <= warmup and self._has_joint():
                        checkpoints.save_joint_vae(self.model, self._joint_pool_path())
                best_loss = va_loss
            else:
                bad_epochs += 1

            plateau.step(va_loss)
            if bad_epochs == 20:
                if epoch >= warmup:
                    break  # early stop (main.py:267-270)
                # end warmup early (main.py:271-277)
                warmup = epoch + 1
                self.cfg.warmup = warmup
                bad_epochs = 0
                best_loss = math.inf
                self.log(f"====> ending warmup early at epoch {epoch}")
            epoch += 1

        self._history = dict(hist)
        return epoch

    def _has_joint(self):
        return hasattr(self.model, "joint_encoder")

    def _joint_pool_path(self):
        """The shared joint-encoder pool <experiments_dir>/joint_encoders/<exp>
        (main.py:79), shared across runs; next to the run dir's parent when
        no experiments_dir was given."""
        exp = (self.cfg.experiment or "default").split("/")[-1]
        if self.experiments_dir:
            return os.path.join(self.experiments_dir, "joint_encoders", exp)
        base = os.path.dirname(self.run_path.rstrip("/")) if self.run_path else "."
        return os.path.join(base, "joint_encoders", exp)
