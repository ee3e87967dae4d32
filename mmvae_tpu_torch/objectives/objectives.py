"""Training objectives (mmvae_tpu/objectives/objectives.py).

An objective is a plain function
    (model, x, spec, K=..., noise=..., generator=..., **cfg) -> (objective, details)
returning the MAXIMIZATION objective (the train loop negates) and a dict of
scalar terms. `noise` is the posterior samples' noise in the order the
objective draws them (each function says which), of the posterior family's
kind, or None to draw from `generator`. The unimodal objectives (elbo,
iwae, dreg) take a UnimodalVAE and one tensor x, as in the JAX package; the
multimodal ones a list of tensors, one per modality.

The DReG estimators replace the JAX package's two-stage VJP with a tensor
hook on the samples (`zss`, or the unimodal `zs`): the gradient that
reaches them is multiplied by the stop-grad importance weights before it
flows back into the encoders and flows, the reference's hook
(objectives.py:66-67, 398-401, 434-437). With the posterior parameters
detached inside the log-weights, the one backward pass gives JAX's
gp1 + gp2. Under `no_grad` (the eval step) no hook is registered and the
objective returns the surrogate's value, as JAX's eval step does.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Tuple

import torch

from ..core import distributions as D
from ..core.distributions import LocScale
from ..core.math import log_mean_exp
from ..nets.conv import batchnorm_stats
from ..parallel.mesh import k_split_of


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model metadata consumed by objectives."""

    latent_dim: int
    posterior: str = "normal"
    recon_dists: Tuple[str, ...] = ("normal", "normal")
    lik_scaling: Tuple[float, ...] = (1.0, 1.0)
    vae_recon_losses: Tuple[str, ...] = ("mse", "mse")
    no_recon: bool = False
    linear_warmup: bool = False
    align: int = -1
    llik_scaling: float = 1.0


def prior(spec: ModelSpec, like: torch.Tensor) -> LocScale:
    """The standard prior, (1, latent), on `like`'s device and dtype."""
    zeros = like.new_zeros((1, spec.latent_dim))
    return LocScale(zeros, torch.ones_like(zeros))


def recon_log_prob(dist_name: str, recon, x, lead_ndim: int):
    """ln p(x|z) with unit scale, summed over the event dims
    (px_z wrapping at mmvae.py:54-76)."""
    lp = D.log_prob(dist_name, LocScale(recon, torch.ones_like(recon)), x)
    return lp.reshape(*lp.shape[:lead_ndim], -1).sum(-1)


def recon_pointwise_loss(loss_name: str, recon, x):
    """recon_loss_dict equivalent (objectives.py:177): mse / l1 / bce, summed."""
    r = recon.reshape(recon.shape[0], -1)
    t = x.reshape(x.shape[0], -1)
    if loss_name == "normal":      # F.mse_loss
        return torch.sum((r - t) ** 2)
    if loss_name == "laplace":     # F.l1_loss
        return torch.sum(torch.abs(r - t))
    if loss_name == "bernoulli":   # F.binary_cross_entropy
        rc = torch.clamp(r, 1e-7, 1 - 1e-7)
        return -torch.sum(t * torch.log(rc) + (1 - t) * torch.log1p(-rc))
    raise ValueError(loss_name)


def _detached(details):
    return {k: v.detach() for k, v in details.items()}


# ===========================================================================
# Unimodal objectives (objectives.py:20-69)
# ===========================================================================

def elbo(model, x, spec: ModelSpec, K=1, beta_prior=1.0, noise=None, generator=None, **kw):
    """E[ELBO] of a UnimodalVAE (objectives.py:20-25): the mean over the K
    samples, the SUM over the batch (the reference's .mean(0).sum()).
    UnimodalVAE drops the sample axis at K=1. noise: the posterior sample's,
    (K, B, latent), or (B, latent) at K=1."""
    out = model(x, K=K, noise=noise, generator=generator)
    qz = LocScale(out["mu"], out["std"])
    has_k = out["z"].dim() == 3
    lpx_z = recon_log_prob(spec.recon_dists[0], out["recon"], x, 2 if has_k else 1)
    lpx_z = lpx_z * spec.llik_scaling
    kld = torch.sum(D.kl(spec.posterior, qz, prior(spec, qz.loc)), dim=-1)
    val = lpx_z - beta_prior * kld  # (K, B) or (B,)
    if has_k:
        val = torch.mean(val, dim=0)
    return torch.sum(val), {}


def _unimodal_lw(x, spec: ModelSpec, qz: LocScale, zs, recon):
    """Log-weights lpz + llik_scaling * lpx - lqz of K samples, always
    (K, B): at K=1 the axis UnimodalVAE drops is restored
    (objectives.py:117-131)."""
    has_k = zs.dim() == 3
    lpz = torch.sum(D.log_prob(spec.posterior, prior(spec, zs), zs), dim=-1)
    lpx_z = recon_log_prob(spec.recon_dists[0], recon, x, 2 if has_k else 1) * spec.llik_scaling
    lqz_x = torch.sum(D.log_prob(spec.posterior, qz, zs), dim=-1)
    lw = lpz + lpx_z - lqz_x
    return lw if has_k else lw[None]


def iwae(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    """The IWAE bound of a UnimodalVAE (objectives.py:28-43): log-mean-exp
    over the K samples, summed over the batch. noise: as `elbo`'s."""
    out = model(x, K=K, noise=noise, generator=generator)
    lw = _unimodal_lw(x, spec, LocScale(out["mu"], out["std"]), out["z"], out["recon"])
    return torch.sum(log_mean_exp(lw, dim=0)), {}


def dreg(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    """Unimodal DReG (objectives.py:46-69): the posterior parameters
    detached in the log-weights, the surrogate sum(w * lw) with the
    stop-grad softmax weights w over K, and the gradient reaching the
    samples (after the flow) multiplied by w again, a hook as `_m_dreg`'s.
    noise: the posterior samples', (K, B, latent) at every K."""
    (mu, std), zs, _ = model.encode_and_sample(x, K=K, noise=noise, generator=generator)
    recon = model.decode(zs)
    lw = _unimodal_lw(x, spec, LocScale(mu.detach(), std.detach()), zs, recon)
    with torch.no_grad():
        w = torch.softmax(lw, dim=0)
    if zs.requires_grad:
        zs.register_hook(lambda g: g * w[..., None])
    return torch.sum(w * lw), {}


# ===========================================================================
# Multimodal ELBOs (objectives.py:73-111)
# ===========================================================================

def m_elbo_naive(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    """Naive multimodal ELBO (objectives.py:73-84)."""
    out = model(x, K=K, noise=noise, generator=generator)
    qz_params, recons = out["qz_params"], out["recons"]
    n = len(qz_params)
    lpx_zs, klds = [], []
    for r in range(n):
        qz = LocScale(*qz_params[r])
        klds.append(torch.sum(D.kl(spec.posterior, qz, prior(spec, qz.loc)), dim=-1))
        for d in range(n):
            lp = recon_log_prob(spec.recon_dists[d], recons[r][d], x[d], 2)
            lpx_zs.append(lp * spec.lik_scaling[d])
    obj = (1.0 / n) * (sum(lpx_zs) - sum(klds))
    return torch.sum(torch.mean(obj, dim=0)), {}


def m_elbo(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    """Importance-weighted multimodal ELBO with stop-grad cross weights
    (objectives.py:87-111)."""
    out = model(x, K=K, noise=noise, generator=generator)
    qz_params, recons, zss = out["qz_params"], out["recons"], out["zss"]
    n = len(qz_params)
    lpx_zs, klds = [], []
    details = {}
    for r in range(n):
        qz_r = LocScale(*qz_params[r])
        klds.append(torch.sum(D.kl(spec.posterior, qz_r, prior(spec, qz_r.loc)), dim=-1))
        for d in range(n):
            lp = recon_log_prob(spec.recon_dists[d], recons[d][d], x[d], 2)
            lp = lp * spec.lik_scaling[d]
            if d == r:
                lwt = lp.new_zeros(())
            else:
                zs = zss[d].detach()
                qz_d = LocScale(*qz_params[d])
                lwt = torch.sum(D.log_prob(spec.posterior, qz_r, zs)
                                - D.log_prob(spec.posterior, qz_d, zs).detach(), dim=-1)
            lpx_zs.append(torch.exp(lwt) * lp)
            details[f"lpx_zs{r}{d}"] = torch.sum(lpx_zs[-1]).detach()
    obj = (1.0 / n) * (sum(lpx_zs) - sum(klds))
    return torch.sum(torch.mean(obj, dim=0)), details


# ===========================================================================
# Multimodal IWAE / DReG (objectives.py:117-131, 333-438)
# ===========================================================================

def _m_lws(x, spec: ModelSpec, qz_params, zss, recons, detach_post: bool):
    """Per-expert log-weights lw_r = lpz + sum_d lpx - lqz_moe
    (objectives.py:117-131 / 372-388), (M, K, B). lpx is scaled by
    spec.lik_scaling for both IWAE and DReG, as in the JAX package."""
    n = len(qz_params)
    if detach_post:
        qz_params = [(mu.detach(), std.detach()) for mu, std in qz_params]
    lws = []
    for r in range(n):
        pz = prior(spec, zss)
        lpz = torch.sum(D.log_prob(spec.posterior, pz, zss[r]), dim=-1)
        lqz = log_mean_exp(torch.stack([
            torch.sum(D.log_prob(spec.posterior, LocScale(*qz_params[m]), zss[r]), dim=-1)
            for m in range(n)
        ]))
        lpx = sum(recon_log_prob(spec.recon_dists[d], recons[r][d], x[d], 2) * spec.lik_scaling[d]
                  for d in range(n))
        lws.append(lpz + lpx - lqz)
    return torch.stack(lws)


def _iwae_lws(model, x, spec: ModelSpec, K, noise, generator):
    """The IWAE log-weights over all K, (M, K, B), and the share of the
    objective this rank holds (1 / n_k under a K split, whose gather
    passes each rank its part of the gradient)."""
    out = model(x, K=K, noise=noise, generator=generator)
    lws = _m_lws(x, spec, out["qz_params"], out["zss"], out["recons"], False)
    split = k_split_of(model, K)
    if split is None:
        return lws, 1.0
    return split.gather_k(lws, 1), 1.0 / split.n_k


def m_iwae(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    """Multimodal IWAE, tight bound: log-mean over M*K (objectives.py:333-340)."""
    lws, share = _iwae_lws(model, x, spec, K, noise, generator)
    m, k, b = lws.shape
    return torch.sum(log_mean_exp(lws.reshape(m * k, b), dim=0)) * share, {}


def m_iwae_looser(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    """Looser bound: modality average outside the log (objectives.py:343-369)."""
    lws, share = _iwae_lws(model, x, spec, K, noise, generator)
    return torch.sum(torch.mean(log_mean_exp(lws, dim=1), dim=0)) * share, {}


def _m_dreg(model, x, spec: ModelSpec, K, looser: bool, noise, generator):
    """Shared DReG machinery (objectives.py:372-438). Under a K split the
    softmax weights are taken over every k rank's log-weights, and each
    rank's surrogate sums its own samples' terms."""
    qz_params, zss = model.encode_and_sample(x, K=K, noise=noise, generator=generator)
    recons = model.decode_cross(zss)
    lws = _m_lws(x, spec, qz_params, zss, recons, detach_post=True)
    split = k_split_of(model, K)
    with torch.no_grad():
        full = lws if split is None else split.gather_k(lws, 1)
        if looser:
            # softmax over K per (modality, batch) (objectives.py:435)
            w = torch.softmax(full, dim=1)
        else:
            # softmax over the joint (M*K) axis (objectives.py:399)
            m, k, b = full.shape
            w = torch.softmax(full.reshape(m * k, b), dim=0).reshape(m, k, b)
        if split is not None:
            w = w[:, split.k_samples(K)]
    if zss.requires_grad:
        # the z-gradient additionally scaled by w (objectives.py:401, 437)
        zss.register_hook(lambda g: g * w[..., None])
    if looser:
        return torch.sum(torch.mean(w * lws, dim=0)), {}
    return torch.sum(w * lws), {}


def m_dreg(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    return _m_dreg(model, x, spec, K, False, noise, generator)


def m_dreg_looser(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    return _m_dreg(model, x, spec, K, True, noise, generator)


# ===========================================================================
# MMVAE-NF (objectives.py:463-479)
# ===========================================================================

def m_elbo_nf(model, x, spec: ModelSpec, K=1, noise=None, generator=None, **kw):
    """Flow-posterior ELBO with unit-gaussian decoder (reference
    objectives.py:463-479), summed over the batch. K is not used: MMVAE_NF
    runs each VAE at K=1."""
    out = model(x, noise=noise, generator=generator)
    ln_qz_xs, zs, recons = out["ln_qz_xs"], out["zs"], out["recons"]
    n = len(zs)
    obj = 0.0
    for e in range(n):
        log_prob_z = -0.5 * torch.sum(zs[e] ** 2)
        kld = torch.sum(ln_qz_xs[e]) - log_prob_z
        obj = obj - kld / n
        for d, recon in enumerate(recons[e]):
            obj = obj + (-0.5 * torch.sum((recon - x[d]) ** 2)) / n * spec.lik_scaling[d]
    return obj, {}


# ===========================================================================
# JMVAE-NF (objectives.py:179-220)
# ===========================================================================

def _joint_kld_prior(mu, std):
    """-0.5 sum(1 + log_var - mu^2 - var) with log_var = 2 log std
    (objectives.py:209-211)."""
    log_var = 2 * torch.log(std)
    return torch.sum(-0.5 * torch.sum(1 + log_var - mu ** 2 - torch.exp(log_var), dim=-1))


def _joint_terms(model, x, spec: ModelSpec, noise, generator):
    """The joint forward's scaled reconstruction losses and prior KL, shared
    by JMVAE-NF and TELBO (objectives.py:179-220, 223-259): (loss, details)
    with loss = -sum_m loss_m, details loss_{m}, loss and kld_prior."""
    out = model(x, noise=noise, generator=generator)
    details = {}
    loss = 0.0
    for m, xm in enumerate(x):
        l_m = recon_pointwise_loss(spec.recon_dists[m], out["recons"][m], xm) * spec.lik_scaling[m]
        details[f"loss_{m}"] = l_m
        loss = loss - l_m
    details["loss"] = loss
    details["kld_prior"] = _joint_kld_prior(*out["qz_xy"])
    return loss, details


def m_jmvae_nf(model, x, spec: ModelSpec, K=1, epoch=1, warmup=0, beta_prior=1.0,
               beta_kl=1.0, past_warmup=None, frozen_joint=False, noise=None,
               generator=None, **kw):
    """The paper's JMVAE-NF loss (objectives.py:179-220). `past_warmup`
    selects the phase (default epoch >= warmup); beta_kl arrives already
    decayed by the schedule.

    `frozen_joint` (the Trainer sets it from fix_jencoder and fix_decoders)
    past warmup runs the joint forward without a gradient: every parameter
    it reaches is frozen then, so the trainable gradients are unchanged and
    the frozen ones' backward is skipped (tests/test_torch_jmvae_nf.py).

    noise: standard-normal noise in the order the samples are drawn, the
    joint forward's, compute_kld's joint sample, then each modality's
    unimodal VAE forward (used past warmup; the last ones only without
    no_recon); or None to draw from `generator`."""
    if past_warmup is None:
        past_warmup = epoch >= warmup
    frozen_joint = bool(frozen_joint) and bool(past_warmup)
    noise = [None] * (2 + len(x)) if noise is None else list(noise)
    bn_stats = batchnorm_stats(model) if model.training else []
    bn_before = [t.clone() for t in bn_stats]
    with torch.no_grad() if frozen_joint else nullcontext():
        loss, details = _joint_terms(model, x, spec, noise[0], generator)
    if spec.linear_warmup:
        beta_reg = min((epoch - 1) / warmup, 1.0) if warmup > 0 else 1.0
    else:
        beta_reg = 1.0
    if past_warmup or spec.linear_warmup:
        # the JAX package keeps the BatchNorm statistics of compute_kld's
        # pass alone, which starts from the step's old ones: the joint
        # forward's updates (of the decoders') are dropped
        with torch.no_grad():
            for t, old in zip(bn_stats, bn_before):
                t.copy_(old)
        reg, det = model.compute_kld(x, no_recon=spec.no_recon, beta_kl=beta_kl,
                                     stop_joint_grad=frozen_joint, noise=noise[1:],
                                     generator=generator)
        details["reg"] = reg
        details.update(det)
    else:
        reg = 0.0
        details["reg"] = loss.new_zeros(())
    obj = loss - beta_reg * (beta_prior * details["kld_prior"] + reg)
    return obj, _detached(details)


# ===========================================================================
# TELBO (objectives.py:223-259)
# ===========================================================================

def _vae_neg_elbo(spec: ModelSpec, m: int, vout, x):
    """my_VAE.loss_function (vae_model_adapted.py:104-124): 0.5 * squared
    error ("mse") or the clipped binary cross-entropy, plus the analytic
    KL of (mu, log_var) to the prior (the flow's log-det is not in it),
    summed over the batch."""
    recon, mu, log_var = vout["recon"], vout["mu"], vout["log_var"]
    r = recon.reshape(x.shape[0], -1)
    t = x.reshape(x.shape[0], -1)
    if spec.vae_recon_losses[m] == "mse":
        recon_loss = 0.5 * torch.sum((r - t) ** 2, dim=-1)
    else:
        rc = torch.clamp(r, 1e-7, 1 - 1e-7)
        recon_loss = -torch.sum(t * torch.log(rc) + (1 - t) * torch.log1p(-rc), dim=-1)
    kld = -0.5 * torch.sum(1 + log_var - mu ** 2 - torch.exp(log_var), dim=-1)
    return torch.sum(recon_loss + kld)


def m_telbo_nf(model, x, spec: ModelSpec, K=1, epoch=1, warmup=0, beta_prior=1.0,
               past_warmup=None, noise=None, generator=None, **kw):
    """TELBO with a joint warmup, then the unimodal VAEs' ELBOs
    (objectives.py:223-259). The joint term stays in the objective past
    warmup, where the Trainer's freezing keeps it from training the frozen
    joint encoder and decoders; unlike m_jmvae_nf there is no detached
    joint path (the Trainer's `frozen_joint` lands in **kw), and
    `spec.no_recon` is not read. Past warmup each unimodal VAE runs its
    full forward under autograd: with a flow, its sampling direction, the
    fused solve.

    noise: standard-normal noise in draw order, the joint forward's, then
    each modality's unimodal VAE forward (past warmup); or None to draw
    from `generator`."""
    if past_warmup is None:
        past_warmup = epoch >= warmup
    noise = [None] * (1 + len(x)) if noise is None else list(noise)
    loss, details = _joint_terms(model, x, spec, noise[0], generator)
    if past_warmup:
        for m, xm in enumerate(x):
            vout = model.vae_forward(xm, m, noise=noise[1 + m], generator=generator)
            neg_elbo = _vae_neg_elbo(spec, m, vout, xm) * spec.lik_scaling[m]
            details[f"neg_elbo_{m}"] = neg_elbo
            loss = loss - neg_elbo
    obj = loss - beta_prior * details["kld_prior"]
    return obj, _detached(details)


# ===========================================================================
# JMVAE, VAEVAE, SVAE, multi-ELBOs, TELBO on JMVAE_NF (objectives.py:133-174,
# 261-329)
# ===========================================================================

def _batch_mean(t, block, dim=None):
    """torch.mean of `t`, whose axis 0 is the batch, over `dim` (every
    element when None). With `block` (parallel/mesh.py), t holds this
    rank's rows of a batch sharded over ranks, and the result is this
    rank's share of the global batch's mean, so that the ranks' values and
    gradients sum to the one-process ones, as the batch sums do."""
    m = torch.mean(t) if dim is None else torch.mean(t, dim=dim)
    return m if block is None else m * (t.shape[0] / block.rows)


def _mean_kl(spec: ModelSpec, p: LocScale, q: LocScale, block=None):
    """sum over latents of the batch mean of KL(p || q), the reference's
    .mean(0).sum()."""
    return torch.sum(_batch_mean(D.kl(spec.posterior, p, q), block, 0))


def m_jmvae(model, x, spec: ModelSpec, K=1, beta=0.0, epoch=1, warmup=0, beta_prior=1.0,
            past_warmup=None, noise=None, generator=None, block=None, **kw):
    """The original JMVAE loss (objectives.py:157-174): the joint forward's
    reconstructions and prior KL (batch means), and past warmup beta times
    the KLs of the joint posterior to each unimodal one. Past warmup the
    Trainer freezes the joint encoder whatever fix_jencoder says
    (train/freezing.py). noise: [the joint sample's]."""
    if past_warmup is None:
        past_warmup = epoch >= warmup
    noise = [None] if noise is None else list(noise)
    out = model(x, noise=noise[0], generator=generator)
    uni = model.encode_all_unimodal(x)
    loss = 0.0
    for m, xm in enumerate(x):
        loss = loss + torch.sum(_batch_mean(
            recon_log_prob(spec.recon_dists[m], out["recons"][m], xm, 1), block, 0))
    qz_xy = LocScale(*out["qz_xy"])
    loss = loss - beta_prior * _mean_kl(spec, qz_xy, prior(spec, qz_xy.loc), block)
    details = {"loss": loss}
    kls = []
    for m, (mu_m, std_m) in enumerate(uni):
        details[f"kl{m + 1}"] = _mean_kl(spec, qz_xy, LocScale(mu_m, std_m), block)
        kls.append(details[f"kl{m + 1}"])
    obj = loss - beta * sum(kls) if past_warmup else loss
    return obj, _detached(details)


def _m_vaevae(model, x, spec: ModelSpec, dist_fn, beta, epoch, warmup, beta_prior,
              past_warmup, noise, generator, block):
    """VAEVAE (objectives.py:133-155) on the first two modalities: each
    unimodal VAE's ELBO SUMMED over the batch (the reference's elbo, its
    .mean(0) over the K=1 axis) against a symmetric alignment term of the
    two posteriors MEANED over the batch, over the first `spec.align`
    latents unless align is -1, weighted by beta past warmup."""
    if past_warmup is None:
        past_warmup = epoch >= warmup
    noise = [None] * 2 if noise is None else list(noise)
    losses, qs = [], []
    for m in range(2):
        vout = model.vae_forward(x[m], m, noise=noise[m], generator=generator)
        q_m = LocScale(vout["mu"], vout["std"])
        lpx = recon_log_prob(spec.recon_dists[m], vout["recon"], x[m], 1) * spec.llik_scaling
        kld = torch.sum(D.kl(spec.posterior, q_m, prior(spec, q_m.loc)), dim=-1)
        losses.append(torch.sum(lpx - beta_prior * kld))
        qs.append(q_m)
    cut = slice(None) if spec.align == -1 else slice(None, spec.align)
    reg = 0.5 * (torch.sum(_batch_mean(dist_fn(qs[0], qs[1])[:, cut], block, 0))
                 + torch.sum(_batch_mean(dist_fn(qs[1], qs[0])[:, cut], block, 0)))
    details = dict(loss=losses[0] + losses[1], reg=reg, loss1=losses[0], loss2=losses[1])
    obj = losses[0] + losses[1] - (beta * reg if past_warmup else 0.0)
    return obj, _detached(details)


def m_vaevae_kl(model, x, spec: ModelSpec, K=1, beta=1000.0, epoch=1, warmup=0, beta_prior=1.0,
                past_warmup=None, noise=None, generator=None, block=None, **kw):
    """VAEVAE with the KL alignment term. noise: [each VAE's sample, 0 and 1]."""
    return _m_vaevae(model, x, spec, lambda p, q: D.kl(spec.posterior, p, q), beta, epoch,
                     warmup, beta_prior, past_warmup, noise, generator, block)


def m_vaevae_w2(model, x, spec: ModelSpec, K=1, beta=1000.0, epoch=1, warmup=0, beta_prior=1.0,
                past_warmup=None, noise=None, generator=None, block=None, **kw):
    """VAEVAE with the reference's W2 alignment term (D.wasserstein_2).
    noise: as m_vaevae_kl's."""
    return _m_vaevae(model, x, spec, D.wasserstein_2, beta, epoch, warmup, beta_prior,
                     past_warmup, noise, generator, block)


def m_svae(model, x, spec: ModelSpec, K=1, beta=0.0, noise=None, generator=None, block=None,
           **kw):
    """SVAE (objectives.py:284-303): the unimodal and joint reconstructions,
    each a .mean() over ALL elements, as the reference takes them, against
    the unimodal prior KLs and the joint-to-unimodal KLs (.mean(0).sum()).
    noise: [the joint sample's, then each VAE's]."""
    noise = [None] * (1 + len(x)) if noise is None else list(noise)
    out = model(x, noise=noise[0], generator=generator)
    qz_xy = LocScale(*out["qz_xy"])
    loss, reg = 0.0, 0.0
    for m, xm in enumerate(x):
        vout = model.vae_forward(xm, m, noise=noise[1 + m], generator=generator)
        q_m = LocScale(vout["mu"], vout["std"])
        for recon in (vout["recon"], out["recons"][m]):
            loss = loss + _batch_mean(
                D.log_prob(spec.recon_dists[m], LocScale(recon, torch.ones_like(recon)), xm),
                block)
        reg = (reg + _mean_kl(spec, q_m, prior(spec, q_m.loc), block)
               + _mean_kl(spec, qz_xy, q_m, block))
    return 0.5 * (loss - beta * reg), _detached({"loss": loss, "reg": reg})


def m_multi_elbos(model, x, spec: ModelSpec, K=1, noise=None, generator=None, block=None,
                  **kw):
    """Sutter et al.'s sum of ELBOs (objectives.py:261-281): the joint
    reconstructions, every unimodal cross reconstruction, the unimodal and
    the joint prior KLs (batch means), divided by 3.0 whatever the number
    of modalities, as the reference does. noise: [the joint sample's, then
    each VAE's in unimodal_cross_forward]."""
    noise = [None] * (1 + len(x)) if noise is None else list(noise)
    out = model(x, noise=noise[0], generator=generator)
    uni = model.unimodal_cross_forward(x, noise=noise[1:], generator=generator)
    loss = 0.0
    for m, xm in enumerate(x):
        loss = loss + _batch_mean(
            recon_log_prob(spec.recon_dists[m], out["recons"][m], xm, 1), block)
        for r in range(len(x)):
            loss = loss + _batch_mean(
                recon_log_prob(spec.recon_dists[m], uni["recons"][r][m], xm, 1), block)
        q_m = LocScale(*uni["qz_params"][m])
        loss = loss - _mean_kl(spec, q_m, prior(spec, q_m.loc), block)
    qz_xy = LocScale(*out["qz_xy"])
    loss = loss - _mean_kl(spec, qz_xy, prior(spec, qz_xy.loc), block)
    return loss / 3.0, {}


def m_telbo(model, x, spec: ModelSpec, K=1, beta=0.0, beta_prior=1.0, noise=None,
            generator=None, block=None, **kw):
    """TELBO (objectives.py:306-329) on the first two modalities' unimodal
    terms: the joint reconstructions less the joint prior KL, plus beta
    times each unimodal ELBO (its own reconstruction, batch mean, less its
    prior KL). The reference toggles requires_grad_ after building the
    graph, so every parameter gets its gradient; as the JAX package, this
    reproduces those ungated gradients. noise: as m_multi_elbos'."""
    noise = [None] * (1 + len(x)) if noise is None else list(noise)
    out = model(x, noise=noise[0], generator=generator)
    uni = model.unimodal_cross_forward(x, noise=noise[1:], generator=generator)
    details = {"mloss": 0.0}
    for m, xm in enumerate(x):
        q_m = LocScale(*uni["qz_params"][m])
        details[f"loss_{m}"] = (
            _batch_mean(recon_log_prob(spec.recon_dists[m], uni["recons"][m][m], xm, 1), block)
            - beta_prior * _mean_kl(spec, q_m, prior(spec, q_m.loc), block))
        details["mloss"] = details["mloss"] + _batch_mean(
            recon_log_prob(spec.recon_dists[m], out["recons"][m], xm, 1), block)
    qz_xy = LocScale(*out["qz_xy"])
    details["reg"] = beta_prior * _mean_kl(spec, qz_xy, prior(spec, qz_xy.loc), block)
    obj = details["mloss"] - details["reg"] + beta * (details["loss_0"] + details["loss_1"])
    return obj, _detached(details)


# ===========================================================================
# MVAE / MoE-PoE (objectives.py:481-483)
# ===========================================================================

def m_self_built(model, x, spec: ModelSpec, K=1, noise=None, generator=None, block=None,
                 **kw):
    """The model's own ELBO (MVAE, MoE-PoE build it in their forward), with
    no details. K reaches nothing, as in the JAX package. `block`: as the
    models take it."""
    return model(x, noise=noise, generator=generator, block=block)["elbo"], {}


# every objective of the JAX package, its OBJECTIVES and its
# CUSTOM_GRAD_OBJECTIVES (here the DReG hooks) together
OBJECTIVES = {
    "elbo": elbo,
    "iwae": iwae,
    "dreg": dreg,
    "m_elbo_naive": m_elbo_naive,
    "m_elbo": m_elbo,
    "m_iwae": m_iwae,
    "m_iwae_looser": m_iwae_looser,
    "m_dreg": m_dreg,
    "m_dreg_looser": m_dreg_looser,
    "m_jmvae": m_jmvae,
    "m_jmvae_nf": m_jmvae_nf,
    "m_telbo": m_telbo,
    "m_telbo_nf": m_telbo_nf,
    "m_vaevae_kl": m_vaevae_kl,
    "m_vaevae_w2": m_vaevae_w2,
    "m_svae": m_svae,
    "m_multi_elbos": m_multi_elbos,
    "m_elbo_nf": m_elbo_nf,
    "m_self_built": m_self_built,
}


def resolve(obj_name: str, multimodal: bool, looser: bool):
    """main.py:134-137 dispatch: ('m_' if multimodal) + obj + ('_looser' if
    looser and obj != 'elbo'). Returns (name, fn); a name the JAX package
    does not have either raises KeyError, as there."""
    name = ("m_" if multimodal else "") + obj_name
    if looser and obj_name != "elbo":
        name = name + "_looser"
    return name, OBJECTIVES[name]
