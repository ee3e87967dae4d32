"""Importance-sampled likelihood estimators (mmvae_tpu/eval/likelihoods.py;
reference multi_vaes.py:219-355, mmvae.py:121-234, jmvae_nf.py:87-143,209-270,
mvae.py:219-264).

Vectorised over datapoints: each IS chunk of `batch_size_K` samples runs
for P datapoints in one model call of P * batch_size_K rows, and the K /
batch_size_K chunks are combined in the reference's chunk-then-combine
order (multi_vaes.py:242-248). A chunk draws its noise for all n
datapoints, (n, batch_size_K, ...), before its first model call, so no value
depends on P, and a `generation.Noise` with one generator per test batch
makes a call over several batches give each batch the values it gets alone
(`protocol_chunked`).

Where a JAX estimator returns the mean over the batch, these return the
per-datapoint values, {name: (n,)}; `protocol_chunked` takes each test
batch's mean of them. Callers run them under `torch.no_grad()`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

from ..core import distributions as D
from ..core.constants import LOG2PI
from ..core.distributions import LocScale
from .generation import Noise

# Rows of one model call: P = ROWS_PER_CALL // batch_size_K datapoints (100
# at the protocol's batch_size_K = 100). It bounds a likelihood run's peak
# memory, which is the SVHN decoder's: its live tensors take 82 KB a row in
# float32, and cuDNN's workspace for its transposed convs 7 times as much
# (the same decode without cuDNN peaks at its tensors alone). On an H100
# 80GB, one test batch of 500's conditional likelihoods peaked at 6.5 GB at
# 10,000 rows a call, 32.6 GB at 50,000 (1.3 % faster) and 3.3 GB at 5,000
# (11 % slower) (chip_smoke.py, phase eval_memory).
ROWS_PER_CALL = 10_000


def _groups(n: int, bk: int) -> List[slice]:
    p = max(1, ROWS_PER_CALL // bk)
    return [slice(s, min(s + p, n)) for s in range(0, n, p)]


def _chunked_is(draw: Callable, log_w: Callable, n: int, K: int, bk: int) -> torch.Tensor:
    """Per-datapoint log (1/K) sum_k w_k over K // bk chunks of bk samples,
    preserving the reference's chunk-then-combine reduction (JAX
    `_chunked_is`). draw() -> the chunk's noise tensors, (n, bk, ...) each;
    log_w(rows, *noise[rows]) -> (len(rows), bk) log-weights."""
    per_chunk = []
    for _ in range(K // bk):
        noise = draw()
        per_chunk.append(torch.cat([
            torch.logsumexp(log_w(sl, *(e[sl] for e in noise)), dim=-1) for sl in _groups(n, bk)]))
    return torch.logsumexp(torch.stack(per_chunk), dim=0) - math.log(K)


def recon_log_prob_flat(dist_name, recon, x, event_dims: int):
    """log p(x | recon) with unit scale, summed over the last `event_dims`
    dims (the event's); recon and x broadcast against each other."""
    lp = D.log_prob(dist_name, LocScale(recon, torch.ones_like(recon)), x)
    return lp.sum(dim=tuple(range(lp.dim() - event_dims, lp.dim())))


def _lpx(spec, recons, xs, axis: int):
    """sum_m log p(x_m | recon_m): recons (bk, P, ...) with axis 0, or
    (P, bk, ...) with axis 1, against the P datapoints xs."""
    return sum(recon_log_prob_flat(spec.recon_dists[m], r, xs[m].unsqueeze(axis), xs[m].dim() - 1)
               for m, r in enumerate(recons))


def _prior_log_prob(spec, z):
    return torch.sum(D.log_prob(spec.posterior, LocScale(torch.zeros_like(z), torch.ones_like(z)),
                                z), dim=-1)


def _expand(t, bk: int):
    """(P, D) -> (P, bk, D), the proposal's parameters once per sample."""
    return t[:, None].expand(-1, bk, -1)


def _model_sample(sample: Callable, eps):
    """The model's sampler at K = bk from noise (P, bk, D): it takes its
    noise, and adds its leading sample axis, in (bk, P, D) and only for
    bk > 1."""
    e = eps.transpose(0, 1)
    return sample(eps.shape[1], e if eps.shape[1] > 1 else e[0])


def compute_conditional_likelihood(model, data, cond_mod: int, gen_mod: int, spec,
                                   noise: Noise, K: int = 1000, batch_size_K: int = 100):
    """ln p(x_gen | x_cond) ~ logmeanexp over z ~ q(z|x_cond) of ln p(x_gen|z)
    (multi_vaes.py:271-318), z from the model's own conditional rule."""
    x_cond, x_gen, bk = data[cond_mod], data[gen_mod], batch_size_K
    n, latent = x_cond.shape[0], model.vaes[cond_mod].latent_dim

    def log_w(sl, eps):
        z = _model_sample(lambda k, e: model.infer_latent_from_mod(cond_mod, x_cond[sl], K=k,
                                                                   noise=e), eps)
        recon = model.vaes[gen_mod].decode(z.reshape(bk, -1, latent))
        return recon_log_prob_flat(spec.recon_dists[gen_mod], recon, x_gen[sl][None],
                                   x_gen.dim() - 1).T

    def draw():
        return (noise.draw(model.vaes[cond_mod].posterior, (n, bk, latent)),)

    return {f"cond_likelihood_{cond_mod}_{gen_mod}": _chunked_is(draw, log_w, n, K, bk)}


def compute_conditional_likelihoods(model, data, spec, noise: Noise, K: int = 1000,
                                    batch_size_K: int = 100) -> Dict[str, torch.Tensor]:
    """All ordered pairs (multi_vaes.py:324-355), in JAX's order; for three
    modalities also the MoE subset conditionals cond_lw_subset_i, ln of the
    mean of the two conditionals into modality i."""
    n_mod = len(data)
    metrics = {}
    for i in range(n_mod):
        for j in range(n_mod):
            if i != j:
                metrics.update(compute_conditional_likelihood(model, data, j, i, spec, noise, K,
                                                              batch_size_K))
    if n_mod == 3:
        for i in range(n_mod):
            lls = torch.stack([metrics[f"cond_likelihood_{j}_{i}"] for j in range(n_mod) if j != i])
            metrics[f"cond_lw_subset_{i}"] = torch.logsumexp(lls, dim=0) - math.log(2)
    return metrics


def compute_uni_ll_from_prior(model, data, mod: int, spec, noise: Noise, K: int = 1000,
                              batch_size_K: int = 100):
    """ln p(x) ~ ln E_{p(z)} p(x|z) (multi_vaes.py:219-250)."""
    x, bk, latent = data[mod], batch_size_K, spec.latent_dim

    def log_w(sl, eps):
        z = D.sample(spec.posterior, LocScale(torch.zeros_like(eps), torch.ones_like(eps)),
                     noise=eps)
        return recon_log_prob_flat(spec.recon_dists[mod], model.vaes[mod].decode(z),
                                   x[sl][:, None], x.dim() - 1)

    def draw():
        return (noise.draw(spec.posterior, (x.shape[0], bk, latent)),)

    return {f"uni_from_prior_{mod}": _chunked_is(draw, log_w, x.shape[0], K, bk)}


# ---------------------------------------------------------------------------
# joint likelihoods per family
# ---------------------------------------------------------------------------

def _gaussian_proposal_is(model, data, spec, noise: Noise, mu, std, K: int, bk: int):
    """Per-datapoint ln p(x, y) by IS with the proposal N(mu, std) (the
    posterior family's, `spec.posterior`): weights lpx + lpz - lqz."""
    n = mu.shape[0]

    def log_w(sl, eps):
        q = LocScale(_expand(mu[sl], bk), _expand(std[sl], bk))
        z = D.sample(spec.posterior, q, noise=eps)
        lqz = torch.sum(D.log_prob(spec.posterior, q, z), dim=-1)
        return (_lpx(spec, model.decode_all(z), [x[sl] for x in data], 1)
                + _prior_log_prob(spec, z) - lqz)

    def draw():
        return (noise.draw(spec.posterior, (n, bk, mu.shape[1])),)

    return _chunked_is(draw, log_w, n, K, bk)


def joint_likelihood_jmvae_nf(model, data, spec, noise: Noise, K: int = 1000,
                              batch_size_K: int = 100):
    """IS with the joint posterior as proposal (jmvae_nf.py:209-270)."""
    mu, std = model.encode_joint(data)
    return {"likelihood": _gaussian_proposal_is(model, data, spec, noise, mu, std, K,
                                                batch_size_K)}


def joint_likelihood_mvae(model, data, spec, noise: Noise, K: int = 1000,
                          batch_size_K: int = 100):
    """IS with the PoE of every expert and the prior as proposal
    (mvae.py:219-264). JAX takes it from a full forward and discards that
    forward's samples; the port computes the PoE alone: the same values, no
    noise drawn for it."""
    mu, std = model.poe_subset_params(range(len(data)), data)
    return {"likelihood": _gaussian_proposal_is(model, data, spec, noise, mu, std, K,
                                                batch_size_K)}


def joint_likelihood_mmvae(model, data, spec, noise: Noise, K: int = 1000,
                           batch_size_K: int = 100):
    """IS with the Bernoulli mixture of the unimodal posteriors as proposal
    (mmvae.py:121-177), including the reference's lqz_xy =
    logsumexp(lqz_xs) / 2 convention (mmvae.py:166). Noise per chunk: the
    mixture's uniform u (modality 0 where u < 0.5), then each posterior's.
    With three modalities the proposal stays the mixture of modalities 0
    and 1, and ln p(x|z) sums over all three, as in the JAX package."""
    qz_params = model.encode_all(data)
    (mu0, std0), (mu1, std1) = qz_params[0], qz_params[1]
    n, bk, latent = mu0.shape[0], batch_size_K, mu0.shape[1]

    def log_w(sl, u, e0, e1):
        q0 = LocScale(_expand(mu0[sl], bk), _expand(std0[sl], bk))
        q1 = LocScale(_expand(mu1[sl], bk), _expand(std1[sl], bk))
        bern = (u < 0.5).to(mu0.dtype)
        z = bern * D.sample(spec.posterior, q0, noise=e0) + \
            (1 - bern) * D.sample(spec.posterior, q1, noise=e1)
        lqz = torch.stack([torch.sum(D.log_prob(spec.posterior, q, z), dim=-1) for q in (q0, q1)])
        lqz_xy = torch.logsumexp(lqz, dim=0) / 2  # mmvae.py:166
        return (_lpx(spec, model.decode_all(z), [x[sl] for x in data], 1)
                + _prior_log_prob(spec, z) - lqz_xy)

    def draw():
        return (noise.draw("uniform", (n, bk, 1)), noise.draw(spec.posterior, (n, bk, latent)),
                noise.draw(spec.posterior, (n, bk, latent)))

    return {"likelihood": _chunked_is(draw, log_w, n, K, bk)}


def joint_ll_from_uni_jmvae_nf(model, data, cond_mod: int, spec, noise: Noise, K: int = 1000,
                               batch_size_K: int = 100):
    """ln p(x, y) with the flow posterior q(z|x_cond) as proposal
    (jmvae_nf.py:87-143): its density is the base Gaussian's at z0 less the
    flow's log|det J|."""
    x_cond, bk = data[cond_mod], batch_size_K
    n, latent = x_cond.shape[0], model.vaes[cond_mod].latent_dim

    def log_w(sl, eps):
        out = _model_sample(lambda k, e: model.vae_forward_by_mod(x_cond[sl], cond_mod, K=k,
                                                                  noise=e), eps)
        z, z0 = out["z"].reshape(bk, -1, latent), out["z0"].reshape(bk, -1, latent)
        log_q_z0 = torch.sum(-0.5 * (out["log_var"] + LOG2PI + (z0 - out["mu"]) ** 2
                                     / torch.exp(out["log_var"])), dim=-1)
        lqz = log_q_z0 - out["log_abs_det_jac"].reshape(bk, -1)
        lw = _lpx(spec, model.decode_all(z), [x[sl] for x in data], 0) + _prior_log_prob(spec, z)
        return (lw - lqz).T

    def draw():
        return (noise.draw(model.vaes[cond_mod].posterior, (n, bk, latent)),)

    return {f"joint_ll_from_{cond_mod}": _chunked_is(draw, log_w, n, K, bk)}


def joint_ll_from_uni_gaussian(model, data, cond_mod: int, spec, noise: Noise, K: int = 1000,
                               batch_size_K: int = 100):
    """ln p(x, y) by IS with the unimodal encoder posterior q(z|x_cond) as
    proposal, the MMVAE variant (mmvae.py:180-234); MVAE's and MoE-PoE's
    too, on their raw encoder posteriors (`encode_all`)."""
    mu, std = model.encode_all(data)[cond_mod]
    return {f"joint_ll_from_{cond_mod}": _gaussian_proposal_is(model, data, spec, noise, mu, std,
                                                               K, batch_size_K)}


def joint_ll_from_uni_for(model):
    """The ln p(x, y)-from-a-unimodal-posterior estimator of the model's
    family: JMVAE-NF the flow posterior density, the families with
    `encode_all` (MMVAE, MVAE, MoE-PoE) the encoder posterior."""
    from ..models.jmvae_nf import JMVAE_NF

    if isinstance(model, JMVAE_NF):
        return joint_ll_from_uni_jmvae_nf
    if hasattr(model, "encode_all"):
        return joint_ll_from_uni_gaussian
    raise NotImplementedError(f"no joint_ll_from_uni estimator for {type(model).__name__}")


def compute_conditional_likelihood_bis(model, data, cond_mod: int, gen_mod: int, spec,
                                       noise: Noise, K: int = 1000, batch_size_K: int = 100,
                                       joint_ll_fn=None):
    """ln p(x|y) = joint_ll_from_uni - uni_from_prior (multi_vaes.py:253-268)."""
    if joint_ll_fn is None:
        joint_ll_fn = joint_ll_from_uni_for(model)
    t1 = joint_ll_fn(model, data, cond_mod, spec, noise, K, batch_size_K)
    t2 = compute_uni_ll_from_prior(model, data, cond_mod, spec, noise, K, batch_size_K)
    return {f"conditional_likelihood_bis_{cond_mod}_{gen_mod}":
            t1[f"joint_ll_from_{cond_mod}"] - t2[f"uni_from_prior_{cond_mod}"]}


def compute_conditional_likelihoods_bis(model, data, spec, noise: Noise, K: int = 1000,
                                        batch_size_K: int = 100):
    """The bis protocol over all ordered pairs (multi_vaes.py:253-268)."""
    joint_ll_fn = joint_ll_from_uni_for(model)
    n_mod = len(data)
    metrics = {}
    for i in range(n_mod):
        for j in range(n_mod):
            if i != j:
                metrics.update(compute_conditional_likelihood_bis(
                    model, data, j, i, spec, noise, K, batch_size_K, joint_ll_fn=joint_ll_fn))
    return metrics


@torch.no_grad()
def protocol_chunked(model, spec, batches: Sequence[Sequence[torch.Tensor]],
                     generators: Sequence[torch.Generator], K: int, batch_size_K: int,
                     joint_fn=None, bis: bool = False) -> Dict[str, List[float]]:
    """The likelihood protocol (compute_likelihoods.py:95-122) for S test
    batches in one call, batch b's noise from generators[b]: the
    conditional likelihoods, the family's joint likelihood (`joint_fn`) and
    with `bis` the bis protocol, in that order. Returns {name: S per-batch
    means}, the same as S calls of one batch each."""
    sizes = [b[0].shape[0] for b in batches]
    data = [torch.cat([b[m] for b in batches]) for m in range(len(batches[0]))]
    noise = Noise(generators, sizes, dtype=data[0].dtype)
    metrics = compute_conditional_likelihoods(model, data, spec, noise, K, batch_size_K)
    if joint_fn is not None:
        metrics.update(joint_fn(model, data, spec, noise, K, batch_size_K))
    if bis:
        metrics.update(compute_conditional_likelihoods_bis(model, data, spec, noise, K,
                                                           batch_size_K))
    return {k: torch.stack([c.mean() for c in v.split(sizes)]).tolist() for k, v in metrics.items()}
