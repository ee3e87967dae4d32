"""Hamiltonian Monte Carlo over a product of flow-posterior experts
(mmvae_tpu/eval/hmc.py; reference jmvae_nf.py:272-437).

The gradient of ln q comes from `torch.autograd.grad` of the summed
density, under `torch.enable_grad()`, so that callers may run under
`no_grad` (validate does); one evaluation gives the density and the
gradient, where JAX evaluates ln q twice, and the chain carries both from
the end of one step into the next: `n_lf` evaluations a step, where JAX
makes 2·(n_lf + 2). The experts' encoders run once
per chain (`JMVAE_NF.poe_density`); each evaluation runs the flows' density
direction only, the parallel MADE pass: no `ar_solve` launch. On the card
the evaluation is one captured CUDA graph, replayed (`_evaluator`). The starting point
samples the unimodal posteriors, the flows' sampling direction, which on
the card is the forward kernel.

Every draw can be given instead of drawn (the tests hold the port to the
JAX package with JAX's own draws): the start's modality `choice` and
per-modality noise, or the start `z0` itself; the momenta `rho` (steps, n,
D) and the accept-uniforms `u` (steps, n). What is not given is drawn from
`generator`, in the order choice, the modalities' noise, then rho and u of
each step in turn.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def sample_from_moe_subset(model, subset: Sequence[int], data, generator=None, choice=None,
                           eps=None):
    """For each row, a sample of the unimodal posterior of a modality of
    `subset` picked at random (jmvae_nf.py:272-290). `choice` (n,) indexes
    `subset`; `eps[j]` (n, D) is modality subset[j]'s standard-normal noise."""
    x0 = data[subset[0]]
    n = x0.shape[0]
    if choice is None:
        choice = torch.randint(0, len(subset), (n,), generator=generator, device=x0.device)
    zs = torch.stack([
        model.infer_latent_from_mod(m, data[m], noise=None if eps is None else eps[j],
                                    generator=generator)
        for j, m in enumerate(subset)])  # (|S|, n, D)
    idx = torch.as_tensor(choice, device=zs.device).long()
    return zs[idx, torch.arange(n, device=zs.device)]


def _log_q_and_grad(log_density, z):
    """Per-sample ln q_PoE(z) and the gradient of its sum."""
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        lnq = log_density(z)
        (g,) = torch.autograd.grad(lnq.sum(), z)
    return lnq.detach(), g


def _evaluator(log_density, z):
    """z -> (ln q, its gradient) for a chain at z's shape. On the card, one
    CUDA graph of the density and its gradient, captured here and replayed
    at each evaluation: the chain makes n_lf of them a step, each a few
    hundred small launches, whose host cost otherwise bounds the chain.
    The replay runs the same kernels on the same inputs."""
    if not z.is_cuda:
        return lambda zz: _log_q_and_grad(log_density, zz)
    static_z = z.detach().clone()
    side = torch.cuda.Stream(device=z.device)
    side.wait_stream(torch.cuda.current_stream(z.device))
    with torch.cuda.stream(side):
        for _ in range(2):  # warm up the autograd engine off the capture
            _log_q_and_grad(log_density, static_z)
    torch.cuda.current_stream(z.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        lnq, g = _log_q_and_grad(log_density, static_z)

    def evaluate(zz):
        static_z.copy_(zz)
        graph.replay()
        return lnq.clone(), g.clone()

    return evaluate


def sample_from_poe_subset(model, subset: Sequence[int], data, mcmc_steps: int = 100,
                           n_lf: int = 10, eps_lf: float = 0.01, K: int = 1,
                           divide_prior: bool = True, return_acceptance: bool = False,
                           generator=None, z0: Optional[torch.Tensor] = None,
                           rho: Optional[torch.Tensor] = None,
                           u: Optional[torch.Tensor] = None):
    """HMC over ln q_PoE(z | x_subset) (jmvae_nf.py:332-437): `mcmc_steps`
    steps of `n_lf` leapfrogs of size `eps_lf` from a sample of the mixture
    of the subset's posteriors, K chains per datapoint. Returns (K, n_data,
    D); with `return_acceptance`, (samples, the mean accepted share over
    steps and chains)."""
    n_data = data[0].shape[0]
    data = [torch.cat([d] * K) for d in data]
    if z0 is None:
        z0 = sample_from_moe_subset(model, subset, data, generator)
    with torch.no_grad():
        log_density = model.poe_density(subset, data, divide_prior=divide_prior)
    z = z0.detach()
    log_q_and_grad = _evaluator(log_density, z)
    lnq, g = log_q_and_grad(z)
    acc = z.new_zeros(())
    for i in range(mcmc_steps):
        r = rho[i] if rho is not None else torch.randn(z.shape, generator=generator,
                                                       device=z.device, dtype=z.dtype)
        h0 = -lnq + 0.5 * torch.sum(r ** 2, dim=1)
        z_new, g_new = z, g
        for _ in range(n_lf):
            r_half = r + (eps_lf / 2) * g_new
            z_new = z_new + eps_lf * r_half
            lnq_new, g_new = log_q_and_grad(z_new)
            r = r_half + (eps_lf / 2) * g_new
        h = -lnq_new + 0.5 * torch.sum(r ** 2, dim=1)
        alpha = torch.exp(h0 - h)
        ui = u[i] if u is not None else torch.rand(z.shape[0], generator=generator,
                                                   device=z.device, dtype=z.dtype)
        accepted = ui < alpha
        moves = accepted.to(z.dtype)[:, None]
        z = z_new * moves + (1 - moves) * z
        # ln q and its gradient at the chain's new point, for the next step
        lnq = torch.where(accepted, lnq_new, lnq)
        g = torch.where(accepted[:, None], g_new, g)
        acc = acc + moves.mean()
    z = z.reshape(K, n_data, -1)
    if return_acceptance:
        return z, acc / mcmc_steps
    return z
