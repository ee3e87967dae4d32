"""The plain reference's shared parts: distributions and their noise, the
MNIST and SVHN nets, the joint encoder, MADE with the unrolled
autoregressive solve, the chunked importance-sampling reduction and an
AMSGrad training loop with its skip of non-finite steps.

Plain PyTorch in float32, written from the JMVAE-NF paper's code (its
`bivae` package, which also holds its MMVAE after Shi et al. 2019). It
imports nothing of the program under test and takes nothing it made: the
benchmark hands both sides the same raw data, weights and noise.

Parameter names and layouts match the program's state dict, so that the
benchmark can hand both the same weights by name: Linear (out, in), Conv2d
(out, in, kh, kw), ConvTranspose2d (in, out, kh, kw), a MADE kernel (in, out).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LOG2PI = math.log(2.0 * math.pi)
ETA = 1e-6  # added to every std parameterization but the unimodal normal's
# the open interval a Laplace sample's uniform comes from
LAPLACE_U_MIN, LAPLACE_U_MAX = -1.0 + 1e-7, 1.0


# ---------------------------------------------------------------------------
# noise and distributions
# ---------------------------------------------------------------------------

def draw_noise(kind: str, shape, generator: torch.Generator, device, dtype=torch.float32):
    """One draw of a family's noise from `generator`: standard normal
    ("normal"), uniform in [0, 1) ("uniform"), or uniform in
    (-1 + 1e-7, 1) ("laplace", the law of JAX's laplace sampler)."""
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    r = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    if kind == "uniform":
        return r
    if kind == "laplace":
        return torch.clamp_min(r * (LAPLACE_U_MAX - LAPLACE_U_MIN) + LAPLACE_U_MIN, LAPLACE_U_MIN)
    raise ValueError(f"no noise law for {kind!r}")


def log_prob(kind: str, loc, scale, x):
    if kind == "normal":
        return -0.5 * ((x - loc) / scale) ** 2 - torch.log(scale) - 0.5 * LOG2PI
    if kind == "laplace":
        return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)
    raise ValueError(kind)


def prior_log_prob(kind: str, z):
    """ln p(z) under the standard prior of the family, summed over z's last axis."""
    if kind == "normal":
        return torch.sum(-0.5 * z * z - 0.5 * LOG2PI, dim=-1)
    return torch.sum(-torch.abs(z) - math.log(2.0), dim=-1)


def sample(kind: str, loc, scale, noise):
    """A reparameterised sample from its noise (`draw_noise`'s law)."""
    if kind == "normal":
        return loc + scale * noise
    if kind == "laplace":
        tiny = torch.finfo(noise.dtype).tiny
        return loc - scale * torch.sign(noise) * torch.log1p(-torch.clamp_min(noise.abs(), tiny))
    raise ValueError(kind)


def posterior_std(kind: str, log_var):
    """The unimodal posterior's std: the softmax trick for the Laplace
    (MMVAE), exp(log_var / 2) for the normal."""
    if kind == "laplace":
        return torch.softmax(log_var, dim=-1) * log_var.shape[-1] + ETA
    return torch.exp(0.5 * log_var)


def unit_normal_lpx(recon, x, event_dims: int):
    """ln N(x; recon, 1) summed over the last `event_dims` axes."""
    lp = -0.5 * (x - recon) ** 2 - 0.5 * LOG2PI
    return lp.flatten(lp.dim() - event_dims).sum(-1)


def gather(base_u8: np.ndarray, table: np.ndarray, rows: np.ndarray, device):
    """The pairs' images of one modality as float32 in [0, 1]."""
    return torch.from_numpy(base_u8[table[rows]]).to(device).to(torch.float32) / 255.0


# ---------------------------------------------------------------------------
# nets (the reference's MNIST MLP and SVHN conv nets, 20-wide latents)
# ---------------------------------------------------------------------------

class MLPEncoder(nn.Module):
    def __init__(self, latent: int, in_features: int, hidden: int = 512):
        super().__init__()
        self.Linear_0 = nn.Linear(in_features, hidden)
        self.embedding = nn.Linear(hidden, latent)
        self.log_var = nn.Linear(hidden, latent)

    def forward(self, x):
        h = F.relu(self.Linear_0(x.flatten(1)))
        return self.embedding(h), self.log_var(h)


class MLPDecoder(nn.Module):
    def __init__(self, latent: int, shape: Sequence[int], hidden: int = 512):
        super().__init__()
        self.shape = tuple(shape)
        self.Linear_0 = nn.Linear(latent, hidden)
        self.Linear_1 = nn.Linear(hidden, int(np.prod(shape)))

    def forward(self, z):
        h = F.relu(self.Linear_0(z.reshape(-1, z.shape[-1])))
        return torch.sigmoid(self.Linear_1(h)).reshape(*z.shape[:-1], *self.shape)


class EncoderSVHN(nn.Module):
    def __init__(self, latent: int, channels: int = 3, f: int = 32):
        super().__init__()
        self.Conv2d_0 = nn.Conv2d(channels, f, 4, 2, 1)
        self.Conv2d_1 = nn.Conv2d(f, 2 * f, 4, 2, 1)
        self.Conv2d_2 = nn.Conv2d(2 * f, 4 * f, 4, 2, 1)
        self.c1 = nn.Conv2d(4 * f, latent, 4, 2, 0)
        self.c2 = nn.Conv2d(4 * f, latent, 4, 2, 0)

    def forward(self, x):
        h = F.relu(self.Conv2d_0(x))
        h = F.relu(self.Conv2d_1(h))
        h = F.relu(self.Conv2d_2(h))
        return self.c1(h).flatten(1), self.c2(h).flatten(1)


class DecoderSVHN(nn.Module):
    def __init__(self, latent: int, channels: int = 3, f: int = 32):
        super().__init__()
        self.ConvTranspose2d_0 = nn.ConvTranspose2d(latent, 4 * f, 4, 1, 0)
        self.ConvTranspose2d_1 = nn.ConvTranspose2d(4 * f, 2 * f, 4, 2, 1)
        self.ConvTranspose2d_2 = nn.ConvTranspose2d(2 * f, f, 4, 2, 1)
        self.ConvTranspose2d_3 = nn.ConvTranspose2d(f, channels, 4, 2, 1)

    def forward(self, z):
        h = z.reshape(-1, z.shape[-1], 1, 1)
        h = F.relu(self.ConvTranspose2d_0(h))
        h = F.relu(self.ConvTranspose2d_1(h))
        h = F.relu(self.ConvTranspose2d_2(h))
        h = torch.sigmoid(self.ConvTranspose2d_3(h))
        return h.reshape(*z.shape[:-1], *h.shape[1:])


class JointEncoder(nn.Module):
    """q(z|x, y): each modality's encoder embedding, concatenated, one
    hidden ReLU layer, then the mean and std heads (std exp(h / 2) + ETA)."""

    def __init__(self, encoders: Sequence[nn.Module], latent: int, in_features: int,
                 hidden: int = 512):
        super().__init__()
        self.encoders = nn.ModuleList(encoders)
        self.Linear_0 = nn.Linear(in_features, hidden)
        self.fc21 = nn.Linear(hidden, latent)
        self.fc22 = nn.Linear(hidden, latent)

    def forward(self, xs):
        h = torch.cat([enc(x)[0] for enc, x in zip(self.encoders, xs)], dim=1)
        h = F.relu(self.Linear_0(h))
        return self.fc21(h), torch.exp(0.5 * self.fc22(h)) + ETA


# ---------------------------------------------------------------------------
# MADE and the masked autoregressive flow
# ---------------------------------------------------------------------------

def made_masks(features: int, hidden: Sequence[int]):
    """Sequential degrees: inputs 0..D-1, hidden units k mod (D - 1); a
    hidden mask lets a unit see degrees at or below its own, the head
    (mu and log-scale columns alike) only strictly lower ones."""
    degrees = [np.arange(features)] + [np.arange(h) % (features - 1) for h in hidden]
    masks = [(cur[None, :] >= prev[:, None]).astype(np.float32)
             for prev, cur in zip(degrees[:-1], degrees[1:])]
    head = (degrees[-1][:, None] < np.arange(features)[None, :]).astype(np.float32)
    return masks + [np.concatenate([head, head], axis=1)]


class MaskedDense(nn.Module):
    def __init__(self, in_features: int, features: int, mask: np.ndarray):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mask", torch.as_tensor(mask), persistent=False)

    def weight(self):
        return self.kernel * self.mask


class MADE(nn.Module):
    def __init__(self, features: int, hidden: Sequence[int]):
        super().__init__()
        masks = made_masks(features, hidden)
        widths = [features, *hidden]
        self.hidden = nn.ModuleList(MaskedDense(a, b, m)
                                    for a, b, m in zip(widths[:-1], widths[1:], masks[:-1]))
        self.out = MaskedDense(widths[-1], 2 * features, masks[-1])

    def layers(self):
        layers = [*self.hidden, self.out]
        return [l.weight() for l in layers], [l.bias for l in layers]


class ARSolve(nn.Module):
    """The sampling direction of one MADE block, solved one feature at a
    time (y_i = v_i exp(s_i(y)) + mu_i(y)), with its log-determinant
    sum_i s_i. A frozen copy of the plain unrolled solve; the hidden ReLU
    is max(z, 0). A module of its own so that a forward hook sees each
    solve's rows and widths."""

    def forward(self, ws: List[torch.Tensor], bs: List[torch.Tensor], v):
        d = v.shape[-1]
        y = torch.zeros_like(v)
        ld = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
        cols = torch.arange(d, device=v.device)
        for i in range(d):
            h = y
            for w, b in zip(ws[:-1], bs[:-1]):
                h = torch.maximum(h @ w + b, h.new_zeros(()))
            o = h @ ws[-1] + bs[-1]
            mu_i, s_i = o[..., i], o[..., i + d]
            y = torch.where(cols == i, (v[..., i] * torch.exp(s_i) + mu_i).unsqueeze(-1), y)
            ld = ld + s_i
        return y, ld


class MAF(nn.Module):
    """Masked autoregressive flow of MADE blocks, the features flipped after
    each block in the density direction; `inverse` is the sampling
    direction z0 -> z with its log|det J|."""

    def __init__(self, features: int, blocks: int = 2, hidden: Sequence[int] = (128,) * 3):
        super().__init__()
        self.made = nn.ModuleList(MADE(features, hidden) for _ in range(blocks))
        self.solve = ARSolve()

    def inverse(self, z0):
        z, ld = z0, torch.zeros(z0.shape[:-1], dtype=z0.dtype, device=z0.device)
        for made in reversed(self.made):
            ws, bs = made.layers()
            z, l = self.solve(ws, bs, torch.flip(z, dims=(-1,)))
            ld = ld + l
        return z, ld


# ---------------------------------------------------------------------------
# initial weights, importance sampling, training
# ---------------------------------------------------------------------------

def init_bounds(model: nn.Module) -> Dict[str, float]:
    """Each parameter's half-width of the uniform it starts from: kaiming
    uniform, sqrt(3 / fan_in) for weights and 1 / sqrt(fan_in) for biases
    (the MADE biases too, so that no hidden unit starts at a ReLU tie)."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear):
            fan = m.in_features
        elif isinstance(m, nn.ConvTranspose2d):
            fan = m.weight.shape[1] * m.weight[0, 0].numel()
        elif isinstance(m, nn.Conv2d):
            fan = m.weight[0].numel()
        elif isinstance(m, MaskedDense):
            fan = m.kernel.shape[0]
        else:
            continue
        for pname, p in m.named_parameters(recurse=False):
            bound = 1.0 / math.sqrt(fan)
            out[f"{name}.{pname}"] = bound if pname == "bias" else math.sqrt(3.0) * bound
    return out


def chunked_is(log_w: Callable, draw: Callable, n: int, K: int, bk: int, rows_per_call: int):
    """Per-datapoint ln (1/K) sum_k w_k: K / bk chunks of bk samples, each
    chunk's noise drawn for all n datapoints at once, its log-weights for
    P = rows_per_call / bk datapoints a call, the chunks' log-sum-exps then
    combined. log_w(sl, *noise) -> (P, bk)."""
    p = max(1, rows_per_call // bk)
    chunks = []
    for _ in range(K // bk):
        noise = draw()
        chunks.append(torch.cat([torch.logsumexp(log_w(sl, *(e[sl] for e in noise)), dim=-1)
                                 for sl in (slice(s, min(s + p, n)) for s in range(0, n, p))]))
    return torch.logsumexp(torch.stack(chunks), dim=0) - math.log(K)


class AMSGrad:
    """AMSGrad as optax writes it: the running max of the bias-corrected
    second moment, eps 1e-8 outside the root. A step whose loss or any
    gradient is not finite leaves the parameters and the moments as they
    were."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = list(params), lr, b1, b2, eps
        self.t = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, loss, grads) -> bool:
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)):
            return False
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, mu, nu, nmax in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            torch.maximum(nmax, nu / c2, out=nmax)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nmax) + self.eps))
        return True


def train_steps(model: nn.Module, loss_fn: Callable, batches, lr: float):
    """Runs the reference steps over `batches` (each the arguments of
    loss_fn after the model) from the model's weights as they are. Returns
    each step's loss, the first step's gradient per parameter name and the
    parameters after the last step."""
    names, params = zip(*model.named_parameters())
    opt = AMSGrad(params, lr)
    losses, first = [], None
    for args in batches:
        loss = loss_fn(model, *args)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        opt.step(loss.detach(), grads)
        losses.append(float(loss.detach()))
    return losses, first, {n: p.detach().clone() for n, p in zip(names, params)}
