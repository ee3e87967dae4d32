"""Adam / AMSGrad, and the DCCA Solver's RMSprop, written out to match
optax. Adam: mmvae_tpu/train/loop.py `_make_tx`, optax.amsgrad(1.0) or
optax.adam(1.0), then the update scaled by the learning rate.

optax's AMSGrad keeps the running max of the BIAS-CORRECTED second moment,
max(nu_max, nu / (1 - b2^t)), and divides by sqrt(nu_max) + eps.
torch.optim.Adam(amsgrad=True) keeps the max of the raw moment and
bias-corrects afterwards; the two differ from the second step on, so the
update is written here by hand (eps=1e-8, eps_root=0).

`step` takes an optional device-side `finite` flag (nan_guard): when it is
False the gradients are zeroed before the update and the old parameters and
moments are kept, without a host round trip.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..utils import trace


class Adam:
    def __init__(self, params: Sequence[torch.nn.Parameter], amsgrad: bool = True,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 clip_grad_norm: float = 0.0):
        self.params: List[torch.nn.Parameter] = list(params)
        self.amsgrad = amsgrad
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip = clip_grad_norm
        dev = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params] if amsgrad else None

    def _clip(self, grads):
        """optax.clip_by_global_norm: g * clip / ||g|| when ||g|| >= clip."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        return [torch.where(norm < self.clip, g, g / norm * self.clip) for g in grads]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float,
             finite: Optional[torch.Tensor] = None) -> None:
        with trace.span("optimizer.step"):
            grads = list(grads)
            if finite is not None:
                grads = [torch.where(finite, g, torch.zeros_like(g)) for g in grads]
            if self.clip > 0.0:
                grads = self._clip(grads)
            count = self.count + 1
            # the bias corrections in the parameters' precision, as optax takes
            # them in JAX's default float type (float64 under x64)
            t = count.to(self.params[0].dtype if self.params else torch.float32)
            bc1 = 1.0 - self.b1 ** t
            bc2 = 1.0 - self.b2 ** t

            def keep(new, old):
                return new if finite is None else torch.where(finite, new, old)

            for k, (p, g) in enumerate(zip(self.params, grads)):
                mu = (1.0 - self.b1) * g + self.b1 * self.mu[k]
                nu = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[k]
                mu_hat, nu_hat = mu / bc1, nu / bc2
                if self.amsgrad:
                    nu_max = torch.maximum(self.nu_max[k], nu_hat)
                    self.nu_max[k] = keep(nu_max, self.nu_max[k])
                    nu_hat = nu_max
                update = -(mu_hat / (torch.sqrt(nu_hat) + self.eps)) * lr
                p.copy_(keep(p + update, p))
                self.mu[k] = keep(mu, self.mu[k])
                self.nu[k] = keep(nu, self.nu[k])
            self.count = keep(count, self.count)


class RMSprop:
    """The DCCA Solver's optimizer written out to match optax
    (mmvae_tpu/dcca/train.py: optax.chain(add_decayed_weights(weight_decay),
    rmsprop(lr))). optax.rmsprop's defaults are not torch.optim.RMSprop's:
    decay 0.9 (torch's alpha is 0.99), eps inside the square root
    (g / sqrt(nu + eps); torch divides by sqrt(nu) + eps), and the second
    moment starts at 0. The weight decay is added to the gradient first."""

    def __init__(self, params: Sequence[torch.nn.Parameter], lr: float = 1e-3,
                 weight_decay: float = 1e-5, decay: float = 0.9, eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr, self.weight_decay, self.decay, self.eps = lr, weight_decay, decay, eps
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for k, (p, g) in enumerate(zip(self.params, grads)):
            g = g + self.weight_decay * p
            self.nu[k] = (1.0 - self.decay) * (g * g) + self.decay * self.nu[k]
            p.add_(-self.lr * (torch.rsqrt(self.nu[k] + self.eps) * g))
