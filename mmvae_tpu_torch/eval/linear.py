"""Linear probes without scikit-learn, in torch on the device: the
counterparts of the JAX package's `sklearn.svm.LinearSVC` (dcca_train's
SVM probe, mmvae_tpu/cli/dcca_train.py:88-127) and of its hinge-loss
`sklearn.linear_model.SGDClassifier` (classify_latent,
mmvae_tpu/eval/latent_analysis.py:19-27), each at scikit-learn's defaults.

`LinearSVC`: the squared hinge with an L2 penalty, C = 1, one-vs-rest for
more than two classes, the intercept a feature of value intercept_scaling
(1) whose weight is regularised, as liblinear does:

    min_w  0.5 |w|^2 + C sum_i max(0, 1 - y_i w.[x_i, 1])^2.

The objective is strictly convex, so its minimiser is unique. liblinear
stops its trust-region Newton at tol 1e-4; here Newton's method in float64
(the generalised Hessian I + 2C X_A^T X_A of the margin violators A, a
backtracking line search) runs to the minimiser itself: it stops when the
gradient is at round-off, in a few steps.

`SGDClassifier`: the hinge loss, alpha 1e-4, the "optimal" step
1 / (alpha (t0 + t)) with t0 from Bottou's heuristic, the unregularised
intercept, max_iter 1000, tol 1e-3 on the epoch's summed loss with 5
epochs without improvement, samples shuffled each epoch (sgd_fast.pyx
`_plain_sgd`), one-vs-rest over the classes at once, each class stopping on
its own. The shuffles come from a torch.Generator and cannot reproduce
scikit-learn's, so the fit is scikit-learn's in distribution, not in value.

Labels are any sortable values; `classes_` are their sorted uniques, and
for two classes the one weight row scores classes_[1], as scikit-learn's.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

# scikit-learn's defaults, the only settings the probes use: LinearSVC's
# C and intercept_scaling (its max_iter caps the Newton steps here), and
# SGDClassifier's alpha, max_iter, tol and n_iter_no_change
SVC_C = 1.0
SVC_INTERCEPT_SCALING = 1.0
SVC_MAX_ITER = 1000
SGD_ALPHA = 1e-4
SGD_MAX_ITER = 1000
SGD_TOL = 1e-3
SGD_N_ITER_NO_CHANGE = 5


class _Linear:
    """`coef_` (k, d), `intercept_` (k,), `classes_`; k is 1 for two classes."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def _targets(self, y):
        """(classes, +-1 targets (k, n) in float64, one-vs-rest)."""
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError(f"one class in the labels ({self.classes_}); a probe needs two")
        pos = self.classes_[1:] if len(self.classes_) == 2 else self.classes_
        t = np.where(y[None, :] == pos[:, None], 1.0, -1.0)
        return torch.as_tensor(t, dtype=torch.float64, device=self.device)

    def _x(self, X):
        return torch.as_tensor(np.asarray(X), dtype=torch.float64, device=self.device)

    def decision_function(self, X) -> np.ndarray:
        x = self._x(X)
        scores = x @ self._w.T + self._b
        out = scores.cpu().numpy()
        return out[:, 0] if out.shape[1] == 1 else out

    def predict(self, X) -> np.ndarray:
        scores = self.decision_function(X)
        if scores.ndim == 1:
            return self.classes_[(scores > 0).astype(int)]
        return self.classes_[np.argmax(scores, axis=1)]

    def score(self, X, y) -> float:
        """Mean accuracy on (X, y)."""
        return float(np.mean(self.predict(X) == np.asarray(y)))

    @property
    def coef_(self) -> np.ndarray:
        return self._w.cpu().numpy()

    @property
    def intercept_(self) -> np.ndarray:
        return self._b.cpu().numpy()


class LinearSVC(_Linear):
    """scikit-learn's LinearSVC at its defaults (C 1, squared hinge, L2,
    intercept_scaling 1, one-vs-rest), solved exactly in at most
    SVC_MAX_ITER Newton steps. `n_iter_`: the steps the fit took."""

    def fit(self, X, y) -> "LinearSVC":
        x = self._x(X)
        x = torch.cat([x, x.new_full((len(x), 1), SVC_INTERCEPT_SCALING)], 1)
        t = self._targets(y)
        w, self.n_iter_ = _sq_hinge_newton(x, t, SVC_C, SVC_MAX_ITER)
        self._w, self._b = w[:, :-1], w[:, -1] * SVC_INTERCEPT_SCALING
        return self


def _sq_hinge_newton(x, t, C, max_iter):
    """The minimisers w (k, d) of 0.5 |w|^2 + C sum_i max(0, 1 - t_ki w.x_i)^2,
    one per row of the targets `t` (k, n), all at once: Newton steps on the
    generalised Hessian, halved until the objective falls (Armijo, 1e-4)."""
    k, d = t.shape[0], x.shape[1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    def parts(w):
        margin = 1 - t * (w @ x.T)  # (k, n)
        active = (margin > 0).to(x.dtype)
        f = 0.5 * (w * w).sum(1) + C * (active * margin ** 2).sum(1)
        grad = w - 2 * C * (active * margin * t) @ x
        return f, grad, active

    w = x.new_zeros(k, d)
    f, grad, active = parts(w)
    g0 = grad.norm(dim=1).clamp_min(1e-300)
    steps = 0
    for steps in range(1, max_iter + 1):
        hess = eye + 2 * C * torch.einsum("kn,ni,nj->kij", active, x, x)
        step = -torch.linalg.solve(hess, grad.unsqueeze(-1)).squeeze(-1)
        slope = (grad * step).sum(1)
        size = x.new_ones(k)
        while True:
            f_new, grad_new, active_new = parts(w + size[:, None] * step)
            bad = f_new > f + 1e-4 * size * slope
            if not bool(bad.any()) or float(size.min()) < 1e-12:
                break
            size = torch.where(bad, size / 2, size)
        w = w + size[:, None] * step
        f, grad, active = f_new, grad_new, active_new
        if bool((grad.norm(dim=1) <= 1e-12 * g0).all()):
            break
    return w, steps


class SGDClassifier(_Linear):
    """scikit-learn's SGDClassifier(loss="hinge", penalty="l2") at its
    defaults (alpha 1e-4, learning_rate "optimal", max_iter 1000, tol 1e-3,
    n_iter_no_change 5, shuffle, fit_intercept), the samples shuffled each
    epoch by `generator` (a CPU torch.Generator; default seed 0).
    `n_iter_`: the epochs of the class that ran longest."""

    def __init__(self, generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__(device)
        self.generator = generator or torch.Generator().manual_seed(0)

    def fit(self, X, y) -> "SGDClassifier":
        x = self._x(X)
        t = self._targets(y)  # (k, n)
        k, (n, d) = t.shape[0], x.shape
        alpha = SGD_ALPHA
        # Bottou's heuristic for the first step (sgd_fast.pyx): for the hinge
        # |dloss(-typw, 1)| = 1, so eta0 = typw
        typw = math.sqrt(1.0 / math.sqrt(alpha))
        t0 = 1.0 / (typw * alpha)
        w, b = x.new_zeros(k, d), x.new_zeros(k)
        running = torch.ones(k, dtype=torch.bool, device=self.device)
        best = torch.full((k,), math.inf, dtype=torch.float64, device=self.device)
        stale = torch.zeros(k, dtype=torch.int64, device=self.device)
        step, epochs = 1, 0
        for epoch in range(SGD_MAX_ITER):
            order = torch.randperm(n, generator=self.generator).to(self.device)
            xs, ts = x[order], t[:, order]
            live = running.to(x.dtype)
            loss = x.new_zeros(k)
            for i in range(n):
                eta = 1.0 / (alpha * (t0 + step - 1))
                p = w @ xs[i] + b
                z = p * ts[:, i]
                loss += torch.clamp(1 - z, min=0) * live
                update = eta * ts[:, i] * (z <= 1).to(x.dtype) * live
                # the L2 shrink, then the hinge's step (classes that stopped
                # keep their weights)
                w.mul_((1 - live * min(1.0, eta * alpha))[:, None]).addr_(update, xs[i])
                b.add_(update)
                step += 1
            epochs = epoch + 1
            stale = torch.where(loss > best - SGD_TOL * n, stale + 1, 0)
            best = torch.minimum(best, loss)
            running &= stale < SGD_N_ITER_NO_CHANGE
            if not bool(running.any()):
                break
        self._w, self._b, self.n_iter_ = w, b, epochs
        return self
