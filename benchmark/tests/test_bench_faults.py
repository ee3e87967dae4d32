"""The harness's check comes out false when the timed path is broken
underneath: each fault is planted in the program, the rest of a run is
driven on the CPU (the look for a card skipped) and `correct` must read
false. The cells run on one chip, so no exchange between chips can be
left out."""

import pytest
import torch


def _halved(orig):
    """A train step over the first half of the batch, its loss and
    gradients scaled back to the whole batch."""
    def loss_and_grads(self, xs, beta_kl=1.0, epoch=1, noise=None, block=None):
        b = xs[0].shape[0] // 2
        loss, details, grads, finite = orig(self, [x[:b] for x in xs], beta_kl, epoch,
                                            [n[:, :b] for n in noise], block)
        return 2 * loss, details, [2 * g for g in grads], finite
    return loss_and_grads


def _altered(orig):
    def train_step(self, *a, **k):
        loss, details = orig(self, *a, **k)
        return loss * (1 + 1e-3), details
    return train_step


def _nonfinite_after(orig, n):
    """A train step whose first gradient leaf is NaN from call n + 1 on, so
    that nan_guard skips the update while the loss stays finite."""
    calls = [0]

    def loss_and_grads(self, *a, **k):
        loss, details, grads, finite = orig(self, *a, **k)
        calls[0] += 1
        if calls[0] > n:
            grads = [grads[0] * float("nan")] + list(grads[1:])
            finite = finite & torch.isfinite(grads[0]).all()
        return loss, details, grads, finite
    return loss_and_grads


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "loss_altered",
                                   "window_steps_skipped"])
def test_train_faults_are_caught(run_small, small_cell, monkeypatch, fault):
    from mmvae_tpu_torch.train import loop, optim

    if fault == "state_unchanged":
        monkeypatch.setattr(optim.Adam, "step", lambda self, grads, lr, finite=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(loop.Trainer, "loss_and_grads", _halved(loop.Trainer.loss_and_grads))
    elif fault == "window_steps_skipped":  # set-up's steps are sound, the window's skipped
        n = small_cell("mmvae_dreg.train").traffic["warmup_steps"]
        monkeypatch.setattr(loop.Trainer, "loss_and_grads",
                            _nonfinite_after(loop.Trainer.loss_and_grads, n))
    else:
        monkeypatch.setattr(loop.Trainer, "train_step", _altered(loop.Trainer.train_step))
    r = run_small("mmvae_dreg.train")
    assert r["correct"] is False, r["compared"]


def _chunked(orig, fault):
    def chunked_is(*a, **k):
        v = orig(*a, **k)
        if fault == "half_batch":  # the second half's values are the first half's
            h = v.shape[0] // 2
            return torch.cat([v[:v.shape[0] - h], v[:h]])
        if fault == "pairs_swapped":  # the first and the last pair's values trade places
            return torch.cat([v[-1:], v[1:-1], v[:1]])
        return torch.cat([v[:1] * (1 + 1e-3), v[1:]])
    return chunked_is


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered", "pairs_swapped"])
@pytest.mark.parametrize("cell", ["jmvae_nf.likelihood", "mmvae_dreg.likelihood"])
def test_likelihood_faults_are_caught(run_small, monkeypatch, cell, fault):
    from mmvae_tpu_torch.eval import likelihoods

    monkeypatch.setattr(likelihoods, "_chunked_is", _chunked(likelihoods._chunked_is, fault))
    r = run_small(cell)
    assert r["correct"] is False, r["compared"]
