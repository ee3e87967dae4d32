"""Conditional FID (mmvae_tpu/eval/fid.py; reference analysis/pytorch_fid/
and modalities/mnist_svhn.py:13-66).

- The Frechet distance (fid_score.py:148-200).
- The FID InceptionV3 of pytorch-fid (inception.py:16-345), up to its
  2048-d pool3 features, with the FID quirks of its "Patch" comments:
  InceptionA, InceptionC and InceptionE's first block pool with
  count_include_pad=False, InceptionE's second block pools its last branch
  by max; BatchNorm eps 1e-3; the input mapped to 2x - 1. Its modules are
  named as pytorch-fid's state dict (`Conv2d_1a_3x3.conv.weight`,
  `Mixed_5b.branch1x1.bn.running_mean`, ...), so that the published
  checkpoint pt_inception-2015-12-05-6726825d.pth loads as it is
  (`load_fid_weights`). Without weights the net runs at flax's random
  init, drawn from a seeded torch.Generator (`init_inception`).
- The per-direction cross-modal FID over any encoders: the InceptionV3
  (`make_inception_fn`, validate's default) or the eval classifiers'
  penultimate features (`classifiers.make_feature_fn`, the reference's
  Quality_assess.py custom-encoder pattern). With `compute_prd` the same
  activations also give each direction's PRD (eval/prd.py).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .generation import Noise, sample_from_conditional


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) (fid_score.py:148-200)."""
    import scipy.linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def activation_statistics(acts: np.ndarray):
    return np.mean(acts, axis=0), np.cov(acts, rowvar=False)


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def fid_preprocess(x: torch.Tensor) -> torch.Tensor:
    """NCHW in [0, 1] -> (N, 3, 299, 299): the bilinear resize
    (align_corners=False), a 1-channel input padded with two zero channels
    (modalities/mnist_svhn.py:17, utils.py:315-320)."""
    y = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
    if y.shape[1] == 1:
        y = torch.cat([y, torch.zeros_like(y), torch.zeros_like(y)], dim=1)
    return y


# ---------------------------------------------------------------------------
# InceptionV3 (pytorch-fid's FIDInceptionV3)
# ---------------------------------------------------------------------------

class FrozenBatchNorm(nn.Module):
    """BatchNorm at its running statistics, the only mode the FID net runs
    in. The buffers and parameters are pytorch-fid's (weight, bias,
    running_mean, running_var); its checkpoint's num_batches_tracked has no
    use here."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """A convolution without bias, BatchNorm (eps 1e-3), ReLU (fid.py:73-90)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                              bias=False)
        self.bn = FrozenBatchNorm(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x, count_include_pad: bool):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    """FIDInceptionA: its pool branch averages without the padding."""

    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, False))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    """FIDInceptionC: its pool branch averages without the padding."""

    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool(x, False))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """FIDInceptionE_1 (pool "avg": an average without the padding) and
    FIDInceptionE_2 (pool "max": a 3x3 max pool of stride 1)."""

    def __init__(self, in_ch: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "avg":
            bp = _avg_pool(x, False)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """pytorch-fid's InceptionV3 up to the 2048-d pool3 features
    (fid.py:198-224). Input: NCHW in [0, 1] at any size the strides allow
    (299 x 299 after `fid_preprocess`); the net maps it to 2x - 1 itself."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = 2 * x - 1
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return torch.mean(x, dim=(2, 3))


def init_inception(model: InceptionV3FID, generator: torch.Generator) -> InceptionV3FID:
    """flax's init of JAX's net, in distribution (its threefry draws cannot
    be reproduced): each kernel lecun-normal, a normal truncated to
    [-2, 2] of std sqrt(1 / fan_in) / 0.8796..., fan_in taken as flax takes
    it for JAX's (O, I, kh, kw) declaration (fid.py:83-84) with in_axis -2
    and out_axis -1: kh * O * I; BatchNorm at scale 1, bias 0, mean 0,
    var 1. In place; returns `model`."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                o, i, kh, _ = m.weight.shape
                std = math.sqrt(1.0 / (kh * o * i)) / _TRUNC_STD
                w = torch.empty(m.weight.shape, dtype=torch.float64)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                m.weight.copy_(w * std)
            elif isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


# the std of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978

# the seed of the random net `make_inception_fn` builds without weights
# (JAX's inits from PRNGKey(0), mmvae_tpu/eval/fid.py:331)
FID_INIT_SEED = 0

# the published pytorch-fid weights (inception.py:13) embed the first 8
# sha256 hex chars in the filename, per the torch.hub convention
FID_WEIGHTS_NAME = "pt_inception-2015-12-05-6726825d.pth"
FID_WEIGHTS_SHA256_PREFIX = "6726825d"


def verify_fid_weights(path: str) -> str:
    """Hash-check a FID weights file before use. Returns the sha256 hex.

    The expected prefix is parsed from the filename's ``-<8hex>.pth``
    suffix (torch.hub's download convention, which pytorch-fid's
    FID_WEIGHTS_URL follows, inception.py:13); a file named like the
    published checkpoint but with other bytes is rejected. Files without a
    hash-suffixed name pass (custom weights), their digest printed for the
    record."""
    import hashlib
    import re

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    digest = h.hexdigest()
    m = re.search(r"-([0-9a-f]{8,})\.pth$", os.path.basename(path))
    if m and not digest.startswith(m.group(1)):
        raise ValueError(
            f"FID weights hash mismatch for {path}: sha256={digest} does "
            f"not start with filename-embedded prefix {m.group(1)}")
    print(f"fid weights {os.path.basename(path)}: sha256={digest}")
    return digest


def load_fid_weights(model: InceptionV3FID, path: str) -> InceptionV3FID:
    """A pytorch-fid checkpoint (the state dict of its FIDInceptionV3, or a
    module holding one) into `model`, strictly: the classifier head
    (``fc.*``, inception.py:193) and BatchNorm's ``num_batches_tracked`` are
    ignored; any other checkpoint key the net does not take, or a key of
    the net the checkpoint lacks, raises (load_torch_inception_weights,
    fid.py:261-303). Returns `model`."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    own = model.state_dict()
    leftovers = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if leftovers or missing:
        raise ValueError(
            f"FID checkpoint {path} does not fit the net (wrong file?): unconsumed keys "
            f"{leftovers[:8]}{' ...' if len(leftovers) > 8 else ''}, missing keys "
            f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    model.load_state_dict(sd, strict=True)
    return model


def make_inception_fn(weights_path: Optional[str] = None, device="cuda", batch: int = 64):
    """wrapper_inception (inception.py:332-345): images -> (N, 2048)
    activations, as float32 numpy, `batch` images a call of the net on
    `device` in float32. Images: NCHW in [0, 1], numpy or torch, any size
    and 1 or 3 channels (`fid_preprocess`). Without `weights_path` the net
    is flax's random init drawn from seed `FID_INIT_SEED`
    (`init_inception`); with it, the file is hash-checked
    (`verify_fid_weights`) and loaded strictly. On cuda TF32 is turned off
    for matrix products and cuDNN convolutions."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = InceptionV3FID()
    if weights_path:
        verify_fid_weights(weights_path)
        load_fid_weights(model, weights_path)
    else:
        init_inception(model, torch.Generator().manual_seed(FID_INIT_SEED))
    model = model.to(device, torch.float32).eval()

    @torch.no_grad()
    def activations(images) -> np.ndarray:
        images = torch.as_tensor(images)
        out = []
        for s in range(0, len(images), batch):
            x = images[s:s + batch].to(device, torch.float32)
            out.append(model(fid_preprocess(x)).cpu().numpy())
        return np.concatenate(out)

    activations.model = model
    return activations


def cross_modal_fid(model, loader, noise_for_batch: Callable[[int], Noise],
                    encoder_fn, n_batches: Optional[int] = None, verbose: bool = False,
                    compute_prd: bool = False, prd_curve_dir: Optional[str] = None,
                    prd_generator: Optional[torch.Generator] = None):
    """Conditional FID over all ordered cross pairs: activations of the real
    test data against those of samples generated from the other modality,
    one conditional sample per datapoint, batch bi's from
    `noise_for_batch(bi)`. Keys as the reference: `fid_{target}` for two
    modalities, `fid_{src}_{target}` for more (modalities/trimodal.py:60-78).

    encoder_fn: one callable for every modality or a list of per-modality
    callables, each x -> (rows, features) numpy activations.
    n_batches=None takes the whole test loader (mnist_svhn.py:26-33).

    compute_prd adds `prd_f8_{suffix}` and `prd_f1_8_{suffix}` per
    direction, from the first min(generated, real) rows of the same
    activations (prd_score.py:139), the clusterings seeded from
    `prd_generator`, on the model's device. With `prd_curve_dir` the curve
    is saved as prd_curve_{suffix}.npz (precision, recall) and drawn as
    prd_curve_{suffix}.png with its JSON."""
    t0 = time.time()

    def _mark(msg):
        if verbose:
            print(f"  [fid +{time.time() - t0:8.3f}s] {msg}", flush=True)

    p = next(model.parameters())
    n_mod, enc = None, None
    ref_acts: List[List[np.ndarray]] = []
    gen_acts: dict = {}
    for bi, (xs, _) in enumerate(loader):
        if n_batches is not None and bi >= n_batches:
            break
        xs = [torch.as_tensor(np.asarray(x)).to(p.device, p.dtype) for x in xs]
        if n_mod is None:
            n_mod = len(xs)
            enc = (list(encoder_fn) if isinstance(encoder_fn, (list, tuple))
                   else [encoder_fn] * n_mod)
            if len(enc) != n_mod:
                raise ValueError(f"{len(enc)} encoders for {n_mod} modalities")
            ref_acts = [[] for _ in range(n_mod)]
            gen_acts = {(s, t): [] for s in range(n_mod) for t in range(n_mod) if s != t}
        for m in range(n_mod):
            ref_acts[m].append(enc[m](xs[m]))
        gen = sample_from_conditional(model, xs, noise_for_batch(bi), n=1)
        for (src, tgt), acc in gen_acts.items():
            acc.append(enc[tgt](gen[src][tgt][0]))
        _mark(f"batch {bi}: activations")

    ref_cat = [np.concatenate(r) for r in ref_acts]
    ref_stats = [activation_statistics(r) for r in ref_cat]
    fids = {}
    for (src, tgt), acc in gen_acts.items():
        gen_cat = np.concatenate(acc)
        mu1, s1 = ref_stats[tgt]
        mu2, s2 = activation_statistics(gen_cat)
        keysuf = f"{tgt}" if n_mod == 2 else f"{src}_{tgt}"
        fids[f"fid_{keysuf}"] = calculate_frechet_distance(mu1, s1, mu2, s2)
        _mark(f"frechet distance {keysuf}")
        if compute_prd:
            from . import prd

            n = min(len(gen_cat), len(ref_cat[tgt]))
            precision, recall = prd.compute_prd_from_embedding(
                gen_cat[:n], ref_cat[tgt][:n], generator=prd_generator, device=p.device)
            f8, f18 = prd.prd_to_max_f_beta_pair(precision, recall)
            fids[f"prd_f8_{keysuf}"] = f8
            fids[f"prd_f1_8_{keysuf}"] = f18
            if prd_curve_dir:
                os.makedirs(prd_curve_dir, exist_ok=True)
                base = os.path.join(prd_curve_dir, f"prd_curve_{keysuf}")
                np.savez(base + ".npz", precision=precision.cpu().numpy(),
                         recall=recall.cpu().numpy())
                prd.plot_prd_curves([(f"F8={f8:.3f} F1/8={f18:.3f}", precision, recall)],
                                    base + ".png")
            _mark(f"prd {keysuf}")
    return fids

