"""What a run feeds both sides, made from `--seed`: the paired image data,
the initial weights and the generators of the noise.

The data are uint8 images the size of the configuration's data sets,
drawn on the device, with class labels drawn on the host; the pairs follow
the reference's class-matched rule (a copy of it below). Weights are one
uniform draw on the device, cut into leaves and scaled by the reference's
kaiming bounds, handed to both sides by parameter name.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .reference import common

# streams of the generators a run draws from, beside its seed
STREAM_TRAIN_DATA, STREAM_TEST_DATA, STREAM_WEIGHTS, STREAM_ORDER, STREAM_NOISE, \
    STREAM_LIKELIHOOD, STREAM_WARMUP, STREAM_CHECK = range(1, 9)


def derived_seed(*keys: int) -> int:
    """A 63-bit seed from integer keys (numpy's SeedSequence): any run seed,
    however large, and a stream."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def generator(device, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(*keys))


def rand_match_on_idx(labels: Sequence[np.ndarray], max_d: int, dm: int,
                      rng: np.random.Generator) -> Tuple[np.ndarray, ...]:
    """Class-matched pairs (the reference's make-mnist-svhn-idx rule): for
    each class, the first min(count, max_d) examples of every modality,
    matched by `dm` random permutations."""
    sorted_idx = [np.argsort(l, kind="stable") for l in labels]
    sorted_lab = [l[si] for l, si in zip(labels, sorted_idx)]
    out: List[List[np.ndarray]] = [[] for _ in labels]
    for c in np.unique(sorted_lab[0]):
        per_mod = [si[sl == c] for si, sl in zip(sorted_idx, sorted_lab)]
        n = min(min(len(p) for p in per_mod), max_d)
        for _ in range(dm):
            for m, p in enumerate(per_mod):
                out[m].append(p[:n][rng.permutation(n)])
    return tuple(np.concatenate(o).astype(np.int32) for o in out)


class PairedData(NamedTuple):
    images: List[np.ndarray]   # per modality, (n_m, *shape) uint8
    tables: List[np.ndarray]   # per modality, (pairs,) int32 rows of `images`

    @property
    def pairs(self) -> int:
        return len(self.tables[0])


def make_data(seed: int, spec: dict, split: str, device) -> PairedData:
    """The `split` ("train" or "test") data of a configuration's `data`
    spec: for each modality spec[split][m] images of shape
    spec["modalities"][m], uniform uint8 on the device, labels uniform over
    spec["classes"]; pairs by `rand_match_on_idx`, the test pairs shuffled
    once, as the reference's test pairing is."""
    stream = STREAM_TRAIN_DATA if split == "train" else STREAM_TEST_DATA
    g = generator(device, seed, stream)
    images = [torch.randint(0, 256, (n, *shape), generator=g, device=device,
                            dtype=torch.uint8).cpu().numpy()
              for n, shape in zip(spec[split], spec["modalities"])]
    rng = np.random.default_rng(derived_seed(seed, stream))
    labels = [rng.integers(0, spec["classes"], n) for n in spec[split]]
    tables = rand_match_on_idx(labels, spec["max_d"], spec["dm"], rng)
    if split == "test":
        order = rng.permutation(len(tables[0]))
        tables = tuple(t[order] for t in tables)
    return PairedData(images, list(tables))


def make_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the reference `model` (built on the meta device
    or any other: only names and shapes are read), drawn in one uniform
    call on `device` and scaled to its kaiming bound."""
    bounds = common.init_bounds(model)
    named = list(model.named_parameters())
    missing = [n for n, _ in named if n not in bounds]
    if missing:
        raise ValueError(f"no init bound for {missing}")
    total = sum(p.numel() for _, p in named)
    u = torch.rand(total, generator=generator(device, seed, STREAM_WEIGHTS), device=device)
    out, start = {}, 0
    for name, p in named:
        out[name] = ((2.0 * u[start:start + p.numel()] - 1.0) * bounds[name]).view(p.shape)
        start += p.numel()
    return out


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into `model`'s parameters by name; both must name the
    same parameters."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError("the program's and the reference's parameters differ: "
                         f"{sorted(set(params) ^ set(weights))[:6]}")
    for name, p in params.items():
        p.copy_(weights[name])


def reference_model(ref, cfg: dict, seed: int, device) -> torch.nn.Module:
    """The reference's model on `device` with the run's initial weights."""
    model = ref.build(cfg).to(device)
    load_weights(model, make_weights(model, seed, device))
    return model


def noise(kinds, g: torch.Generator, device) -> List[torch.Tensor]:
    """One draw of each (kind, shape) in `kinds` from `g`."""
    return [common.draw_noise(kind, shape, g, device) for kind, shape in kinds]
