"""The control on the card: the reference put in the program's place and
computed in TF32, the precision below the configurations' float32 with
TF32 off, must fail at least one of each cell's compared numbers, at the
cell's own size. Needs the card:

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_control.py
"""

import pytest
import torch

from benchmark import calibrate, cells


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the card computes")
    from mmvae_tpu_torch.cli.common import torch_device

    return torch_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mmvae_dreg.train", "jmvae_nf.likelihood", "mmvae_dreg.likelihood"])
def test_the_tf32_control_is_not_correct(card, name):
    cell = cells.find(name)
    r = calibrate.readings(cell, 2 ** 31 + 977, 0.5, card)
    assert all(v <= cell.limits[k]["limit"] for k, v in r["program"].items()), r["program"]
    assert any(v > cell.limits[k]["limit"] for k, v in r["control"].items()), r["control"]
