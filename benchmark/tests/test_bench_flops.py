"""flops.py against hand sums: the four nets' multiply-adds by layer, the
training multiplier, the MADE solve, and the cells' totals."""

import torch

from benchmark import cells, flops
from benchmark.reference import common, jmvae_nf, mmvae_dreg

ROWS = 3


def _forward(net, x):
    return flops.count(lambda: net(x), net)


def test_the_mnist_mlp_encoder_and_decoder():
    with torch.device("meta"):
        enc, dec = common.MLPEncoder(20, 784), common.MLPDecoder(20, (1, 28, 28))
    assert _forward(enc, torch.empty(ROWS, 1, 28, 28, device="meta"))["forward"] == \
        2 * ROWS * (784 * 512 + 2 * 512 * 20)
    assert _forward(dec, torch.empty(ROWS, 20, device="meta"))["forward"] == \
        2 * ROWS * (20 * 512 + 512 * 784)


def test_the_svhn_conv_encoder_and_decoder():
    with torch.device("meta"):
        enc, dec = common.EncoderSVHN(20), common.DecoderSVHN(20)
    # output pixels * out channels * in channels * 4 * 4, per conv
    macs = 16 * 16 * 32 * 3 * 16 + 8 * 8 * 64 * 32 * 16 + 4 * 4 * 128 * 64 * 16 + 2 * 20 * 128 * 16
    assert _forward(enc, torch.empty(ROWS, 3, 32, 32, device="meta"))["forward"] == 2 * ROWS * macs
    # input elements * out channels * 4 * 4, per transposed conv
    macs = 20 * 128 * 16 + 128 * 4 * 4 * 64 * 16 + 64 * 8 * 8 * 32 * 16 + 32 * 16 * 16 * 3 * 16
    assert _forward(dec, torch.empty(ROWS, 20, device="meta"))["forward"] == 2 * ROWS * macs


def test_training_counts_the_input_gradient_only_where_the_input_needs_one():
    with torch.device("meta"):
        dec = common.MLPDecoder(20, (1, 28, 28))
    f = 2 * ROWS * (20 * 512 + 512 * 784)
    data = _forward(dec, torch.empty(ROWS, 20, device="meta"))
    latent = _forward(dec, torch.empty(ROWS, 20, device="meta", requires_grad=True))
    assert data["train"] == 2 * f + 2 * ROWS * 512 * 784   # the first layer's input is data
    assert latent["train"] == 3 * f


def test_solve_flops_by_hand_and_through_the_reference_flow():
    # D = 20, three hidden layers of 128, 10,000 rows: 19 steps of a rank-1
    # first-layer term, two 128 x 128 layers and the two head columns
    assert flops.solve_flops(10_000, [20, 128, 128, 128, 40]) == \
        2 * 10_000 * 19 * (128 + 2 * 128 * 128 + 2 * 128)
    bound_ms = flops.solve_flops(10_000, [20, 128, 128, 128, 40]) / flops.PEAK_FLOPS["float32"] * 1e3
    assert abs(bound_ms - 0.18803) < 1e-5
    with torch.device("meta"):
        maf = common.MAF(20)
    c = flops.count(lambda: maf.inverse(torch.empty(5, 7, 20, device="meta")), maf)
    assert c["solve"] == 2 * flops.solve_flops(35, [20, 128, 128, 128, 40]) == c["forward"]


def test_the_cells_work():
    c = cells.find("mmvae_dreg.train")
    step = flops.train_step(mmvae_dreg, c.config["config"], 128, c.config["data"]["modalities"])
    assert step == 235_955_814_400
    c = cells.find("jmvae_nf.likelihood")
    batch = flops.likelihood_batch(jmvae_nf, c.config["config"], 500, 1000, 100,
                                   c.config["data"]["modalities"])
    # 400 solves of 10,000 rows a test batch (the conditionals' and the bis
    # joints' flow samples, two MADE blocks each)
    assert batch["solve"] == 400 * flops.solve_flops(10_000, [20, 128, 128, 128, 40])
    assert batch["forward"] == 30_249_967_616_000
