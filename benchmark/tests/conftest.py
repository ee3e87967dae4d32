"""Shared pieces of the benchmark's tests: the repository root on the path,
the `cuda` marker, one torch thread, and cells cut to a size the CPU runs in
seconds (the harness and its check as they are, on smaller data, batches
and samples)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips with a reason where there is none)")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# the CPU's tolerances for the likelihood cells' gaps: at 8 pairs and 20
# samples a pair the mean gap's float32 rounding averages over 500 times
# fewer values than on the card (measured up to 1.2e-7 on this CPU), and
# the pair gap over fewer samples a pair
CPU_MEAN_GAP = 1e-6
CPU_PAIR_GAP = 1e-6


def small_cell(name, **traffic):
    """The cell `name` with its data, batch and samples cut for the CPU."""
    from benchmark import cells

    c = cells.find(name)
    c.config = copy.deepcopy(c.config)
    c.config["data"].update(train=[600, 700], test=[100, 260], max_d=30, dm=2)
    c.config["config"].update(batch_size=8, K=3)
    small = {"test_batch": 8, "K": 20, "batch_size_K": 10, "warmup_K": 10, "rows_per_call": 40}
    c.traffic = {**c.traffic, **(small if c.job == "likelihood" else {}), **traffic}
    if c.job == "likelihood":
        c.limits = {"mean_gap": {**c.limits["mean_gap"], "limit": CPU_MEAN_GAP},
                    "pair_gap": {**c.limits.get("pair_gap", {}), "limit": CPU_PAIR_GAP}}
    return c


def run_small(name, seed=2 ** 31 + 12345, seconds=0.5, **traffic):
    import time

    import torch

    from benchmark import harness

    return harness.execute(small_cell(name, **traffic), seed, seconds, False,
                           torch.device("cpu"), time.perf_counter())


@pytest.fixture(name="small_cell")
def _small_cell():
    return small_cell


@pytest.fixture(name="run_small")
def _run_small():
    return run_small
