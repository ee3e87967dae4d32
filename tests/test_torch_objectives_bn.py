"""m_multi_elbos on jnf_mnist_fashion (the conv MNIST VAEs with BatchNorm)
against the JAX package in float64: its value, every parameter's gradient
and the running statistics after the pass, which the joint forward and
each unimodal VAE's forward and cross decodes update in turn
(`check_objective` of test_torch_objectives_tail.py). Apart from that
file, so that the test workers, which take whole files, run the two side
by side.
"""

import pytest
import torch

from test_torch_objectives_tail import check_objective


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_multi_elbos_on_batchnorm_vaes_matches_jax(monkeypatch):
    check_objective(monkeypatch, "m_multi_elbos", "bn", True, {})
