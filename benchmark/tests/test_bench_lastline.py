"""The result line: its keys, in order, "compared" last; the metrics of an
untraced run are the cell's end-to-end metrics; and without a CUDA card
run.py exits non-zero and prints no result."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import cells, harness


def test_the_last_line_of_a_run(run_small):
    r = run_small("mmvae_dreg.likelihood")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert harness.report(r) == 0
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1])
    assert list(last) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(last["metrics"]) == {"likelihood_pairs_per_s", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in last["metrics"].values())
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(json.loads(line).get("note") for line in lines[:-1])
    tail = err.getvalue().strip().splitlines()[-len(last["compared"]):]
    assert [line.split()[1] for line in tail] == list(last["compared"]) == ["mean_gap", "pair_gap"]


def test_a_run_with_jax_in_the_process_prints_no_result(run_small, monkeypatch):
    r = run_small("mmvae_dreg.likelihood")
    monkeypatch.setitem(sys.modules, "jax", sys)
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        assert harness.report(r) != 0
    assert out.getvalue() == ""


def test_without_a_card_run_py_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = subprocess.run([sys.executable, os.path.join(cells.BENCH_DIR, "run.py"), "--workload",
                        "mmvae_dreg.train", "--seed", "3000000000", "--seconds", "10",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=cells.ROOT)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
