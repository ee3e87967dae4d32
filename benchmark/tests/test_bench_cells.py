"""The harness finds a cell, its configuration, traffic, limits, reference
and per-layer readers by name from BENCHMARK.json and data files alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_of_the_benchmark_resolves():
    spec = cells.load_benchmark()
    for w in spec["workloads"]:
        c = cells.find(w["name"])
        assert c.chips == 1
        job = cells.job_module(c)
        ref = cells.reference_module(c)
        for fn in ("setup", "window", "check", "work", "release", "compare"):
            assert callable(getattr(job, fn))
        need = ("build", "train_noise", "train_loss") if c.job == "train" else ("build", "likelihood")
        for fn in need:
            assert callable(getattr(ref, fn)), (w["name"], fn)
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        assert len(c.end_to_end) >= 2 and c.per_layer
        assert set(c.limits) and all("limit" in v for v in c.limits.values())
        for m in c.per_layer:
            read, _ = cells.metric_reader(m["name"])
            assert callable(read)
            assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_the_benchmark_file_has_its_keys_and_well_formed_names():
    spec = cells.load_benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert set(spec["configs"][0]) == {"name", "source", "file", "reduced", "why"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))


def test_a_new_cell_traffic_and_metric_are_found_from_data_files_alone(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(cells.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = cells.load_benchmark()
    spec["workloads"].append({"name": "mmvae_dreg.train_b256", "config": "mmvae_dreg",
                              "traffic": "train_b256", "chips": 1, "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("mmvae_dreg.train_b256")
    for m in spec["per_layer"]:
        if m["name"].endswith(".train"):
            m["workloads"].append("mmvae_dreg.train_b256")
    spec["per_layer"].append({"name": "steps.train_b256", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "Trainer and optimizer",
                              "moves": "train_pairs_per_s", "workloads": ["mmvae_dreg.train_b256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "traffic" / "train_b256.json").write_text(json.dumps(
        {"job": "train", "warmup_steps": 4, "checked_steps": 3, "epoch": 1, "trace_after_s": 2,
         "trace_steps": 8}))
    shutil.copy(bench / "limits" / "mmvae_dreg.train.json", bench / "limits" / "mmvae_dreg.train_b256.json")
    (bench / "metrics" / "steps.train_b256.py").write_text(
        "def read(r):\n    return r['window']['units'] * r['data']['scale']\n")
    (bench / "metrics" / "steps.train_b256.json").write_text('{"scale": 2}')

    c = cells.find("mmvae_dreg.train_b256", root=str(root), bench_dir=str(bench))
    assert c.traffic["trace_steps"] == 8 and c.job == "train"
    assert c.config["config"]["K"] == 30
    assert [m["name"] for m in c.per_layer] == ["device_idle_share.train", "mfu.train",
                                                "launches_per_step.train", "steps.train_b256"]
    assert "train_pairs_per_s" in {m["name"] for m in c.end_to_end}
    read, data = cells.metric_reader("steps.train_b256", str(bench))
    assert read({"window": {"units": 21}, "data": data}) == 42
    assert cells.reference_module(c).__name__ == "benchmark.reference.mmvae_dreg"


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.find("no_such.cell")
