"""The readings that a cell's limits are set from, in one process on the
card: for each seed, the numbers the check compares (a) for the program,
(b) for the control, the reference put in the program's place and run in
TF32, the precision below the configuration's float32 with TF32 off, and
(c) for a train cell, the reference in the program's place with half of
each batch left out and the loss taken over the rest, scaled back to the
whole batch; for a likelihood cell, the program's own bfloat16 path (its
compute_dtype policy) switched on for the same batch, and the program's
values with the first and the last pair swapped. The benchmark's own runs
do not run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 1]

One JSON line a seed, then one with each number's largest program
reading and smallest control and fault readings.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from benchmark import cells, harness  # noqa: E402


@contextlib.contextmanager
def tf32():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def half_batch(ref):
    """The reference's train loss over the first half of each batch, times 2."""
    class Half:
        def __getattr__(self, name):
            return getattr(ref, name)

        @staticmethod
        def train_loss(model, xs, noise, cfg):
            b = xs[0].shape[0] // 2
            return 2 * ref.train_loss(model, [x[:b] for x in xs], [n[:, :b] for n in noise], cfg)
    return Half()


def worst_leaves(prog, ref, n=4):
    """The leaves with the largest gaps of first-gradient and of change
    norms, each with its own norms, for the look behind a high reading."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        r, p = ref[key], prog[key]
        gaps = sorted(((abs(p[k] - v) / v if v else float("inf"), k, p[k], v)
                       for k, v in r.items()), reverse=True)[:n]
        out[key] = gaps
    return out


def swapped(values):
    """Each estimator's per-pair values with the first and last pair's
    values swapped."""
    out = {}
    for k, v in values.items():
        v = v.clone()
        v[[0, -1]] = v[[-1, 0]]
        out[k] = v
    return out


def program_bf16(job, run, state):
    """The program's per-pair values of test batch 0 under its bfloat16
    compute policy."""
    from mmvae_tpu_torch.core import precision

    undo = job._around_estimators(state, False)
    state["record"] = {}
    try:
        with precision.use("bfloat16"):
            job._protocol(run, state, job._batch(run, state, 0), job._generator(run, 0),
                          run.cell.traffic["K"])
    finally:
        undo()
    return state.pop("record")


def readings(cell, seed, seconds, device):
    run = harness.Run(cell, seed, device)
    job = cells.job_module(cell)
    state = job.setup(run)
    win = job.window(run, state, seconds, False)
    bf16 = program_bf16(job, run, state) if cell.job == "likelihood" else None
    job.release(state)
    run.free()
    out = {"seed": seed, "units": win["units"]}
    if cell.job == "train":
        ref = job.reference_readings(run, state)
        out["program"] = job.compare(state["readings"], ref)
        out["worst_leaves"] = worst_leaves(state["readings"], ref)
        with tf32():
            out["control"] = job.compare(job.reference_readings(run, state), ref)
        run.ref = half_batch(run.ref)
        out["half_batch"] = job.compare(job.reference_readings(run, state), ref)
    else:
        ref = job.reference_values(run, state, 0)
        out["program"] = job.compare(state["per_pair"][0], ref)
        out["pairs_swapped"] = job.compare(swapped(state["per_pair"][0]), ref)
        out["program_bf16"] = job.compare(bf16, ref)
        with tf32():
            out["control"] = job.compare(job.reference_values(run, state, 0), ref)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.5)
    a = p.parse_args()
    cell = cells.find(a.workload)
    device = torch.device("cuda", 0)
    from mmvae_tpu_torch.cli.common import torch_device

    torch_device(device)
    rows = []
    for s in a.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(cell, int(s), a.seconds, device)
        r["seconds"] = time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": a.workload, "seeds": len(rows)}
    for k in rows[0]["program"]:
        summary[k] = {"program_max": max(r["program"][k] for r in rows)}
        for side in ("control", "half_batch", "pairs_swapped", "program_bf16"):
            if side in rows[0]:
                summary[k][side + "_min"] = min(r[side][k] for r in rows)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
