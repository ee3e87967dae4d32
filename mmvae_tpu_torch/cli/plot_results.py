"""Result plotting (mmvae_tpu/cli/plot_results.py; the reference's
paper-figure scripts tests/ablation_n_made.py, analysis/plot_prds_*): metric
comparisons, loss curves and PRD curves drawn from run dirs.

    python -m mmvae_tpu_torch.cli.plot_results --runs runA runB --metric acc_0_1 \\
        --labels "1 made" "2 made" --out ablation.png
    python -m mmvae_tpu_torch.cli.plot_results --runs runA runB --losses --out losses.png
    python -m mmvae_tpu_torch.cli.plot_results --runs runA runB --prd-curves \\
        --direction 0 --out prds.png

--metric draws each run's metrics.json mean with its std as an error bar,
one point per run; --losses each run's losses.json train (solid) and val
(dashed) curves; --prd-curves each run's prd_curve_<direction>.npz, written
by `validate --prd`, on one precision/recall figure. The figures have no
text: the series, labels and legend order go beside the PNG as
<out>.json (vis.line_plot).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot metrics, losses or PRD curves of runs")
    parser.add_argument("--runs", nargs="+", required=True,
                        help="run dirs containing metrics.json")
    parser.add_argument("--metric", type=str, default="acc_0_1")
    parser.add_argument("--labels", nargs="*", default=None)
    parser.add_argument("--out", type=str, default="plot.png")
    parser.add_argument("--losses", action="store_true",
                        help="plot losses.json training curves instead")
    parser.add_argument("--prd-curves", action="store_true",
                        help="overlay the runs' stored PRD curves (prd_curve_<direction>.npz "
                        "from validate --prd)")
    parser.add_argument("--direction", type=str, default="0",
                        help="PRD direction suffix: the <dir> in prd_curve_<dir>.npz")
    info = parser.parse_args(argv)

    if info.labels and len(info.labels) != len(info.runs):
        parser.error(f"--labels got {len(info.labels)} labels for {len(info.runs)} runs "
                     "(must match, or omit --labels to use run-dir basenames)")
    labels = info.labels or [os.path.basename(r.rstrip("/")) for r in info.runs]

    import numpy as np

    from ..vis import line_plot

    if info.prd_curves:
        from ..eval.prd import plot_prd_curves

        curves = []
        for run, lab in zip(info.runs, labels):
            d = np.load(os.path.join(run, f"prd_curve_{info.direction}.npz"))
            curves.append((lab, d["precision"], d["recall"]))
        plot_prd_curves(curves, info.out)
    elif info.losses:
        series = []
        for run, lab in zip(info.runs, labels):
            with open(os.path.join(run, "losses.json")) as f:
                hist = json.load(f)
            for key, name, dashed in (("train_loss", "train", False), ("test_loss", "val", True)):
                y = hist[key]
                series.append({"label": f"{lab} {name}", "x": np.arange(len(y)), "y": y,
                               "dashed": dashed})
        line_plot(series, info.out, xlabel="epoch", ylabel="loss")
    else:
        ys, errs = [], []
        for run in info.runs:
            with open(os.path.join(run, "metrics.json")) as f:
                entry = json.load(f)[info.metric]
            ys.append(entry["mean"] if isinstance(entry, dict) else entry)
            errs.append(entry.get("std", 0.0) if isinstance(entry, dict) else 0.0)
        xs = np.arange(len(ys))
        line_plot([{"label": info.metric, "x": xs, "y": ys, "yerr": errs, "marker": True}],
                  info.out, xlim=(-0.5, len(ys) - 0.5), xlabel="run", ylabel=info.metric,
                  xticklabels=labels)
    print("wrote", info.out)
    return info.out


if __name__ == "__main__":
    main()
