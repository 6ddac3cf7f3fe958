"""Paper figures: the port's copy of ``skyline_tpu/plots/paper_figures.py``.

Draws the published headline figures of the system this repository models
(time against dimensions, optimality against dimensions; dimensions 2, 3
and 4, anti-correlated, 1M rows) as ``REFERENCE_*``, and overlays the
port's own results from collector CSVs (``--ours D:Label=file.csv``) where
given.

    python -m skyline_tpu_torch.plots.paper_figures --ours 2:MR-Angle=a.csv
"""

from __future__ import annotations

import argparse

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd

DIMENSIONS = [2, 3, 4]

# the published results, anti-correlated 1M rows
REFERENCE_TIME_MS = {
    "MR-Dim": [19544, 27264, 716996],
    "MR-Grid": [17593, 26601, 691882],
    "MR-Angle": [17282, 27015, 766937],
}
REFERENCE_OPTIMALITY = {
    "MR-Dim": [0.7379, 0.6742, 0.25],
    "MR-Grid": [0.5415, 0.5906, 0.25],
    "MR-Angle": [0.7453, 0.6652, 0.25],
}


def plot_paper_figures(
    ours_time: dict[int, dict[str, float]] | None = None,
    ours_opt: dict[int, dict[str, float]] | None = None,
    prefix: str = "",
):
    """Write figure_5_replication.png (time) and figure_7_replication.png
    (optimality); returns the two paths."""
    t_path = f"{prefix}figure_5_replication.png"
    plt.figure(figsize=(10, 5))
    for algo, times in REFERENCE_TIME_MS.items():
        plt.plot(DIMENSIONS, times, marker="o", label=f"{algo} (reference)")
    if ours_time:
        dims = sorted(ours_time)
        for algo in sorted({a for m in ours_time.values() for a in m}):
            ys = [ours_time[d].get(algo) for d in dims]
            plt.plot(dims, ys, marker="^", linestyle="-.", label=f"{algo} (port)")
    plt.title("Processing Time vs Dimensionality (Cardinality 1 Million)")
    plt.xlabel("Dimensions")
    plt.ylabel("Processing Time (ms)")
    plt.yscale("log")
    plt.legend()
    plt.grid(True)
    plt.savefig(t_path, dpi=120)
    plt.close()

    o_path = f"{prefix}figure_7_replication.png"
    plt.figure(figsize=(10, 5))
    for algo, opts in REFERENCE_OPTIMALITY.items():
        plt.plot(DIMENSIONS, opts, marker="s", linestyle="--", label=f"{algo} (reference)")
    if ours_opt:
        dims = sorted(ours_opt)
        for algo in sorted({a for m in ours_opt.values() for a in m}):
            ys = [ours_opt[d].get(algo) for d in dims]
            plt.plot(dims, ys, marker="^", linestyle="-.", label=f"{algo} (port)")
    plt.title("Local Skyline Optimality vs Dimensionality (Cardinality 1 Million)")
    plt.xlabel("Dimensions")
    plt.ylabel("Optimality Ratio")
    plt.legend()
    plt.grid(True)
    plt.savefig(o_path, dpi=120)
    plt.close()
    return t_path, o_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ours", nargs="*", default=[],
                    help="D:Label=file.csv — last row's TotalTime/Optimality per dim")
    ap.add_argument("--prefix", default="")
    a = ap.parse_args(argv)
    ours_time: dict[int, dict[str, float]] = {}
    ours_opt: dict[int, dict[str, float]] = {}
    for item in a.ours:
        dpart, _, rest = item.partition(":")
        label, _, path = rest.partition("=")
        if not (dpart.isdigit() and label and path):
            ap.error(f"malformed --ours {item!r}; want 'D:Label=file.csv'")
        df = pd.read_csv(path)
        last = df.iloc[-1]
        ours_time.setdefault(int(dpart), {})[label] = float(last["TotalTime(ms)"])
        ours_opt.setdefault(int(dpart), {})[label] = float(last["Optimality"])
    for p in plot_paper_figures(ours_time or None, ours_opt or None, a.prefix):
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
