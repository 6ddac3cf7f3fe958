"""Performance dashboard: the port's copy of ``skyline_tpu/plots/performance.py``.

A 2x2 figure over one or more collector CSVs (``Label=file.csv`` arguments):
ingestion time against volume, total time against volume, optimality, and a
local-against-global stacked bar of each run's final batch.

    python -m skyline_tpu_torch.plots.performance A=a.csv B=b.csv [--out f.png]
"""

from __future__ import annotations

import argparse
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd


def plot_performance(file_map: dict[str, str], out: str = "performance_analysis.png") -> str:
    fig, ((ax_ingest, ax_total), (ax_opt, ax_break)) = plt.subplots(
        2, 2, figsize=(14, 10)
    )
    fig.suptitle("Skyline Streaming Performance", fontsize=14)

    first = True
    for label, path in file_map.items():
        df = pd.read_csv(path).sort_values(by="Records")
        x = df["Records"] / 1_000_000
        ax_ingest.plot(x, df["IngestTime(ms)"], marker=".", label=label)
        ax_total.plot(x, df["TotalTime(ms)"] / 1000, marker="o", label=label)
        ax_opt.plot(x, df["Optimality"], marker="x", linestyle="--", label=label)
        last = df.iloc[-1]
        ax_break.bar(label, last["LocalTime(ms)"],
                     label="Local CPU" if first else "", color="skyblue")
        ax_break.bar(label, last["GlobalTime(ms)"], bottom=last["LocalTime(ms)"],
                     label="Global Merge" if first else "", color="orange")
        first = False

    ax_ingest.set_title("Ingestion Time vs Data Volume")
    ax_ingest.set_xlabel("Records (Millions)")
    ax_ingest.set_ylabel("Time (ms)")
    ax_total.set_title("Total Processing Time (Scalability)")
    ax_total.set_xlabel("Records (Millions)")
    ax_total.set_ylabel("Time (Seconds)")
    ax_opt.set_title("Local Optimality Ratio")
    ax_opt.set_xlabel("Records (Millions)")
    ax_opt.set_ylabel("Optimality (0.0 - 1.0)")
    ax_opt.set_ylim(0, 1.1)
    ax_break.set_title("Time Breakdown (Final Batch)")
    ax_break.set_ylabel("Time (ms)")
    for ax in (ax_ingest, ax_total, ax_opt):
        ax.legend()
        ax.grid(True, alpha=0.3)
    ax_break.legend()

    fig.tight_layout(rect=[0, 0.03, 1, 0.95])
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("runs", nargs="+", help="Label=file.csv ...")
    ap.add_argument("--out", default="performance_analysis.png")
    a = ap.parse_args(argv)
    files = {}
    for arg in a.runs:
        if "=" not in arg:
            print(f"skipping malformed arg {arg!r} (want Label=file.csv)", file=sys.stderr)
            continue
        label, path = arg.split("=", 1)
        files[label] = path
    if not files:
        ap.error("no valid Label=file.csv args")
    print(plot_performance(files, a.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
