"""Per-dimension comparison: the port's copy of ``skyline_tpu/plots/by_dimension.py``.

Side-by-side TotalTime-against-records panels, one per dimensionality, each
overlaying the partitioning strategies, given on the command line as
``D:Label=file.csv``.

    python -m skyline_tpu_torch.plots.by_dimension 2:MR-Dim=a.csv 3:MR-Dim=b.csv
"""

from __future__ import annotations

import argparse

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import pandas as pd


def plot_by_dimension(dim_maps: dict[int, dict[str, str]],
                      out: str = "performance_by_dimension.png") -> str:
    dims = sorted(dim_maps)
    fig, axes = plt.subplots(1, len(dims), figsize=(6 * len(dims), 5), squeeze=False)
    for ax, d in zip(axes[0], dims):
        for label, path in dim_maps[d].items():
            df = pd.read_csv(path).sort_values(by="Records")
            ax.plot(df["Records"] / 1_000_000, df["TotalTime(ms)"] / 1000,
                    marker="o", label=label)
        ax.set_title(f"{d}D")
        ax.set_xlabel("Records (Millions)")
        ax.set_ylabel("Total Time (s)")
        ax.legend()
        ax.grid(True, alpha=0.3)
    fig.suptitle("Total Processing Time by Dimensionality")
    fig.tight_layout(rect=[0, 0.03, 1, 0.95])
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("spec", nargs="+",
                    help="alternating: --dim style groups as 'D:Label=file.csv'")
    ap.add_argument("--out", default="performance_by_dimension.png")
    a = ap.parse_args(argv)
    dim_maps: dict[int, dict[str, str]] = {}
    for item in a.spec:
        dpart, _, rest = item.partition(":")
        label, _, path = rest.partition("=")
        if not (dpart.isdigit() and label and path):
            ap.error(f"malformed spec {item!r}; want 'D:Label=file.csv'")
        dim_maps.setdefault(int(dpart), {})[label] = path
    print(plot_by_dimension(dim_maps, a.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
