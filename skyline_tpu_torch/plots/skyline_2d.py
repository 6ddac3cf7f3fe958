"""2D skyline figure: the port's copy of ``skyline_tpu/plots/skyline_2d.py``.

Reads one collector-CSV row, parses its ``SkylinePoints`` JSON, and draws a
scatter plus a post-step Pareto line with the axes locked to the domain
(0-10000 by default), so the frontier is judged against the origin, not the
data's range.

    python -m skyline_tpu_torch.plots.skyline_2d results.csv [row] [--out f.png]
"""

from __future__ import annotations

import argparse
import json

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd


def plot_skyline(csv_file: str, row_index: int = -1, d_min: float = 0.0,
                 d_max: float = 10000.0, out: str | None = None) -> str:
    df = pd.read_csv(csv_file)
    row = df.iloc[row_index]
    pts = np.asarray(json.loads(row["SkylinePoints"]), dtype=float)
    if pts.size == 0:
        raise ValueError(
            "row has no SkylinePoints — run the engine with "
            "emit_skyline_points=True"
        )
    if pts.shape[1] != 2:
        raise ValueError(f"2D plot needs 2-dim points, got d={pts.shape[1]}")
    pts = pts[np.argsort(pts[:, 0], kind="stable")]

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(pts[:, 0], pts[:, 1], c="red", s=12, zorder=3, label="skyline points")
    ax.step(pts[:, 0], pts[:, 1], where="post", linestyle=":", color="blue",
            zorder=2, label="dominance frontier")
    ax.set_xlim(d_min, d_max)
    ax.set_ylim(d_min, d_max)
    ax.set_xlabel("dimension 0")
    ax.set_ylabel("dimension 1")
    ax.set_title(
        f"Skyline (query {row.get('QueryID', '?')}, {len(pts)} points)"
    )
    ax.legend()
    ax.grid(alpha=0.3)
    out = out or f"skyline_viz_{row_index}.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("csv_file")
    ap.add_argument("row_index", nargs="?", type=int, default=-1)
    ap.add_argument("--d-min", type=float, default=0.0)
    ap.add_argument("--d-max", type=float, default=10000.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    print(plot_skyline(a.csv_file, a.row_index, a.d_min, a.d_max, a.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
