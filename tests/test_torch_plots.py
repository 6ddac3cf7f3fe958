"""The port's figures against the JAX package's.

The same collector CSVs through ``skyline_tpu_torch.plots`` and
``skyline_tpu.plots``: the same PNG bytes for the 2-D skyline, the
dashboard and the per-dimension panels; the same plotted lines (the
port's own results labelled ``(port)`` where the reference says
``(tpu)``) for the paper figures; and the same command lines.
"""

import json

import numpy as np
import pytest

pytest.importorskip("matplotlib")
pytest.importorskip("pandas")

import matplotlib.pyplot as plt  # noqa: E402

from skyline_tpu.plots import by_dimension as ref_by_dimension  # noqa: E402
from skyline_tpu.plots import paper_figures as ref_paper_figures  # noqa: E402
from skyline_tpu.plots import performance as ref_performance  # noqa: E402
from skyline_tpu.plots import skyline_2d as ref_skyline_2d  # noqa: E402
from skyline_tpu_torch.metrics.collector import CSV_HEADERS  # noqa: E402
from skyline_tpu_torch.plots import (  # noqa: E402
    by_dimension,
    paper_figures,
    performance,
    skyline_2d,
)


def _csv(path, rows=6, seed=0, points=True):
    """A collector CSV: ``rows`` query results with growing record counts."""
    rng = np.random.default_rng(seed)
    lines = [",".join(CSV_HEADERS)]
    for i in range(rows):
        rec = {h: 0 for h in CSV_HEADERS}
        rec.update({
            "QueryID": i, "Records": (i + 1) * 250_000,
            "IngestTime(ms)": float(rng.uniform(10, 50)),
            "LocalTime(ms)": float(rng.uniform(100, 400)),
            "GlobalTime(ms)": float(rng.uniform(5, 50)),
            "TotalTime(ms)": float(rng.uniform(1000, 9000)),
            "Optimality": float(rng.uniform(0, 1)),
        })
        if "SkylinePoints" in rec:
            pts = np.sort(rng.uniform(0, 10000, (12, 2)), axis=0) if points else np.zeros((0, 2))
            pts[:, 1] = pts[::-1, 1]
            rec["SkylinePoints"] = '"' + json.dumps(pts.round(3).tolist()) + '"'
        lines.append(",".join(str(rec[h]) for h in CSV_HEADERS))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_csv_schema_is_the_references():
    from skyline_tpu.metrics.collector import CSV_HEADERS as REF

    assert CSV_HEADERS == REF


def test_skyline_2d_same_png(tmp_path):
    csv = _csv(tmp_path / "r.csv")
    a = skyline_2d.plot_skyline(csv, -1, out=str(tmp_path / "a.png"))
    b = ref_skyline_2d.plot_skyline(csv, -1, out=str(tmp_path / "b.png"))
    assert open(a, "rb").read() == open(b, "rb").read()
    empty = _csv(tmp_path / "e.csv", points=False)
    with pytest.raises(ValueError):
        skyline_2d.plot_skyline(empty)


def test_performance_same_png(tmp_path):
    files = {"MR-Angle": _csv(tmp_path / "a.csv", seed=1),
             "MR-Grid": _csv(tmp_path / "b.csv", seed=2)}
    a = performance.plot_performance(files, str(tmp_path / "a.png"))
    b = ref_performance.plot_performance(files, str(tmp_path / "b.png"))
    assert open(a, "rb").read() == open(b, "rb").read()


def test_by_dimension_same_png(tmp_path):
    maps = {d: {"MR-Dim": _csv(tmp_path / f"{d}a.csv", seed=d),
                "MR-Angle": _csv(tmp_path / f"{d}b.csv", seed=10 + d)} for d in (2, 3)}
    a = by_dimension.plot_by_dimension(maps, str(tmp_path / "a.png"))
    b = ref_by_dimension.plot_by_dimension(maps, str(tmp_path / "b.png"))
    assert open(a, "rb").read() == open(b, "rb").read()


def _lines_of(fn, monkeypatch, *args):
    """Every saved figure's lines as (x, y, label), the port's label mapped
    to the reference's."""
    saved = []

    def keep(path, **kw):
        fig = plt.gcf()
        saved.append([(list(ln.get_xdata()), list(ln.get_ydata()),
                       ln.get_label().replace("(port)", "(tpu)"))
                      for ax in fig.axes for ln in ax.lines])

    monkeypatch.setattr(plt, "savefig", keep)
    fn(*args)
    return saved


@pytest.mark.parametrize("ours", [False, True])
def test_paper_figures_same_lines(tmp_path, monkeypatch, ours):
    assert paper_figures.REFERENCE_TIME_MS == ref_paper_figures.REFERENCE_TIME_MS
    assert paper_figures.REFERENCE_OPTIMALITY == ref_paper_figures.REFERENCE_OPTIMALITY
    t = {2: {"MR-Angle": 1.0, "MR-Dim": 2.0}, 3: {"MR-Angle": 3.0}} if ours else None
    o = {2: {"MR-Angle": 0.5}, 3: {"MR-Angle": 0.4}} if ours else None
    got = _lines_of(paper_figures.plot_paper_figures, monkeypatch, t, o, str(tmp_path / "p"))
    want = _lines_of(ref_paper_figures.plot_paper_figures, monkeypatch, t, o,
                     str(tmp_path / "r"))
    assert len(got) == 2 and got == want


def test_command_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    csv = _csv(tmp_path / "r.csv")
    assert skyline_2d.main([csv, "--out", "s.png"]) == 0
    assert performance.main([f"A={csv}", "--out", "p.png"]) == 0
    assert by_dimension.main([f"2:A={csv}", f"3:A={csv}", "--out", "d.png"]) == 0
    assert paper_figures.main(["--ours", f"2:A={csv}", "--prefix", "x_"]) == 0
    out = capsys.readouterr().out.split()
    assert out == ["s.png", "p.png", "d.png", "x_figure_5_replication.png",
                   "x_figure_7_replication.png"]
    for name in out:
        assert (tmp_path / name).stat().st_size > 0
    with pytest.raises(SystemExit):
        by_dimension.main(["bad-spec"])
