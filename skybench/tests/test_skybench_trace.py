"""The profiler arithmetic on a hand-made trace."""

import pytest

from skybench import trace


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def test_merge_covered_and_gaps():
    assert trace.merge([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert trace.covered([(0, 2), (1, 3), (5, 7)]) == 5
    assert trace.gaps([(1, 3), (5, 7)], 0, 10) == [(0, 1), (3, 5), (7, 10)]
    assert trace.gaps([], 0, 4) == [(0, 4)]


def test_summarize_two_cards():
    events = [
        ev("skybench.traced", "user_annotation", 0, 100),
        ev("skybench.ingest", "user_annotation", 0, 58),
        ev("skybench.trigger", "user_annotation", 58, 42),
        ev("aten::sort", "cpu_op", 52, 6),
        ev("void (anonymous namespace)::dominated_kernel<8, true>(float const*)", "kernel", 10, 20, device=0),
        ev("void (anonymous namespace)::dominated_kernel<8, true>(float const*)", "kernel", 20, 20, device=0),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 60, 10, device=0),
        ev("predrop_kernel<3>", "kernel", 0, 50, device=1),
        ev("late", "kernel", 95, 30, device=1),
    ]
    s = trace.summarize(events, 2)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_by_device"] == pytest.approx([40e-6, 55e-6])
    assert s["busy_s"] == pytest.approx(47.5e-6)
    assert s["kernel_s"]["dominated_kernel"] == pytest.approx(40e-6)
    assert s["device_ops"][0] == ["predrop_kernel", pytest.approx(50e-6)]
    # idle on every card: 50-60 (the host sorting inside ingest, then
    # trigger) and 70-95 (trigger)
    idle = dict((k, v) for k, v in s["idle_gaps"])
    assert idle == {"ingest:aten::sort": pytest.approx(10e-6), "trigger:python": pytest.approx(25e-6)}


def test_no_window_no_summary():
    assert trace.summarize([ev("k", "kernel", 0, 1, device=0)], 1) is None


def test_short_names():
    assert trace.short_name("void (anonymous namespace)::predrop_kernel<8, true>(int)") == "predrop_kernel"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
