"""The port's ops journal (``skyline_tpu_torch/telemetry/opslog.py`` and
the ``python -m skyline_tpu_torch.opslog`` CLI) against the JAX package's:
the same frames for the same records under a pinned clock, each package
reading the other's journals, torn tails and CRC damage read alike, the
size cap, ``ops_doc``, the CLI's print and diff; and the worker attaching
its journal to the hub with crash safety on (``SKYLINE_OPSLOG`` unset or
on), ``/ops`` answering on the stats port. Tolerance: exact bytes and
records.
"""

import json
import urllib.request

import pytest

from skyline_tpu.telemetry import opslog as jops
from skyline_tpu_torch import opslog as cli
from skyline_tpu_torch.telemetry import opslog as ops

EVENTS = [
    ("lease_acquired", dict(epoch=1, fence=1, holder="w")),
    ("fence_raised", dict(epoch=2, fence=2, trace_id="t-1", cut_seq=7, cut_pos=40)),
    ("promoted", dict(epoch=2, head={"version": 3, "digest": "ab"})),
    ("degraded_publish", dict(chips=[0, 2], note="é")),
]


def _pin_clock(monkeypatch):
    tick = {"now": 1_700_000_000.0}

    def clock():
        tick["now"] += 0.001
        return tick["now"]

    for mod in (ops, jops):
        monkeypatch.setattr(mod.time, "time", clock)


def _journal(mod, d, **kw):
    log = mod.OpsLog(d, process_id="worker-h-1", fsync="off", **kw)
    try:
        for kind, fields in EVENTS:
            assert log.record(kind, **fields) is not None
    finally:
        log.close()
    return log


def test_frames_and_records_match_jax(tmp_path, monkeypatch):
    _pin_clock(monkeypatch)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    la = _journal(ops, a)
    _pin_clock(monkeypatch)
    lb = _journal(jops, b)
    (pa,), (pb,) = ops.list_journals(a), jops.list_journals(b)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()
    doc, jdoc = ops.read_ops(a), jops.read_ops(b)
    assert doc["records"] == jdoc["records"] and doc["total"] == 4
    assert ops.read_ops(b)["records"] == jops.read_ops(a)["records"] == doc["records"]
    assert la.stats()["appends"] == lb.stats()["appends"] == 4
    for since in (0, 2, 4):
        assert ops.read_ops(a, since_seq=since) == jops.read_ops(a, since_seq=since)


@pytest.mark.parametrize("damage", ["torn", "crc", "magic"])
def test_damage_reads_like_jax(tmp_path, damage):
    d = str(tmp_path)
    _journal(ops, d)
    (path,) = ops.list_journals(d)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if damage == "torn":
        data += b"\x40\x00\x00\x00\x99"
    elif damage == "crc":
        data[len(data) * 2 // 3] ^= 0xFF
    else:
        data[:4] = b"NOPE"
    with open(path, "wb") as f:
        f.write(data)
    assert ops.read_ops(d) == jops.read_ops(d)
    assert ops.read_ops(d)["torn"] == 1


def test_size_cap_and_closed_journal_count_never_raise(tmp_path):
    log = ops.OpsLog(str(tmp_path), fsync="off", max_bytes=256)
    results = [log.record("lease_acquired", epoch=i) for i in range(50)]
    dropped = sum(r is None for r in results)
    assert 0 < dropped < 50 and log.stats()["dropped"] == dropped
    log.close()
    assert log.record("promoted") is None
    assert ops.read_ops(str(tmp_path))["total"] == 50 - dropped


def test_ops_doc_and_enabled_knob(monkeypatch):
    assert ops.ops_doc(None) == jops.ops_doc(None) == {"ok": True, "enabled": False}
    assert ops.ops_doc("/nonexistent-skyline-opslog-dir")["enabled"] is False
    assert ops.opslog_enabled()
    monkeypatch.setenv("SKYLINE_OPSLOG", "off")
    assert not ops.opslog_enabled()


def test_cli_print_and_diff_like_jax(tmp_path, capsys, monkeypatch):
    _pin_clock(monkeypatch)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    _journal(ops, d1)
    log = ops.OpsLog(d2, process_id="worker-h-1", fsync="off")
    log.record("lease_acquired", epoch=1, fence=1, holder="w")
    log.close()
    for argv in ([d1, "--json"], [d1], [d1, "--since-seq", "2"], [d1, d2],
                 [d1, d2, "--json"]):
        assert cli.main(argv) == 0
        got = capsys.readouterr().out
        assert jops.main(argv) == 0
        assert got == capsys.readouterr().out, argv
    assert cli.main(["/nonexistent-skyline-opslog-dir", "--json"]) == 2


def test_worker_attaches_its_journal_and_serves_ops(tmp_path, monkeypatch):
    from skyline_tpu_torch.bridge import MemoryBus, SkylineWorker
    from skyline_tpu_torch.resilience import ResilienceConfig
    from skyline_tpu_torch.stream.engine import EngineConfig

    monkeypatch.delenv("SKYLINE_OPSLOG", raising=False)
    w = SkylineWorker(MemoryBus(), EngineConfig(dims=2, device="cpu"), stats_port=0,
                      resilience=ResilienceConfig(checkpoint_dir=str(tmp_path)))
    try:
        assert w.telemetry.opslog is w._opslog is not None
        w._opslog.record("degraded_publish", note="drill")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{w.stats_server.port}/ops", timeout=10) as r:
            doc = json.load(r)
        assert doc["enabled"] and [x["type"] for x in doc["records"]] == ["degraded_publish"]
        assert w.stats()["resilience"]["ops"]["appends"] == 1
    finally:
        w.close()
    monkeypatch.setenv("SKYLINE_OPSLOG", "0")
    w = SkylineWorker(MemoryBus(), EngineConfig(dims=2, device="cpu"),
                      resilience=ResilienceConfig(checkpoint_dir=str(tmp_path / "off")))
    assert w.telemetry.opslog is None
    w.close()
