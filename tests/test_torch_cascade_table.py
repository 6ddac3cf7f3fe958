"""The port's dispatch cascade table, profiler and race against the JAX
package's, on the CPU. The resolvers are pure logic: both packages'
``resolve_mask`` and ``resolve_flush`` run side by side over the
reference's host grid (the port given a CPU device) and its accelerator
grid (the reference with ``on_tpu`` patched true, the port given a CUDA
device), with fresh profilers, with measured EMAs and with pins, and must
give the same variant and recording flag. Then the profiler's bookkeeping,
the pin and override rules, ``table_doc`` and the import boundary of every
new module. Every comparison is exact."""

import json
import subprocess
import sys

import pytest

from skyline_tpu.ops import cascade as jcascade
from skyline_tpu.ops import dispatch as jdispatch
from skyline_tpu.telemetry.profiler import KernelProfiler as JaxProfiler
from skyline_tpu.telemetry.profiler import n_bucket as j_n_bucket
from skyline_tpu_torch.ops import cascade, dispatch
from skyline_tpu_torch.telemetry.profiler import KernelProfiler, n_bucket
from skyline_tpu_torch.utils import knobs

ENV = (
    "SKYLINE_SORTED_SFS", "SKYLINE_DEVICE_CASCADE", "SKYLINE_RANK_CASCADE",
    "SKYLINE_DELTA_CUTOFF", "SKYLINE_MERGE_PRUNE", "SKYLINE_MERGE_CACHE",
    "SKYLINE_MERGE_TREE", "SKYLINE_FLUSH_PREFILTER", "SKYLINE_CHIP_PRUNE",
    "SKYLINE_CLUSTER_HOST_PRUNE", "SKYLINE_SORTED_SFS_BLOCK",
    "SKYLINE_DEVICE_CASCADE_BLOCK",
)


@pytest.fixture(autouse=True)
def _clean_tables(monkeypatch):
    """Pins and overrides are process-wide in both packages: every test
    starts and ends with clean tables and unset dispatch knobs."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)

    def clear():
        for t in (jcascade, cascade):
            t.clear_pins()
            for k in t.TUNABLE_KNOBS:
                t.clear_override(k)

    clear()
    yield
    clear()


def _entries(emas, backend):
    return {
        "version": 1,
        "entries": [
            {"variant": v, "d": d, "n_bucket": nb, "backend": backend, "mp": mp,
             "calls": 3, "wall_ms": e * 3, "ema_ms": e, "first_call_ms": e,
             "last_ms": e}
            for (v, d, nb, mp), e in (emas or {}).items()
        ],
    }


def _profs(emas=None, card=False):
    """(reference profiler, port profiler) holding the same EMAs — the
    reference's under "tpu" on its accelerator grid, the port's under
    "cuda"."""
    jp = JaxProfiler(backend="tpu" if card else "cpu")
    tp = KernelProfiler(backend="cuda" if card else "cpu")
    jp.restore_state(_entries(emas, "tpu" if card else "cpu"))
    tp.restore_state(_entries(emas, "cuda" if card else "cpu"))
    return jp, tp


def _env(monkeypatch, **kv):
    for k, v in kv.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


def _on_tpu(monkeypatch, on: bool):
    monkeypatch.setattr(jcascade, "on_tpu", lambda: on)


MODES = ["auto", "on", "off", "junk", None]
DC_MODES = ["auto", "on", "off"]


# -- the mask stage ---------------------------------------------------------------------


# the reference's _HOST_GRID (tests/test_cascade_table.py) and every other
# (mode, dc, concrete) combination, junk and unset modes included
@pytest.mark.parametrize("concrete", [True, False])
@pytest.mark.parametrize("dc", DC_MODES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [2, 4])
def test_resolve_mask_host_grid(monkeypatch, mode, dc, concrete, d):
    _env(monkeypatch, SKYLINE_SORTED_SFS=mode, SKYLINE_DEVICE_CASCADE=dc)
    _on_tpu(monkeypatch, False)
    jp, tp = _profs()
    for _ in range(3):  # fresh race, then the sticky claims
        want = jcascade.resolve_mask(d, 512, concrete, jp)
        got = cascade.resolve_mask(d, 512, concrete, tp, device="cpu")
        assert got == want, (mode, dc, concrete, d)


@pytest.mark.parametrize("rank", ["0", "1"])
@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("concrete", [True, False])
@pytest.mark.parametrize("dc", DC_MODES)
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_resolve_mask_card_grid(monkeypatch, mode, dc, concrete, mp, rank):
    """The accelerator grid: the host cascade is never in play, whatever
    ``SKYLINE_SORTED_SFS`` says."""
    _env(monkeypatch, SKYLINE_SORTED_SFS=mode, SKYLINE_DEVICE_CASCADE=dc,
         SKYLINE_RANK_CASCADE=rank)
    _on_tpu(monkeypatch, True)
    jp, tp = _profs(card=True)
    for _ in range(3):
        want = jcascade.resolve_mask(4, 4096, concrete, jp, mp=mp)
        got = cascade.resolve_mask(4, 4096, concrete, tp, mp, device="cuda")
        assert got == want


EMA_CASES = {
    "none": {},
    "dev_only": {("mask_pallas", 4, 4096, True): 2.0},
    "dc_faster": {("mask_pallas", 4, 4096, True): 2.0,
                  ("mask_device_cascade", 4, 4096, True): 1.0},
    "dc_slower": {("mask_pallas", 4, 4096, True): 1.0,
                  ("mask_device_cascade", 4, 4096, True): 2.0},
    "other_mp": {("mask_pallas", 4, 4096, False): 2.0,
                 ("mask_device_cascade", 4, 4096, False): 1.0},
}


@pytest.mark.parametrize("concrete", [True, False])
@pytest.mark.parametrize("case", sorted(EMA_CASES))
def test_resolve_mask_card_evidence(monkeypatch, case, concrete):
    """On the card a merge-time call swaps to the cascade only when both
    candidates have EMAs under its signature and the cascade's is lower; a
    concrete call races them."""
    _on_tpu(monkeypatch, True)
    jp, tp = _profs(EMA_CASES[case], card=True)
    want = jcascade.resolve_mask(4, 4096, concrete, jp, mp=True)
    got = cascade.resolve_mask(4, 4096, concrete, tp, True, device="cuda")
    assert got == want, case


HOST_EMAS = {
    "scan_fast": {("sorted_sfs_mask", 4, 512, False): 5.0,
                  ("mask_scan", 4, 512, False): 1.0,
                  ("mask_device_cascade", 4, 512, False): 3.0},
    "sorted_fast": {("sorted_sfs_mask", 4, 512, False): 1.0,
                    ("mask_scan", 4, 512, False): 5.0,
                    ("mask_device_cascade", 4, 512, False): 3.0},
    "dc_fast": {("sorted_sfs_mask", 4, 512, False): 5.0,
                ("mask_scan", 4, 512, False): 3.0,
                ("mask_device_cascade", 4, 512, False): 1.0},
}


@pytest.mark.parametrize("dc", DC_MODES)
@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("case", sorted(HOST_EMAS))
def test_resolve_mask_host_ema_decides(monkeypatch, case, mode, dc):
    _env(monkeypatch, SKYLINE_SORTED_SFS=mode, SKYLINE_DEVICE_CASCADE=dc)
    _on_tpu(monkeypatch, False)
    jp, tp = _profs(HOST_EMAS[case])
    want = jcascade.resolve_mask(4, 512, True, jp)
    assert cascade.resolve_mask(4, 512, True, tp, device="cpu") == want


@pytest.mark.parametrize("pinned", ["mask_device_cascade", "mask_scan", "sorted_sfs_mask"])
@pytest.mark.parametrize("dc", DC_MODES)
def test_resolve_mask_pins(monkeypatch, pinned, dc):
    """A pin short-circuits the race where its row is a candidate and is
    ignored where the environment excluded it."""
    _env(monkeypatch, SKYLINE_SORTED_SFS="auto", SKYLINE_DEVICE_CASCADE=dc)
    _on_tpu(monkeypatch, False)
    jp, tp = _profs(HOST_EMAS["sorted_fast"])
    assert jcascade.pin("mask", pinned, 4, 512)
    assert cascade.pin("mask", pinned, 4, 512, backend="cpu")
    want = jcascade.resolve_mask(4, 512, True, jp)
    assert cascade.resolve_mask(4, 512, True, tp, device="cpu") == want


def test_card_pin_is_keyed_by_device_type(monkeypatch):
    """A pin learned on the card acts on a card's calls only."""
    jp, tp = _profs({("mask_pallas", 4, 4096, True): 1.0,
                     ("mask_device_cascade", 4, 4096, True): 2.0}, card=True)
    assert cascade.pin("mask", "mask_device_cascade", 4, 4096, mp=True, backend="cuda")
    assert cascade.resolve_mask(4, 4096, True, tp, True, device="cuda") == (
        "mask_device_cascade", True)
    assert cascade.pinned("mask", 4, 4096, True, backend="cpu") is None
    cascade.unpin("mask", 4, 4096, True, backend="cuda")
    assert cascade.resolve_mask(4, 4096, True, tp, True, device="cuda") == (
        "mask_pallas", True)


# -- the flush stage --------------------------------------------------------------------


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("meshed", [False, True])
@pytest.mark.parametrize("dc", DC_MODES)
@pytest.mark.parametrize("mode", MODES)
def test_flush_chooser_active(monkeypatch, mode, dc, meshed, card):
    _env(monkeypatch, SKYLINE_SORTED_SFS=mode, SKYLINE_DEVICE_CASCADE=dc)
    _on_tpu(monkeypatch, card)
    want = jcascade.flush_chooser_active(meshed)
    assert cascade.flush_chooser_active(meshed, "cuda" if card else "cpu") == want


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("variant", ["vmapped", "sequential"])
@pytest.mark.parametrize("meshed", [False, True])
@pytest.mark.parametrize("dc", DC_MODES)
@pytest.mark.parametrize("mode", MODES)
def test_resolve_flush_grid(monkeypatch, mode, dc, meshed, variant, card):
    """The reference's _FLUSH_GRID and every other combination, host and
    card, through three flushes: the fresh race's exploration, its sticky
    claim, and again."""
    _env(monkeypatch, SKYLINE_SORTED_SFS=mode, SKYLINE_DEVICE_CASCADE=dc)
    _on_tpu(monkeypatch, card)
    jp, tp = _profs(card=card)
    for _ in range(3):
        want = jcascade.resolve_flush(variant, 4, 1000, meshed, jp)
        got = cascade.resolve_flush(variant, 4, 1000, meshed, tp,
                                    device="cuda" if card else "cpu")
        assert got == want


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("winner", ["flush_sorted_sfs", "flush_sfs_sequential",
                                    "flush_device_cascade"])
@pytest.mark.parametrize("mode", ["auto", "off"])
def test_resolve_flush_ema_and_pin(monkeypatch, mode, winner, card):
    _env(monkeypatch, SKYLINE_SORTED_SFS=mode, SKYLINE_DEVICE_CASCADE="auto")
    _on_tpu(monkeypatch, card)
    nb = n_bucket(1000)
    emas = {(v, 4, nb, False): (1.0 if v == winner else 5.0)
            for v in ("flush_sorted_sfs", "flush_sfs_sequential", "flush_device_cascade")}
    jp, tp = _profs(emas, card=card)
    dev = "cuda" if card else "cpu"
    want = jcascade.resolve_flush("sequential", 4, 1000, False, jp)
    assert cascade.resolve_flush("sequential", 4, 1000, False, tp, device=dev) == want
    # a pin on the device cascade acts only where it is a candidate
    assert jcascade.pin("flush", "flush_device_cascade", 4, 1000,
                        backend=jcascade._backend())
    assert cascade.pin("flush", "flush_device_cascade", 4, 1000, backend=dev)
    want = jcascade.resolve_flush("sequential", 4, 1000, False, jp)
    assert cascade.resolve_flush("sequential", 4, 1000, False, tp, device=dev) == want


# -- the race itself --------------------------------------------------------------------


def test_choose_variant_sticky_sequence():
    """Fresh profilers explore each candidate once, in order; a claimed
    candidate is not explored again before its record lands; then the least
    EMA wins."""
    cands = ("a", "b", "c")
    jp, tp = JaxProfiler(backend="cpu"), KernelProfiler(backend="cpu")
    seq = []
    for _ in range(4):
        j = jdispatch.choose_variant(jp, cands, 4, 100)
        t = dispatch.choose_variant(tp, cands, 4, 100)
        assert t == j
        seq.append(t)
    assert seq == ["a", "b", "c", "a"]
    for prof in (jp, tp):
        for v, ms in (("a", 3.0), ("b", 1.0), ("c", 2.0)):
            prof.restore_state(_entries({(v, 4, n_bucket(100), False): ms}, "cpu"))
    assert dispatch.choose_variant(tp, cands, 4, 100) == "b"
    assert jdispatch.choose_variant(jp, cands, 4, 100) == "b"
    assert dispatch.choose_variant(None, cands, 4, 100) == "a"


# -- the profiler -----------------------------------------------------------------------


def test_n_bucket_matches():
    for n in list(range(-2, 70)) + [1000, 1024, 1025, 1 << 20, (1 << 20) + 1]:
        assert n_bucket(n) == j_n_bucket(n)


def test_profiler_bookkeeping():
    p = KernelProfiler(backend="cpu")
    assert p.claim_explore("v", 4, 100) and not p.claim_explore("v", 4, 100)
    with p.record("v", 4, 100):
        pass
    with p.record("v", 4, 100):
        pass
    with p.record("w", 4, 100, mp=True, backend="cuda"):
        pass
    assert p.ema_ms("v", 4, 100) is not None and p.ema_ms("v", 4, 100, backend="cuda") is None
    assert p.ema_ms("w", 4, 100, True, "cuda") is not None
    counts = p.snapshot_counts()
    assert counts[("v", 4, 128, "cpu", False)][0] == 2
    assert counts[("w", 4, 128, "cuda", True)][0] == 1
    doc = p.doc(phase_total_ms=1000.0)
    json.dumps(doc)
    assert set(doc) == set(JaxProfiler(backend="cpu").doc(phase_total_ms=1.0))
    assert doc["dispatches"] == 3 and doc["signatures"] == 2
    assert p.total_wall_ms() >= 0.0


def test_profiler_ema_and_state_round_trip():
    """The EMA's arithmetic (alpha 0.2, first call seeds it) on recorded
    walls, export/restore across both packages' documents, live data
    winning, malformed rows skipped, and reset_signatures."""
    p = KernelProfiler(backend="cpu")
    walls = []
    for _ in range(4):
        with p.record("v", 3, 10):
            pass
        walls.append(p.snapshot_counts())
    state = p.export_state()
    e = state["entries"][0]
    assert e["calls"] == 4 and e["first_call_ms"] is not None
    # the reference adopts the port's document and gives it back unchanged
    j = JaxProfiler(backend="cpu")
    assert j.restore_state(state) == 1
    assert j.export_state() == state
    q = KernelProfiler(backend="cpu")
    assert q.restore_state(j.export_state()) == 1
    assert q.export_state() == state
    assert q.restore_state(state) == 0  # live data wins
    bad = {"entries": [{"variant": "x"}, {"variant": "y", "d": "z", "n_bucket": 1,
                                          "backend": "cpu", "mp": 0, "calls": 1,
                                          "wall_ms": 1, "ema_ms": 1}]}
    assert q.restore_state(bad) == 0 and q.restore_state(None) == 0
    assert q.claim_explore("u", 3, 10)
    assert q.reset_signatures(["v"]) == 1 and q.ema_ms("v", 3, 10) is None
    assert q.claim_explore("v", 3, 10)  # re-explorable
    assert not q.claim_explore("u", 3, 10)  # other claims kept
    assert q.reset_signatures() == 0 and q.claim_explore("u", 3, 10)


# -- pins, overrides, gates and the table -----------------------------------------------


def test_pin_rules():
    assert not cascade.pin("mask", "nonesuch", 4, 512)
    assert not cascade.pin("flush", "mask_scan", 4, 512)
    assert cascade.pin("mask", "mask_scan", 4, 512, backend="cpu")
    assert cascade.pinned("mask", 4, 512, backend="cpu") == "mask_scan"
    doc = cascade.pins_doc()
    assert doc == [{"stage": "mask", "d": 4, "n_bucket": 512, "backend": "cpu",
                    "mp": False, "variant": "mask_scan"}]
    cascade.unpin("mask", 4, 512, backend="cpu")
    assert cascade.pinned("mask", 4, 512, backend="cpu") is None
    assert cascade.pin("flush", "flush_sorted_sfs", 4, 512, backend="cpu")
    cascade.clear_pins("mask")
    assert cascade.pins_doc() and not cascade.clear_pins() and not cascade.pins_doc()


def test_pin_needs_registered_oracle(monkeypatch):
    monkeypatch.delitem(cascade.ORACLES, "host_oracle")
    assert not cascade.pin("mask", "mask_scan", 4, 512, backend="cpu")
    assert cascade.pinned("mask", 4, 512, backend="cpu") is None


@pytest.mark.parametrize("knob,gate_row", [
    ("SKYLINE_MERGE_PRUNE", "partition_prune"),
    ("SKYLINE_FLUSH_PREFILTER", "flush_prefilter"),
    ("SKYLINE_CHIP_PRUNE", "chip_prune"),
    ("SKYLINE_CLUSTER_HOST_PRUNE", "host_prune"),
])
def test_gate_override_and_env_priority(monkeypatch, knob, gate_row):
    """The same sequence in both tables: an env-pinned knob refuses the
    override; a floating one takes it; a later export beats it at read
    time."""
    for t in (jcascade, cascade):
        monkeypatch.setenv(knob, "1")
        assert not t.set_override(knob, "0") and t.gate(gate_row)
        monkeypatch.delenv(knob)
        assert t.set_override(knob, "0") and not t.gate(gate_row)
        assert t.overrides_doc() == {knob: "0"}
        monkeypatch.setenv(knob, "1")
        assert t.gate(gate_row)
        monkeypatch.delenv(knob)
        t.clear_override(knob)
        assert t.gate(gate_row) and t.override(knob) is None


def test_cutoff_and_tree_overrides(monkeypatch):
    for t in (jcascade, cascade):
        assert t.delta_cutoff() == 0.75
        assert not t.set_override("SKYLINE_MERGE_TREE", "0")  # not tunable
        assert t.set_override("SKYLINE_DELTA_CUTOFF", "0.2")
        assert t.delta_cutoff() == pytest.approx(0.2)
        assert t.delta_applies(0.2) and not t.delta_applies(0.3)
        assert t.set_override("SKYLINE_DELTA_CUTOFF", "nan?")
        assert t.delta_cutoff() == 0.75  # an unparsable override reads as the knob
        monkeypatch.setenv("SKYLINE_DELTA_CUTOFF", "0.5")
        assert t.delta_cutoff() == pytest.approx(0.5)
        monkeypatch.delenv("SKYLINE_DELTA_CUTOFF")
        t.clear_override("SKYLINE_DELTA_CUTOFF")


@pytest.mark.parametrize("env", [{}, {"SKYLINE_MERGE_TREE": "0"}, {"SKYLINE_MERGE_CACHE": "0"},
                                 {"SKYLINE_FLUSH_PREFILTER": "0"}, {"SKYLINE_MERGE_PRUNE": "x"}])
def test_plane_helpers_match(monkeypatch, env):
    _env(monkeypatch, **env)
    for meshed in (False, True):
        assert cascade.merge_cache_on(meshed) == jcascade.merge_cache_on(meshed)
        for d in (1, 2, 3, 8):
            assert cascade.merge_tree_on(meshed, d) == jcascade.merge_tree_on(meshed, d)
            for row in ("flush_prefilter", "partition_prune", "chip_prune", "mask_sweep"):
                if row == "mask_sweep":
                    continue
                assert cascade.applies(row, d=d, meshed=meshed) == jcascade.applies(
                    row, d=d, meshed=meshed)
    for f in (0.0, 0.5, 0.75, 0.76, 1.0):
        assert cascade.delta_applies(f) == jcascade.delta_applies(f)
    for t in (True, False):
        for dl in (True, False):
            assert cascade.merge_path(t, dl) == jcascade.merge_path(t, dl)


def test_table_doc_matches_reference(monkeypatch):
    assert cascade.set_override("SKYLINE_DELTA_CUTOFF", "0.4")
    assert jcascade.set_override("SKYLINE_DELTA_CUTOFF", "0.4")
    assert cascade.pin("merge", "merge_tree", 4, 1000, backend="cpu")
    assert jcascade.pin("merge", "merge_tree", 4, 1000, backend="cpu")
    doc, want = cascade.table_doc(), jcascade.table_doc()
    json.dumps(doc)
    assert len(doc["rows"]) == len(cascade.TABLE) == 19
    assert doc["rows"] == want["rows"]
    assert doc["oracles"] == want["oracles"]
    assert doc["effective"] == want["effective"]
    assert doc["pins"] == want["pins"] and doc["overrides"] == want["overrides"]
    assert doc["backend"] in ("cpu", "cuda")
    assert cascade.TUNABLE_KNOBS == jcascade.TUNABLE_KNOBS
    assert set(cascade.ROW_BY_NAME) == set(jcascade.ROW_BY_NAME)


@pytest.mark.parametrize("raw", [None, "", "auto", "on", "off", "ON", " on", "1"])
@pytest.mark.parametrize("name,port_fn,ref_fn", [
    ("SKYLINE_SORTED_SFS", "sorted_sfs_mode", "sorted_sfs_mode"),
    ("SKYLINE_DEVICE_CASCADE", "device_cascade_mode", "device_cascade_mode"),
])
def test_mode_knobs_match(monkeypatch, name, port_fn, ref_fn, raw):
    _env(monkeypatch, **{name: raw})
    assert getattr(knobs, port_fn)() == getattr(jdispatch, ref_fn)()


@pytest.mark.parametrize("raw", [None, "1", "8", "9", "100", "3000", "junk"])
def test_block_knobs_match(monkeypatch, raw):
    import warnings

    from skyline_tpu.ops.device_cascade import device_cascade_block
    from skyline_tpu.ops.sorted_sfs import sorted_sfs_block

    _env(monkeypatch, SKYLINE_DEVICE_CASCADE_BLOCK=raw, SKYLINE_SORTED_SFS_BLOCK=raw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert knobs.device_cascade_block() == device_cascade_block()
        assert knobs.sorted_sfs_block() == sorted_sfs_block()


# -- the import boundary ----------------------------------------------------------------


@pytest.mark.parametrize("module", [
    "skyline_tpu_torch.ops.cascade", "skyline_tpu_torch.ops.dispatch",
    "skyline_tpu_torch.ops.device_cascade", "skyline_tpu_torch.ops.sorted_sfs",
    "skyline_tpu_torch.ops.block_skyline", "skyline_tpu_torch.telemetry.profiler",
    "skyline_tpu_torch.stream.batched",
])
def test_module_imports_no_jax(module):
    code = (
        f"import sys; import {module}; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'skyline_tpu' or m.startswith('skyline_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
