"""The port's wire plane against the JAX package's: the data-plane parser
(``bridge/wire.py`` ``parse_tuple_lines``) on adversarial lines through the
native helper and through the Python loop, the native helper's other entry
points (CRC32C, record frames, RecordBatch walks, CSV and row formatting),
the kafkalite frames (``protocol.py``) against the JAX encoders and the
spec-built golden frames of ``tests/test_kafkalite_golden.py``, the
generators, the producer and trigger CLIs' lines on a bus, and the
collector's CSV rows. Tolerance: exact bytes everywhere.
"""

import csv
import fcntl
import io
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

from skyline_tpu import native as jnative
from skyline_tpu.bridge import wire as jwire
from skyline_tpu.bridge.kafkalite import protocol as JP
from skyline_tpu.metrics import collector as jcollector
from skyline_tpu.workload import generators as jgen
from skyline_tpu.workload import producer as jproducer
from skyline_tpu.workload import trigger as jtrigger
from skyline_tpu_torch import native
from skyline_tpu_torch.bridge import MemoryBus, wire
from skyline_tpu_torch.bridge.kafkalite import protocol as P
from skyline_tpu_torch.metrics import collector
from skyline_tpu_torch.workload import generators as gen
from skyline_tpu_torch.workload import producer
from skyline_tpu_torch.workload import trigger

from test_kafkalite_golden import RFC3720_VECTORS, _crc32c_bitwise, _golden_batch

# malformed, short and long rows, nan, +-inf, -0.0, exponents, CRLF, blank
# lines, out-of-range ids, signs, spaces, empty fields
ADVERSARIAL = [
    "0,1,2,3",
    "1,1.5,2.25,3.125",
    "2,-0.0,0,-0",
    "3,1e3,2E-2,3.5e+1",
    "4,nan,1,2",
    "5,1,inf,2",
    "6,1,2,-inf",
    "7,1,2",
    "8,1,2,3,4",
    "9,a,2,3",
    "x,1,2,3",
    "",
    "   ",
    "10,1,2,3\r",
    "11, 1,2,3",
    "12,1,,3",
    "9223372036854775807,1,2,3",
    "9223372036854775808,1,2,3",
    "-9223372036854775808,1,2,3",
    "-9223372036854775809,1,2,3",
    "+13,+1,2,3",
    "14,3.4028235e38,1e39,1",
    "15,1e-45,1e-50,0.1",
    "16,0x10,1,2",
    "17,1.,.5,2",
    "18,123456789012345678901234,1,2",
    "19,1,2,3,",
    ",1,2,3",
    "20,1,2,3",
]


# The reference's loader (``skyline_tpu/native/__init__.py``) runs g++
# straight onto its library's final path whenever that file is missing or
# older than its source, so a test worker that starts beside another can
# dlopen a half-written file, and the reference then keeps None (or a
# library short of symbols) for the rest of the process. Before a module's
# first test, under a file lock in the temp dir, a reference library that
# does not load whole is built to a temp file, moved into place in one
# step, and loaded again (tests/test_torch_kafkalite.py imports this
# fixture). The reference's own tests call its loader without the lock, so
# one of them that rebuilds in place at the same moment can still race it.
_JNATIVE_SYMBOLS = ("sky_parse_tuples", "sky_crc32c", "sky_encode_records",
                    "sky_format_tuples", "sky_format_rows", "sky_parse_recordbatches")


def _whole(lib) -> bool:
    return lib is not None and all(hasattr(lib, s) for s in _JNATIVE_SYMBOLS)


@pytest.fixture(autouse=True, scope="module")
def _whole_reference_native():
    with open(Path(tempfile.gettempdir()) / "skyline_tpu_fastcsv.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _whole(jnative.get_lib()):
            return
        tmp = f"{jnative._SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp,
                            jnative._SRC], check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return  # no compiler: the tests see what the reference sees
        os.replace(tmp, jnative._SO)
        jnative._lib, jnative._tried = None, False
        assert _whole(jnative.get_lib()), "the reference's native library does not load whole"


def _python_only(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


def _native_or_skip():
    if native.get_lib() is None:
        pytest.skip(f"no native helper here: {native.build_error()}")


def _same_parse(a, b):
    assert a[0].dtype == b[0].dtype == np.int64
    assert a[1].dtype == b[1].dtype == np.float32
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()
    assert a[2] == b[2]


@pytest.mark.parametrize("plane", ["python", "native"])
@pytest.mark.parametrize("dims", [1, 3, 8])
def test_parse_tuple_lines_matches_jax_on_adversarial_lines(monkeypatch, plane, dims):
    if plane == "python":
        _python_only(monkeypatch)
    else:
        _native_or_skip()
    rng = np.random.default_rng(dims)
    lines = list(ADVERSARIAL)
    lines += [",".join([str(i)] + [str(v) for v in rng.normal(0, 1e4, dims)])
              for i in range(100, 140)]
    lines += [",".join([str(i)] + ["-0.0"] * dims) for i in range(140, 145)]
    got = wire.parse_tuple_lines(lines, dims)
    want = jwire.parse_tuple_lines(lines, dims)
    _same_parse(got, want)
    assert 0 < got[0].shape[0] < len(lines) and got[2] > 0


def test_parse_tuple_lines_empty_and_generator_input(monkeypatch):
    for fn in (wire.parse_tuple_lines, jwire.parse_tuple_lines):
        ids, vals, dropped = fn([], 4)
        assert ids.shape == (0,) and vals.shape == (0, 4) and dropped == 0
    lines = (f"{i},{i},{i + 1}" for i in range(10))
    _same_parse(wire.parse_tuple_lines(lines, 2),
                jwire.parse_tuple_lines([f"{i},{i},{i + 1}" for i in range(10)], 2))


def test_parse_result_roundtrip():
    doc = {"query_id": "q", "record_count": 3, "skyline_size": 1, "optimality": 0.33333,
           "skyline_points": [[1.0, 2.0]], "trace_id": "t"}
    line = wire.format_result(doc)
    assert line == jwire.format_result(doc)
    assert wire.parse_result(line) == jwire.parse_result(line)


# -- the native helper ------------------------------------------------------------


def test_native_builds_into_the_build_dir_keyed_by_source():
    _native_or_skip()
    path = native.library_path()
    assert path.parent.name == "_build" and path.parent.parent.name == "skyline_tpu_torch"
    assert path.name.startswith("fastcsv_") and path.exists()
    assert native.build_error() is None


def test_crc32c_matches_jax_and_rfc_vectors(rng):
    for data, want in RFC3720_VECTORS:
        assert P.crc32c(data) == JP.crc32c(data) == want
        assert P._crc32c_py(data) == want
    for n in (0, 1, 7, 8, 9, 63, 4097):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = _crc32c_bitwise(data)
        assert P.crc32c(data) == JP.crc32c(data) == P._crc32c_py(data) == want
        if native.get_lib() is not None:
            assert native.crc32c_native(data) == want


@pytest.mark.parametrize("native_on", [True, False])
def test_record_batch_bytes_match_jax_and_golden(monkeypatch, native_on):
    if not native_on:
        monkeypatch.setattr(P, "_records_encoder_impl", [None])
        monkeypatch.setattr(JP, "_records_encoder_impl", [None])
    else:
        _native_or_skip()
    golden_in = [(None, b"1,42.5,17.25"), (b"k", b"second")]
    got = P.encode_record_batch(golden_in, base_offset=42, base_timestamp=1_700_000_000_000)
    assert got == _golden_batch(golden_in, 42, 1_700_000_000_000)
    assert got == JP.encode_record_batch(golden_in, base_offset=42,
                                         base_timestamp=1_700_000_000_000)
    values = [(None, f"{i},{i * 3},{i * 7}".encode()) for i in range(300)]
    got = P.encode_record_batch(values, base_offset=5, base_timestamp=123)
    assert got == JP.encode_record_batch(values, base_offset=5, base_timestamp=123)
    assert got == _golden_batch(values, 5, 123)
    assert P.decode_record_batches(got) == JP.decode_record_batches(got)


def test_native_entry_points_match_jax(rng):
    _native_or_skip()
    ids = np.arange(1000, 1500, dtype=np.int64)
    vals = rng.integers(-5, 10_000, size=(500, 8)).astype(np.int64)
    blob, offs = native.format_tuples_native(ids, vals)
    jblob, joffs = jnative.format_tuples_native(ids, vals)
    assert blob == jblob and offs.tobytes() == joffs.tobytes()
    batch = P.encode_record_batch_blob(blob, offs, base_offset=0, base_timestamp=9)
    assert batch == JP.encode_record_batch_blob(blob, offs, base_offset=0, base_timestamp=9)
    for verify in (False, True):
        got = native.parse_recordbatches_native(batch, 100, 8, verify_crc=verify)
        want = jnative.parse_recordbatches_native(batch, 100, 8, verify_crc=verify)
        _same_parse(got[:3], want[:3])
        assert got[3] == want[3] == 500
    pts = rng.normal(0, 1e3, size=(40, 5)).astype(np.float32)
    pts[0, 0] = -0.0
    for mode in (native.ROWS_JSON, native.ROWS_CSV):
        assert native.format_rows_native(pts, mode) == jnative.format_rows_native(pts, mode)
    frames = native.encode_records_native([b"a", b"bb", b""])
    assert frames == jnative.encode_records_native([b"a", b"bb", b""])


def test_native_corrupt_batch_raises_like_jax():
    _native_or_skip()
    frame = bytearray(_golden_batch([(None, b"1,2,3")], 0, 0))
    frame[-1] ^= 0x01
    for fn in (native.parse_recordbatches_native, jnative.parse_recordbatches_native):
        with pytest.raises(ValueError, match="CRC"):
            fn(bytes(frame), 0, 2, verify_crc=True)


# -- generators ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(gen.GENERATORS))
@pytest.mark.parametrize("dims", [2, 3, 4, 8])
def test_generators_match_jax_byte_for_byte(name, dims):
    a = gen.generate(name, np.random.default_rng(5), 500, dims, 0.0, 10_000.0)
    b = jgen.generate(name, np.random.default_rng(5), 500, dims, 0.0, 10_000.0)
    assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_generator_tables_match_jax():
    assert sorted(gen.GENERATORS) == sorted(jgen.GENERATORS)
    assert gen.SIMPLE_VARIANT == jgen.SIMPLE_VARIANT
    assert gen.QUERY_THRESHOLD == jgen.QUERY_THRESHOLD
    with pytest.raises(ValueError, match="unknown distribution"):
        gen.generate("nope", np.random.default_rng(0), 1, 2, 0, 1)


# -- the producer and trigger CLIs on a bus ----------------------------------------


class _BlobBus(MemoryBus):
    """A MemoryBus with the KafkaBus produce surface the CLIs use."""

    def __init__(self, bootstrap="unused"):
        super().__init__()
        _BlobBus.last = self

    def produce_blob(self, topic, blob, offsets):
        ot = list(offsets)
        self.produce_many(topic, [blob[ot[i]:ot[i + 1]].decode() for i in range(len(ot) - 1)])

    def produce_many(self, topic, messages):
        super().produce_many(topic, [m.decode() if isinstance(m, bytes) else m
                                     for m in messages])


def _cli_topics(monkeypatch, kafka_mod, main, argv):
    monkeypatch.setattr(kafka_mod, "KafkaBus", _BlobBus)
    assert main(argv) == 0
    bus = _BlobBus.last
    return {t: list(bus._topics[t]) for t in sorted(bus._topics)}


PRODUCER_ARGS = [
    ["input-tuples", "anti_correlated", "8", "0", "10000", "--count", "3000",
     "--seed", "3", "--query-threshold", "0", "--final-trigger"],
    ["in", "uniform", "2", "0", "1000", "q", "--count", "2500", "--seed", "1",
     "--batch", "700", "--query-threshold", "1000", "--start-id", "500"],
    ["in", "correlated", "4", "0", "100", "--count", "900", "--seed", "2",
     "--variant", "simple", "--start-query-id", "7", "--final-trigger"],
    ["in", "anti-correlated", "3", "0", "10000", "--count", "600", "--seed", "4",
     "--variant", "simple"],
    ["in", "qos", "6", "0", "10000", "--count", "400", "--seed", "8"],
]


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("argv", PRODUCER_ARGS, ids=lambda a: f"{a[1]}-{a[2]}d")
def test_producer_cli_lines_match_jax(monkeypatch, argv, native_on):
    import skyline_tpu.bridge.kafka as jkafka
    import skyline_tpu_torch.bridge.kafka as tkafka

    if not native_on:
        monkeypatch.setattr(producer, "format_tuples_native", lambda i, v: None)
        monkeypatch.setattr(jproducer, "format_tuples_native", lambda i, v: None)
    got = _cli_topics(monkeypatch, tkafka, producer.main, argv)
    want = _cli_topics(monkeypatch, jkafka, jproducer.main, argv)
    assert got == want
    count = int(argv[argv.index("--count") + 1])
    assert len(got[argv[0]]) == count


def test_producer_stdout_sink_matches_jax(capsys):
    argv = ["in", "uniform", "3", "0", "50", "--count", "200", "--seed", "9",
            "--sink", "stdout", "--query-threshold", "64"]
    assert producer.main(argv) == 0
    got = capsys.readouterr().out
    assert jproducer.main(argv) == 0
    assert got == capsys.readouterr().out and got.count("\n") == 200 + 3


@pytest.mark.parametrize("argv", [[], ["q7"], ["q7", "--required", "99"],
                                  ["2", "--topic", "other"]])
def test_trigger_cli_lines_match_jax(monkeypatch, argv):
    import skyline_tpu.bridge.kafka as jkafka
    import skyline_tpu_torch.bridge.kafka as tkafka

    got = _cli_topics(monkeypatch, tkafka, trigger.main, argv)
    assert got == _cli_topics(monkeypatch, jkafka, jtrigger.main, argv)
    assert sum(len(v) for v in got.values()) == 1


# -- the collector ---------------------------------------------------------------

RESULTS = [
    {"query_id": "0", "record_count": 10, "skyline_size": 2, "optimality": 0.2,
     "ingestion_time_ms": 1.5, "local_processing_time_ms": 2, "global_processing_time_ms": 3,
     "total_processing_time_ms": 4.25, "query_latency_ms": 5,
     "skyline_points": [[1.0, 2.0], [2.0, 1.0]]},
    {"query_id": "1", "record_count": 20, "skyline_size": 0, "optimality": 0.0},
    {"query_id": "2", "record_count": 3, "skyline_size": 1, "optimality": 0.3333,
     "trace_id": "abc", "skyline_points": [[-0.0, 5.5]]},
]


def test_collector_rows_and_csv_match_jax(tmp_path):
    assert collector.CSV_HEADERS == jcollector.CSV_HEADERS
    for r in RESULTS:
        assert collector.result_to_row(r) == jcollector.result_to_row(r)
    for first in (0, 2):  # the header with and without the TraceID column
        a, b = tmp_path / f"port{first}.csv", tmp_path / f"jax{first}.csv"
        for r in RESULTS[first:] + RESULTS[:first]:
            collector.append_result_row(str(a), r)
            jcollector.append_result_row(str(b), r)
        assert a.read_bytes() == b.read_bytes()
        assert next(csv.reader(io.StringIO(a.read_text())))[:10] == collector.CSV_HEADERS


def test_collector_cli_stdin_and_count(tmp_path, monkeypatch, capsys):
    lines = "".join(json.dumps(r) + "\n\n" for r in RESULTS)
    for mod, name in ((collector, "port"), (jcollector, "jax")):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        assert mod.main([str(tmp_path / f"{name}.csv"), "--source", "stdin"]) == 0
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    out = capsys.readouterr().out
    assert out.count("[Query ") == 2 * len(RESULTS)
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    assert collector.main([str(tmp_path / "two.csv"), "--source", "stdin", "--count", "2"]) == 0
    assert (tmp_path / "two.csv").read_text().count("\n") == 3
