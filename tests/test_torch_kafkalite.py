"""The port's kafkalite (``skyline_tpu_torch/bridge/kafkalite``) over real
TCP against the JAX package's, both ways: the JAX producer writes to the
port's broker and the port's consumer reads it back (lines and the native
arrays plane), the port's producer (``send``, ``send_many``, ``send_blob``)
writes to the JAX broker and both consumers read the same records; seek,
latest-reset, a broker restart under a live producer and consumer, the
message cap; and the port's worker over ``KafkaBus`` against the JAX
worker over the same lines. Every test binds port 0, stops its brokers in
a ``finally``, and bounds its waits (socket timeouts and bounded loops).
Tolerance: exact records, ids and value bytes.
"""

import contextlib
import json

import numpy as np
import pytest

from skyline_tpu.bridge.kafkalite import Broker as JBroker
from skyline_tpu.bridge.kafkalite import KafkaLiteConsumer as JConsumer
from skyline_tpu.bridge.kafkalite import KafkaLiteProducer as JProducer
from skyline_tpu_torch import native
from skyline_tpu_torch.bridge.kafkalite import (
    Broker,
    KafkaLiteConsumer,
    KafkaLiteProducer,
    MessageSizeTooLargeError,
)

TIMEOUT_S = 10.0
REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _broker(cls=Broker, **kw):
    b = cls(host="127.0.0.1", port=0, **kw).start()
    try:
        yield b
    finally:
        b.stop()


def _drain(consumer, want: int, max_polls: int = 200) -> list:
    """Poll until ``want`` records arrived, at most ``max_polls`` times."""
    out: list = []
    for _ in range(max_polls):
        if len(out) >= want:
            break
        out += consumer.poll(timeout_ms=20)
    return out


def _lines(n, start=0, d=3):
    return [f"{i}," + ",".join(str((i * 7 + k) % 1000) for k in range(d))
            for i in range(start, start + n)]


def _close(*clients):
    for c in clients:
        c.close()


def test_jax_producer_to_port_broker_port_consumer_reads_back():
    with _broker() as b:
        prod = JProducer(b.address)
        lines = _lines(5000)
        prod.send_many("t", lines)
        prod.flush()
        cons = KafkaLiteConsumer("t", b.address)
        jcons = JConsumer("t", b.address)
        try:
            got = _drain(cons, 5000)
            assert got == lines == _drain(jcons, 5000)
            assert cons.position() == 5000
            cons.seek(1234)
            assert cons.position() == 1234
            assert _drain(cons, 100)[:3] == lines[1234:1237]
        finally:
            _close(prod, cons, jcons)


def test_port_arrays_plane_matches_line_parse_and_jax():
    if native.get_lib() is None:
        pytest.skip(f"no native helper here: {native.build_error()}")
    from skyline_tpu.bridge.wire import parse_tuple_lines

    with _broker() as b:
        prod = JProducer(b.address)
        lines = _lines(3000, d=4) + ["bad,line", "7,1,2,nan,4"] + _lines(10, 5000, 4)
        prod.send_many("t", lines)
        prod.flush()
        cons = KafkaLiteConsumer("t", b.address)
        jcons = JConsumer("t", b.address)
        try:
            parts, jparts = [], []
            for _ in range(100):
                got = cons.poll_arrays(4, timeout_ms=20)
                jgot = jcons.poll_arrays(4, timeout_ms=20)
                parts.append(got)
                jparts.append(jgot)
                if sum(p[0].shape[0] + p[2] for p in parts) >= len(lines):
                    break
            ids = np.concatenate([p[0] for p in parts])
            vals = np.concatenate([p[1] for p in parts])
            want = parse_tuple_lines(lines, 4)
            assert ids.tobytes() == want[0].tobytes()
            assert vals.tobytes() == want[1].tobytes()
            assert sum(p[2] for p in parts) == want[2] == 2
            assert ids.tobytes() == np.concatenate([p[0] for p in jparts]).tobytes()
            assert cons.position() == len(lines)
        finally:
            _close(prod, cons, jcons)


@pytest.mark.parametrize("how", ["send", "send_many", "send_blob"])
def test_port_producer_to_jax_broker(how):
    with _broker(JBroker) as b:
        prod = KafkaLiteProducer(b.address, linger_records=700)
        lines = _lines(2500, d=8)
        if how == "send":
            for ln in lines:
                prod.send("t", ln)
        elif how == "send_many":
            prod.send_many("t", lines)
        else:
            blob = "".join(lines).encode()
            offs = np.cumsum([0] + [len(ln) for ln in lines])
            prod.send_blob("t", blob, offs)
        prod.flush()
        cons = KafkaLiteConsumer("t", b.address)
        jcons = JConsumer("t", b.address)
        try:
            assert _drain(cons, 2500) == lines == _drain(jcons, 2500)
        finally:
            _close(prod, cons, jcons)


def test_latest_reset_skips_only_what_predates_the_subscription():
    with _broker() as b:
        prod = KafkaLiteProducer(b.address)
        prod.send("q", "old")
        prod.flush()
        cons = KafkaLiteConsumer("q", b.address, auto_offset_reset="latest")
        try:
            assert cons.poll(timeout_ms=20) == []
            prod.send("q", "new")
            prod.flush()
            assert _drain(cons, 1) == ["new"]
        finally:
            _close(prod, cons)


def _broker_process(port: int):
    """The port's broker CLI on 127.0.0.1:``port`` (0 picks one), and the
    address it printed — read within ``TIMEOUT_S``."""
    import selectors
    import subprocess
    import sys
    import time

    proc = subprocess.Popen(
        [sys.executable, "-m", "skyline_tpu_torch.bridge.kafkalite.broker",
         "--host", "127.0.0.1", "--port", str(port)],
        stderr=subprocess.PIPE, text=True, cwd=REPO,
    )
    sel = selectors.DefaultSelector()
    sel.register(proc.stderr, selectors.EVENT_READ)
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        if sel.select(timeout=0.2):
            line = proc.stderr.readline()
            if "listening on" in line:
                return proc, line.rsplit(" ", 1)[1].strip()
    proc.kill()
    raise AssertionError("the broker CLI printed no address")


def test_broker_restart_keeps_producer_and_consumer_alive():
    """The broker process dies (SIGKILL) and a new one starts on the same
    port with empty logs: the producer's next flush and the consumer's next
    poll reconnect under their retry budget, and the consumer, finding its
    offset past the new log's end, re-resolves it and reads what was
    produced after the restart — nothing of it lost or duplicated."""
    procs = []
    prod = cons = None
    try:
        proc, addr = _broker_process(0)
        procs.append(proc)
        prod = KafkaLiteProducer(addr)
        cons = KafkaLiteConsumer("t", addr)
        prod.send_many("t", _lines(100))
        prod.flush()
        assert _drain(cons, 100) == _lines(100)
        proc.kill()
        proc.wait(timeout=TIMEOUT_S)
        procs.append(_broker_process(int(addr.rsplit(":", 1)[1]))[0])
        prod.send_many("t", _lines(50, 100))
        prod.flush()
        assert prod._conn.reconnects >= 1
        assert _drain(cons, 50) == _lines(50, 100)
        assert cons._conn.reconnects >= 1 and cons.position() == 50
    finally:
        for c in (prod, cons):
            if c is not None:
                c._conn.close()
        for p in procs:
            p.kill()
            p.wait(timeout=TIMEOUT_S)


def test_message_cap_is_enforced_like_jax():
    with _broker(max_message_bytes=4096) as b:
        prod = KafkaLiteProducer(b.address, max_request_size=1024)
        try:
            with pytest.raises(MessageSizeTooLargeError):
                prod.send("t", "x" * 2000)
            big = KafkaLiteProducer(b.address)
            with pytest.raises(MessageSizeTooLargeError):
                big.send("t", "y" * 8000)
                big.flush()
            big._buf.clear()
            big.close()
        finally:
            prod.close()


# -- the worker over the wire -------------------------------------------------------


def _worker_lines(mod_worker, bus_cls, broker, cfg, lines, tag):
    from skyline_tpu_torch.bridge.wire import format_trigger

    bus = bus_cls(broker.address)
    topics = {k: f"{k}-{tag}" for k in ("in", "q", "out")}
    w = mod_worker.SkylineWorker(bus, cfg, input_topic=topics["in"],
                                 query_topic=topics["q"], output_topic=topics["out"])
    out = bus.consumer(topics["out"], from_beginning=True)
    try:
        bus.produce_many(topics["in"], lines)
        bus.produce(topics["q"], format_trigger("q1", 0))
        got = []
        for _ in range(300):
            w.step(max_records=700)
            got += out.poll()
            if got:
                break
        return [json.loads(x) for x in got], w._arrays_plane, w.engine.records_in
    finally:
        w.close()
        bus.close()


@pytest.mark.parametrize("d", [2, 8])
def test_port_worker_over_kafkalite_matches_jax_worker(d):
    import skyline_tpu.bridge.worker as jworker
    import skyline_tpu_torch.bridge.worker as tworker
    from skyline_tpu.bridge.kafka import KafkaBus as JKafkaBus
    from skyline_tpu.stream.engine import EngineConfig as JConfig
    from skyline_tpu_torch.bridge.kafka import KafkaBus
    from skyline_tpu_torch.stream.engine import EngineConfig
    from skyline_tpu_torch.workload.generators import anti_correlated

    rows = anti_correlated(np.random.default_rng(d), 1500, d, 0, 10000)
    lines = [f"{i}," + ",".join(str(int(v)) for v in r) for i, r in enumerate(rows)]
    lines.insert(10, "malformed")
    kw = dict(parallelism=2, dims=d, domain_max=10000.0, emit_skyline_points=True,
              flush_policy="lazy")
    with _broker() as b:
        got, plane, n_in = _worker_lines(tworker, KafkaBus, b, EngineConfig(**kw, device="cpu"),
                                   lines, "port")
        want, jplane, _ = _worker_lines(jworker, JKafkaBus, b, JConfig(**kw), lines, "jax")
    assert plane == jplane == (native.get_lib() is not None)
    untimed = [{k: v for k, v in r.items() if not k.endswith("_ms") and k != "trace_id"}
               for r in got]
    assert untimed == [{k: v for k, v in r.items()
                        if not k.endswith("_ms") and k != "trace_id"} for r in want]
    assert n_in == 1500 and len(got) == 1 and got[0]["skyline_size"] > 0
