"""The chaos drill (``skyline_tpu_torch/deploy/drills/chaos.py``) on the
CPU, held against the JAX package, and the replica-death twin.

``python -m skyline_tpu_torch.deploy.drills chaos --device cpu
--outcomes-only`` must exit 0 with all five legs. Each leg then runs in
process through the JAX package's objects on the same streams and fault
plans, and the port's evidence must equal the JAX drill's:

- crash: the supervised answer's size and sha1, ``records_in``, restarts,
  ``wal.replayed``, ``checkpoint.saved``;
- audit: checks, divergences, the bundle's files, the replay's verdict, the
  published and oracle arrays' bytes (the JAX bundle replayed by
  ``python -m skyline_tpu.audit replay``);
- chip: the uninterrupted, degraded and healed answers' bytes, the
  excluded chip, the completeness bound, the failover's owner;
- replica: every version's CSV bytes, the fenced 503, the reconverged head;
- promotion: holder, epochs, the promoted head's bytes, the zombie's
  rejected append, the ops journal's chain and seqs.

``test_primary_death_and_restart_under_two_replicas_matches_jax`` is the
twin of the reference's ``tests/test_replica.py`` chaos scenario: a
generous replica and one fenced at 250 ms across the primary's death and
restart, every wait polled, held against the JAX replica. No test here
asserts a wall-clock bound (the card run holds those).

Tolerance: exact (digests of bytes, integer counters, the bound's float).
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from skyline_tpu_torch.deploy.drills import chaos

REPO = Path(__file__).resolve().parents[1]

WALLS = ("wall_ms", "refuse_ms", "time_to_promote_ms", "dark_ms")


def untimed(doc):
    if isinstance(doc, dict):
        return {k: untimed(v) for k, v in doc.items() if k not in WALLS}
    return doc


def jax_ns() -> SimpleNamespace:
    import functools

    from skyline_tpu.bridge import MemoryBus, SkylineWorker
    from skyline_tpu.bridge.wire import format_trigger, format_tuple_line
    from skyline_tpu.cluster import ClusterSupervisor, FencedWalWriter, LeasePlane, WalFencedError
    from skyline_tpu.distributed import ShardedEngine
    from skyline_tpu.resilience import ResilienceConfig, faults
    from skyline_tpu.resilience.supervisor import Supervisor
    from skyline_tpu.resilience.wal import WalWriter
    from skyline_tpu.serve import SkylineServer, SnapshotStore, delta_wal_record
    from skyline_tpu.serve.replica import SkylineReplica
    from skyline_tpu.serve.snapshot import points_digest
    from skyline_tpu.stream import EngineConfig, SkylineEngine
    from skyline_tpu.telemetry import Telemetry
    from skyline_tpu.telemetry.opslog import OpsLog, read_ops
    from skyline_tpu.workload.generators import anti_correlated

    return SimpleNamespace(
        MemoryBus=MemoryBus, SkylineWorker=SkylineWorker, format_trigger=format_trigger,
        format_tuple_line=format_tuple_line, EngineConfig=functools.partial(EngineConfig),
        SkylineEngine=SkylineEngine, ShardedEngine=ShardedEngine,
        ResilienceConfig=ResilienceConfig, FaultPlan=faults.FaultPlan,
        install_plan=faults.install_plan, clear=faults.clear, Supervisor=Supervisor,
        Telemetry=Telemetry, anti_correlated=anti_correlated, WalWriter=WalWriter,
        SkylineServer=SkylineServer, SnapshotStore=SnapshotStore,
        delta_wal_record=delta_wal_record, SkylineReplica=SkylineReplica,
        points_digest=points_digest, ClusterSupervisor=ClusterSupervisor,
        FencedWalWriter=FencedWalWriter, LeasePlane=LeasePlane, WalFencedError=WalFencedError,
        OpsLog=OpsLog, read_ops=read_ops, fault_plan=chaos.CRASH_PLAN,
        replay_cmd=[sys.executable, "-m", "skyline_tpu.audit", "replay"], replay_flags=[])


@pytest.fixture(scope="module")
def port_evidence():
    env = {k: v for k, v in os.environ.items() if k != "SKYLINE_FAULT_PLAN"}
    r = subprocess.run([sys.executable, "-m", "skyline_tpu_torch.deploy.drills", "chaos",
                        "--device", "cpu", "--outcomes-only"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for line in ("[chaos-smoke] PASS", "audit drill ok", "chip drill ok: slow@chip1",
                 "chip drill ok: crash@chip1", "replica drill ok", "promotion drill ok"):
        assert line in r.stdout, line
    ev = json.loads(r.stdout.strip().splitlines()[-1])
    assert ev["ok"] is True and ev["launches"] == {}
    return ev["drills"]["chaos"]


@pytest.fixture
def jax_state(monkeypatch):
    from skyline_tpu.resilience import faults

    monkeypatch.delenv("SKYLINE_FAULT_PLAN", raising=False)
    faults.clear()
    yield
    faults.clear()


@pytest.mark.parametrize("leg", ["crash", "audit", "chip", "promotion"])
def test_chaos_leg_matches_jax(port_evidence, jax_state, leg):
    ref = dict(chaos.LEGS)[leg](jax_ns(), bounds=False)
    assert untimed(port_evidence[leg]) == untimed(ref)


def test_chaos_drill_outcomes(port_evidence):
    ev = port_evidence
    assert ev["crash"]["restarts"] >= 1 and ev["crash"]["records_in"] == 600
    assert ev["crash"]["wal_replayed"] > 0 and ev["crash"]["checkpoint_saved"] >= 1
    assert ev["audit"]["reproduced"] is True and ev["audit"]["engine_diverges"] is False
    for action in ("slow", "crash"):
        assert ev["chip"][action]["healed_sha256"] == ev["chip"]["truth_sha256"]
        assert ev["chip"][action]["excluded_chips"] == [1]
    assert ev["replica"]["fenced_status"] == 503 and len(ev["replica"]["versions"]) == 6
    assert ev["promotion"]["chain"] == list(chaos.CHAIN)


def test_primary_death_and_restart_under_two_replicas_matches_jax(port_evidence, jax_state):
    got = chaos.replica_leg(chaos.port_ns("cpu"), bounds=False, fence_ms=250.0)
    ref = chaos.replica_leg(jax_ns(), bounds=False, fence_ms=250.0)
    assert untimed(got) == untimed(ref)
    assert got["fenced_status"] == 503 and got["fenced_stale"] is True and got["aging"]
    assert got["rebootstraps"] == 0 and got["bootstraps"] == 1 and got["head_version"] == 9
    # the 300 ms drill's versions are the same stream's
    assert got["versions"] == port_evidence["replica"]["versions"]
