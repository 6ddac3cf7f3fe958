"""Deterministic fault injection: named kill points compiled into the hot
paths as near-zero-cost no-ops when disabled.

Counterpart of ``skyline_tpu/resilience/faults.py``, with the same kill
points and plan grammar. Each instrumented site calls
``fault_point("<name>")``; with no plan installed that is one global load
and a ``None`` check. A plan — parsed from ``SKYLINE_FAULT_PLAN`` (e.g.
``crash@flush.pre_merge:3``, clauses comma-separated) or installed
programmatically — counts hits per point and raises ``InjectedCrash`` when
a clause's hit number comes up. Hit counting is global and monotonic, and
each clause fires exactly once, so a plan describes a bounded, reproducible
fault schedule.

Verbs: ``crash`` (raise ``InjectedCrash``), ``exit`` (``os._exit(86)``),
``corrupt`` (the site polls ``fault_fired()`` and mutates its own data —
the audit plane's divergence drill flips one byte of a published
snapshot), ``slow`` (sleep ``SKYLINE_FAULT_SLOW_MS`` and continue) and
``hang`` (stall until ``clear()`` or ``SKYLINE_FAULT_HANG_S``). A site that
exposes a scope passes it as ``fault_point(point, chip=c)``, and a clause
may target one scope as ``slow@sharded.chip_merge#2:1``.

``InjectedCrash`` subclasses ``BaseException`` deliberately: an injected
crash models a process death, so no ``except Exception`` recovery path may
swallow it.
"""

from __future__ import annotations

import os
import threading
import time

# every instrumented site, so a typo'd plan fails at parse time instead of
# silently never firing
KILL_POINTS = frozenset(
    (
        "flush.pre_merge",  # stream/batched.py flush_all entry
        "wal.pre_fsync",  # resilience/wal.py before os.fsync
        "wal.post_append",  # resilience/wal.py after a frame lands
        "checkpoint.pre_replace",  # utils/checkpoint.py before os.replace
        "snapshot.publish",  # serve/snapshot.py publish entry
        "kafka.poll",  # bridge/worker.py step() poll entry
        "audit.corrupt",  # serve/snapshot.py publish body byte-flip
        "sharded.chip_merge",  # distributed/sharded.py per-chip merge entry
        "replica.tail",  # serve/replica.py tail-loop iteration entry
        "replica.restore",  # serve/replica.py bootstrap entry
        "wal.rotate_during_tail",  # resilience/wal.py segment rotation
        "cluster.lease_expire",  # cluster/lease.py supervisor expiry branch
        "wal.stale_fence",  # cluster/lease.py fenced-append rejection
    )
)

# "corrupt" does not kill the process: the instrumented site polls
# fault_fired() and mutates its own data when the clause comes up — used
# by the audit divergence drill to flip one byte in a published snapshot.
# "slow" and "hang" return control to the site after the injected latency
# (sleep / stall) elapses — they model stragglers and wedged chips, not
# deaths.
_ACTIONS = ("crash", "exit", "corrupt", "slow", "hang")

# hang@ clauses park the calling thread on this event; clear() sets it so
# a drill teardown releases every stalled thread instead of leaking them
_HANG_RELEASE = threading.Event()


class InjectedCrash(BaseException):
    """A simulated process death (see module docstring for why this is a
    BaseException). Carries the kill point and — for chip-scoped clauses,
    which model a single chip failing rather than the process — the chip
    index, so supervisors and post-mortems can attribute the hit."""

    def __init__(self, msg: str, point: str | None = None,
                 chip: int | None = None, chip_scoped: bool = False):
        super().__init__(msg)
        self.point = point
        self.chip = chip
        self.chip_scoped = chip_scoped


def _split_scope(point: str) -> tuple[str, int | None]:
    """``"sharded.chip_merge#2"`` -> ``("sharded.chip_merge", 2)``;
    unscoped names pass through with ``None``."""
    base, sep, suffix = point.partition("#")
    if not sep:
        return point, None
    try:
        chip = int(suffix)
    except ValueError:
        raise ValueError(
            f"bad chip scope in fault point {point!r}: expected point#<int>"
        ) from None
    if chip < 0:
        raise ValueError(f"chip scope must be >= 0, got {point!r}")
    return base, chip


class FaultClause:
    """One ``action@point[#chip]:nth`` clause; fires once, then stays
    disarmed."""

    __slots__ = ("action", "point", "base", "chip", "nth", "fired")

    def __init__(self, action: str, point: str, nth: int):
        if action not in _ACTIONS:
            raise ValueError(f"fault action must be one of {_ACTIONS}, got {action!r}")
        base, chip = _split_scope(point)
        if base not in KILL_POINTS:
            raise ValueError(
                f"unknown kill point {base!r}; known: {sorted(KILL_POINTS)}"
            )
        if nth < 1:
            raise ValueError(f"fault hit number must be >= 1, got {nth}")
        self.action = action
        self.point = point
        self.base = base
        self.chip = chip
        self.nth = nth
        self.fired = False

    def __repr__(self):
        return f"{self.action}@{self.point}:{self.nth}"


def _slow_ms() -> float:
    from skyline_tpu_torch.utils.knobs import env_float

    return env_float("SKYLINE_FAULT_SLOW_MS", 250.0)


def _hang_s() -> float:
    from skyline_tpu_torch.utils.knobs import env_float

    return env_float("SKYLINE_FAULT_HANG_S", 3600.0)


class FaultPlan:
    """A parsed fault plan: per-point hit counters + one-shot clauses.

    ``last_fired`` records the most recent clause that went off
    (clause repr, base point, chip scope, hit number) so the supervisor's
    crash-dump flight line can attribute a sharded post-mortem to the
    chip and kill point that actually fired."""

    def __init__(self, clauses):
        self.clauses = list(clauses)
        self.hits: dict[str, int] = {}
        self.last_fired: dict | None = None

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``crash@flush.pre_merge:3,exit@kafka.poll:7`` -> FaultPlan.
        The action defaults to ``crash`` when omitted (``flush.pre_merge:3``)."""
        clauses = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            action, sep, rest = part.partition("@")
            if not sep:
                action, rest = "crash", part
            point, sep, nth_s = rest.partition(":")
            if not sep:
                raise ValueError(
                    f"bad fault clause {part!r}: expected action@point:nth"
                )
            clauses.append(FaultClause(action, point, int(nth_s)))
        if not clauses:
            raise ValueError(f"empty fault plan {spec!r}")
        return cls(clauses)

    def _fire(self, c: FaultClause, point: str, chip: int | None, n: int) -> bool:
        """Execute one armed clause. Returns True for data-mutating
        (corrupt) fires; slow/hang return False after the latency elapses;
        crash/exit never return."""
        c.fired = True
        self.last_fired = {
            "clause": repr(c),
            "point": point,
            "chip": c.chip if c.chip is not None else chip,
            "hit": n,
        }
        if c.action == "corrupt":
            return True
        if c.action == "slow":
            time.sleep(_slow_ms() / 1000.0)
            return False
        if c.action == "hang":
            # stall until a drill teardown (clear()) releases us; the env
            # safety valve bounds a forgotten drill to a finite wedge
            _HANG_RELEASE.wait(timeout=_hang_s())
            return False
        if c.action == "exit":
            os._exit(86)  # a hard process death, no unwinding
        raise InjectedCrash(
            f"injected crash at {c.point} (hit {n})",
            point=point,
            chip=c.chip if c.chip is not None else chip,
            chip_scoped=c.chip is not None,
        )

    def hit(self, point: str, chip: int | None = None) -> bool:
        """Count a hit; crash/exit clauses never return, a fired corrupt
        clause returns True so the site can mutate its own data.

        Sites that pass a ``chip`` scope tick two counters — the base
        point (unscoped clauses keep their historical semantics: the Nth
        hit across ALL chips) and ``point#chip`` (scoped clauses count
        only that chip's hits)."""
        n = self.hits.get(point, 0) + 1
        self.hits[point] = n
        n_scoped = None
        if chip is not None:
            scoped = f"{point}#{chip}"
            n_scoped = self.hits.get(scoped, 0) + 1
            self.hits[scoped] = n_scoped
        fired = False
        for c in self.clauses:
            if c.fired or c.base != point:
                continue
            if c.chip is None:
                if c.nth == n:
                    fired = self._fire(c, point, chip, n) or fired
            elif chip is not None and c.chip == chip and c.nth == n_scoped:
                fired = self._fire(c, point, chip, n_scoped) or fired
        return fired

    def exhausted(self) -> bool:
        return all(c.fired for c in self.clauses)

    def __repr__(self):
        return f"FaultPlan({','.join(map(repr, self.clauses))})"


_PLAN: FaultPlan | None = None


def fault_point(point: str, chip: int | None = None) -> None:
    """THE hot-path hook. With no plan installed this is one global load
    and a None check."""
    plan = _PLAN
    if plan is not None:
        plan.hit(point, chip)


def fault_fired(point: str) -> bool:
    """Like fault_point but for data-mutating clauses: returns True when a
    ``corrupt@<point>`` clause fires on this hit. Same no-plan fast path."""
    plan = _PLAN
    return plan.hit(point) if plan is not None else False


def install_plan(plan: FaultPlan | None) -> None:
    global _PLAN
    _PLAN = plan


def active_plan() -> FaultPlan | None:
    return _PLAN


def clear() -> None:
    global _HANG_RELEASE
    install_plan(None)
    # release any thread parked on a hang@ clause, then re-arm for the
    # next plan (threads already waiting hold a reference to the old
    # event, so set-then-replace wakes them without racing new installs)
    _HANG_RELEASE.set()
    _HANG_RELEASE = threading.Event()


def install_from_env() -> FaultPlan | None:
    """Install the ``SKYLINE_FAULT_PLAN`` plan if one is set and none is
    active yet. Parse-once semantics: an already-installed plan keeps its
    hit counters and fired flags across in-process worker restarts (the
    whole point — each clause kills exactly one incarnation)."""
    global _PLAN
    if _PLAN is not None:
        return _PLAN
    from skyline_tpu_torch.utils.knobs import env_str

    spec = env_str("SKYLINE_FAULT_PLAN")
    if spec:
        _PLAN = FaultPlan.parse(spec)
    return _PLAN
