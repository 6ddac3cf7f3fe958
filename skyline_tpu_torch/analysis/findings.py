"""Shared finding record of the analysis passes.

The port's copy of ``skyline_tpu/analysis/findings.py``: every pass (knob
lint, graph audit, lock lint) reports ``file:line severity rule message``,
one line per finding. ``severity`` is ``error`` (fails the gate) or ``warn``
(printed, never fails).
"""

from __future__ import annotations

from dataclasses import dataclass

SEVERITIES = ("error", "warn")


@dataclass(frozen=True)
class Finding:
    file: str
    line: int
    severity: str
    rule: str
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")

    def format(self) -> str:
        return f"{self.file}:{self.line} {self.severity} {self.rule} {self.message}"


def errors(findings) -> list[Finding]:
    return [f for f in findings if f.severity == "error"]
