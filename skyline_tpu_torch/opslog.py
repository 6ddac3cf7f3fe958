"""CLI alias: ``python -m skyline_tpu_torch.opslog`` pretty-prints/diffs the
cluster ops journal (the implementation lives in
``skyline_tpu_torch.telemetry.opslog``; this module exists so the CLI sits
beside ``python -m skyline_tpu_torch.explain`` and ``python -m
skyline_tpu_torch.audit`` in the operator's muscle memory — RUNBOOK §2s)."""

from skyline_tpu_torch.telemetry.opslog import main

if __name__ == "__main__":
    raise SystemExit(main())
