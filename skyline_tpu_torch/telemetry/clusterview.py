"""The ``GET /cluster/overview`` document.

Counterpart of ``overview_doc`` and ``members_from_env`` in
``skyline_tpu/telemetry/clusterview.py``, for the case the port can answer:
no members configured and no ``ClusterView`` on the hub, where the
reference answers ``{"ok": true, "enabled": false}``. The scrape of the
members (``ClusterView``) is not ported yet (ROADMAP queue 1 item 8), so
with members configured this raises instead of answering a document it did
not compute.
"""

from __future__ import annotations

from skyline_tpu_torch.utils.knobs import env_str


def members_from_env() -> list[str]:
    """``SKYLINE_CLUSTERVIEW_MEMBERS``: comma-separated member base URLs."""
    raw = env_str("SKYLINE_CLUSTERVIEW_MEMBERS") or ""
    return [m.strip() for m in raw.split(",") if m.strip()]


def overview_doc(telemetry=None) -> dict:
    """``{"ok": true, "enabled": false}`` when the hub carries no
    ``clusterview`` and ``SKYLINE_CLUSTERVIEW_MEMBERS`` names no member;
    otherwise ``NotImplementedError``."""
    cv = getattr(telemetry, "clusterview", None) if telemetry is not None else None
    members = members_from_env()
    if cv is None and not members:
        return {"ok": True, "enabled": False}
    raise NotImplementedError(
        "the cluster overview's scrape of "
        f"{members or 'the attached ClusterView'} is not ported yet "
        "(ROADMAP queue 1 item 8)"
    )
