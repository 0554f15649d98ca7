"""Tracing + metrics spine of the port (copy of the parts of ``repro.obs``
the serve path uses; stdlib only).

* :func:`configure` — enable/disable instrumentation and pick a run
  directory; sets ``REPRO_OBS`` so processes spawned afterwards inherit
  the state;
* :func:`enabled` — the one branch every instrumentation site checks;
* :func:`flush` — write ``trace.json`` + append a ``metrics.jsonl``
  snapshot to the configured run directory.

``repro_torch.obs.bridge`` turns the live metrics into the cost model's
shapes for the re-planner; :func:`snapshot_resources` resolves it lazily,
so importing this package (as the spawned PS shard worker does) loads
neither ``repro_torch.core`` nor torch.
"""

from __future__ import annotations

import os

from repro_torch.obs import metrics, trace
from repro_torch.obs.metrics import REGISTRY, Registry
from repro_torch.obs.trace import BUFFER, instant, span

__all__ = [
    "BUFFER", "REGISTRY", "Registry", "configure", "enabled", "flush",
    "instant", "metrics", "run_dir", "snapshot_resources", "span", "trace",
]

_run_dir: str | None = None


def enabled() -> bool:
    return trace.enabled()


def run_dir() -> str | None:
    return _run_dir


def configure(*, enabled: bool | None = None,
              run_dir: str | None = None) -> None:
    """Flip instrumentation on/off and/or set the export directory.

    Passing ``run_dir`` implies ``enabled=True`` unless overridden.
    The enabled state is mirrored into the ``REPRO_OBS`` environment
    variable so processes spawned from here on inherit it.
    """
    global _run_dir
    if run_dir is not None:
        _run_dir = run_dir
        if enabled is None:
            enabled = True
    if enabled is not None:
        trace.set_enabled(enabled)
        REGISTRY.enabled = enabled
        os.environ["REPRO_OBS"] = "1" if enabled else "0"


def flush(extra: dict | None = None) -> dict | None:
    """Export the session to the configured run directory: write the
    merged Chrome trace and append one metrics snapshot.  Returns the
    paths (``None`` when no run directory is configured)."""
    if _run_dir is None:
        return None
    from repro_torch.obs import export

    return {"trace": export.write_trace(_run_dir),
            "metrics": export.write_metrics(_run_dir, extra)}


def snapshot_resources(base, **kw):
    """Lazy re-export of :func:`repro_torch.obs.bridge.snapshot_resources`
    (keeps ``repro_torch.core`` out of the shard worker's import path)."""
    from repro_torch.obs.bridge import snapshot_resources as _snap

    return _snap(base, **kw)
