"""Run-directory export: JSONL metric snapshots + Chrome trace files.

One run directory holds the whole session's observability output:

* ``metrics.jsonl`` — append-only; each line is one timestamped snapshot
  of every live registry (:func:`repro_torch.obs.metrics.snapshot_all`), so a
  run's metric trajectory is greppable / loadable with one
  ``json.loads`` per line;
* ``trace.json`` — the merged Chrome trace (main-process buffer + any
  worker events already collected into it), loadable in Perfetto.

Stdlib-only, like the rest of the obs spine.
"""

from __future__ import annotations

import json
import os
import time

from repro_torch.obs import metrics, trace

METRICS_FILE = "metrics.jsonl"
TRACE_FILE = "trace.json"


def metrics_snapshot(extra: dict | None = None) -> dict:
    """One timestamped snapshot of every live registry."""
    snap = {"unix_ts": time.time(), "registries": metrics.snapshot_all()}
    if extra:
        snap["extra"] = extra
    return snap


def write_metrics(run_dir: str, extra: dict | None = None) -> str:
    """Append one snapshot line to ``<run_dir>/metrics.jsonl``."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, METRICS_FILE)
    with open(path, "a") as f:
        f.write(json.dumps(metrics_snapshot(extra), default=str) + "\n")
    return path


def write_trace(run_dir: str, *event_lists) -> str:
    """Write the merged Chrome trace to ``<run_dir>/trace.json``."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, TRACE_FILE)
    return trace.write_chrome(path, *event_lists)


def read_metrics(run_dir: str) -> list[dict]:
    path = os.path.join(run_dir, METRICS_FILE)
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_trace(run_dir: str) -> dict:
    with open(os.path.join(run_dir, TRACE_FILE)) as f:
        return json.load(f)
