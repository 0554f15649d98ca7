"""Sharded parameter-server subsystem (HeterPS §3; port of ``repro.ps``).

``ShardedTable`` vocab-partitions sparse embedding tables across PS
shards behind a pluggable ``Transport`` (in-process queues or real
worker processes) and keeps a hot-row cache on the device; ``PSClient``
overlaps the pulls/pushes with compute (double-buffered); ``TierPlacer``
re-pins hot rows from the access monitor's decisions; ``PSTelemetry``
meters per-shard traffic and feeds it back to the cost model;
``train_ctr_ps`` trains the CTR model over them.  The elastic fleet
waits for a later slice (ROADMAP.md queue 1 item 11).

Exports resolve lazily (PEP 562): a spawned shard worker process imports
``repro_torch.ps.server`` through this package, and must get the
numpy-only event loop without paying the torch import the client-side
modules need.
"""

_EXPORTS = {
    "PSClient": "repro_torch.ps.client",
    "TierPlacer": "repro_torch.ps.placement",
    "RoutingSpec": "repro_torch.ps.sharding",
    "ShardedTable": "repro_torch.ps.sharding",
    "sharded_pull": "repro_torch.ps.sharding",
    "sharded_update": "repro_torch.ps.sharding",
    "TIER_DEVICE": "repro_torch.ps.sharding",
    "TIER_HOST": "repro_torch.ps.sharding",
    "TIER_DISK": "repro_torch.ps.sharding",
    "PSTelemetry": "repro_torch.ps.telemetry",
    "ShardCounters": "repro_torch.ps.telemetry",
    "CTRConfig": "repro_torch.ps.workload",
    "click_stream": "repro_torch.ps.workload",
    "init_tower": "repro_torch.ps.workload",
    "make_step_fn": "repro_torch.ps.workload",
    "make_table": "repro_torch.ps.workload",
    "tower_from_numpy": "repro_torch.ps.workload",
    "train_ctr_ps": "repro_torch.ps.workload",
    "Transport": "repro_torch.ps.transport",
    "InProcTransport": "repro_torch.ps.transport",
    "MultiprocTransport": "repro_torch.ps.transport",
    "make_transport": "repro_torch.ps.transport",
    "PSShardError": "repro_torch.ps.transport",
    "PSShardLost": "repro_torch.ps.transport",
    "PSShardSlow": "repro_torch.ps.transport",
    "RetryPolicy": "repro_torch.ps.transport",
    "ShardServer": "repro_torch.ps.server",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
