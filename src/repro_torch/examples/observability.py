"""Observability example: traces + metrics from train and serve runs.

Shows the ``--obs-dir`` workflow as a library user sees it:

1. enable obs and run a short sparse-PS training job over the
   *multiprocess* transport — the spawned shard workers (NumPy only:
   they never touch the device) inherit the obs switch via
   ``REPRO_OBS`` and ship their spans back, so the merged ``trace.json``
   has one lane per worker pid next to the main process;
2. run a continuous-batching serve with open-loop arrivals and read the
   TTFT/TPOT histograms back from the metric registry;
3. feed the live metrics through the cost-model bridge
   (``obs.snapshot_resources``) to get the ``ResourceType`` shape the
   scheduler consumes.

``main`` puts the obs switch and ``REPRO_OBS`` back as it found them
before it returns, so a caller's later work runs uninstrumented.

The same outputs come from the CLIs:

  PYTHONPATH=src python -m repro_torch.launch.train --sparse-ps \\
      --steps 20 --ps-shards 2 --ps-transport multiproc \\
      --obs-dir /tmp/obsrun
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous \\
      --obs-dir /tmp/obsrun

Open ``<obs-dir>/trace.json`` at https://ui.perfetto.dev (or
``chrome://tracing``); each ``metrics.jsonl`` line is one JSON snapshot.

Run:  PYTHONPATH=src python -m repro_torch.examples.observability
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch import obs
from repro_torch.core.resources import CPU_CORE
from repro_torch.device import resolve_device
from repro_torch.examples import example_parser
from repro_torch.launch.serve import serve_continuous
from repro_torch.launch.train import train_sparse_ps

TRAIN_STEPS = 20
PS_SHARDS = 2
REQUESTS = [(8, 4), (8, 8), (16, 4), (8, 4)]
ARRIVAL_S = [0.0, 0.05, 0.1, 0.4]


def build_parser() -> argparse.ArgumentParser:
    return example_parser(__doc__)


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    was_enabled, was_env = obs.enabled(), os.environ.get("REPRO_OBS")
    run_dir = tempfile.mkdtemp(prefix="obsrun-")
    obs.configure(run_dir=run_dir)   # implies enabled=True; sets REPRO_OBS
    try:
        return _run(dev)
    finally:
        obs.configure(enabled=was_enabled)
        if was_env is None:
            os.environ.pop("REPRO_OBS", None)
        else:
            os.environ["REPRO_OBS"] = was_env


def _run(dev) -> dict:
    # 1) multiproc PS training: worker spans merge in as their own pid lanes
    summary = train_sparse_ps(steps=TRAIN_STEPS, num_shards=PS_SHARDS,
                              transport="multiproc", log_every=0,
                              device=dev)
    print(f"train: {summary['steps_per_sec']:.1f} steps/s, "
          f"pull {summary['pull_bw_gbs']:.2f} GB/s")

    # 2) continuous serve with open-loop arrivals → TTFT/TPOT histograms
    out = serve_continuous("llama3.2-1b", slots=2, page_size=8,
                           decode_chunk=4, requests=REQUESTS,
                           arrival_s=ARRIVAL_S, device=dev)
    ttft = obs.REGISTRY.find("serve.ttft_s")[0][1]
    print(f"serve: {out['decode_tok_per_s']:.1f} tok/s, "
          f"ttft p50={ttft.quantile(0.5):.3f}s p99={ttft.quantile(0.99):.3f}s")

    # 3) live cost-model bridge: measured PS bandwidths + serve signals in
    # the exact shapes core/profiles.py consumes
    snap = obs.snapshot_resources(CPU_CORE)
    print(f"bridge: {snap['resource'].name} "
          f"ingest_bw={snap['resource'].ingest_bw / 1e9:.2f} GB/s "
          f"net_bw={snap['resource'].net_bw / 1e9:.2f} GB/s")

    paths = obs.flush()
    with open(paths["trace"]) as f:
        trace = json.load(f)
    pids = {e["pid"] for e in trace["traceEvents"]}
    print(f"wrote {paths['trace']} ({len(trace['traceEvents'])} events, "
          f"{len(pids)} process lanes) and {paths['metrics']}")
    return {
        "train_steps_per_sec": summary["steps_per_sec"],
        "pull_bw_gbs": summary["pull_bw_gbs"],
        "requests": out["requests"], "generated": out["generated"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "ttft_p50_s": ttft.quantile(0.5), "ttft_p99_s": ttft.quantile(0.99),
        "resource": snap["resource"].name,
        "ingest_bw_gbs": snap["resource"].ingest_bw / 1e9,
        "net_bw_gbs": snap["resource"].net_bw / 1e9,
        "trace": paths["trace"], "metrics": paths["metrics"],
        "events": len(trace["traceEvents"]), "lanes": len(pids),
        "span_names": sorted({e["name"] for e in trace["traceEvents"]}),
    }


if __name__ == "__main__":
    main()
