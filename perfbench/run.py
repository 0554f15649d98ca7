"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic mix, driver and per-layer metric
readers are all found by name from ``BENCHMARK.json`` and the files under
``perfbench/`` (see ``harness/spec.py``).  A run makes its inputs and
weights from ``--seed``, warms up the cell's own shapes (set-up, timed as
``setup_s`` from the start of this process), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints as its last line one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit.  It needs as many CUDA devices as the cell asks for and exits with
code 2 without them, and with code 3 if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from harness import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro``; ``repro_torch`` is another name)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def _num(x):
    return x if x is None or math.isfinite(x) else None


def result_line(cell, out: dict, trace: bool, device_info: dict) -> dict:
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            v = out["setup_s"] if m["name"] == "setup_s" else out["e2e"].get(
                m["name"])
            metrics[m["name"]] = {"value": _num(v), "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(cell=cell, **out)
        for m in cell.per_layer:
            v = spec.load_reader(cell, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": _num(v), "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if trace and out.get("trace") is not None:
        t = out["trace"]
        line["device"] = {**device_info, "busy_s": t.busy_s(),
                          "window_s": t.window_s}
        line["breakdown"] = {"device_ops": t.top_ops(10),
                             "idle_gaps": t.idle_gaps(out["spans"], 10)}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = spec.load_driver(cell)
    out = driver.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device,
                     t_start=T_START)
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = result_line(cell, out, bool(args.trace), device_info)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    print(out["note"])
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
