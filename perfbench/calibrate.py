"""Readings the benchmark's bounds, rates and limits were set from; not run
by the benchmark itself.

    # the knee of an open-loop serving cell: one seed, windows at rates
    python3 perfbench/calibrate.py sweep --workload olmoe-chat \\
        --rates 2,3,4 --seconds 30
    # the judge's numbers for the program and for its control (the plain
    # reference in float8 in the program's place), seed by seed, at the
    # cell's own size and load; a training cell also with a fault planted
    python3 perfbench/calibrate.py limits --workload olmoe-chat \\
        --seeds 11,12,13 --seconds 20
    python3 perfbench/calibrate.py limits --workload olmoe-train-2k \\
        --seeds 11,12,13 --seconds 0 --fault half_batch
    # a CTR cell: whole runs with a short window, faults planted
    python3 perfbench/calibrate.py limits --workload ctr-criteo \\
        --seeds 11,12,13 --seconds 5 --fault zeroed_push

``limits`` hands the cell to its driver's ``calibrate(cell, seeds,
seconds, device, fault, emit)``, which plants the faults it knows.  Each
prints one JSON line per reading, with ``correct`` (and
``control_correct``): whether the cell's own checks pass on the
program's (and the control's) numbers.  ``limits`` reads a dozen seeds
and the control in one process, so the kernels and CUDA start once.
"""

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from harness import spec  # noqa: E402


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def sweep(cell, driver, rates, seconds: float, seed: int, device) -> None:
    st = driver.prepare(cell, seed, device)
    driver.warm(st)
    for rate in rates:
        c = dataclasses.replace(cell, params={**cell.params,
                                              "rate_per_s": rate})
        st.cell = c
        reqs = driver.make_requests(st, seed, seconds)
        res, wall = driver.window(st, reqs, seconds)
        done = [i for i, o in enumerate(res["outcomes"]) if o == "completed"]
        late = [res["arrival_s"][i] + res["total_s"][i] - seconds
                for i in done]
        _emit({"rate_per_s": rate, "requests": len(reqs),
               "completed": len(done), "wall_s": wall,
               **driver.end_to_end(res, wall),
               "ttft_p50_ms": 1e3 * sorted(
                   res["ttft_s"][i] for i in done)[len(done) // 2]
               if done else None,
               "last_done_after_window_s": max(late) if late else None,
               "decode_step_ms": 1e3 * res["decode_s"]
               / max(1, res["decode_steps"])})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("sweep", "limits"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--fault", default=None,
                    help="a fault that the cell driver's calibrate "
                    "plants, or control_only where it reads the control "
                    "alone")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = spec.load_driver(cell)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.mode == "sweep":
        sweep(cell, driver, [float(r) for r in args.rates.split(",")],
              args.seconds, seeds[0], device)
    else:
        driver.calibrate(cell, seeds, args.seconds, device, args.fault, _emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
