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

Each prints one JSON line per reading, with ``correct`` (and
``control_correct``): whether the cell's own checks pass on the
program's (and the control's) numbers.  ``limits`` reads a dozen seeds
and the control in one process, so the kernels and CUDA start once.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

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


def train_limits(cell, driver, seeds, device, fault: str | None) -> None:
    """Per seed: the program's three checked steps (one window step
    after them) against the reference, and the float8 control against
    the reference; with ``fault="half_batch"`` the program's loss is taken
    over the first half of each batch only; ``"control_only"`` reads the
    control alone."""
    if fault == "half_batch":
        from harness import port  # noqa: F401  (puts the port on the path)
        from repro_torch.models import decoder as dec

        orig = dec.loss_fn

        def half(params, cfg, batch, **kw):
            n = batch["tokens"].shape[0] // 2
            return orig(params, cfg, {k: v[:n] for k, v in batch.items()},
                        **kw)

        dec.loss_fn = half
    for seed in seeds:
        t0 = time.perf_counter()
        rec = {"seed": seed, "fault": fault}
        if fault != "control_only":
            prog = driver.run_program(cell, seed, 0.1, False, device, t0)
            driver.free(device)
        t1 = time.perf_counter()
        ref = driver.run_reference(cell, seed, device)
        driver.free(device)
        t2 = time.perf_counter()
        if fault != "control_only":
            got = driver.compare(prog, ref, cell)
            rec.update(**got, correct=driver.verdict_checks(cell, got)[1],
                       losses=prog["losses"], ref_losses=ref["losses"],
                       program_s=t1 - t0, reference_s=t2 - t1)
        if fault in (None, "control_only"):
            ctl = driver.run_reference(cell, seed, device, quant="fp8")
            driver.free(device)
            rec["control"] = driver.compare(ctl, ref, cell)
            rec["control_correct"] = driver.verdict_checks(
                cell, rec["control"])[1]
        _emit(rec)


def alter_served_tokens() -> None:
    """Plant the fault 'a token altered where it is produced': the second
    token of every slot in every decode chunk is replaced by the next
    id."""
    from harness import port  # noqa: F401  (puts the port on the path)
    from repro_torch.models import decoder as dec

    orig = dec.decode_loop

    def altered(params, cfg, token, cache, index, steps, **kw):
        toks, ntok, cache = orig(params, cfg, token, cache, index, steps,
                                 **kw)
        toks = toks.clone()
        toks[:, 1] = (toks[:, 1] + 1) % cfg.vocab
        return toks, ntok, cache

    dec.decode_loop = altered


def limits(cell, driver, seeds, seconds: float, device,
           fault: str | None = None) -> None:
    if fault == "altered_token":
        alter_served_tokens()
    for seed in seeds:
        t0 = time.perf_counter()
        st = driver.prepare(cell, seed, device)
        driver.warm(st)
        reqs = driver.make_requests(st, seed, seconds)
        res, wall = driver.window(st, reqs, seconds)
        t1 = time.perf_counter()
        v = driver.check(st, reqs, res, seed, control=fault is None)
        v["correct"] = driver.verdict_checks(cell, v)[1]
        if fault is None:
            # the control judged as the program is: the same limits, on
            # the same sampled tokens
            v["control_correct"] = driver.verdict_checks(cell, {
                **v, **{k[len("control_"):]: x for k, x in v.items()
                        if k.startswith("control_")}})[1]
        _emit({"seed": seed, "fault": fault, **v, "requests": len(reqs),
               "completed": sum(o == "completed" for o in res["outcomes"]),
               **driver.end_to_end(res, wall), "setup_and_window_s": t1 - t0,
               "check_s": time.perf_counter() - t1})
        driver.free(st)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("sweep", "limits"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--fault", default=None,
                    choices=("half_batch", "altered_token", "control_only"))
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
    elif cell.driver == "train":
        train_limits(cell, driver, seeds, device, args.fault)
    else:
        limits(cell, driver, seeds, args.seconds, device, args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
