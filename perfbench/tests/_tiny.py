"""A test-sized benchmark written to a temporary folder: a cell, its
configuration, mix and cell file found from files alone, driven on the CPU
through the same drivers as the chip's cells."""

from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

TINY_MODELS = {
    "moe": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
            "head_dim": 16, "vocab": 500, "ffn": "moe", "d_ff": 64,
            "n_experts": 8, "top_k": 2, "capacity_factor": 1.25,
            "qk_norm": True, "rope_theta": 10000.0, "rope_fraction": 1.0,
            "norm_eps": 1e-6, "moe_aux_coef": 0.01, "dtype": "bfloat16"},
    "dense": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
              "head_dim": 16, "vocab": 500, "ffn": "dense", "d_ff": 96,
              "qk_norm": False, "rope_theta": 10000.0, "rope_fraction": 0.5,
              "norm_eps": 1e-6, "dtype": "bfloat16"},
}

#: the tiny cells' limits, read from tiny runs as the chip cells' were
#: from theirs.  The tiny model runs in float32: in bfloat16 a 64-wide
#: model's round-off is as large as the float8 control's (serving gaps up
#: to 1.8 where its routing flips; training loss 0.3%, gradients 2%),
#: while in float32 the program reads 0 (serving) and 1e-7 to 1e-6
#: (training), and the float8 control 0.3-1.5 and 0.006 / 0.04 / 0.008.
SERVE_LIMIT = 0.05
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_norm_gap": 1e-3,
                "update_norm_gap": 1e-3}

#: a CTR model over five slots, its table 1,364 rows of 4
TINY_CTR = {"vocab": 1364, "emb_dim": 4, "slots": 5, "tower": [16, 8],
            "activation": "tanh", "lr": 0.05, "emb_lr_scale": 10.0,
            "init_scale": 0.05, "dtype": "float32",
            "cardinalities": [50, 7, 300, 3, 1004]}
TINY_CTR_MIX = {"kind": "ctr_ids", "batch": 64, "zipf_exponent": 1.1,
                "positive_rate": 0.256, "label_weight": 0.7}
#: the tiny CTR cell's limits: on the CPU the program reads 0 to 1e-7
#: (loss, tower) and up to 1e-6 (rows), the bfloat16 control 1e-3 and more;
#: in the window the program's sampled steps read 0, the control 1e-4
#: (loss), 9e-4 (tower), 0.01 (row gradients), and the program's pushes
#: add up to 1.2e-5, one push zeroed or misrouted to 1.2 and more
CTR_LIMITS = {"loss_gap": 1e-5, "grad_norm_gap": 1e-4,
              "update_norm_gap": 1e-4, "row_norm_gap": 1e-4,
              "stray_rows": 0, "batches_untrained": 0, "pushes_missing": 0,
              "hot_rows_differing": 0, "nonfinite_losses": 0,
              "push_sum_gap": 1e-3, "window_stray_rows": 0,
              "window_loss_gap": 1e-5, "window_update_gap": 1e-4,
              "window_grad_gap": 1e-4}
CTR_METRICS = {"pull_wait_share.ctr": "%", "ps_push_ms.ctr": "ms",
               "repin_share.ctr": "%", "hot_row_share.ctr": "%",
               "device_idle.ctr": "%"}


def write_bench(root: Path, *, kind: str = "moe", dtype: str = "float32",
                extra_metrics=()) -> Path:
    """A BENCHMARK.json with a serving cell ``serve-<kind>`` (open loop),
    an offline cell ``offline-<kind>``, a training cell ``train`` and a
    CTR cell ``ctr`` (two PS shards in-process, a re-pin every 10 steps),
    and their files under ``root/perfbench``."""
    pb = root / "perfbench"
    for d in ("configs", "traffic", "cells"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    model = {**TINY_MODELS[kind], "dtype": dtype}
    (pb / "configs" / f"tiny-{kind}.json").write_text(
        json.dumps({"name": f"tiny-{kind}", "model": model}))
    lens = {"prompt": {"dist": "lognormal", "median": 40, "sigma": 0.8,
                       "min": 8, "max": 120},
            "output": {"dist": "lognormal", "median": 12, "sigma": 0.8,
                       "min": 4, "max": 40}}
    (pb / "traffic" / "tiny-chat.json").write_text(
        json.dumps({"kind": "open_loop", **lens}))
    (pb / "traffic" / "tiny-offline.json").write_text(
        json.dumps({"kind": "backlog", "block": 8, **lens}))
    (pb / "traffic" / "tiny-pretrain.json").write_text(
        json.dumps({"kind": "tokens", "batch": 2, "seq_len": 64}))
    serve = {"driver": "serve", "slots": 4, "page_size": 16,
             "decode_chunk": 8, "grace_s": 30, "check_tokens": 40,
             "trace_slice": {"start_s": 0.2, "length_s": 0.5},
             "limits": {"max_logit_gap": SERVE_LIMIT}}
    (pb / "cells" / f"serve-{kind}.json").write_text(
        json.dumps({**serve, "rate_per_s": 6}))
    (pb / "cells" / f"offline-{kind}.json").write_text(
        json.dumps({**serve, "backlog": 40}))
    (pb / "cells" / "train.json").write_text(json.dumps(
        {"driver": "train", "lr": 3e-4, "weight_decay": 0.1, "clip": 1.0,
         "checked_steps": 3, "trace_slice": {"start_s": 0.1, "length_s": 0.1},
         "limits": TRAIN_LIMITS}))
    (pb / "configs" / "tiny-ctr.json").write_text(
        json.dumps({"name": "tiny-ctr", "ctr": TINY_CTR}))
    (pb / "traffic" / "tiny-ctr.json").write_text(json.dumps(TINY_CTR_MIX))
    (pb / "cells" / "ctr.json").write_text(json.dumps(
        {"driver": "ctr", "shards": 2, "transport": "inproc",
         "partition": "mod", "depth": 2, "repin_interval": 10,
         "checked_steps": 3, "checked_repin_interval": 1,
         "trace_slice": {"start_s": 0.1, "length_s": 0.1},
         "limits": CTR_LIMITS}))
    cells = [f"serve-{kind}", f"offline-{kind}"]
    bench = {
        "configs": [{"name": f"tiny-{kind}",
                     "file": f"perfbench/configs/tiny-{kind}.json"},
                    {"name": "tiny-ctr",
                     "file": "perfbench/configs/tiny-ctr.json"}],
        "workloads": [
            {"name": f"serve-{kind}", "config": f"tiny-{kind}",
             "traffic": "tiny-chat", "chips": 1},
            {"name": f"offline-{kind}", "config": f"tiny-{kind}",
             "traffic": "tiny-offline", "chips": 1},
            {"name": "train", "config": f"tiny-{kind}",
             "traffic": "tiny-pretrain", "chips": 1},
            {"name": "ctr", "config": "tiny-ctr", "traffic": "tiny-ctr",
             "chips": 1}],
        "end_to_end": [
            {"name": "ttft_p90_ms", "unit": "ms", "workloads": cells[:1]},
            {"name": "tpot_p90_ms", "unit": "ms", "workloads": cells[:1]},
            {"name": "out_tok_s", "unit": "tokens/s", "workloads": cells[1:]},
            {"name": "train_samples_s", "unit": "samples/s",
             "workloads": ["train"]},
            {"name": "ctr_examples_s", "unit": "examples/s",
             "workloads": ["ctr"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "queue_wait_p90_ms", "unit": "ms",
             "workloads": cells[:1]},
            {"name": "prefill_ms_per_ktok", "unit": "ms",
             "workloads": cells[:1]},
            {"name": "decode_step_ms.chat", "unit": "ms",
             "workloads": cells[:1]},
            {"name": "step_mfu.offline", "unit": "%", "workloads": cells[1:]},
            {"name": "step_mfu.train", "unit": "%", "workloads": ["train"]},
            *({"name": m, "unit": u, "workloads": ["ctr"]}
              for m, u in CTR_METRICS.items()),
            *extra_metrics],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
