"""Batched serving example: batched prefill + chunked KV-cache decode.

Exercises the three cache families — full attention KV (llama3.2-1b),
sliding-window ring buffer (gemma2-2b), recurrent state (rwkv6-7b,
jamba-v0.1-52b) — then the paged KV cache and the continuous-batching
loop (admit/evict against the shared page pool) on llama3.2-1b, all at
the archs' reduced sizes.

On a CUDA device the prefills run the flash forward kernel, jamba's MoE
layer the dispatch and combine kernels, and the paged and continuous
runs' decode steps the paged-decode kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode
      [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.examples import example_parser
from repro_torch.launch.serve import serve, serve_continuous

ARCHS = ("llama3.2-1b", "gemma2-2b", "rwkv6-7b", "jamba-v0.1-52b")
BATCH = 4
PROMPT_LEN = 16
GEN = 16
PAGE_SIZE = 8
SLOTS = 4
DECODE_CHUNK = 4


def build_parser() -> argparse.ArgumentParser:
    return example_parser(__doc__)


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    result: dict = {"archs": {}}
    for arch in ARCHS:
        out = serve(arch, reduced=True, batch=BATCH, prompt_len=PROMPT_LEN,
                    gen=GEN, device=args.device)
        print(f"{arch:20s} gen={out['generated_shape']} "
              f"vocab-valid={out['tokens_in_vocab']} "
              f"decode {out['decode_tok_per_s']:7.1f} tok/s")
        result["archs"][arch] = {k: out[k] for k in (
            "generated_shape", "tokens_in_vocab", "decode_tok_per_s")}

    out = serve("llama3.2-1b", reduced=True, batch=BATCH,
                prompt_len=PROMPT_LEN, gen=GEN, kv_impl="paged",
                page_size=PAGE_SIZE, device=args.device)
    print(f"{'llama3.2-1b/paged':20s} gen={out['generated_shape']} "
          f"decode {out['decode_tok_per_s']:7.1f} tok/s "
          f"kv {out['kv_bytes_per_token']:.0f} B/tok")
    result["paged"] = {k: out[k] for k in (
        "generated_shape", "tokens_in_vocab", "decode_tok_per_s",
        "kv_bytes_per_token")}

    out = serve_continuous("llama3.2-1b", slots=SLOTS, page_size=PAGE_SIZE,
                           decode_chunk=DECODE_CHUNK, device=args.device)
    ratio = out["kv_bytes_per_token_paged"] / out["kv_bytes_per_token_dense"]
    print(f"{'continuous batching':20s} requests={out['requests']} "
          f"gen={out['generated']} decode {out['decode_tok_per_s']:5.1f} "
          f"tok/s kv-bytes ratio paged/dense={ratio:.3f} "
          f"pool-conserved={out['pool_conserved']}")
    result["continuous"] = {
        "requests": out["requests"], "generated": out["generated"],
        "decode_tok_per_s": out["decode_tok_per_s"], "kv_ratio": ratio,
        "pool_conserved": out["pool_conserved"]}
    return result


if __name__ == "__main__":
    main()
