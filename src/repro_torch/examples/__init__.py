"""The reference's five ``examples/`` scripts, ported: each module runs
as ``python -m repro_torch.examples.<name>`` with the reference's flags
plus ``--device`` (default ``cuda``; ``cpu`` for the plain path), prints
the reference's lines in its order, and returns the printed numbers
from ``main(argv) -> dict``.

* ``quickstart`` — the HeterPS flow on CTRDNN: profiles, the RL-LSTM
  search against the baselines, provisioning, then a short training run;
* ``serve_decode`` — batched prefill and decode over the cache families,
  the paged KV cache and continuous batching;
* ``schedule_all_archs`` — the ten archs' layers scheduled on a
  four-type fleet;
* ``observability`` — traces and metrics from a multi-process PS run and
  a continuous serve, and the cost-model bridge;
* ``heterps_ctr_pipeline`` — the CTR model over the sharded PS with a
  pipelined dense tower (``--chaos``: the checkpoint/restore walkthrough).

Sizes are module constants, as in the reference.
"""

import argparse


def example_parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser: ``doc``'s first paragraph as its
    description and ``--device`` (default ``cuda``), the one flag every
    example adds to the reference's."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    return ap
