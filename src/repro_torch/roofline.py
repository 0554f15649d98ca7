"""Roofline terms of a traced dry-run step, for a cluster of H100s (port
of ``repro.roofline``).

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw

Constants are one NVIDIA H100 SXM's published peaks (NVIDIA's H100 data
sheet, dense rates without sparsity, at the full 700 W power limit):
989e12 bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM3, and NVLink
at 450e9 B/s per direction per GPU (900 GB/s both ways, all to all
inside one host of 8).  A mesh axis that spans hosts runs over
InfiniBand, which is several times slower than NVLink: the collective
term of such an axis is then a lower bound.

The dry run (:mod:`repro_torch.launch.dryrun`) traces a step over
DTensor arguments into an FX graph of per-device (local) ops and
``_c10d_functional`` collectives; :func:`collective_bytes_from_graph`
reads the collectives of that graph where the reference parsed compiled
HLO text.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12       # bf16 dense FLOP/s per H100 SXM
HBM_BW = 3.35e12          # bytes/s per H100 SXM
LINK_BW = 450e9           # bytes/s per direction per GPU over NVLink

#: ``_c10d_functional`` op names → the reference's HLO collective kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def _val_bytes(val) -> int:
    """Bytes of a node's output value (a tensor or a list of tensors)."""
    if isinstance(val, (list, tuple)):
        return sum(_val_bytes(v) for v in val)
    if hasattr(val, "numel") and hasattr(val, "element_size"):
        return int(val.numel()) * int(val.element_size())
    return 0


def collective_kind(node) -> str | None:
    """The reference's kind name of an FX node that calls a
    ``_c10d_functional`` collective (its own op name for one the
    reference has no kind for, such as a broadcast), else None."""
    if node.op != "call_function":
        return None
    ns = getattr(node.target, "namespace", None)
    if ns not in ("_c10d_functional", "c10d_functional"):
        return None
    name = node.target._schema.name.split("::")[-1]
    if name == "wait_tensor":
        return None
    return _KINDS.get(name, name)


def collective_bytes_from_graph(gm) -> dict:
    """Per-device collective bytes by kind of a traced FX graph: each
    ``_c10d_functional`` collective sized by its output (``meta["val"]``),
    as the reference sizes an HLO collective; the ``wait_tensor`` that
    completes it is not counted again."""
    graph = getattr(gm, "graph", gm)
    by_kind: dict[str, int] = {}
    counts: dict[str, int] = {}
    for node in graph.nodes:
        kind = collective_kind(node)
        if kind is None:
            continue
        b = _val_bytes(node.meta.get("val"))
        by_kind[kind] = by_kind.get(kind, 0) + b
        counts[kind] = counts.get(kind, 0) + 1
    return {
        "bytes_by_kind": by_kind,
        "counts": counts,
        "total_bytes": sum(by_kind.values()),
    }


def roofline_terms(*, flops: float, hbm_bytes: float,
                   collective_bytes: float) -> dict:
    compute = flops / PEAK_FLOPS
    memory = hbm_bytes / HBM_BW
    collective = collective_bytes / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    total = max(compute, memory, collective)
    terms["bound_fraction"] = {
        k.replace("_s", ""): (v / total if total else 0.0)
        for k, v in list(terms.items())
        if isinstance(v, float)
    }
    return terms


def model_flops(n_params_active: float, tokens: float) -> float:
    """MODEL_FLOPS = 6·N·D (per step), N = active params, D = tokens."""
    return 6.0 * n_params_active * tokens
