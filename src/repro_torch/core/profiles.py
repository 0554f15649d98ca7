"""Per-layer profiles — the scheduler's view of a DNN (HeterPS Fig. 3;
the port's copy of ``repro.core.profiles``).

The paper profiles each layer on a single unit of each resource type with
a small batch ``B_o`` to obtain ``OCT`` (original computation time) and
``ODT`` (original data-communication time).  We provide:

* :class:`LayerProfile` — one layer's features + per-type OCT/ODT, exactly
  the five LSTM input features of Fig. 3 (index, layer type, input size,
  weight size, comm time);
* analytic profiling (:func:`analytic_oct` / :func:`profile_layers`) that
  derives OCT/ODT from layer FLOPs/bytes and the resource roofline;
* the paper's four experimental models (MATCHNET/CTRDNN/2EMB/NCE,
  Appendix Figs. 13–16) as layer graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.resources import ResourceType

# Layer kinds understood by the profiler / LSTM one-hot (Fig. 3 "type").
LAYER_KINDS = (
    "embedding",     # sparse lookup — data-intensive
    "fc",            # fully-connected — compute-intensive
    "attention",
    "moe",
    "ssm",           # mamba / rwkv mixing
    "norm",
    "match",         # cosine/dot match head (MATCHNET)
    "nce",           # sampled-softmax loss head (NCE)
    "conv",
    "cross_attention",
)

#: small profiling batch size ``B_o`` (paper §4.1)
B_O = 64


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Profile of one layer.

    ``flops``/``weight_bytes``/``input_bytes``/``output_bytes`` are *per
    example*; ``oct``/``odt`` are seconds for a batch of ``B_o`` examples
    on one unit of each resource type (paper's OCT/ODT), index-aligned
    with the fleet.  ``alpha``/``beta`` are the Amdahl parallel fractions
    of computation and communication (Formulas 1–2).
    """

    index: int
    kind: str
    flops: float
    input_bytes: float
    weight_bytes: float
    output_bytes: float
    oct: tuple[float, ...]
    odt_sync: tuple[float, ...]   # gradient/parameter sync per B_o window
    odt_act: tuple[float, ...]    # activation hand-off per B_o window
    alpha: float = 0.95
    beta: float = 0.90

    @property
    def odt(self) -> tuple[float, ...]:
        return tuple(s + a for s, a in zip(self.odt_sync, self.odt_act))

    def comm_time(self, t: int) -> float:
        return self.odt[t]


def analytic_oct(
    kind: str,
    flops: float,
    input_bytes: float,
    output_bytes: float,
    weight_bytes: float,
    res: ResourceType,
) -> float:
    """Seconds to compute one layer for ``B_o`` examples on one unit.

    Roofline-style: compute time + memory time + input-ingest time.  For
    data-intensive kinds (embedding lookups) the FLOPs are negligible but
    the *ingest* term dominates — and is far worse on accelerators that
    must pull sparse inputs across PCIe.  This reproduces the paper's
    data-intensive vs compute-intensive split without physical profiling.
    """
    sparse = kind in ("embedding", "nce")
    eff_flops = res.flops * (res.sparse_eff if sparse else 1.0)
    compute = B_O * flops / eff_flops
    # Dense layers stream their full weights each step; sparse lookups only
    # touch the gathered rows (~= the layer's output bytes per example).
    weight_traffic = B_O * output_bytes if sparse else weight_bytes
    memory = (B_O * input_bytes + weight_traffic) / res.mem_bw
    ingest = B_O * input_bytes / res.ingest_bw if kind == "embedding" else 0.0
    return compute + memory + ingest


#: global batch size the weight-gradient sync is amortized over when
#: profiling (sync happens once per *training batch*, not per example;
#: the paper §6.2 notes exactly this small-batch profiling distortion for
#: its CPU runs — we amortize at the job batch size to avoid it).
TRAIN_BATCH_FOR_PROFILING = 4096


def analytic_odt(
    kind: str,
    output_bytes: float,
    weight_bytes: float,
    res: ResourceType,
    *,
    train_batch: int = TRAIN_BATCH_FOR_PROFILING,
) -> tuple[float, float]:
    """(sync, activation) communication seconds for ``B_o`` examples.

    * sync — gradient/parameter synchronization.  Dense layers allreduce /
      PS-push+pull their full weights once per *training batch* (amortized
      to the ``B_o`` window).  Sparse layers (embedding/nce) exchange only
      the touched rows — per example, the PS-for-sparse path of §3.
    * activation — hand-off of the layer output to the next stage.
    """
    if kind in ("embedding", "nce"):
        sync = 2.0 * B_O * output_bytes
    else:
        sync = 2.0 * weight_bytes * (B_O / train_batch)
    return sync / res.net_bw, B_O * output_bytes / res.net_bw


def profile_layers(
    specs: Sequence[tuple[str, float, float, float, float]],
    fleet: Sequence[ResourceType],
    *,
    alpha: float = 0.95,
    beta: float = 0.90,
) -> list[LayerProfile]:
    """Build :class:`LayerProfile`s from ``(kind, flops, in_b, w_b, out_b)``."""
    out = []
    for i, (kind, flops, in_b, w_b, out_b) in enumerate(specs):
        oct_ = tuple(analytic_oct(kind, flops, in_b, out_b, w_b, r) for r in fleet)
        pairs = [analytic_odt(kind, out_b, w_b, r) for r in fleet]
        out.append(
            LayerProfile(
                index=i, kind=kind, flops=flops, input_bytes=in_b,
                weight_bytes=w_b, output_bytes=out_b, oct=oct_,
                odt_sync=tuple(p[0] for p in pairs),
                odt_act=tuple(p[1] for p in pairs),
                alpha=alpha, beta=beta,
            )
        )
    return out


# ---------------------------------------------------------------------------
# The paper's four experimental models (Appendix Figs. 13–16).
#
# The appendix gives the structures only as figures; we reconstruct
# representative CTR-style layer stacks with the stated layer counts:
# MATCHNET (16 layers), CTRDNN (16), 2EMB (10), NCE (5).  Sizes follow the
# paper's setting — huge sparse inputs (≈10 TB-scale feature logs → large
# per-example sparse bytes) and modest dense towers.
# ---------------------------------------------------------------------------

_F = 4  # bytes per float32


def _fc(d_in: int, d_out: int) -> tuple[str, float, float, float, float]:
    return ("fc", 2.0 * d_in * d_out, d_in * _F, d_in * d_out * _F, d_out * _F)


def _norm(d: int) -> tuple[str, float, float, float, float]:
    return ("norm", 8.0 * d, d * _F, 2 * d * _F, d * _F)


def _emb(n_slots: int, dim: int, vocab: float) -> tuple[str, float, float, float, float]:
    # n_slots sparse feature slots, each a lookup+sum into `dim`; input is
    # the raw sparse ids/values (data-intensive part).
    return (
        "embedding",
        2.0 * n_slots * dim,
        n_slots * 64 * _F,          # sparse ids+values per example
        vocab * dim * _F,           # the (huge) table
        n_slots * dim * _F,
    )


def ctrdnn_layers() -> list[tuple[str, float, float, float, float]]:
    """CTRDNN (16 layers): embedding → deep FC tower → sigmoid head."""
    d = 1024
    ls = [_emb(400, 16, 1e7)]
    ls += [_fc(400 * 16, d)]
    for _ in range(6):
        ls += [_fc(d, d), _norm(d)]
    ls += [_fc(d, 1), ("fc", 2.0, _F, 2 * _F, _F)]
    assert len(ls) == 16, len(ls)
    return ls


def matchnet_layers() -> list[tuple[str, float, float, float, float]]:
    """MATCHNET (16 layers): two embedding towers + match head.

    More heterogeneous than CTRDNN (the paper: "MATCHNET is more complex
    … because of the diverse types of layers").
    """
    d = 1024
    ls = [
        _emb(300, 32, 2e7), _fc(300 * 32, d), _norm(d), _fc(d, d),   # query tower
        _emb(500, 32, 5e7), _fc(500 * 32, d), _norm(d), _fc(d, d),   # doc tower
        _fc(d, d), _norm(d), _fc(d, d), _norm(d),
        ("match", 2.0 * d, 2 * d * _F, 0.0, _F),
        _fc(2 * d, d), _fc(d, 256), _fc(256, 1),
    ]
    assert len(ls) == 16, len(ls)
    return ls


def twoemb_layers() -> list[tuple[str, float, float, float, float]]:
    """2EMB (10 layers): two embeddings feeding one shared FC tower."""
    d = 384
    ls = [
        _emb(200, 16, 8e6), _emb(200, 16, 8e6),
        _fc(400 * 16, d), _norm(d), _fc(d, d), _norm(d),
        _fc(d, d), _norm(d), _fc(d, 128), _fc(128, 1),
    ]
    assert len(ls) == 10, len(ls)
    return ls


def nce_layers() -> list[tuple[str, float, float, float, float]]:
    """NCE (5 layers): embedding + small tower + sampled-softmax head."""
    d = 256
    ls = [
        _emb(100, 64, 3e7), _fc(100 * 64, d), _fc(d, d),
        _norm(d),
        ("nce", 2.0 * d * 50, d * _F, 3e6 * d * _F, 50 * _F),
    ]
    assert len(ls) == 5, len(ls)
    return ls


PAPER_MODELS = {
    "CTRDNN": ctrdnn_layers,
    "MATCHNET": matchnet_layers,
    "2EMB": twoemb_layers,
    "NCE": nce_layers,
}


def paper_model_profiles(
    name: str, fleet: Sequence[ResourceType]
) -> list[LayerProfile]:
    return profile_layers(PAPER_MODELS[name](), fleet)


def profiles_from_json(path: str, fleet: Sequence[ResourceType]
                       ) -> list[LayerProfile]:
    """Load *measured* per-layer profiles (the paper's §4.1 profiling
    path: OCT/ODT measured on a single unit with a small batch).

    JSON schema: a list of layer objects, either
      {"kind", "oct": [s per type], "odt_sync": […], "odt_act": […]}
    (direct measurements, index-aligned with ``fleet``), or
      {"kind", "flops", "input_bytes", "weight_bytes", "output_bytes"}
    (size measurements → analytic OCT/ODT).  ``alpha``/``beta`` optional.
    """
    import json

    with open(path) as f:
        rows = json.load(f)
    out: list[LayerProfile] = []
    for i, r in enumerate(rows):
        kw = dict(alpha=r.get("alpha", 0.95), beta=r.get("beta", 0.90))
        if "oct" in r:
            if not (len(r["oct"]) == len(fleet)):
                raise ValueError(f"layer {i}: {len(r['oct'])} octs for "
                                 f"{len(fleet)} resource types")
            out.append(LayerProfile(
                index=i, kind=r["kind"],
                flops=r.get("flops", 0.0),
                input_bytes=r.get("input_bytes", 0.0),
                weight_bytes=r.get("weight_bytes", 0.0),
                output_bytes=r.get("output_bytes", 0.0),
                oct=tuple(r["oct"]),
                odt_sync=tuple(r.get("odt_sync", [0.0] * len(fleet))),
                odt_act=tuple(r.get("odt_act", [0.0] * len(fleet))),
                **kw,
            ))
        else:
            out.extend(profile_layers(
                [(r["kind"], r["flops"], r["input_bytes"],
                  r["weight_bytes"], r["output_bytes"])], fleet, **kw,
            ))
            object.__setattr__(out[-1], "index", i)
    return out


def ctrdnn_variant(num_layers: int) -> list[tuple[str, float, float, float, float]]:
    """CTRDNN with FC layers added/removed (paper §6.2, Table 2: 8/12/16/20)."""
    base = ctrdnn_layers()
    if num_layers == 16:
        return base
    if num_layers < 16:
        # drop (fc, norm) pairs from the middle
        drop = 16 - num_layers
        return base[:2] + base[2 + drop:]
    d = 512
    extra = []
    while len(extra) < num_layers - 16:
        extra.append(_fc(d, d))
        if len(extra) < num_layers - 16:
            extra.append(_norm(d))
    return base[:-2] + extra + base[-2:]
