"""Parameter / batch / cache sharding rules for the production mesh (port
of ``repro.parallel.sharding``).

Baseline layout (the reference's):

* 2-D param sharding — tensor-parallel over ``model`` and FSDP-style over
  ``data`` wherever both dims divide evenly (Megatron × ZeRO hybrid); the
  ``pod`` axis is pure data parallelism (params replicated across pods).
* batch shards over ``("pod", "data")``; a batch of 1 (``long_500k``)
  replicates batch and shards the KV-cache *length* over ``data``.
* optimizer moments mirror the param specs (ZeRO falls out for free).

A spec is the reference's PartitionSpec as a plain tuple, one entry per
leading tensor dim: ``None``, an axis name, or a tuple of axis names
(trailing dims unnamed).  The rules work on axis *sizes* only, so they run
on templates and on a duck-typed mesh (``.shape`` a dict, ``.axis_names``)
as well as on a ``DeviceMesh``.  :func:`placements` turns a spec into
DTensor ``Shard`` / ``Replicate`` placements, the counterpart of the
reference's ``named()``.  A dim is never sharded unless it divides
evenly: DTensor would allow uneven shards, the reference never makes
them.
"""

from __future__ import annotations

from typing import Any

from repro_torch.tree import tree_map, tree_map_with_path

#: 2-D weights whose *input* dim contracts on the model axis (output
#: projections): shard (model, data).  Everything else 2-D that divides
#: evenly shards (data, model).
_OUT_PROJ_NAMES = {"wo", "w2", "out_proj"}


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_sizes(mesh) -> tuple[int, int]:
    shape = mesh_shape(mesh)
    return shape.get("data", 1), shape.get("model", 1)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _spec(*entries) -> tuple:
    """A spec as a PartitionSpec normalizes it: a one-axis tuple entry
    becomes the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _names(path: tuple) -> list[str]:
    return [str(p) for p in path]


def _spec_for(path: tuple, leaf, *, data: int, model: int, d_ff: int,
              stacked: bool = False) -> tuple:
    """The spec of one parameter leaf (anything with ``.shape``) at
    ``path`` (its keys and indices from the root) for axis sizes ``data``
    and ``model``."""
    return _spec_for_shape(_names(path), tuple(leaf.shape), data=data,
                           model=model, d_ff=d_ff, stacked=stacked)


def _spec_for_shape(names: list[str], shape: tuple, *, data: int,
                    model: int, d_ff: int, stacked: bool) -> tuple:
    name = names[-1] if names else ""

    if stacked and "blocks" in names:
        # stacked pattern-block leaves carry a leading ``repeats`` dim:
        # compute the spec for the per-layer shape and prepend None.
        inner = _spec_for_shape(names, shape[1:], data=data, model=model,
                                d_ff=d_ff, stacked=False)
        return (None, *inner)

    if len(shape) <= 1:
        return ()  # scalars & vectors: replicate (tiny)

    if name == "embed":
        # vocab → model (PS-style sharded table), d_model → data (ZeRO)
        return ("model" if _div(shape[0], model) else None,
                "data" if _div(shape[1], data) else None)
    if name == "lm_head":
        return ("data" if _div(shape[0], data) else None,
                "model" if _div(shape[1], model) else None)
    if name == "pos":
        return (None, "model" if _div(shape[1], model) else None)

    if len(shape) == 3:  # MoE expert weights (E, in, out)
        e = "model" if _div(shape[0], model) else None
        if name == "w2":  # (E, F, D): F contracts; shard D over data
            return (e, None, "data" if _div(shape[2], data) else None)
        return (e, "data" if _div(shape[1], data) else None, None)

    if len(shape) == 2:
        out_proj = name in _OUT_PROJ_NAMES or (
            name == "wv" and shape[0] == d_ff  # rwkv channel-mix value proj
        )
        if out_proj:
            return ("model" if _div(shape[0], model) else None,
                    "data" if _div(shape[1], data) else None)
        return ("data" if _div(shape[0], data) else None,
                "model" if _div(shape[1], model) else None)

    return ()


def param_specs(params, cfg, mesh) -> Any:
    """Spec tree matching ``params`` (works on templates and on the
    AdamW state, whose moments mirror the parameters)."""
    data, model = _axis_sizes(mesh)

    def f(path, leaf):
        return _spec_for(path, leaf, data=data, model=model, d_ff=cfg.d_ff,
                         stacked=True)

    return tree_map_with_path(f, params)


def batch_axes(mesh) -> tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _batch_total(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    total = 1
    for a in axes:
        total *= shape[a]
    return total


def batch_specs(batch_template, mesh, *, batch_size: int) -> Any:
    """Shard the batch dim over ("pod","data") when divisible, else
    replicate (the ``long_500k`` B=1 case)."""
    axes = batch_axes(mesh)
    lead = axes if _div(batch_size, _batch_total(mesh, axes)) else None
    return tree_map(
        lambda leaf: _spec(lead, *([None] * (len(leaf.shape) - 1))),
        batch_template)


def cache_specs(cache_template, cfg, mesh, *, batch_size: int) -> Any:
    """Decode-cache sharding.  Leaves are stacked (repeats, B, …).

    * batch divisible → shard B over ("pod","data") and the KV cache
      *length* over model — flash-decode style: the q·K score contraction
      is then local per shard (only per-shard softmax stats/logits cross
      the mesh) instead of all-gathering K/V every layer;
    * B=1 (long_500k) → additionally shard the length over data.
    """
    axes = batch_axes(mesh)
    shard_batch = _div(batch_size, _batch_total(mesh, axes))
    data, model = _axis_sizes(mesh)

    def f(path, leaf):
        name = _names(path)[-1]
        shape = tuple(leaf.shape)
        s: list = [None] * len(shape)
        if shard_batch:
            s[1] = axes
        if name in ("k", "v", "ck", "cv"):
            # (repeats, B, L, KV, hd): L over model (+ data when B=1)
            if shard_batch:
                if _div(shape[2], model):
                    s[2] = "model"
            else:
                l_axes = tuple(a for a, n in (("data", data), ("model", model))
                               if _div(shape[2], n))
                if _div(shape[2], data * model):
                    s[2] = ("data", "model")
                elif l_axes:
                    s[2] = l_axes[0]
        elif name == "pos":
            if shard_batch:
                if _div(shape[2], model):
                    s[2] = "model"
            elif _div(shape[2], data * model):
                s[2] = ("data", "model")
            elif _div(shape[2], data):
                s[2] = "data"
        elif name in ("h", "conv"):           # mamba (…, din, N) / (…, W, din)
            din_axis = 2 if name == "h" else 3
            if _div(shape[din_axis], model):
                s[din_axis] = "model"
        elif name == "state":                 # rwkv (repeats, B, H, hd, hd)
            if _div(shape[2], model):
                s[2] = "model"
        elif name in ("tm_shift", "cm_shift"):
            if _div(shape[-1], model):
                s[-1] = "model"
        return _spec(*s)

    return tree_map_with_path(f, cache_template)


# --------------------------------------------------------------------------
# specs → DTensor placements
# --------------------------------------------------------------------------


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements, one per mesh dim, of a tensor laid out as
    ``spec``: ``Shard(d)`` on each mesh dim whose axis names tensor dim
    ``d``, ``Replicate()`` on the others.  A dim named by several axes
    (``("pod", "data")``) is split over them in the mesh's order — the
    first axis outermost, as a PartitionSpec splits it; a spec that
    lists them in another order, or names an axis twice or one the mesh
    lacks, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    where: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {tuple(names)}")
            if a in where:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            where[a] = d
            order.append(names.index(a))
        if order != sorted(order):
            raise ValueError(f"spec {spec} splits dim {d} over {axes}, "
                             f"against the mesh's axis order {tuple(names)}")
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in names)


def distribute(tree, spec_tree, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` laid out by the
    spec at the same place in ``spec_tree``.  Each rank cuts its shard
    from its own full copy (no communication): every rank must hold the
    same values."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(
        lambda t, s: distribute_tensor(t, mesh, placements(s, mesh),
                                      src_data_rank=None),
        tree, spec_tree)
