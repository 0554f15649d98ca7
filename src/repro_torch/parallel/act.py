"""Activation layouts on a DeviceMesh, mesh-context aware (port of
``repro.parallel.act``).

Under ``with use_mesh(mesh):`` each helper redistributes a DTensor to the
reference's layout for that activation — the counterpart of
``jax.lax.with_sharding_constraint``: the batch dim on the data axes, a
head / feature / vocab / expert dim on ``model``.  With no mesh active,
or for a plain tensor, each returns its input object unchanged, so the
single-device path gains no launch, no host sync and no bit.  A dim that
does not divide its axes evenly is left replicated, as in the reference.

:func:`use_mesh` also lets plain tensors (positions, masks, zero
scalars) meet DTensors in one op as replicated values
(``implicit_replication``), which the decoder's index arithmetic needs.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.parallel.sharding import _spec_for, mesh_shape, placements
from repro_torch.tree import tree_map_with_path

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh of the helpers below (the reference's
    ``with mesh:``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _MESH.get()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _active(x):
    """The active mesh when ``x`` is a DTensor under one, else None."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return None
    return mesh


def _axes_for_batch(mesh, n: int):
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if a in shape)
    prod = 1
    for a in axes:
        prod *= shape[a]
    if axes and prod and n % prod == 0:
        return axes
    return None


def _model_axis(mesh, n: int):
    shape = mesh_shape(mesh)
    if "model" in shape and n % shape["model"] == 0:
        return "model"
    return None


def _constrain(x, spec):
    return x.redistribute(x.device_mesh, placements(tuple(spec),
                                                    x.device_mesh))


def shard_batch_act(x):
    """(B, …) activations: batch over ("pod","data")."""
    mesh = _active(x)
    if mesh is None:
        return x
    axes = _axes_for_batch(mesh, x.shape[0])
    if axes is None:
        return x
    return _constrain(x, (axes, *([None] * (x.dim() - 1))))


def shard_logits(x):
    """(B, S, V) logits: batch over data axes, vocab over model."""
    mesh = _active(x)
    if mesh is None:
        return x
    axes = _axes_for_batch(mesh, x.shape[0])
    vax = _model_axis(mesh, x.shape[-1])
    if axes is None and vax is None:
        return x
    return _constrain(x, (axes, *([None] * (x.dim() - 2)), vax))


def shard_heads(x, *, axis: int):
    """The head dim ``axis`` of an attention intermediate on the model
    axis (tensor parallelism through the score products); batch dim 0 on
    the data axes."""
    mesh = _active(x)
    if mesh is None:
        return x
    spec = [None] * x.dim()
    spec[0] = _axes_for_batch(mesh, x.shape[0])
    spec[axis] = _model_axis(mesh, x.shape[axis])
    if spec[0] is None and spec[axis] is None:
        return x
    return _constrain(x, spec)


def shard_last_dim(x):
    """(B, …, F) hiddens: batch over data axes, feature over model — the
    Megatron column-parallel FFN / state layout."""
    mesh = _active(x)
    if mesh is None:
        return x
    spec = [None] * x.dim()
    spec[0] = _axes_for_batch(mesh, x.shape[0])
    spec[-1] = _model_axis(mesh, x.shape[-1])
    if spec[0] is None and spec[-1] is None:
        return x
    return _constrain(x, spec)


def gather_params(p, cfg):
    """Each float weight of one layer ``p`` (ndim ≥ 2) in the layout of
    the reference's ``gather_params``: ``_spec_for`` at axis sizes
    ``data=1`` and the mesh's ``model``.  As in the reference, ``data=1``
    divides every dim, so the spec keeps the ``data`` axis wherever the
    stored layout has it (ROADMAP.md R8).  Returns ``p`` itself with no
    mesh active."""
    mesh = _MESH.get()
    if mesh is None:
        return p
    model = mesh_shape(mesh).get("model", 1)

    def f(path, leaf):
        if (not is_dtensor(leaf) or leaf.dim() < 2
                or not leaf.is_floating_point()):
            return leaf
        return _constrain(leaf, _spec_for(path, leaf, data=1, model=model,
                                          d_ff=cfg.d_ff))

    return tree_map_with_path(f, p)


def shard_moe_group_buffer(x):
    """(G, E, C, D) grouped expert buffers: groups over the data axes,
    experts over the model axis."""
    mesh = _active(x)
    if mesh is None:
        return x
    gax = _axes_for_batch(mesh, x.shape[0])
    eax = _model_axis(mesh, x.shape[1])
    if gax is None and eax is None:
        return x
    return _constrain(x, (gax, eax, *([None] * (x.dim() - 2))))


def unshard(x, *dims: int):
    """``x`` with the given dims whole on every rank (a DTensor's shards of
    them gathered; a plain tensor returned as it is).  DTensor, unlike
    XLA's SPMD partitioner, refuses to split a sharded dim into two when
    the blocks straddle the split (the (H,) → (KV, G) regrouping of GQA
    heads over 16 ranks), so such reshapes gather the dim first."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.dim() for d in dims}
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def split_heads(x, n: int, hd: int):
    """(…, n·hd) → (…, n, hd).  For a DTensor whose last dim is split
    over more ranks than divide ``n``, the last dim is gathered first (see
    :func:`unshard`)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard

        k = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == x.dim() - 1:
                k *= x.device_mesh.size(i)
        if n % k:
            x = unshard(x, -1)
    return x.reshape(*x.shape[:-1], n, hd)


def _shard_range(n: int, dim: int, mesh, placements) -> tuple[int, int]:
    """(offset, length) of this rank's block of a dim of size ``n``, in
    Python integers (DTensor's own helper computes with tensors, which a
    trace would record).  The mesh dims shard in order, each into
    ``torch.chunk``-sized blocks."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    offset, length = 0, n
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(i)
            size = -(-length // k)
            start = min(coord[i] * size, length)
            offset += start
            length = min(size, length - start)
    return offset, length


def per_expert(fn, buf, *weights):
    """``fn(buf, *weights)`` for a (G, E, …) expert buffer and (E, …)
    expert weights.  Plain tensors: called as it is.  DTensors: each rank
    runs ``fn`` on its own groups and experts (``local_map``) — the buffer
    keeps its group and expert shards, each weight is gathered to its
    rank's experts whole (the FSDP gather), and a weight's gradient is a
    partial sum over the mesh dims that split the groups.  DTensor's own
    rules would flatten (G, E) with E sharded for the batched product,
    which they refuse."""
    if not is_dtensor(buf):
        return fn(buf, *weights)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    b_pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
                 else Replicate() for p in buf.placements)
    w_pl = tuple(Shard(0) if p == Shard(1) else Replicate() for p in b_pl)
    w_grad = tuple(Partial() if p == Shard(0) else q
                   for p, q in zip(b_pl, w_pl))
    n = len(weights)
    return local_map(fn, out_placements=(b_pl,),
                     in_placements=(b_pl,) + (w_pl,) * n,
                     in_grad_placements=(b_pl,) + (w_grad,) * n,
                     redistribute_inputs=True)(buf, *weights)


def embed_lookup(table, ids):
    """``table[ids]``: rows of a (V, D) table.  For a DTensor table the
    lookup is vocab-parallel (``local_map``): the table keeps its vocab
    shards and gathers its feature dim, each rank reads the ids that fall
    in its vocab block (zeros for the others) and the output is a partial
    sum over the vocab's mesh dims, laid out over the ids' shards
    elsewhere.  DTensor's own gradient of an indexed read, an
    accumulating ``index_put``, has no sharding rule that holds on every
    torch version."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    t_pl = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in table.placements)
    i_pl = tuple(Replicate() if t == Shard(0) or not isinstance(p, Shard)
                 else p for t, p in zip(t_pl, ids.placements))
    out_pl = tuple(Partial() if t == Shard(0) else i
                   for t, i in zip(t_pl, i_pl))
    t_grad = tuple(Partial() if isinstance(i, Shard) else t
                   for t, i in zip(t_pl, i_pl))
    lo, n = _shard_range(table.shape[0], 0, mesh, t_pl)

    def rows(t, i):
        j = i - lo
        ok = (j >= 0) & (j < n)
        return torch.where(ok[..., None], t[torch.where(ok, j, 0)], 0)

    return local_map(rows, out_placements=(out_pl,),
                     in_placements=(t_pl, i_pl),
                     in_grad_placements=(t_grad, i_pl),
                     redistribute_inputs=True)(table, ids)


@torch.no_grad()
def write_index(buf, dim: int, index: int, value) -> None:
    """``buf.select(dim, index).copy_(value)`` in place, also where
    ``buf`` is a DTensor sharded along ``dim``: DTensor would write a
    redistributed copy there and leave ``buf`` as it was, so each rank
    writes its own shard, and only the rank whose shard holds ``index``
    writes anything.  ``value`` is a Python number or a tensor shaped as
    ``buf`` less ``dim``."""
    scalar = isinstance(value, (int, float))
    if not is_dtensor(buf):
        row = buf.select(dim, index)
        row.fill_(value) if scalar else row.copy_(value)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = buf.device_mesh
    offset, length = _shard_range(buf.shape[dim], dim, mesh, buf.placements)
    # the value's layout: buf's, with ``dim`` gone
    val_pl = []
    for p in buf.placements:
        if isinstance(p, Shard) and p.dim == dim:
            val_pl.append(Replicate())
        elif isinstance(p, Shard) and p.dim > dim:
            val_pl.append(Shard(p.dim - 1))
        else:
            val_pl.append(p)
    if not scalar:
        if not isinstance(value, DTensor):
            value = DTensor.from_local(value, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
        value = value.redistribute(mesh, val_pl).to_local()
    i = index - offset
    if 0 <= i < length:
        row = buf.to_local().select(dim, i)
        row.fill_(value) if scalar else row.copy_(value)
