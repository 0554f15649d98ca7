"""Multi-pod dry run: trace every (arch × input-shape) step on the
production mesh, show what each device holds, and estimate its roofline
terms on a cluster of H100s (port of ``repro.launch.dryrun``).

The mesh is 16×16 (``--multi-pod``: 2×16×16) ranks of ``torch.distributed``'s
fake backend in one process: collectives return at once and move nothing.
The step runs under ``make_fx`` over DTensor arguments whose local
tensors are fake (shapes only), so DTensor's dispatch lays out every op
and the traced graph holds what one device runs — local ops at local
shapes, the ``_c10d_functional`` collectives between them, and the
port's kernels as custom ops (their fake implementations stand in for
the launches).  From that graph, per device:

* ``memory`` — argument, output, alias (updated in place) and temp bytes,
  the last from a liveness walk over the nodes' storages;
  ``peak_bytes_per_device`` = argument + output + temp − alias;
* ``cost.flops`` (``torch.utils.flop_counter``'s formulas, the kernels'
  registered ones included) and ``cost.bytes_accessed`` (each op's
  inputs read and outputs written once; views and collectives move
  none here);
* ``collectives`` (:func:`repro_torch.roofline.collective_bytes_from_graph`)
  and ``roofline`` (H100 SXM constants; estimates, not measurements).

The train step's microbatch loop is a Python loop: one microbatch
(``global_batch / n_micro`` sequences) is traced, and ``scan_correction``
(= n_micro) scales its FLOPs into ``compute_s_corrected``, as the
reference scales its scanned loop bodies.  The layers are unrolled, so
prefill and decode trace whole (factor 1).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch llama3.2-1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      --out r.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import close_process_group, make_production_mesh
from repro_torch.launch.specs import SHAPES, fake_mode, input_specs, supports
from repro_torch.parallel.act import use_mesh
from repro_torch.roofline import (PEAK_FLOPS, collective_bytes_from_graph,
                                  collective_kind, roofline_terms)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _local_shape(shape, placements, mesh) -> tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` (called outside a
    fake mode: DTensor computes the offsets with tensors)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    return tuple(compute_local_shape_and_global_offset(shape, mesh,
                                                       placements)[0])


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _storage(t):
    from torch.multiprocessing.reductions import StorageWeakRef

    return StorageWeakRef(t.untyped_storage())


def _tensors(val):
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return []


def _node_vals(args):
    """Node arguments with each FX node replaced by its traced value."""
    return torch.fx.node.map_arg(args, lambda n: n.meta.get("val"))


def graph_costs(gm) -> dict:
    """Memory, FLOPs and bytes accessed of one device's traced graph, and
    the port's kernels (custom ops) it launches, by name."""
    from torch.utils.flop_counter import flop_registry

    nodes = list(gm.graph.nodes)
    placeholders = [n for n in nodes if n.op == "placeholder"]
    out_node = nodes[-1]
    arg_st = {_storage(t): _nbytes(t) for n in placeholders
              for t in _tensors(n.meta.get("val"))}
    out_vals = [v for v in _tensors(_node_vals(out_node.args[0]))]
    out_st = {_storage(t): _nbytes(t) for t in out_vals}
    alias = sum(b for s, b in out_st.items() if s in arg_st)

    # last use of each node
    last = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            last[a] = i
    live: dict = {}           # storage → bytes of temps alive now
    owner: dict = {}          # storage → the nodes that hold it
    temp_peak = temp = 0
    flops = 0
    accessed = 0
    kernels: dict[str, int] = {}
    for i, n in enumerate(nodes):
        if n.op != "call_function":
            continue
        if getattr(n.target, "namespace", None) == "repro_torch":
            k = n.target._schema.name.split("::")[-1]
            kernels[k] = kernels.get(k, 0) + 1
        outs = _tensors(n.meta.get("val"))
        ins = [t for a in n.all_input_nodes
               for t in _tensors(a.meta.get("val"))]
        in_st = {_storage(t) for t in ins}
        mutable = getattr(getattr(n.target, "_schema", None), "is_mutable",
                          False)
        is_view = bool(outs) and all(_storage(o) in in_st for o in outs)
        packet = getattr(n.target, "overloadpacket", None)
        if packet in flop_registry:
            args, kwargs = _node_vals((n.args, n.kwargs))
            flops += flop_registry[packet](*args, **kwargs,
                                           out_val=n.meta.get("val"))
        if collective_kind(n) is None and (mutable or not is_view):
            accessed += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        for o in outs:
            s = _storage(o)
            owner.setdefault(s, set()).add(n)
            if s in arg_st or s in out_st or s in live:
                continue
            live[s] = o.untyped_storage().nbytes()
            temp += live[s]
        temp_peak = max(temp_peak, temp)
        # free storages whose every holder has had its last use
        for a in n.all_input_nodes:
            for t in _tensors(a.meta.get("val")):
                s = _storage(t)
                if s in live and all(last.get(h, -1) <= i
                                     for h in owner.get(s, ())):
                    temp -= live.pop(s)
    arg_b, out_b = sum(arg_st.values()), sum(out_st.values())
    return {
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_peak,
            "alias_bytes": alias,
            "peak_bytes_per_device": arg_b + out_b + temp_peak - alias,
        },
        "cost": {"flops": float(flops), "bytes_accessed": float(accessed)},
        "kernels": kernels,
    }


def _first_microbatch(args, cfg, shape):
    """The train step's arguments with the batch cut to one microbatch,
    and the number of microbatches the full step runs."""
    B = shape.global_batch
    m = cfg.train_microbatch
    n_micro = max(1, B // m) if B % (m or 1) == 0 else 1
    params, opt, batch = args
    size = B // n_micro
    with batch["tokens"].fake_mode:
        batch = {k: torch.empty((size, *v.shape[1:]), dtype=v.dtype,
                                device=v.device) for k, v in batch.items()}
    return (params, opt, batch), n_micro


@contextlib.contextmanager
def _untraced_strided_offsets():
    """Run DTensor's ``_StridedShard`` offset helper outside the trace.

    DTensor plans some redistributions (a gradient whose flattened batch
    dim is split over two mesh axes) by computing shard offsets with
    ``torch.arange(...).tolist()``; under ``make_fx`` over fake tensors
    that is a data-dependent read and the trace stops.  The offsets are
    integers of the layout alone, so they are computed on the host with
    the proxy and fake modes off."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.fx.experimental.proxy_tensor import (
        disable_proxy_modes_tracing)

    orig = _StridedShard.local_shard_size_and_offset

    def host(self, *args, **kwargs):
        with unset_fake_temporarily(), disable_proxy_modes_tracing():
            return orig(self, *args, **kwargs)

    _StridedShard.local_shard_size_and_offset = host
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def trace_step(step, args, placements, mesh):
    """``make_fx`` graph of ``step`` on ``args`` laid out as
    ``placements``: the graph's inputs are each argument's local shard."""
    from torch.distributed.tensor import DTensor
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves = tree_leaves(args)
    pls = [p for p in tree_leaves(_boxed(placements, args))]
    mode = next(t.fake_mode for t in leaves if isinstance(t, torch.Tensor))
    is_t = [isinstance(t, torch.Tensor) for t in leaves]
    shapes = [_local_shape(t.shape, p.value, mesh)
              for t, p, ok in zip(leaves, pls, is_t) if ok]
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    with mode:
        locals_ = [torch.empty(s, dtype=t.dtype, device=t.device)
                   for s, t in zip(shapes, tensors)]

    def run(*local):
        it = iter(local)
        full = [DTensor.from_local(next(it), mesh, p.value, run_check=False,
                                   shape=t.shape, stride=t.stride())
                if ok else t for t, p, ok in zip(leaves, pls, is_t)]
        with use_mesh(mesh):
            out = step(*tree_unflatten(args, full))
        return [o.to_local() for o in tree_leaves(out)
                if isinstance(o, DTensor)]

    with mode, _untraced_strided_offsets():
        return make_fx(run)(*locals_)


class _Box:
    """A placements tuple held as one leaf of the port's tree functions
    (which would walk into a bare tuple)."""

    def __init__(self, value):
        self.value = value


def _boxed(placements, args):
    return tree_map(lambda _, p: _Box(p), args, placements)


def dryrun_one(arch, shape_name: str, *, multi_pod: bool = False,
               device: str = "cuda", hlo_out: str | None = None,
               mesh=None) -> dict:
    """The record of one (arch × shape) pair.  ``arch`` is an id or an
    ``ArchConfig``; ``mesh`` defaults to the production mesh on the fake
    backend (created when no process group exists)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if not supports(cfg, shape_name):
        return {"arch": cfg.name, "shape": shape_name, "status": "skipped",
                "reason": "full-attention arch at 524k context"}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device,
                                    backend="fake")
    shape = SHAPES[shape_name]
    rec = {"arch": cfg.name, "shape": shape_name,
           "mesh": "x".join(str(n) for n in mesh.shape),
           "num_devices": mesh.size(), "device_type": device}
    mode = fake_mode()
    step, args, placements, _ = input_specs(cfg, shape_name, mesh,
                                            mode=mode, device=device)
    full_args = args
    factor = 1
    if shape.kind == "train":
        args, factor = _first_microbatch(args, cfg, shape)
    t0 = time.perf_counter()
    gm = trace_step(step, args, placements, mesh)
    rec["lower_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    rec.update(graph_costs(gm))
    if shape.kind == "train":
        # the arguments the full step holds (the traced batch is one
        # microbatch of it)
        rec["memory"]["argument_bytes"] = _argument_bytes(full_args,
                                                          placements, mesh)
        m = rec["memory"]
        m["peak_bytes_per_device"] = (m["argument_bytes"] + m["output_bytes"]
                                      + m["temp_bytes"] - m["alias_bytes"])
    rec["collectives"] = collective_bytes_from_graph(gm)
    rec["compile_s"] = round(time.perf_counter() - t0, 2)
    if hlo_out:
        with open(hlo_out, "w") as f:
            f.write(gm.code)
    rec["scan_correction"] = factor
    # the memory and collective terms are those of the traced graph (one
    # microbatch for train: a per-microbatch lower bound); the corrected
    # compute term scales the FLOPs by the microbatches
    rec["roofline"] = roofline_terms(
        flops=rec["cost"]["flops"],
        hbm_bytes=rec["cost"]["bytes_accessed"],
        collective_bytes=rec["collectives"]["total_bytes"],
    )
    rec["roofline"]["compute_s_corrected"] = (
        rec["cost"]["flops"] * factor / PEAK_FLOPS)
    rec["status"] = "ok"
    return rec


def _argument_bytes(args, placements, mesh) -> int:
    total = 0
    for t, p in zip(tree_leaves(args), tree_leaves(_boxed(placements,
                                                          args))):
        if isinstance(t, torch.Tensor):
            shape = _local_shape(t.shape, p.value, mesh)
            n = 1
            for d in shape:
                n *= d
            total += n * t.element_size()
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--hlo-out", default=None,
                    help="write the traced graph's code here")
    ap.add_argument("--device", default="cuda",
                    help="device type of the mesh and the traced tensors "
                         "(cuda: the card's program, kernels included; "
                         "cpu: the plain versions)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to trace the "
                         "CPU program")
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    pairs = (
        [(a, s) for a in ARCH_IDS for s in SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    results = []
    try:
        for arch, shape in pairs:
            try:
                rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                                 device=args.device, hlo_out=args.hlo_out)
            except Exception as e:  # a failure here is a bug in the system
                rec = {"arch": arch, "shape": shape, "status": "FAILED",
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
            results.append(rec)
            mem = rec.get("memory", {}).get("peak_bytes_per_device", 0)
            print(f"[{rec['status']:7s}] {arch:24s} {shape:12s} "
                  f"mem/dev={mem / 2**30:6.2f}GiB "
                  f"lower={rec.get('lower_s', 0):6.1f}s "
                  f"compile={rec.get('compile_s', 0):6.1f}s "
                  + (rec.get("error", "") if rec["status"] == "FAILED"
                     else ""),
                  flush=True)
    finally:
        close_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    failed = [r for r in results if r["status"] == "FAILED"]
    if failed:
        raise SystemExit(f"{len(failed)} dry-run failures")


if __name__ == "__main__":
    main()
