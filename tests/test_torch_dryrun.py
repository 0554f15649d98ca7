"""The dry run (``repro_torch.launch.dryrun``) on reduced configs over a
2×2 mesh of the fake backend, traced on the CPU (``device="cpu"``: the
plain versions of the kernels):

* the collective bytes of a known redistribution equal a hand count;
* per-device argument bytes equal the sum, over the reference's specs
  (``repro.launch.specs.input_specs`` on a duck-typed 2×2 mesh), of each
  argument's shard shape × itemsize — less the reference's int32 decode
  index, which the port takes as a Python int;
* the FLOPs of a dense train step (one microbatch) summed over the 4
  devices lie within [0.9, 1.5] × the step's own arithmetic: 6·N·T with
  the forward run twice (remat: 8·N·T) plus the direct attention's
  16·L·B·H·S²·hd (the forward's QKᵀ and PV twice, the backward's four
  products), where no device repeats another's work at 1.0.

The full llama3.2-1b ``decode_32k`` pair on 16×16 through the CLI is
``slow``, as the reference's ``TestDryRunIntegration`` is."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro_torch.configs import get_config as tget
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import close_process_group, make_mesh
from repro_torch.launch.specs import fake_mode, param_templates
from repro_torch.tree import tree_leaves


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


@pytest.fixture
def mesh_2x2():
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu",
                     backend="fake")
    yield mesh
    close_process_group()


def test_collective_bytes_of_a_known_redistribution(mesh_2x2):
    """A (8, 6) float32 argument sharded over ``data`` is all-gathered to
    replicated: one all-gather of 8·6·4 bytes per device, and the
    argument is the (4, 6) shard."""
    from torch.distributed.tensor import Replicate, Shard

    with fake_mode() as mode:
        x = torch.empty(8, 6)
    assert x.fake_mode is mode

    def step(x):
        return x.redistribute(x.device_mesh, [Replicate(), Replicate()])

    gm = dryrun.trace_step(step, (x,), ((Shard(0), Replicate()),), mesh_2x2)
    assert dryrun.collective_bytes_from_graph(gm) == {
        "bytes_by_kind": {"all-gather": 8 * 6 * 4},
        "counts": {"all-gather": 1}, "total_bytes": 8 * 6 * 4}
    mem = dryrun.graph_costs(gm)["memory"]
    assert mem["argument_bytes"] == 4 * 6 * 4
    assert mem["output_bytes"] == 8 * 6 * 4


def _reference_argument_bytes(arch, shape_name, mesh_shape):
    """Σ over the reference's step arguments of the shard shape that its
    PartitionSpec gives on ``mesh_shape`` × itemsize."""
    _, args, specs, _ = jspecs.input_specs(jget(arch, reduced=True),
                                           shape_name, FakeMesh(mesh_shape))
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa
    total = 0
    for leaf, spec in zip(jax.tree.leaves(args),
                          jax.tree.leaves(specs, is_leaf=is_spec)):
        shape = list(leaf.shape)
        for d, entry in enumerate(tuple(spec)):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    shape[d] //= mesh_shape[a]
        total += int(np.prod(shape)) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape_name", [
    ("llama3.2-1b", "decode_32k"), ("llama3.2-1b", "prefill_32k"),
    ("olmoe-1b-7b", "decode_32k"), ("gemma2-2b", "decode_32k")])
def test_argument_bytes_equal_the_reference_specs(mesh_2x2, arch,
                                                  shape_name):
    rec = dryrun.dryrun_one(tget(arch, reduced=True), shape_name,
                            mesh=mesh_2x2, device="cpu")
    assert rec["status"] == "ok", rec
    want = _reference_argument_bytes(arch, shape_name,
                                     {"data": 2, "model": 2})
    index = 4 if jspecs.SHAPES[shape_name].kind == "decode" else 0
    assert rec["memory"]["argument_bytes"] == want - index
    for key in ("memory", "cost", "collectives", "roofline",
                "scan_correction", "lower_s", "compile_s"):
        assert key in rec
    m = rec["memory"]
    assert m["peak_bytes_per_device"] == (m["argument_bytes"]
                                          + m["output_bytes"]
                                          + m["temp_bytes"] - m["alias_bytes"])
    if shape_name == "decode_32k":      # the cache is updated in place
        assert m["alias_bytes"] > 0


def test_dense_train_flops_within_band(mesh_2x2):
    cfg = tget("llama3.2-1b", reduced=True)
    rec = dryrun.dryrun_one(cfg, "train_4k", mesh=mesh_2x2, device="cpu")
    assert rec["status"] == "ok", rec
    shape = jspecs.SHAPES["train_4k"]
    n_micro = shape.global_batch // cfg.train_microbatch
    assert rec["scan_correction"] == n_micro
    B, S = shape.global_batch // n_micro, shape.seq_len
    N = sum(t.numel() for t in tree_leaves(param_templates(cfg)[0]))
    step = (8 * N * B * S
            + 16 * cfg.num_layers * B * cfg.n_heads * S * S * cfg.head_dim)
    ratio = rec["cost"]["flops"] * 4 / step
    assert 0.9 <= ratio <= 1.5, ratio
    assert rec["collectives"]["total_bytes"] > 0


@pytest.mark.slow
def test_full_llama_decode_32k_on_16x16(capsys, tmp_path):
    out = tmp_path / "r.json"
    dryrun.main(["--device", "cpu", "--arch", "llama3.2-1b", "--shape",
                 "decode_32k", "--out", str(out)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[ok")
    rec = json.loads(out.read_text())[0]
    want = _full_reference_bytes()
    assert rec["memory"]["argument_bytes"] == want - 4
    assert rec["num_devices"] == 256


def _full_reference_bytes():
    _, args, specs, _ = jspecs.input_specs("llama3.2-1b", "decode_32k",
                                           FakeMesh({"data": 16,
                                                     "model": 16}))
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa
    total = 0
    for leaf, spec in zip(jax.tree.leaves(args),
                          jax.tree.leaves(specs, is_leaf=is_spec)):
        shape = list(leaf.shape)
        for d, entry in enumerate(tuple(spec)):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    shape[d] //= 16
        total += int(np.prod(shape)) * np.dtype(leaf.dtype).itemsize
    return total
