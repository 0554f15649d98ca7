"""The port's sharding rules against the reference's: ``param_specs``,
``batch_specs`` and ``cache_specs`` for all ten archs on the 16×16 and
2×16×16 production meshes (duck-typed, as ``tests/test_sharding.py``
does), leaf by leaf; the DTensor placements of a spec cut the same blocks
as the reference's ``NamedSharding`` on a 2×2 mesh (4 gloo ranks against
the reference in a subprocess on 4 forced host devices); and
``init_cache(global_cap=)`` gives the reference's shapes."""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_gloo import run_gloo, shard_offsets_worker
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro.models import decoder as jdec
from repro.parallel import sharding as jshd
from repro_torch.configs import get_config as tget
from repro_torch.launch import specs as tspecs
from repro_torch.models import decoder as tdec
from repro_torch.parallel import sharding as tshd
from repro_torch.tree import tree_map, tree_map_with_path

ROOT = Path(__file__).resolve().parent.parent


class FakeMesh:
    """Duck-typed mesh: only .shape / .axis_names are consulted by the
    spec builders (the reference's test mesh)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _jflat(tree, is_leaf=None):
    """{path: leaf} of a reference tree (paths as the port writes them)."""
    out = {}

    def f(path, leaf):
        out["/".join(str(getattr(p, "key", getattr(p, "idx",
                                                   getattr(p, "name", p))))
                     for p in path)] = leaf
        return leaf

    jax.tree_util.tree_map_with_path(f, tree, is_leaf=is_leaf)
    return out


def _tflat(tree):
    out = {}

    def f(path, leaf):
        out["/".join(map(str, path))] = leaf
        return leaf

    tree_map_with_path(f, tree)
    return out


def _tspecs(template, specs):
    """{path: spec tuple} of a port spec tree (whose tuples the port's
    tree functions would walk into), by the template's structure."""
    paths, vals = [], []
    tree_map_with_path(lambda p, _: paths.append("/".join(map(str, p))),
                       template)
    tree_map(lambda _, s: vals.append(tuple(s)), template, specs)
    return dict(zip(paths, vals))


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _jspecs(specs):
    return {p: tuple(s) for p, s in _jflat(specs, is_leaf=_is_spec).items()}


_OPT_FIELDS = {"0": "mu", "1": "nu", "2": "count"}


@functools.lru_cache(maxsize=None)
def _templates(arch):
    jp, jo = jspecs.param_templates(jget(arch))
    tp, to = tspecs.param_templates(tget(arch))
    return jp, jo, tp, to


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh):
    m = MESHES[mesh]
    jcfg, tcfg = jget(arch), tget(arch)
    jp, jo, tp, to = _templates(arch)
    for jt, tt in ((jp, tp), (jo, to)):
        want = _jspecs(jshd.param_specs(jt, jcfg, m))
        # the reference's OptState flattens as a sequence (mu, nu, count)
        want = {_OPT_FIELDS.get(p.split("/")[0], p.split("/")[0])
                + p[len(p.split("/")[0]):]: v for p, v in want.items()}
        got = _tspecs(tt, tshd.param_specs(tt, tcfg, m))
        assert got == want, arch


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_the_reference(arch, mesh):
    """decode_32k (batch sharded) and, where supported, long_500k (B=1:
    the cache length over data and model); the cache leaves' shapes too."""
    m = MESHES[mesh]
    jcfg, tcfg = jget(arch), tget(arch)
    for shape_name in ("decode_32k", "long_500k"):
        if not jspecs.supports(jcfg, shape_name):
            continue
        shape = jspecs.SHAPES[shape_name]
        B, S = shape.global_batch, shape.seq_len
        cap = (jspecs.GLOBAL_ATTN_CAP_500K if shape_name == "long_500k"
               else None)
        jc = jax.eval_shape(functools.partial(jdec.init_cache, jcfg, B, S,
                                              global_cap=cap))
        with tspecs.fake_mode():
            tc = tdec.init_cache(tcfg, B, S, global_cap=cap, device="cpu")
        assert ({p: tuple(v.shape) for p, v in _tflat(tc).items()}
                == {p: tuple(v.shape) for p, v in _jflat(jc).items()})
        want = _jspecs(jshd.cache_specs(jc, jcfg, m, batch_size=B))
        got = _tspecs(tc, tshd.cache_specs(tc, tcfg, m, batch_size=B))
        assert got == want, (arch, shape_name)
        with tspecs.fake_mode():
            tb = {"tokens": torch.empty((B, S), dtype=torch.int32),
                  "context": torch.empty((B, 3, 5))}
        jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
              for k, v in tb.items()}
        assert (_tspecs(tb, tshd.batch_specs(tb, m, batch_size=B))
                == _jspecs(jshd.batch_specs(jb, m, batch_size=B)))


@pytest.mark.parametrize("arch", ["gemma2-2b", "jamba-v0.1-52b",
                                  "llama3.2-1b"])
def test_init_cache_global_cap_gives_the_reference_shapes(arch):
    jcfg, tcfg = jget(arch, reduced=True), tget(arch, reduced=True)
    for cap in (None, 24):
        jc = jax.eval_shape(functools.partial(jdec.init_cache, jcfg, 2, 64,
                                              global_cap=cap))
        tc = tdec.init_cache(tcfg, 2, 64, global_cap=cap, device="cpu")
        want = {p: tuple(v.shape) for p, v in _jflat(jc).items()}
        got = {p: tuple(v.shape) for p, v in _tflat(tc).items()}
        assert got == want, (arch, cap)


# --------------------------------------------------------------------------
# DTensor blocks vs NamedSharding blocks on a 2×2 mesh
# --------------------------------------------------------------------------

SHAPE = (8, 12, 4)
SPECS = [(("data", "model"), None), ("data", "model"), ("model", "data"),
         (None, ("data", "model")), (("data",), None, "model"),
         (None, None, "data"), ()]

_JAX_BLOCKS = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    shape, specs = json.loads(sys.argv[1])
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for s in specs:
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in s])
        idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
        blocks = {}
        for i in range(2):
            for j in range(2):
                sl = idx[mesh.devices[i][j]]
                blocks[f"{i},{j}"] = [[x.start or 0, x.stop if x.stop is
                                       not None else n]
                                      for x, n in zip(sl, shape)]
        key = tuple(tuple(e) if isinstance(e, list) else e for e in s)
        out[str(key)] = blocks
    print(json.dumps(out))
""")


def test_dtensor_blocks_match_named_sharding_on_2x2():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_BLOCKS, json.dumps([SHAPE, SPECS])],
        env={**env, "PYTHONPATH": str(ROOT / "src")}, capture_output=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    want = json.loads(proc.stdout.decode().strip().splitlines()[-1])
    full = np.arange(int(np.prod(SHAPE)), dtype=np.float32).reshape(SHAPE)
    for local, coord in run_gloo(shard_offsets_worker, 4, SHAPE, SPECS):
        for s in SPECS:
            (a0, a1), (b0, b1), (c0, c1) = want[str(s)][
                f"{coord[0]},{coord[1]}"]
            np.testing.assert_array_equal(local[str(s)],
                                          full[a0:a1, b0:b1, c0:c1])


def test_placements_refuse_what_dtensor_cannot_cut():
    """An axis the mesh lacks, an axis named twice, and a dim split over
    axes against the mesh's order raise."""

    class Mesh:
        mesh_dim_names = ("data", "model")

    for bad in (("pod", None), ("data", "data"), (("model", "data"), None)):
        with pytest.raises(ValueError):
            tshd.placements(bad, Mesh())


def test_reference_gather_params_keeps_the_data_axis_R8():
    """R8: the reference's ``gather_params`` calls ``_spec_for(data=1)``,
    which keeps the ``data`` axis wherever the stored layout has it (its
    docstring says data-axis replicated); the port keeps the same spec."""
    from repro.parallel.sharding import _spec_for as j_spec_for

    cfg = jget("llama3.2-1b")
    leaf = jax.ShapeDtypeStruct((cfg.d_model, cfg.n_heads * cfg.head_dim),
                                np.float32)
    path = (jax.tree_util.DictKey("mixer"), jax.tree_util.DictKey("wq"))
    ref = tuple(j_spec_for(path, leaf, data=1, model=16, d_ff=cfg.d_ff))
    stored = tuple(j_spec_for(path, leaf, data=16, model=16, d_ff=cfg.d_ff))
    assert ref == stored == ("data", "model")
    got = tshd._spec_for(("mixer", "wq"), leaf, data=1, model=16,
                         d_ff=cfg.d_ff)
    assert got == ref
