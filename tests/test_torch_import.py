"""The port stands alone: importing it loads neither jax nor the JAX
package, and no source of the port (or chip_smoke.py) imports them."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


MODULES = ["repro_torch", "repro_torch.launch.serve",
           "repro_torch.kernels.ops", "repro_torch.nn.moe",
           "repro_torch.kernels.moe", "repro_torch.kernels.flash_attention",
           "repro_torch.launch.train", "repro_torch.launch.steps",
           "repro_torch.optim", "repro_torch.data",
           "repro_torch.checkpoint", "repro_torch.tree",
           "repro_torch.kernels.embedding_bag", "repro_torch.parallel.ps",
           "repro_torch.ps.sharding", "repro_torch.ps.workload",
           "repro_torch.ps.client", "repro_torch.ps.server",
           "repro_torch.core", "repro_torch.core.torch_cost",
           "repro_torch.core.schedulers", "repro_torch.core.schedulers.rl",
           "repro_torch.core.schedulers.policy", "repro_torch.core.replan",
           "repro_torch.obs.bridge", "repro_torch.ps.elastic",
           "repro_torch.ps.faults", "repro_torch.ps.snapshot",
           "repro_torch.models.profile", "repro_torch.configs",
           "repro_torch.roofline", "repro_torch.launch.mesh",
           "repro_torch.launch.specs", "repro_torch.launch.dryrun",
           "repro_torch.parallel.sharding", "repro_torch.parallel.act",
           "repro_torch.parallel.pipeline", "repro_torch.data.pipeline"]


@pytest.fixture(scope="module")
def loaded_after_import():
    """One fresh interpreter imports each module in turn and reports which
    jax / reference modules were loaded after each import."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "    out[m] = [k for k in sys.modules if k in ('jax', 'repro')\n"
        "              or k.startswith(('jax.', 'repro.'))]\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    return json.loads(proc.stdout.decode().strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax_and_no_reference(loaded_after_import, module):
    assert loaded_after_import[module] == []


MESH_MODULES = ["repro_torch.roofline", "repro_torch.launch.mesh",
                "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                "repro_torch.parallel.sharding", "repro_torch.parallel.act",
                "repro_torch.parallel.pipeline", "repro_torch.data.pipeline"]


def test_mesh_modules_create_no_process_group():
    """Importing the multi-device layer touches no process group: a mesh
    exists only when a caller makes one."""
    code = ("import importlib, torch.distributed as dist\n"
            f"for m in {MESH_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "    assert not dist.is_initialized(), m\n"
            "print('ok')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.decode().strip() == "ok"


@pytest.mark.parametrize("module", ["repro_torch.ps.server",
                                    "repro_torch.ps.transport"])
def test_shard_worker_imports_load_no_torch(module):
    """A spawned shard process imports the server (and the transport
    beside it) through the lazy package inits: no torch, no jax."""
    code = (f"import importlib, sys; importlib.import_module({module!r}); "
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'jax', 'repro')))")
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.decode().strip() == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|import\s+repro\s*$"
    r"|from\s+repro\s|from\s+repro\.)", re.MULTILINE)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if f.exists()]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_scan_pattern_catches_the_forms():
    for bad in ("import jax", "from jax import numpy", "import repro.nn",
                "from repro import obs", "from repro.core import x",
                "    import jax.numpy as jnp"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch import obs",
               "# no jax here", "import numpy"):
        assert not _FORBIDDEN.search(ok), ok


def test_obs_exports_snapshot_resources_lazily():
    """``repro_torch.obs.snapshot_resources`` is exported, and importing
    the package (the shard worker's path) loads neither the bridge nor
    ``repro_torch.core`` nor torch: the bridge resolves at the call."""
    code = ("import sys; import repro_torch.obs as o; "
            "print('snapshot_resources' in o.__all__, "
            "callable(o.snapshot_resources), sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('torch', 'jax', 'repro') or "
            "k.startswith(('repro_torch.core', 'repro_torch.obs.bridge'))))")
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.decode().strip() == "True True []"


def test_obs_snapshot_resources_matches_the_reference():
    """The package-level call returns what the reference's does from a
    cold registry: the base resource, zero embedding ODT, the same serve
    and PS sections."""
    import dataclasses

    from repro import obs as jobs
    from repro.core import resources as jres
    from repro_torch import obs as tobs
    from repro_torch.core import resources as tres

    for i in range(len(tres.default_fleet())):
        want = jobs.snapshot_resources(jres.default_fleet()[i],
                                       registry=jobs.Registry())
        got = tobs.snapshot_resources(tres.default_fleet()[i],
                                      registry=tobs.Registry())
        assert got.keys() == want.keys()
        assert dataclasses.asdict(got["resource"]) == \
            dataclasses.asdict(want["resource"])
        assert (got["embedding_odt"], got["serve"], got["ps"]) == \
            (want["embedding_odt"], want["serve"], want["ps"])
