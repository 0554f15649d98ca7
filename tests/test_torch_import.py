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
           "repro_torch.ps.client", "repro_torch.ps.server"]


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
