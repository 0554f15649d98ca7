"""Nothing the benchmark runs imports JAX, Flax or the JAX package
(``repro``), top-level names compared whole (``repro_torch`` is the port,
another name), and the plain reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import _tiny

BENCH = _tiny.BENCH
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_under_perfbench_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py")]
    assert len(files) > 20
    for p in files:
        assert not (_imports(p) & FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "ctr_reference.py", "judge.py", "flops.py",
                 "traffic.py", "weights.py"):
        assert not ({"repro_torch", "repro"}
                    & _imports(BENCH / "harness" / name)), name
    code = ("import sys; sys.path.insert(0, %r); "
            "import harness.reference, harness.ctr_reference, "
            "harness.judge, harness.flops, harness.traffic; "
            "print([m for m in sys.modules "
            "if m.split('.')[0] in ('repro_torch', 'repro', 'jax')])"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(BENCH))
    import run

    for name in ("repro_torch.launch", "jax_lookalike", "reproducer"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == sorted(
        n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro.core" in run.forbidden_modules()
    assert "repro_torch.launch" not in run.forbidden_modules()


def test_a_run_drives_the_port_without_loading_jax(tmp_path):
    """A whole tiny run on the CPU in a fresh process, through the port,
    leaves no JAX module loaded."""
    _tiny.write_bench(tmp_path)
    code = f"""
import sys, time, torch
sys.path.insert(0, {str(BENCH)!r})
torch.set_num_threads(2)
import run
from harness import spec
cell = spec.load_cell("serve-moe", root=__import__("pathlib").Path({str(tmp_path)!r}))
out = spec.load_driver(cell).run(cell, seed=1, seconds=1.0, trace=False,
    device=torch.device("cpu"), t_start=time.perf_counter())
assert "repro_torch.launch.serve" in sys.modules
print(out["correct"], run.forbidden_modules())
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, check=True)
    assert out.stdout.split("\n")[-2] == "True []"


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "olmoe-train-2k", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert not isinstance(json.loads(line), dict)
        except json.JSONDecodeError:
            pass
