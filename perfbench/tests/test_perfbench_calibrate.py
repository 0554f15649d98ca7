"""``calibrate.py limits`` hands every cell to its driver's own
``calibrate``: on the CPU, at the tiny cells' size, each driver reads the
program and its control with no fault, and a planted fault fails the
cell's own limits."""

import pytest
import torch

import _tiny
from harness import spec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name, fault, seconds", [
    ("train", None, 0),
    ("train", "half_batch", 0),
    ("serve-moe", "altered_token", 2),
    ("ctr", None, 0.2),
    ("ctr", "zeroed_push", 0.2),
])
def test_each_driver_calibrates_its_own_cell(tmp_path, name, fault, seconds):
    root = _tiny.write_bench(tmp_path)
    cell = spec.load_cell(name, root=root, bench_dir=root / "perfbench")
    recs = []
    spec.load_driver(cell).calibrate(cell, [5], seconds, CPU, fault,
                                     recs.append)
    (rec,) = recs
    assert rec["seed"] == 5 and rec["fault"] == fault
    if fault is None:
        assert rec["correct"] and rec["control_correct"] is False
    else:
        assert rec["correct"] is False and "control" not in rec


def test_a_fault_the_driver_does_not_know_is_refused(tmp_path):
    root = _tiny.write_bench(tmp_path)
    for name in ("train", "serve-moe", "ctr"):
        cell = spec.load_cell(name, root=root, bench_dir=root / "perfbench")
        with pytest.raises(ValueError, match="unknown fault"):
            spec.load_driver(cell).calibrate(cell, [5], 0, CPU, "no_such",
                                             lambda rec: None)
