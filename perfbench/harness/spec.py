"""Find a cell and everything it names from files alone.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics.  Each cell ``<name>`` has its own
``perfbench/cells/<name>.json`` (driver and its parameters: slots, rate,
grace, limits), each traffic mix ``perfbench/traffic/<mix>.json`` and each
configuration the ``file`` that ``BENCHMARK.json`` gives.  A per-layer
metric ``<metric>`` is read by ``perfbench/metrics/<metric>.py``, and the
cell's driver ``<driver>`` (``"driver"`` in its cell file) is
``perfbench/drivers/<driver>.py``, any name, with a ``run`` function.
Adding a cell, a mix, a configuration or a metric is adding files, and so
is a cell that needs a driver of its own: its driver, and as new modules
under ``perfbench/harness/`` that its driver imports, its plain reference
and, where no mix kind of ``harness/traffic.py`` fits, its traffic kind
(the CTR cells' are ``drivers/ctr.py``, ``harness/ctr_reference.py`` and
the ``ctr_ids`` kind).  Nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent     # perfbench/
ROOT = BENCH_DIR.parent                                # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict            # the configuration file, as run
    traffic: dict           # the traffic mix's parameters
    params: dict            # perfbench/cells/<name>.json
    end_to_end: list[dict]  # end-to-end metrics this cell reports
    per_layer: list[dict]   # per-layer metrics this cell reports
    bench_dir: Path

    @property
    def driver(self) -> str:
        return self.params["driver"]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, all_cells: list[str]) -> bool:
    return cell in metric.get("workloads", all_cells)


def load_cell(name: str, *, root: Path = ROOT,
              bench_dir: Path | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files, read
    from ``bench_dir`` (default ``root/perfbench``)."""
    bench = _read(root / "BENCHMARK.json")
    bench_dir = Path(bench_dir) if bench_dir is not None else root / "perfbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    names = list(cells)
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=_read(root / conf["file"]),
        traffic=_read(bench_dir / "traffic" / f"{w['traffic']}.json"),
        params=_read(bench_dir / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if _reports(m, name, names)],
        per_layer=[m for m in bench["per_layer"]
                   if _reports(m, name, names)],
        bench_dir=bench_dir,
    )


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def _find(cell: Cell, sub: str, name: str) -> Path:
    """``<sub>/<name>.py`` in the cell's folder, else in this harness's."""
    for base in (cell.bench_dir, BENCH_DIR):
        path = base / sub / f"{name}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no {sub}/{name}.py under {cell.bench_dir} "
                            f"or {BENCH_DIR}")


def load_driver(cell: Cell):
    """``drivers/<driver>.py`` of the cell."""
    return _load_file(_find(cell, "drivers", cell.driver),
                      f"perfbench_driver_{cell.driver}")


def load_reader(cell: Cell, metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    mod = _load_file(_find(cell, "metrics", metric),
                     "perfbench_metric_" + metric.replace(".", "_"))
    return mod.read
