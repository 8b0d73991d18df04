"""Find a cell by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file (``workloads/<traffic>.json``) and
the reader of each metric it reports (``metrics/<name>.py``).

A later change adds a cell, a configuration, a traffic mix or a metric
by adding such files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: Callable[[Any], Any]


@dataclass(frozen=True)
class CellSpec:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_reader(name: str, bench_dir: Path) -> Callable[[Any], Any]:
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"shedbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, bench_dir: Path = BENCH_DIR) -> CellSpec:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read
    from ``bench_dir``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "workloads" / f"{cell['traffic']}.json").read_text())
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        metrics[kind] = [Metric(m["name"], m["unit"],
                                _load_reader(m["name"], bench_dir))
                         for m in bench[kind] if _reports(m, name)]
    return CellSpec(name=name, chips=int(cell["chips"]), config=config,
                    traffic=traffic, end_to_end=metrics["end_to_end"],
                    per_layer=metrics["per_layer"])
