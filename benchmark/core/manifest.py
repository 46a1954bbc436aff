"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations, and the end-to-end and per-layer
metrics. Everything that belongs to one configuration, traffic mix or
metric is a file of its own, found by its name:

- a configuration: the ``file`` its entry names, under ``benchmark/``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind`` names
  the generator module ``benchmark/traffic/<kind>.py``;
- a metric: ``benchmark/metrics/<name>.py``, a reader with
  ``read(run) -> Optional[float]`` (None: nothing to read in this run).

So a later cell, mix of an existing kind, generator kind or metric is new
files plus new entries, and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    generator: ModuleType
    metrics: List[Dict]   # the manifest's entries this run reports, in order


def load_module(path: Path) -> ModuleType:
    """A Python file as a module of its own (file names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _reported(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest with its configuration, its
    traffic, its generator, and the metrics a run with or without the
    trace reports there."""
    manifest = _read_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    work = by_name[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(root / configs[work["config"]]["file"])
    bench = root / BENCH_DIR.name
    traffic = _read_json(bench / "traffic" / f"{work['traffic']}.json")
    generator = load_module(bench / "traffic" / f"{traffic['kind']}.py")
    section = manifest["per_layer"] if trace else manifest["end_to_end"]
    metrics = [m for m in section if _reported(m, name)]
    return Cell(name=name, chips=int(work["chips"]), config=config, traffic=traffic,
                generator=generator, metrics=metrics)


def reader(metric: Dict, root: Path = ROOT) -> ModuleType:
    return load_module(root / BENCH_DIR.name / "metrics" / f"{metric['name']}.py")


def read_metric(metric: Dict, run, root: Path = ROOT) -> Optional[float]:
    value = reader(metric, root).read(run)
    return None if value is None else float(value)
