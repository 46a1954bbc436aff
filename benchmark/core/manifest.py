"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations, and the end-to-end and per-layer
metrics. Everything that belongs to one configuration, architecture,
traffic mix or metric is a file of its own, found by its name:

- a configuration: the ``file`` its entry names, under ``benchmark/``; it
  names its architecture under ``architecture``, with no default;
- an architecture: ``benchmark/architectures/<architecture>.py`` (below);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind`` names
  the generator module ``benchmark/traffic/<kind>.py``;
- a metric: ``benchmark/metrics/<name>.py``, a reader with
  ``read(run) -> Optional[float]`` (None: nothing to read in this run).

So a later cell, configuration, model of another architecture, mix of an
existing kind, generator kind or metric is new files plus new entries, and
no file here changes.

An architecture module holds what the harness knows of one family of
models, and nothing else does:

- ``REHEARSAL``, ``REHEARSAL_ENGINE``: keys laid over the configuration
  and its ``engine`` for the CPU rehearsal (``run.py --rehearse``);
- ``build_engine(config, seed, device, recorder)``: the port's engine for
  the configuration, its weights drawn from ``seed``, ``recorder``
  (``core/records.py``'s ``Recorder``) as its ``metrics`` hook;
- ``check_deployment(engine, config)``: raises ``SystemExit`` where the
  engine departs from what the configuration states;
- ``request_flops(config, run, req)``: matrix-product FLOPs of one
  finished request (``mfu_pct.*``);
- ``judge(run, reqs, weights_seed, device, control=False)``: the numbers
  the cell's traffic ``limits`` name, over the sampled requests
  (``core/check.py``), from its own plain reference, plus
  ``tokens_judged`` and ``requests_judged``; with ``control`` the
  reference in the precision below the configuration's in the program's
  place.

The engine that ``build_engine`` returns offers what the generators and
``run.py`` drive:

- ``submit(DecodeRequest)`` (``stt_tpu_torch.engine.engine``: audio,
  language, options, is_final, session_id) returns a future of the result;
- ``prewarm(bucket_secs=, batch_sizes=, beam_sizes=, include_drafted=)``
  builds and captures those shapes, so that serving them captures nothing;
- ``start()``, ``close()``; ``graph_captures``, a count that must not move
  inside the window; ``audio_buckets_sec``, the buckets it serves;
- each result carries ``_tokens`` (prompt, served tokens, then the token
  that ended the row, if one did), ``_p_len``, ``_n_gen``, ``avg_logprob``,
  ``no_speech_prob`` and ``inference_sec`` (its group's seconds from the
  device phase's start to the harvest's end, shared by the group's
  results); the span readers read ``spans`` and ``_row`` where present.
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
    architecture: ModuleType


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
    architecture, its traffic, its generator, and the metrics a run with or
    without the trace reports there."""
    manifest = _read_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    work = by_name[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config_file = root / configs[work["config"]]["file"]
    config = _read_json(config_file)
    bench = root / BENCH_DIR.name
    if "architecture" not in config:
        raise KeyError(f"{config_file} names no 'architecture' (a module of "
                       f"{bench / 'architectures'})")
    architecture = load_module(bench / "architectures" / f"{config['architecture']}.py")
    traffic = _read_json(bench / "traffic" / f"{work['traffic']}.json")
    generator = load_module(bench / "traffic" / f"{traffic['kind']}.py")
    section = manifest["per_layer"] if trace else manifest["end_to_end"]
    metrics = [m for m in section if _reported(m, name)]
    return Cell(name=name, chips=int(work["chips"]), config=config, traffic=traffic,
                generator=generator, metrics=metrics, architecture=architecture)


def reader(metric: Dict, root: Path = ROOT) -> ModuleType:
    return load_module(root / BENCH_DIR.name / "metrics" / f"{metric['name']}.py")


def read_metric(metric: Dict, run, root: Path = ROOT) -> Optional[float]:
    value = reader(metric, root).read(run)
    return None if value is None else float(value)
