"""What a cell is, found by name: ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration and traffic mix, and each metric.

* a configuration: the JSON file its entry names (``file``);
* a traffic mix: ``rpbench/traffic/<traffic>.json``, whose ``loop`` names
  the loop kind, ``rpbench/loops/<loop>.py``;
* a metric, end-to-end or per-layer: its reader,
  ``rpbench/metrics/<name>.py``, a module with ``read(obs)`` that returns
  a number, or None where it finds nothing to read.

A new cell, mix or metric is new files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import threading
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg["file"], encoding="utf-8") as fh:
        config = json.load(fh)
    with open(root / "rpbench" / "traffic" / f"{w['traffic']}.json",
              encoding="utf-8") as fh:
        traffic = json.load(fh)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def load_module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``rpbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / "rpbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"rpbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Done:
    """One request of the window: which tenant and noise seed, when it was
    sent and when its result came back, and the error if it failed."""

    tenant: int
    seed: int
    t0: float
    t1: float
    error: Optional[str] = None


@dataclass
class LoopContext:
    """What a loop kind gets: the plan, each tenant's marginals, the
    traffic's parameters, the device, the window's length, a source of
    noise seeds, ``done(record, tables, measurements)`` to call after each
    request, a directory for its files, ``engine_factory(plan, device)``
    (the program's engine) and ``setup``, where it records the seconds of
    its set-up phases."""

    plan: object
    marginals: List[dict]
    traffic: dict
    device: object
    seconds: float
    seeds: Callable[[], int]
    done: Callable
    workdir: Path
    engine_factory: Callable
    setup: Dict[str, float] = field(default_factory=dict)
    lock: threading.Lock = field(default_factory=threading.Lock)


@dataclass
class Observation:
    """What the metric readers read, all on the monotonic clock.

    ``setup``: seconds of set-up phases (``plan_s``, ``engine_build_s``, …);
    ``setup_s``: process start to the first timed request;
    ``releases``: (start, end) of every request completed in the window;
    ``cells``: workload cells one request releases;
    ``peak_bytes``: the device's peak of allocated memory in the window;
    ``spans``: (name, start, end) of the program's spans in the window;
    ``trace``: the profiler's device operations (``harness.trace.Trace``),
    None without a profiler; ``window``: (start, end) of the window;
    ``least_s``: the least time of one release's chains
    (``harness.work``), None where the card has no row of peaks."""

    setup: Dict[str, float]
    setup_s: float
    releases: List[Tuple[float, float]]
    cells: int
    peak_bytes: Optional[int]
    spans: List[Tuple[str, float, float]]
    trace: Optional[object]
    window: Tuple[float, float]
    least_s: Optional[float]
