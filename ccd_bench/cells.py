"""Cells by name: a workload of ``BENCHMARK.json`` resolved to its
configuration file, its traffic file and the readers of its metrics.

Everything is found by name under the benchmark's folder: the
configuration ``configs/<config>.json``, the traffic mix
``traffic/<traffic>.json``, the scene kind the configuration names
(``scenes/<kind>.py``), the call the window makes (``calls/<entry>.py``),
the plain reference its answers are held to (``reference/<name>.py``), and
each metric's reader ``metrics/<metric>.py``, a module with ``read(run)``
that returns the metric's value, or ``None`` where the run holds nothing to
read.  A later cell, mix, scene, option or metric is new files and new
entries, and no edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

__all__ = ["BASE", "BENCHMARK", "Cell", "resolve", "load_module", "load_reader"]

BASE = Path(__file__).resolve().parent
BENCHMARK = BASE.parent / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    #: end-to-end metrics: [(name, unit), ...]
    end_to_end: list
    #: per-layer metrics: [(name, unit), ...]
    per_layer: list
    base: Path
    #: ``calls/<entry>.py``: the call the window makes
    entry: str
    #: ``reference/<reference>.py``: the plain reference of its answers
    reference: str


def _for(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, benchmark: Path = BENCHMARK, base: Path = BASE) -> Cell:
    """The cell ``name`` of the benchmark file; raises ``KeyError`` for a
    cell it does not list and ``FileNotFoundError`` for a missing file."""
    bench = json.loads(Path(benchmark).read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    config = json.loads((base / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((base / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [(m["name"], m["unit"]) for m in bench["end_to_end"] if _for(m, name)]
    layer = [(m["name"], m["unit"]) for m in bench["per_layer"] if _for(m, name)]
    # the traffic's entry and reference, else the configuration's
    named = {key: traffic.get(key, config.get(key)) for key in ("entry", "reference")}
    for key, stem in named.items():
        if stem is None:
            raise KeyError(f"{name!r}: neither its configuration nor its traffic names its {key}")
    needed = [("metrics", m) for m, _ in e2e + layer] + [
        ("scenes", config["scene"]["kind"]), ("calls", named["entry"]),
        ("reference", named["reference"])]
    for folder, stem in needed:
        if not (base / folder / f"{stem}.py").is_file():
            raise FileNotFoundError(f"no {folder}/{stem}.py, which the cell {name!r} needs")
    return Cell(name, int(entry["chips"]), config, traffic, e2e, layer, base,
                named["entry"], named["reference"])


def load_module(base: Path, folder: str, name: str):
    """The module ``<folder>/<name>.py`` under ``base``, loaded from its file."""
    path = Path(base) / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder}/{name}.py under {base}")
    spec = importlib.util.spec_from_file_location(f"ccd_bench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(base: Path, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load_module(base, "metrics", metric).read
