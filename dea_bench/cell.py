"""A cell and its parts, found by name.

``BENCHMARK.json`` at the root names the cells (``workloads``), their
configurations and traffic mixes, and the metrics. Every part lives in a
file of its own under this folder, found by its name alone:

- ``configs/<config>.json``: the configuration's sizes, cohorts and dtype;
- ``mixes/<traffic>.json``: the traffic: the entry it drives, the pool of
  studies, the draw's recipe, the traced stretch and the studies checked;
- ``entries/<entry>.py``: the entry's program call, its reference and the
  numbers that compare them;
- ``limits/<workload>.json``: the limit of each compared number;
- ``metrics/<metric>.py``: a per-layer metric's reader and the spans it reads;
- ``counts/<kernel>.py``: a kernel's operations and bytes from its launch's
  shapes.

A later cell, mix, configuration, metric or kernel count is new files and
new entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path):
    """A module from a file whose name may hold dots (``metrics/a.b.py``)."""
    spec = importlib.util.spec_from_file_location(f"dea_bench_part_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    entry: object
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    chips: int = 1
    base: Path = HERE  # the folder the parts were read from

    def metric_reader(self, name: str):
        """The reader module of per-layer metric ``name``."""
        return load_module(self.base / "metrics" / f"{name}.py")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: Path | None = None, base: Path = HERE) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (at the root of the
    checkout unless ``bench_path``), its parts read from ``base``."""
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    config = _json(base / "configs" / f"{w['config']}.json")
    mix = _json(base / "mixes" / f"{w['traffic']}.json")
    entry = load_module(base / "entries" / f"{mix['entry']}.py")
    limits = _json(base / "limits" / f"{workload}.json")
    return Cell(
        name=workload, config=config, mix=mix, entry=entry, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        chips=int(w["chips"]), base=base,
    )
