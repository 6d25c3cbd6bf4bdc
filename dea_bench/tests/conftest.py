"""Fixtures of the benchmark's CPU tests: a small cell defined by new files
in a temporary copy of the benchmark's folders.

    python -m pytest dea_bench/tests -q

Tests that need a CUDA card carry the ``card`` marker and skip, from
inside the test, where none is visible.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from dea_bench.cell import HERE

TINY_CONFIG = {
    "name": "tiny", "source": "a test draw", "n_genes": 700, "n_samples": 24, "cohorts": {"a": 16, "b": 8},
    "design": "~condition", "contrast": "condition a vs b", "dtype": "float64", "reduced": [], "assumed": {},
}
TINY_MIX = {
    "name": "tiny.mix", "entry": "refit_summary", "loop": "closed", "clients": 1, "pool": 2,
    "recipe": {"base_log_mean": 3.0, "base_log_sd": 1.5, "lfc_sd": 0.5, "disp_log_mean": -2.0, "disp_log_sd": 1.0,
               "disp_min": 0.001, "disp_max": 5.0, "outlier_every": 100, "outlier_scale": 20.0},
    "trace": {"skip_studies": 1, "studies": 2}, "check": {"studies": 2},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where none is visible")


@pytest.fixture
def tiny_tree(tmp_path) -> tuple[Path, Path]:
    """(BENCHMARK.json, base) of a copy of the benchmark's folders with one
    new cell, ``tiny.cell``, added as new files alone. Its limits are the
    ``brca.refit`` cell's."""
    base = tmp_path / "dea_bench"
    for part in ("configs", "mixes", "entries", "limits", "metrics", "counts"):
        shutil.copytree(HERE / part, base / part)
    shutil.copy(HERE / "peaks.json", base / "peaks.json")
    (base / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (base / "mixes" / "tiny.mix.json").write_text(json.dumps(TINY_MIX))
    shutil.copy(HERE / "limits" / "brca.refit.json", base / "limits" / "tiny.cell.json")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test draw", "file": "dea_bench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny", "traffic": "tiny.mix", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.cell")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path, base
