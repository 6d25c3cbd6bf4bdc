"""The harness on the CPU: a cell found from new files, the draw, the
result line, and ``correct`` coming out false for a broken timed path."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from dea_bench.calibrate import altered_answer, half_left_out, unchanged_irls
from dea_bench.cell import HERE, load_cell
from dea_bench.draw import draw_pool
from dea_bench.run import Reservoir, run_cell
from dea_bench.tests.conftest import TINY_CONFIG, TINY_MIX

ROOT = HERE.parent


def _quiet(*a, **k):
    pass


def test_new_cell_found_from_new_files(tiny_tree):
    bench, base = tiny_tree
    cell = load_cell("tiny.cell", bench, base=base)
    assert cell.config["name"] == "tiny" and cell.mix["name"] == "tiny.mix"
    assert cell.entry.__file__.startswith(str(base))
    assert cell.limits == json.loads((HERE / "limits" / "brca.refit.json").read_text())
    assert {m["name"] for m in cell.per_layer} >= {"device_idle_pct", "disp_scan_roofline"}
    assert {m["name"] for m in cell.end_to_end} == {"genes_per_s", "study_p95_s", "peak_device_gib", "setup_s"}
    for m in cell.per_layer:
        assert hasattr(cell.metric_reader(m["name"]), "read")


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        names = {f"{q}.{s}" for q in cell.entry.QUANTITIES
                 for s in (*cell.entry.STATISTICS, *cell.entry.SUBSETS, "count")}
        assert cell.limits["limits"] and set(cell.limits["limits"]) <= names


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_draw_follows_the_recipe(seed):
    (a, b), (c, _) = (draw_pool(seed, TINY_CONFIG, TINY_MIX, torch.float64, "cpu") for _ in range(2))
    G, N = TINY_CONFIG["n_genes"], TINY_CONFIG["n_samples"]
    assert a.counts.shape == (G, N) and a.counts.dtype == torch.float64
    assert torch.equal(a.counts, c.counts) and not torch.equal(a.counts, b.counts)
    for s in (a, b):
        assert s.design[:, 1].sum() == TINY_CONFIG["cohorts"]["a"] and (s.design[:, 0] == 1).all()
        x = s.counts.numpy()
        assert (x >= 0).all() and (x == np.floor(x)).all()
        for g in range(0, G, 100):
            j = (g // 100) % N
            others = np.delete(x[g], j)
            assert x[g, j] >= 20.0 * others.max() > 0 or others.max() == 0


def test_reservoir_is_uniform_and_seeded():
    picks = []
    for seed in range(4000):
        r = Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        picks += r.kept
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 0.85 * 800 and counts.max() < 1.15 * 800
    a, b = Reservoir(3, 7), Reservoir(3, 7)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.kept == b.kept


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny_tree, trace):
    bench, base = tiny_tree
    out = run_cell(load_cell("tiny.cell", bench, base=base), 5, 0.5, bool(trace), device="cpu", log=_quiet)
    keys = list(json.loads(json.dumps(out)))
    want = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert keys == want + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert out["metrics"] == {}  # no device metric from a CPU run
    else:
        assert set(out["metrics"]) == {"genes_per_s", "study_p95_s", "setup_s", "peak_device_gib"}


def _broken(entry, transform):
    """The timed entry with its result put through ``transform``."""
    program = entry.program

    def broken(study, dtype, kn):
        return transform(program(study, dtype, kn))

    return broken


def _irls_unchanged(entry, monkeypatch):
    import pydeseq2_tpu_torch.fused as fused

    monkeypatch.setattr(fused, "irls_core", unchanged_irls)
    return entry.program


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "state_unchanged"])
def test_broken_timed_path_is_not_correct(tiny_tree, monkeypatch, fault):
    """Each fault the cells can have, planted under the timed path; the
    exchange between chips has no fault to plant (one chip a cell)."""
    bench, base = tiny_tree
    cell = load_cell("tiny.cell", bench, base=base)
    make = {"answer_altered": lambda e: _broken(e, altered_answer), "half_left_out": lambda e: _broken(e, half_left_out),
            "state_unchanged": lambda e: _irls_unchanged(e, monkeypatch)}[fault]
    monkeypatch.setattr(cell.entry, "program", make(cell.entry))
    out = run_cell(cell, 9, 0.3, False, device="cpu", log=_quiet)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "-m", "dea_bench.run", "--workload", "brca.refit", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
