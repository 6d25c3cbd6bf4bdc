"""The ``brca.iterative`` cell on the CPU: its parts found from their files,
a reference that loads nothing of the program, a tiny cell of its mix
rehearsed by ``run_cell`` (``correct`` true, and false under a planted
size-factor fault), and its kernel counts and readers against counts worked
by hand."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from dea_bench.cell import HERE, load_cell, load_module
from dea_bench.run import run_cell
from dea_bench.tests.conftest import TINY_CONFIG
from dea_bench.trace import Trace, count_span

ROOT = HERE.parent
NLL = load_module(HERE / "counts" / "sf_nll.py")
NEWTON = load_module(HERE / "counts" / "sf_newton.py")
ROUNDS = load_module(HERE / "counts" / "sf_rounds.py")
PEAKS = {"hbm_bytes_per_s": 1e12, "float32_ops_per_s": 1e13, "float64_ops_per_s": 5e12}
NEW = ("sf_ms", "sf_rounds_per_study", "sf_nll_roofline", "sf_newton_roofline")


def _quiet(*a, **k):
    pass


def test_cell_loads_from_its_files():
    cell = load_cell("brca.iterative")
    assert cell.config["name"] == "tcga-brca-iterate" and cell.mix["name"] == "iterative.pool4"
    assert cell.mix["recipe"]["outlier_every"] == 1 and cell.mix["recipe"]["outlier_scale"] == 0.0
    assert cell.entry.__file__.endswith("iterative_summary.py") and cell.chips == 1
    assert [m["name"] for m in cell.per_layer] == list(NEW)
    assert {m["name"] for m in cell.end_to_end} == {"genes_per_s", "peak_device_gib", "setup_s"}
    limits = cell.limits["limits"]
    assert limits["nan_genes.count"] == 0 and limits["flag_genes.count"] == 0
    assert {"size_factors.max", "base_mean.max"} <= set(limits)
    for name, (lower, upper) in ((k, v) for k, v in cell.limits["readings"].items() if k in limits):
        assert lower <= limits[name] <= upper, name
        assert lower < limits[name] < upper or lower == upper == 0, name


def test_configuration_is_brca_at_its_width():
    """The zero-rich deployment keeps TCGA-BRCA's sizes, cohorts and dtype,
    so its studies are ``brca.refit``'s draw but for the planted zeros; its
    entry in ``BENCHMARK.json`` names its own file and source."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["tcga-brca-iterate"]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    brca = json.loads((HERE / "configs" / "tcga-brca.json").read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"] != brca["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    for key in ("n_genes", "n_samples", "cohorts", "design", "dtype"):
        assert cfg[key] == brca[key], key


_REFERENCE = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from dea_bench.draw import draw_pool
from dea_bench.reference.iterative import iterative_refit_summary
from dea_bench.tests.conftest import TINY_CONFIG
mix = json.loads(open({mix!r}).read())
s = draw_pool(1, TINY_CONFIG, mix, torch.float64, "cpu")[0]
res = iterative_refit_summary(s.counts, s.design, s.contrast, max_disp=24.0)
assert np.isfinite(res["padj"]).any()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_reference_loads_nothing_of_the_program():
    code = _REFERENCE.format(root=str(ROOT), mix=str(HERE / "mixes" / "iterative.pool4.json"))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    names = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "dea_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "pydeseq2_tpu", "pydeseq2_tpu_torch"}


@pytest.fixture
def tiny_iterative(tmp_path):
    """A tiny cell of the ``iterative.pool4`` mix, added as new files to a
    copy of the benchmark's folders, with ``brca.iterative``'s limits."""
    base = tmp_path / "dea_bench"
    for part in ("configs", "mixes", "entries", "limits", "metrics", "counts"):
        shutil.copytree(HERE / part, base / part)
    shutil.copy(HERE / "peaks.json", base / "peaks.json")
    (base / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    mix = json.loads((HERE / "mixes" / "iterative.pool4.json").read_text())
    mix.update(name="tiny.iter", pool=2, trace={"skip_studies": 1, "studies": 2})
    (base / "mixes" / "tiny.iter.json").write_text(json.dumps(mix))
    shutil.copy(HERE / "limits" / "brca.iterative.json", base / "limits" / "tiny.iterative.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test draw", "file": "dea_bench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.iterative", "config": "tiny", "traffic": "tiny.iter", "chips": 1,
                               "why": "a test"})
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tiny.iterative")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return load_cell("tiny.iterative", path, base=base)


@pytest.mark.filterwarnings("ignore:Every gene contains at least one zero")
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_rehearsed_is_correct(tiny_iterative, trace):
    out = run_cell(tiny_iterative, 2**31 + 77, 0.3, bool(trace), device="cpu", log=_quiet)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert all(c["value"] == 0.0 for c in out["checks"].values())  # bit for bit on the CPU
    if trace:
        assert out["metrics"] == {}  # no device metric from a CPU run
    else:
        assert set(out["metrics"]) == {"genes_per_s", "peak_device_gib", "setup_s"}


@pytest.mark.filterwarnings("ignore:Every gene contains at least one zero")
def test_one_round_of_the_solve_is_not_correct(tiny_iterative, monkeypatch):
    import pydeseq2_tpu_torch.fused_stream as fs

    solve = fs.iterative_size_factors
    monkeypatch.setattr(fs, "iterative_size_factors", lambda *a, **k: solve(*a, **dict(k, niter=1)))
    out = run_cell(tiny_iterative, 9, 0.3, False, device="cpu", log=_quiet)
    assert out["correct"] is False
    assert out["checks"]["size_factors.max"]["value"] > out["checks"]["size_factors.max"]["limit"]


def test_nll_cost_by_hand():
    # G=3, N=4, f64: 2 plain rows at 10 a cell, 1 Stirling row at 9.
    assert NLL.nll_cost(3, 4, 2, 1, 8) == (8 * (12 + 9 + 12) + 3, 4 * (2 * 10 + 9))
    disp = torch.tensor([0.5, 0.01, 0.2, 1.0], dtype=torch.float64)  # r = 2, 100, 5, 1
    mask = torch.tensor([True, True, False, True])
    counts = torch.zeros(4, 6, dtype=torch.float64)
    rec = NLL.record((counts, None, None, None, None, disp, mask, 0.5), {}, None)
    assert NLL.cost(rec) == (8 * (24 + 12 + 18) + 4, 6 * (2 * 10 + 9), "float64")


def test_newton_cost_by_hand():
    assert NEWTON.newton_cost(5, 3, 2, 8, 4) == (4 * (15 + 10 + 12) + 5, 8 * 3 * 2 * 19)
    keep = torch.tensor([True, False, True, True, False])
    counts = torch.zeros(5, 3, dtype=torch.float32)
    rec = NEWTON.record((counts, None, None, None, None, None, keep, 0.5, 8, None), {}, None)
    assert NEWTON.cost(rec) == (4 * (15 + 10 + 12) + 5, 8 * 3 * 3 * 19, "float32")


def test_sf_rounds_record_the_change_over_a_call(monkeypatch):
    from pydeseq2_tpu_torch import kernels

    stats = types.SimpleNamespace(sf_rounds=7)
    monkeypatch.setattr(kernels, "STATS", stats)
    assert ROUNDS.counted((), {})
    stats.sf_rounds = 11
    assert ROUNDS.record((), {}, None) == 4
    # a program without the counter (the parent of the change that added it) records None
    monkeypatch.setattr(kernels, "STATS", types.SimpleNamespace(launches={}))
    assert ROUNDS.counted((), {}) and ROUNDS.record((), {}, None) is None


def _trace(kernels, launches, studies=2):
    return Trace(studies=studies, window_s=1.0, busy_s=0.5, kernels=kernels, copies=[], launches=launches,
                 peaks=PEAKS)


def test_readers_by_hand():
    sf_ms, rounds = (load_module(HERE / "metrics" / f"{n}.py") for n in ("sf_ms", "sf_rounds_per_study"))
    span = "fused_stream.iterative_size_factors"
    k = [("sf_nll_kernel<double>", 0.003, frozenset({span})), ("disp_scan", 0.5, frozenset({span})),
         ("irls", 0.2, frozenset())]
    assert sf_ms.read(_trace(k, {})) == pytest.approx(251.5)
    assert sf_ms.read(_trace(k[2:], {})) is None
    assert rounds.read(_trace(k, {"sf_rounds": (ROUNDS, [4, 3])})) == pytest.approx(3.5)
    assert rounds.read(_trace(k, {"sf_rounds": (ROUNDS, [None, None])})) is None
    assert rounds.read(_trace([], {"sf_rounds": (ROUNDS, [4, 3])})) is None  # no card ran


def test_roofline_shares_by_hand():
    disp = torch.full((100,), 0.5, dtype=torch.float64)  # every row plain
    mask = torch.ones(100, dtype=torch.bool)
    counts = torch.zeros(100, 50, dtype=torch.float64)
    rec = NLL.record((counts, None, None, None, None, disp, mask, 0.5), {}, None)
    nbytes, ops, _ = NLL.cost(rec)
    bound = max(nbytes / 1e12, ops / 5e12)
    inside = frozenset({count_span("sf_nll")})
    kern = [("void sf_nll_kernel<double>(NllArgs<double>)", 5 * bound, inside),
            ("void sf_nll_kernel<double>(NllArgs<double>)", 1.0, frozenset())]  # outside the count's span
    share = load_module(HERE / "metrics" / "sf_nll_roofline.py").read(_trace(kern, {"sf_nll": (NLL, [rec])}))
    assert share == pytest.approx(20.0)
    keep = torch.ones(100, dtype=torch.bool)
    nrec = NEWTON.record((counts, None, None, None, None, None, keep, 0.5, 8, None), {}, None)
    nb, no, _ = NEWTON.cost(nrec)
    tk = [("sf_newton_kernel<double, true>", 2 * max(nb / 1e12, no / 5e12), frozenset({count_span("sf_newton")}))]
    reader = load_module(HERE / "metrics" / "sf_newton_roofline.py")
    assert reader.read(_trace(tk, {"sf_newton": (NEWTON, [nrec])})) == pytest.approx(50.0)
    assert reader.read(_trace([], {"sf_newton": (NEWTON, [])})) is None
