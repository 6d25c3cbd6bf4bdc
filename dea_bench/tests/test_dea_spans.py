"""The readings that come from the program's own spans and counters: the
rescue lanes' count and metric, ``analyse_ms`` from the harness's spans,
and ``dea_bench.spans``' reduction of a trace by ``deseq2.*`` spans, on
events worked by hand and on a CPU rehearsal of a small cell."""

from __future__ import annotations

import json
import types

import pytest

from dea_bench import spans as sp
from dea_bench.cell import HERE, load_cell, load_module
from dea_bench.tests.conftest import TINY_CONFIG, TINY_MIX
from dea_bench.trace import Trace

RESCUE = load_module(HERE / "counts" / "irls_rescue.py")
LANES = load_module(HERE / "metrics" / "rescue_lanes_per_study.py")
ANALYSE = load_module(HERE / "metrics" / "analyse_ms.py")
ROOT = HERE.parent


def _trace(kernels, launches, studies=2):
    return Trace(studies=studies, window_s=1.0, busy_s=0.5, kernels=kernels, copies=[], launches=launches, peaks={})


def test_rescue_count_records_the_change_over_a_call(monkeypatch):
    from pydeseq2_tpu_torch import kernels

    stats = types.SimpleNamespace(rescue_lanes={"phase2": 10, "grid": 1})
    monkeypatch.setattr(kernels, "STATS", stats)
    assert RESCUE.counted((), {})
    stats.rescue_lanes = {"phase2": 14, "grid": 3}
    assert RESCUE.record((), {}, None) == {"phase2": 4, "grid": 2}
    # a program without the counter (the parent of the change that added it) records None
    monkeypatch.setattr(kernels, "STATS", types.SimpleNamespace(launches={}))
    assert RESCUE.counted((), {}) and RESCUE.record((), {}, None) is None


def test_rescue_lanes_per_study_reads_the_records():
    k = [("irls_kernel", 1e-3, frozenset())]
    recs = [{"phase2": 3, "grid": 1}, {"phase2": 2, "grid": 0}]
    assert LANES.read(_trace(k, {"irls_rescue": (RESCUE, recs)})) == pytest.approx(3.0)
    assert LANES.read(_trace(k, {"irls_rescue": (RESCUE, [])})) is None
    assert LANES.read(_trace(k, {"irls_rescue": (RESCUE, [None, None])})) is None
    assert LANES.read(_trace([], {"irls_rescue": (RESCUE, recs)})) is None  # no card ran


def test_analyse_ms_leaves_out_the_map_fit_and_the_refit():
    a, m, r = "fused_stream._analyse_pass", "fused_stream._shrunk_dispersions", "fused_stream._apply_streamed_refit"
    k = [("irls", 0.004, frozenset({a})), ("map", 0.5, frozenset({a, m})), ("refit", 0.5, frozenset({r})),
         ("hat_wald", 0.002, frozenset({a})), ("scan", 0.5, frozenset())]
    assert ANALYSE.read(_trace(k, {})) == pytest.approx(3.0)
    assert ANALYSE.read(_trace(k[1:3], {})) is None


def test_old_metrics_read_as_before_beside_a_parent_without_the_counter():
    """A parent's program records no lanes: the new readings are None and
    every other reader of the benchmark reads what it read without them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    k = [("void disp_scan_kernel<2, double>", 0.01, frozenset({"fused_stream._genewise_pass"})),
         ("irls_kernel", 0.002, frozenset({"fused_stream._analyse_pass"})),
         ("refit", 0.003, frozenset({"fused_stream._apply_streamed_refit"}))]
    new = {"analyse_ms", "rescue_lanes_per_study"}
    parent = _trace(k, {"irls_rescue": (RESCUE, [None])})
    alone = _trace(k, {})
    for m in bench["per_layer"]:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        if m["name"] == "rescue_lanes_per_study":
            assert reader.read(parent) is None
        elif m["name"] not in new:
            assert reader.read(parent) == reader.read(alone), m["name"]
    assert {m["name"] for m in bench["per_layer"]} >= new


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _events():
    """A stretch of 1000 us: one study; the analysis (100-600) holding the
    MAP fit (100-200) and one read (300-350); a second read (700-720)."""
    return [
        _x("dea_bench.stretch", "user_annotation", 0, 1000),
        _x("deseq2.study", "user_annotation", 0, 1000),
        _x("deseq2.analyse", "user_annotation", 100, 500),
        _x("deseq2.map", "user_annotation", 100, 100),
        _x("deseq2.read.irls_unfinished", "user_annotation", 300, 50),
        _x("deseq2.read.to_host", "user_annotation", 700, 20),
        _x("aten::item", "cpu_op", 790, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 110, 2, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 250, 2, correlation=2),
        _x("cudaMemcpyAsync", "cuda_runtime", 310, 30, correlation=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 705, 10, correlation=4),
        _x("cudaMemcpyAsync", "cuda_runtime", 800, 5, correlation=5),
        _x("map_kernel", "kernel", 150, 100, correlation=1),  # 150-250
        _x("irls_kernel", "kernel", 260, 40, correlation=2),  # 260-300
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 340, 5, correlation=3),  # 340-345
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 715, 3, correlation=4),  # 715-718
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 805, 1, correlation=5),  # 805-806
    ]


def test_reduce_spans_by_hand():
    out = sp.reduce_spans(_events(), 1, lanes={"phase2": 5, "grid": 2})
    # gaps: 0-150 (study), 250-260 (analyse), 300-340 (read.irls_unfinished),
    # 345-715 (analyse; both reads overlap it), 718-805 (study; the second
    # read overlaps it), 806-1000 (study)
    assert out["busy_s"] == pytest.approx(149e-6)
    assert out["idle_s"] == pytest.approx(851e-6)
    named = dict(out["idle_named"])
    assert named == pytest.approx({"deseq2.study": (150 + 87 + 194) * 1e-6, "deseq2.analyse": 380e-6,
                                   "deseq2.read.irls_unfinished": 40e-6})
    assert out["unnamed_idle_s"] == 0 and out["unnamed_idle_share"] == 0
    assert out["sync_idle_ms"] == pytest.approx(1e3 * (40 + 370 + 87) * 1e-6)
    assert out["sync_idle_ms_by_site"] == pytest.approx({"irls_unfinished": 1e3 * (40 + 185) * 1e-6,
                                                         "to_host": 1e3 * (185 + 87) * 1e-6})
    assert out["reads_per_study"] == {"irls_unfinished": 1, "to_host": 1}
    assert out["dtoh_per_study"] == 3 and out["dtoh_outside_reads"] == 1
    assert out["dtoh_outside_reads_at"] == {"deseq2.study | aten::item": 1}
    assert out["analyse_ms"] == pytest.approx(0.04)  # irls_kernel; map_kernel is the MAP fit's
    assert out["stage_ms"] == pytest.approx({"deseq2.study": 0.14, "deseq2.analyse": 0.14, "deseq2.map": 0.1})
    assert out["rescue_lanes_per_study"] == 7


def test_reduce_spans_without_program_spans():
    ev = [e for e in _events() if not e["name"].startswith("deseq2.")]
    out = sp.reduce_spans(ev, 1)
    assert out["unnamed_idle_share"] == 1.0 and out["sync_idle_ms"] is None
    assert out["dtoh_outside_reads"] is None and out["analyse_ms"] is None
    assert out["rescue_lanes_per_study"] is None
    assert dict(out["idle_named"])["no span | python"] > 0


def test_span_tree_climbs_past_ended_siblings():
    tree = sp.SpanTree([(0, 100, "a"), (10, 20, "b"), (30, 40, "c"), (32, 35, "d"), (50, 60, "e")])
    assert tree.open_at(33) == ["d", "c", "a"]
    assert tree.open_at(45) == ["a"]
    assert tree.open_at(15) == ["b", "a"]
    assert tree.open_at(200) == []


def test_profiled_stretch_on_the_cpu():
    cell = types.SimpleNamespace(config=TINY_CONFIG, mix=TINY_MIX, entry=load_cell("brca.refit").entry)
    out = sp.profile_stretch(cell, 5, 1, device="cpu", log=lambda *a, **k: None)
    assert out["spans"] > 10 and out["rescue_lanes_per_study"] is not None
    assert out["reads_per_study"]["to_host"] == 2  # the main pass's and the refit's
    assert out["dtoh_per_study"] == 0 and out["card"] == "cpu"
