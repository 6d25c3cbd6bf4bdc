"""The port's tracing switch (``pydeseq2_tpu_torch.tracing``): off by
default and then free of spans and of the per-launch records; on, the
``deseq2.*`` spans of the streamed refit route nested under one study, the
host reads in spans of their own, the IRLS rescue's lane counters equal
to the counts the host read, and the iterative size factors' rounds as
spans inside ``deseq2.size_factors`` and as a counter."""

from __future__ import annotations

import re
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from pydeseq2_tpu_torch import fused, fused_stream, kernels, tracing
from pydeseq2_tpu_torch.ops import irls as irl
from pydeseq2_tpu_torch.ops import sizefactors
from pydeseq2_tpu_torch.synthetic import make_data, plant_outliers, zero_per_gene

PKG = Path(tracing.__file__).resolve().parent
STAGES = ("deseq2.stage", "deseq2.host_inputs", "deseq2.size_factors", "deseq2.genewise", "deseq2.trend_prior",
          "deseq2.analyse", "deseq2.map", "deseq2.irls", "deseq2.to_host", "deseq2.refit", "deseq2.padj")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _study(seed=2, N=12, G=400):
    counts, X = make_data(N, G, seed)
    return plant_outliers(counts.T, 50), X


def _run(counts, X):
    return fused_stream.run_summary_streamed(counts, X, np.array([0.0, 1.0]), dtype=np.float64, refit_cooks=True,
                                             min_replicates=3, device="cpu")


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


class _Counting:
    """A stand-in for ``torch.profiler.record_function`` that counts the
    spans entered, by name, and enters the real one."""

    def __init__(self):
        self.names = []
        self.real = torch.profiler.record_function

    def __call__(self, name):
        self.names.append(name)
        return self.real(name)


def test_off_by_default_and_restored():
    assert not tracing.active()
    with tracing.enabled():
        assert tracing.active()
        with tracing.enabled(False):
            assert not tracing.active()
        assert tracing.active()
    assert not tracing.active()
    with pytest.raises(RuntimeError), tracing.enabled():
        raise RuntimeError
    assert not tracing.active()
    assert tracing.enable(True) is False and tracing.enable(False) is True
    assert tracing.span("deseq2.x") is tracing.read("x")  # the one shared no-op


def test_off_enters_no_span_and_on_changes_no_result(monkeypatch):
    counts, X = _study()
    spy = _Counting()
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    off = _run(counts, X)
    assert spy.names == []
    with tracing.enabled():
        on = _run(counts, X)
    assert spy.names and all(n.startswith("deseq2.") for n in spy.names)
    _same(off, on)


def test_spans_nest_under_the_study_and_lanes_match_the_reads(monkeypatch):
    counts, X = _study()
    seen = {"phase1": [], "grid": []}
    core, grid = fused.irls_core, fused.grid_fit_beta_batch

    def irls_core(*a, maxiter=250, **k):
        out = core(*a, maxiter=maxiter, **k)
        if maxiter == 8:  # phase 1: its unfinished lanes are the count read next
            seen["phase1"].append(int(out[1].sum()))
        return out

    def grid_fit(*a, n_sel=None, **k):
        seen["grid"].append(n_sel)
        return grid(*a, n_sel=n_sel, **k)

    monkeypatch.setattr(fused, "irls_core", irls_core)
    monkeypatch.setattr(fused, "grid_fit_beta_batch", grid_fit)
    kernels.STATS.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, tracing.enabled():
        _run(counts, X)
    assert kernels.STATS.rescue_lanes == {"phase2": sum(seen["phase1"]), "grid": sum(seen["grid"])}
    assert kernels.STATS.rescue_lanes["phase2"] > 0  # this draw's lanes reach phase 2
    ev = [e for e in prof.events() if e.name.startswith("deseq2.")]
    names = {e.name for e in ev}
    assert set(STAGES) <= names
    reads = {n for n in names if n.startswith("deseq2.read.")}
    assert {"deseq2.read.irls_unfinished", "deseq2.read.irls_rescue_any", "deseq2.read.irls_grid_count",
            "deseq2.read.to_host", "deseq2.read.padj", "deseq2.read.sf_defined", "deseq2.read.pinv"} == reads
    (study,) = [e for e in ev if e.name == "deseq2.study"]
    t0, t1 = study.time_range.start, study.time_range.end
    assert all(t0 <= e.time_range.start and e.time_range.end <= t1 for e in ev)
    kernels.STATS.reset()


def test_host_inputs_come_before_the_first_read(monkeypatch):
    """The design's host inputs are derived before the size-factor check's
    host read, the study's first, so that they run while the card still
    has the counts' copy queued."""
    counts, X = _study()
    seen = []
    host_inputs, fused_read, stream_read = fused_stream.summary_host_inputs, fused.read, fused_stream.read

    def recording_host_inputs(*a, **k):
        seen.append("host_inputs")
        return host_inputs(*a, **k)

    def recording_read(real):
        def read(site):
            seen.append(site)
            return real(site)

        return read

    monkeypatch.setattr(fused_stream, "summary_host_inputs", recording_host_inputs)
    monkeypatch.setattr(fused_stream, "read", recording_read(stream_read))
    monkeypatch.setattr(fused, "read", recording_read(fused_read))
    _run(counts, X)
    assert seen[:2] == ["host_inputs", "sf_defined"]
    assert seen.count("host_inputs") == 1


def test_grid_lanes_count_the_grid_launch(monkeypatch):
    """The grid tier's lanes: every lane the Newton rescue leaves failed."""
    counts, X = _study(G=300)
    c = torch.as_tensor(counts)
    Xt = torch.as_tensor(X)
    sf = torch.ones(c.shape[1], dtype=torch.float64)
    disp = torch.full((c.shape[0],), 0.2, dtype=torch.float64)
    monkeypatch.setattr(fused, "irls_core", lambda cnt, s, Xd, d, b0, **k: (
        b0.clone(), torch.arange(cnt.shape[0]) % 7 == 0, torch.arange(cnt.shape[0]) % 7 != 0))
    monkeypatch.setattr(fused, "newton_box_nbglm", lambda cnt, s, Xd, d, b0, **k: (
        b0.clone(), torch.zeros(cnt.shape[0], dtype=torch.bool)))
    sizes = []
    monkeypatch.setattr(fused, "grid_fit_beta_batch", lambda cnt, *a, n_sel=None, **k: (
        sizes.append(n_sel), torch.zeros(cnt.shape[0], 2, dtype=torch.float64))[1])
    kernels.STATS.reset()
    fused._irls_with_rescue(c, sf, Xt, disp, torch.zeros(c.shape[0], 2, dtype=torch.float64), 0.5, 1e-8)
    flagged = int((torch.arange(c.shape[0]) % 7 == 0).sum())
    assert len(sizes) == 1 and sizes[0] > 0
    assert kernels.STATS.rescue_lanes == {"phase2": flagged, "grid": sizes[0]}
    kernels.STATS.reset()


def test_every_read_site_is_named():
    """Each ``read("<site>")`` of the package is one of ``tracing.READS``,
    and each of those is read somewhere."""
    sites = set()
    for path in PKG.rglob("*.py"):
        sites |= set(re.findall(r"""\bread\("([a-z0-9_]+)"\)""", path.read_text()))
    assert sites == set(tracing.READS)


def test_irls_trips_only_while_tracing(monkeypatch):
    """Tracing off: no trip reduction and no record; on: one of each.
    ``return_iters`` still gets its count with tracing off."""
    G, N, P = 50, 8, 2
    trips = torch.arange(G, dtype=torch.int32)
    monkeypatch.setattr(irl, "_irls_cuda", lambda counts, *a: (
        torch.zeros(G, P), torch.zeros(G, dtype=torch.bool), trips))
    args = (torch.ones(G, N), torch.ones(N), torch.ones(N, P), torch.ones(G), torch.zeros(G, P), 0.5, 1e-6, 30.0,
            8, 1e-5, 2)
    kernels.STATS.reset()
    assert irl._irls_core_cuda(*args)[2] is None
    assert int(irl._irls_core_cuda(*args, want_iters=True)[2]) == G - 1
    assert kernels.STATS.irls_trips == []
    with tracing.enabled():
        n_iter = irl._irls_core_cuda(*args)[2]
    assert int(n_iter) == G - 1 and kernels.STATS.irls_trips == [n_iter]
    kernels.STATS.reset()


def test_box_passes_only_while_tracing(monkeypatch):
    K, P = 6, 2
    passes = torch.arange(K, dtype=torch.int32)
    monkeypatch.setattr(irl, "_newton_box_cuda", lambda *a: (torch.zeros(K, P), torch.ones(K, dtype=torch.bool),
                                                              passes))
    card = types.SimpleNamespace(is_cuda=True)  # the CUDA route, its wrapper stubbed
    kernels.STATS.reset()
    irl.newton_box_nbglm(card, None, None, None, None)
    assert kernels.STATS.box_passes == []
    with tracing.enabled():
        irl.newton_box_nbglm(card, None, None, None, None)
    assert kernels.STATS.box_passes == [passes]
    kernels.STATS.reset()


def test_iterative_switch_warns_at_the_caller(monkeypatch):
    """The study's span wrapper leaves the switch's warning on the caller's
    line, and the iterative size factors' stop is a read span."""
    counts, X = make_data(12, 120, 1)
    spy = _Counting()
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with warnings.catch_warnings(record=True) as caught, tracing.enabled():
        warnings.simplefilter("always")
        _run(zero_per_gene(counts.T), X)
    (w,) = [w for w in caught if "iterative mode" in str(w.message)]
    assert w.filename == __file__
    assert "deseq2.read.sf_iter_done" in spy.names


SF_SPANS = ("deseq2.sf_round", "deseq2.sf_dispersions", "deseq2.sf_trim")


def _within(inner, outer) -> bool:
    return outer.time_range.start <= inner.time_range.start and inner.time_range.end <= outer.time_range.end


def test_iterative_spans_nest_in_the_size_factors(monkeypatch):
    """On: each round a ``deseq2.sf_round`` inside ``deseq2.size_factors``,
    holding one ``deseq2.sf_dispersions`` and one ``deseq2.sf_trim``, as
    many rounds as the counter gives; off: no span entered."""
    counts, X = make_data(12, 120, 1)
    zi = zero_per_gene(counts.T)
    spy = _Counting()
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        off = _run(zi, X)
        assert spy.names == []
        kernels.STATS.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, tracing.enabled():
            on = _run(zi, X)
    _same(off, on)
    ev = [e for e in prof.events() if e.name.startswith("deseq2.")]
    by = {n: [e for e in ev if e.name == n] for n in SF_SPANS + ("deseq2.size_factors",)}
    rounds = kernels.STATS.sf_rounds
    assert rounds >= 3 and all(len(by[n]) == rounds for n in SF_SPANS)
    for r in by["deseq2.sf_round"]:
        assert any(_within(r, s) for s in by["deseq2.size_factors"])
        for n in ("deseq2.sf_dispersions", "deseq2.sf_trim"):
            assert sum(_within(e, r) for e in by[n]) == 1
    kernels.STATS.reset()


def test_sf_rounds_count_the_solves_rounds():
    """``STATS.sf_rounds`` adds each solve's returned rounds, and a study
    whose ratio is defined leaves it untouched."""
    counts, X = make_data(12, 120, 1)
    zi = torch.as_tensor(zero_per_gene(counts.T))
    kernels.STATS.reset()
    _, n1 = sizefactors.iterative_size_factors(zi, device="cpu")
    assert kernels.STATS.sf_rounds == n1 >= 3
    _, n2 = sizefactors.iterative_size_factors(zi[:, :10], device="cpu")
    assert kernels.STATS.sf_rounds == n1 + n2
    kernels.STATS.reset()
    _run(*_study())
    assert kernels.STATS.sf_rounds == 0
