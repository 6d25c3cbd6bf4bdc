"""The zero-inflated refit route on the CPU: ``run_summary_streamed`` with
ratio size factors asked for, on counts in which every gene has a zero,
switches to the iterative size factors; the benchmark's plain reference
(``dea_bench.reference.iterative``) repeats it bit for bit, and a planted
size-factor fault fails the cell's size-factor limit."""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

from dea_bench.cell import HERE, load_module
from dea_bench.draw import draw_pool
from dea_bench.reference import iterative as ref
from pydeseq2_tpu_torch import fused_stream
from pydeseq2_tpu_torch.ops import sizefactors as sz

ENTRY = load_module(HERE / "entries" / "iterative_summary.py")
MIX = json.loads((HERE / "mixes" / "iterative.pool4.json").read_text())
LIMITS = json.loads((HERE / "limits" / "brca.iterative.json").read_text())["limits"]
# The cell's recipe (a zero planted at sample g mod N of every gene g) at a
# size the CPU runs in about a second.
CONFIG = {"name": "tiny", "n_genes": 600, "n_samples": 24, "cohorts": {"a": 16, "b": 8}}
SEEDS = (0, 7, 2**31 + 11)
DTYPES = {"float64": torch.float64, "float32": torch.float32}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _study(seed, dtype):
    return draw_pool(seed, CONFIG, MIX, dtype, "cpu")[0]


def _program(study, dtype):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = ENTRY.program(study, dtype, ENTRY.knobs(CONFIG["n_samples"], dtype))
    assert any("iterative mode" in str(w.message) for w in caught)
    return res


def _reference(study, dtype):
    return ENTRY.reference(study, dtype, ENTRY.knobs(CONFIG["n_samples"], dtype))


def test_every_gene_has_a_zero():
    counts = _study(SEEDS[0], torch.float64).counts
    assert bool((counts == 0).any(dim=1).all())
    G, N = counts.shape
    assert bool((counts[torch.arange(G), torch.arange(G) % N] == 0).all())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_route_matches_the_reference_bit_for_bit(seed, dtype):
    """Both dtypes bit for bit: on the CPU the program's route and the
    reference run the same plain PyTorch operations in the same order, so
    float32 rounds alike too (a tolerance of zero)."""
    t = DTYPES[dtype]
    study = _study(seed, t)
    prog, want = _program(study, t), _reference(study, t)
    shared = set(prog) & set(want)
    assert shared >= {"size_factors", "base_mean", "lfc", "padj", "replaced", "refitted", "cooks_outlier"}
    for k in sorted(shared):
        a, b = np.asarray(prog[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    numbers = ENTRY.numbers(prog, want, study.contrast)
    assert all(numbers[k] == 0.0 for k in LIMITS)


@pytest.mark.parametrize("gene_block", [None, 256])
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_solve_gives_the_ports_factors_and_rounds(seed, gene_block):
    counts = _study(seed, torch.float64).counts
    got, rounds = sz.iterative_size_factors(counts, max_disp=24.0, gene_block=gene_block, device="cpu")
    want, want_rounds = ref.iterative_size_factors(counts, max_disp=24.0, gene_block=gene_block)
    assert rounds == want_rounds >= 3
    assert got.numpy().tobytes() == want.numpy().tobytes()


def _one_round(monkeypatch):
    solve = fused_stream.iterative_size_factors
    monkeypatch.setattr(fused_stream, "iterative_size_factors", lambda *a, **k: solve(*a, **dict(k, niter=1)))


def _poscounts(monkeypatch):
    run = fused_stream.run_summary_streamed
    monkeypatch.setattr(fused_stream, "run_summary_streamed", lambda *a, **k: run(*a, **k, sf_fit_type="poscounts"))


@pytest.mark.parametrize("fault", ["one_round", "poscounts"])
def test_planted_size_factor_fault_fails_the_limit(monkeypatch, fault):
    study = _study(SEEDS[1], torch.float64)
    want = _reference(study, torch.float64)
    {"one_round": _one_round, "poscounts": _poscounts}[fault](monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prog = ENTRY.program(study, torch.float64, ENTRY.knobs(CONFIG["n_samples"], torch.float64))
    got = ENTRY.numbers(prog, want, study.contrast)
    assert got["size_factors.max"] > LIMITS["size_factors.max"]


def test_reference_refuses_a_defined_ratio():
    counts = _study(SEEDS[0], torch.float64).counts + 1.0
    study = _study(SEEDS[0], torch.float64)
    with pytest.raises(ValueError, match="ratio size factors are defined"):
        ref.iterative_refit_summary(counts, study.design, study.contrast, max_disp=24.0)
