"""The controls: the reference put in the program's place in the next
precision below the configuration's comes out not correct under each
cell's limits. The float64 cell's control (float32) runs here at a small
size; the float32 cell's (TF32 products) needs a card."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from dea_bench.cell import HERE, load_module
from dea_bench.draw import draw_pool
from dea_bench.tests.conftest import TINY_CONFIG, TINY_MIX

ENTRY = load_module(HERE / "entries" / "refit_summary.py")


def _limits(workload):
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())["limits"]


def _fails(numbers, limits) -> bool:
    return any(not (numbers[k] <= lim) for k, lim in limits.items())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_float32_control_fails_the_float64_cell(seed):
    study = draw_pool(seed, TINY_CONFIG, TINY_MIX, torch.float64, "cpu")[0]
    kn = ENTRY.knobs(TINY_CONFIG["n_samples"], torch.float64)
    ref = ENTRY.reference(study, torch.float64, kn)
    assert not _fails(ENTRY.numbers(ref, ref, study.contrast), _limits("brca.refit"))
    ctl = ENTRY.reference(study, torch.float32, kn)
    assert _fails(ENTRY.numbers(ctl, ref, study.contrast), _limits("brca.refit"))


@pytest.mark.card
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tf32_control_fails_the_float32_cell(seed):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card")
    cfg = dict(TINY_CONFIG, n_genes=4000, n_samples=600, cohorts={"a": 400, "b": 200}, dtype="float32")
    study = draw_pool(seed, cfg, TINY_MIX, torch.float32, "cuda")[0]
    kn = ENTRY.knobs(cfg["n_samples"], torch.float32)
    ref = ENTRY.reference(study, torch.float32, kn)
    ctl = ENTRY.reference(study, torch.float32, kn, tf32=True)
    assert np.isfinite(ref["padj"]).any()
    assert _fails(ENTRY.numbers(ctl, ref, study.contrast), _limits("gtex.refit"))
