"""``chip_smoke.py``'s card-against-CPU accounting, rehearsed on the CPU.

``account_rescue_exit`` explains a gene whose IRLS rescue exit differs
between the card and the CPU from the card's captured rescue operands and
outputs. Here the capture comes from a CPU run of ``summary_pipeline`` with
two injected outliers (gene 3 reaches the Newton box and converges), and a
flip is planted in the "CPU" result; the grid branch is planted by a capture
whose Newton box ran one step only, so that it fails.
"""

from __future__ import annotations

import copy
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import pydeseq2_tpu_torch as pt
from pydeseq2_tpu_torch.ops import irls as irl
from pydeseq2_tpu_torch.synthetic import make_data

ROOT = pathlib.Path(__file__).resolve().parents[1]
GENE = 3  # the injected outlier that the rescue tiers take


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_rehearsal", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEVICE = "cpu"
    return mod


@pytest.fixture(scope="module")
def run(cs):
    """(counts, capture, outputs) of a float64 CPU summary run at 40 x 100."""
    torch.set_num_threads(1)
    counts_np, X_np = make_data(40, 100, seed=0)
    counts = cs.with_outliers(counts_np.T)
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **k: None  # the capture synchronises the card
    try:
        seen = cs.capture_summary_inputs(cs.summary_kwargs(counts, X_np, torch.float64, "cpu", beta_tol=1e-8))
    finally:
        torch.cuda.synchronize = sync
    tile = seen["newton_box_nbglm"][0][0]
    assert np.array_equal(tile[0].numpy(), counts[GENE])  # the tile's lane 0, flagged first
    return counts, seen, pt.outputs_to_numpy(seen["summary"])


def flipped(out: dict) -> dict:
    other = copy.deepcopy(out)
    other["irls_converged"][GENE] = not other["irls_converged"][GENE]
    return other


def test_newton_branch(cs, run):
    counts, seen, out = run
    assert bool(seen["newton_box_nbglm"][2][1][0]) and out["cooks_outlier"][GENE]
    gap = cs.account_rescue_exit(seen, counts, GENE, out, flipped(out), "planted")
    assert gap == 0.0
    wrong = copy.deepcopy(out)
    wrong["lfc"][GENE] += 0.5
    with pytest.raises(AssertionError, match="Newton box"):
        cs.account_rescue_exit(seen, counts, GENE, wrong, flipped(out), "planted")


def test_grid_branch(cs, run):
    counts, seen, out = run
    args, kwargs, _ = seen["newton_box_nbglm"]
    one_step = {**kwargs, "maxiter": 1}
    planted = {**seen, "newton_box_nbglm": (args, one_step, irl.newton_box_nbglm(*args, **one_step))}
    assert not bool(planted["newton_box_nbglm"][2][1][0])
    tc, sf, X, disp = args[:4]
    card = copy.deepcopy(out)
    card["irls_converged"][GENE] = False
    card["lfc"][GENE] = irl.grid_fit_beta_batch(tc[:1], sf, X, disp[:1], min_mu=kwargs["min_mu"])[0].numpy()
    cs.account_rescue_exit(planted, counts, GENE, card, out, "planted")
    card["lfc"][GENE] += 0.5
    with pytest.raises(AssertionError, match="grid"):
        cs.account_rescue_exit(planted, counts, GENE, card, out, "planted")


def test_outlier_required(cs, run):
    counts, seen, out = run
    other = flipped(out)
    other["cooks_outlier"] = np.zeros_like(other["cooks_outlier"])
    with pytest.raises(AssertionError, match="Cook's outlier"):
        cs.account_rescue_exit(seen, counts, GENE, out, other, "planted")
