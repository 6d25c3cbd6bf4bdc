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


def _kernel_as_plain(cs, monkeypatch, lanes=(), beta_shift=0.0, flip=False, extra_trips=0):
    """``irls_against_plain`` on the CPU: ``_irls_cuda`` answers with the
    plain loop (PyTorch's constant, every lane at the loop's trip count),
    changed on ``lanes``: coefficients moved by ``beta_shift``, flags
    flipped, ``extra_trips`` more trips."""

    def plain(counts, sf, X, disp, beta_init, log_sf, min_mu, beta_tol, max_beta, maxiter, step_tol, polish, plan):
        beta, fb, it = cs.irls_plain_of({"counts": counts, "sf": sf, "X": X, "disp": disp, "beta_init": beta_init},
                                        maxiter)
        trips = torch.full((counts.shape[0],), int(it), dtype=torch.int32)
        idx = torch.as_tensor(lanes, dtype=torch.int64)
        beta[idx] += beta_shift
        fb[idx] ^= flip
        trips[idx] += extra_trips
        return beta, fb, trips

    monkeypatch.setattr(irl, "_irls_cuda", plain)
    monkeypatch.setattr(irl, "_irls_device_plan", lambda G, N, P, dtype, device: irl._irls_plan(G, N, P))


@pytest.mark.parametrize("own_noise", [False, True])
def test_irls_against_plain_accepts_the_plain_loop(cs, monkeypatch, own_noise):
    """The plain loop passes its own check, by the stated rule and by the
    plain loop's agreement with itself in other sample orders."""
    _kernel_as_plain(cs, monkeypatch)
    ops = cs.irls_case(400, 12, 3, torch.float32, seed=3)
    _, _, trips, plan = cs.irls_against_plain("rehearsal", ops, 8, own_noise=own_noise)
    assert plan == irl.IrlsPlan(32) and int(trips.max()) == 8


@pytest.mark.parametrize("change,fails", [
    (dict(lanes=(1, 2), flip=True), False),
    (dict(lanes=(1, 2, 3), flip=True), True),
    (dict(lanes=(1, 2), beta_shift=2e-4), False),
    (dict(lanes=(1, 2, 3), beta_shift=2e-4), True),
    (dict(lanes=(5,), extra_trips=1), False),
    (dict(lanes=(5,), extra_trips=2), True),
])
def test_irls_against_plain_holds_the_stated_rule(cs, monkeypatch, change, fails):
    """By the stated rule (2000 lanes): at most 2 lanes beyond 1e-4, at
    most 2 with other flags, the slowest lanes at most one trip apart."""
    _kernel_as_plain(cs, monkeypatch, **change)
    ops = cs.irls_case(2_000, 12, 2, torch.float32, seed=2)
    if fails:
        with pytest.raises(AssertionError):
            cs.irls_against_plain("rehearsal", ops, 250)
    else:
        cs.irls_against_plain("rehearsal", ops, 250)
