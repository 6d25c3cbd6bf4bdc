"""The gene mesh's size-factor median on the CPU: ``select_hist``'s launch
plan (``ops/select.py:_hist_plan``, ``_hist_cover``: every (column, row)
counted and staged exactly once), the plain digit pick and decode against
``radix_pick`` and ``_decode`` on edge cases, ``sharded_masked_median``
bit for bit the JAX package's ``masked_median_select``
(``pydeseq2_tpu/ops/select.py:200``), the wrappers' checks, and
``chip_smoke.select_hist_checks`` rehearsed at a small size with the
kernels' plain versions."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from pydeseq2_tpu_torch.ops import select as sel

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(sel._monotone_key(a), sel._monotone_key(b))


# ------------------------------------------------------------ the launch plan
@pytest.mark.parametrize("C", [1, 15, 16, 17, 100])
@pytest.mark.parametrize("L", [100, 3000])
@pytest.mark.parametrize("staged", [True, False])
def test_hist_plan_covers_every_cell_once(C, L, staged):
    plan = sel._hist_plan(C, L, staged, slots=64)
    assert plan.rows % 32 == 0 and (plan.rows >= 256 or plan.rows >= L)
    for p in (plan, plan._replace(rows=777)):
        for vec, itemsize in ((True, 4), (True, 8), (False, 4)) if staged else ((True, 4),):
            counted, staged_n = sel._hist_cover(C, L, p, vec, itemsize)
            assert torch.all(counted == 1), (p, vec)
            if staged:
                assert torch.all(staged_n == 1), (p, vec)
            else:
                assert staged_n is None


@pytest.mark.parametrize(("C", "L", "slots", "splits"), [
    (100, 60_000, 528, 67),  # 7 groups: one wave of 469 blocks
    (10_000, 15_000, 528, 4),  # 625 groups: four splits, within 10% of the fewest waves
    (8_000, 6_000, 528, 1),
    (1, 100, 528, 1),  # fewer rows than one block
])
def test_hist_plan_waves(C, L, slots, splits):
    plan = sel._hist_plan(C, L, True, slots)
    assert -(-L // plan.rows) == splits
    assert plan.rows % 32 == 0


# ------------------------------------------------------ the pick and decode
def edge_tile(dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(values (G, N) +inf where excluded, valid counts (N,)): ties at the
    middle ranks, 0, 1 and 2 valid entries, +-0.0, subnormals, a column of
    +inf, negatives, one value repeated."""
    rng = np.random.default_rng(11)
    G = 41
    tiny = np.finfo(np.float32 if dtype == torch.float32 else np.float64).smallest_subnormal
    cols = [
        rng.choice([-1.5, 0.25, 0.25, 0.25, 3.0], G),  # ties at the middle
        np.full(G, np.inf),  # nothing valid
        np.concatenate([[2.5], np.full(G - 1, np.inf)]),  # one valid
        np.concatenate([[-0.0, 0.0], np.full(G - 2, np.inf)]),  # two: -0.0 and 0.0
        np.concatenate([[tiny, -tiny, 3 * tiny, 0.0], np.full(G - 4, np.inf)]),  # subnormals
        -np.exp(rng.normal(0, 2, G)),  # negatives
        np.full(G, 7.0),  # one value
        rng.normal(0, 1, G),
    ]
    x = torch.tensor(np.stack(cols, axis=1), dtype=dtype)
    return x, torch.isfinite(x).sum(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_pick_is_radix_pick(dtype):
    x, n = edge_tile(dtype)
    C = x.shape[1]
    npass = sel._passes(dtype)
    digits = torch.zeros((C, 2, npass), dtype=torch.uint8)
    picked = digits.clone()
    rank = sel._mid_ranks(n)
    r_k = torch.zeros((C, 2), dtype=torch.int32)
    med = torch.empty(C, dtype=dtype)
    for p in range(npass):
        hist = sel.select_hist_plain(x, digits, p)
        sel.select_pick(hist, n, r_k, picked, p, med if p == npass - 1 else None)
        rank = sel.radix_pick(hist, rank, digits, p)
        assert torch.equal(picked, digits) and torch.equal(r_k.to(torch.int64), rank), p
    v = sel._decode(digits, dtype)
    want = torch.where(n > 0, (v[:, 0] + v[:, 1]) / 2.0, torch.full_like(v[:, 0], math.nan))
    assert same_bits(med, want)
    assert same_bits(med, sel.masked_median_select(x, n))
    assert torch.isnan(med[1]) and not torch.isnan(med[2])
    assert med[3] == 0.0 and med[2] == 2.5


def test_pick_past_the_count_takes_the_last_digit():
    """A rank past every count: digit 255, the rank less the count before
    bin 255, as radix_pick."""
    hist = torch.zeros((2, 2, 256), dtype=torch.int32)
    hist[:, :, 3] = 4
    hist[:, :, 255] = 2
    digits = torch.zeros((2, 2, 4), dtype=torch.uint8)
    ranks_in = torch.tensor([[7, 9], [0, 5]], dtype=torch.int32)
    rank = ranks_in.clone()
    sel.select_pick_plain(hist, torch.tensor([10, 10]), rank, digits, 1)
    want_d = digits.clone()
    want_r = sel.radix_pick(hist, ranks_in.to(torch.int64), want_d, 1)
    assert torch.equal(digits, want_d) and torch.equal(rank.to(torch.int64), want_r)
    assert digits[0, 1, 1] == 255 and rank[0, 1] == 5 and digits[1, 0, 1] == 3


# ------------------------------------------------------- against the JAX one
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_median_cpu_matches_jax(dtype):
    import jax.numpy as jnp

    from pydeseq2_tpu.ops.select import masked_median_select as jax_median

    rng = np.random.default_rng(5)
    G, N = 600, 9
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    x = rng.normal(0, 1, (G, N)).astype(np_dtype)
    x[rng.random((G, N)) < 0.3] = np.inf
    x[:, 4] = np.round(x[:, 4], 1)  # ties
    x[:, 7] = np.inf  # nothing valid
    n = np.isfinite(x).sum(0)
    want = np.asarray(jax_median(jnp.asarray(x), jnp.asarray(n), axis=0))
    got = sel.sharded_masked_median(torch.tensor(x), torch.tensor(n)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(f"u{x.itemsize}"), want.view(f"u{x.itemsize}"))
    # one count for every column, as the size factors hand it
    x1 = np.where(np.isfinite(x[:, 0])[:, None], x, np.inf)[:, :3]
    n1 = int(np.isfinite(x1[:, 0]).sum())
    want = np.asarray(jax_median(jnp.asarray(x1), jnp.asarray(n1), axis=0))
    got = sel.sharded_masked_median(torch.tensor(x1), torch.tensor(n1)).numpy()
    np.testing.assert_array_equal(got.view(f"u{x.itemsize}"), want.view(f"u{x.itemsize}"))


# ------------------------------------------------------------ the wrappers
def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((40, 3))
    digits = torch.zeros((3, 2, 4), dtype=torch.uint8)
    plan = sel._hist_plan(3, 40, True, 64)
    with pytest.raises(ValueError, match="expected CUDA"):
        sel._select_hist_cuda(x, digits, 0, plan=plan)
    with pytest.raises(ValueError, match="digits must be"):
        sel._select_hist_cuda(x, digits[:2], 0, plan=plan)
    hist = torch.zeros((3, 2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected CUDA"):
        sel._select_pick_cuda(hist, torch.tensor(5), torch.zeros((3, 2), dtype=torch.int32), digits, 0)
    with pytest.raises(ValueError, match="rank must be"):
        sel._select_pick_cuda(hist, torch.tensor(5), torch.zeros((3, 2), dtype=torch.int64), digits, 0)
    with pytest.raises(ValueError, match="4-byte aligned"):
        sel._select_hist_cuda(x, torch.zeros(3 * 2 * 4 + 1, dtype=torch.uint8)[1:].view(3, 2, 4), 0, plan=plan)


# -------------------------------------------- chip_smoke's checks, rehearsed
def test_select_hist_checks_rehearsed(monkeypatch):
    """``chip_smoke.select_hist_checks`` at 20 x 700 (and 30 x 300, 21 x
    700) on the CPU, each kernel's wrapper swapped for its plain version:
    its cases, passes, picks, medians and timing record run to the end."""
    from pydeseq2_tpu_torch import kernel_bench

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "N_MAIN", 20)
    monkeypatch.setattr(cs, "G_MAIN", 700)
    monkeypatch.setattr(cs, "N_HIST_WIDE", 30)
    monkeypatch.setattr(cs, "G_HIST_WIDE", 300)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "log", lambda *a, **k: None)
    monkeypatch.setattr(kernel_bench, "wall_ms", lambda fn, reps: (fn(), 0.0)[1])
    monkeypatch.setattr(sel, "_hist_slots", lambda *a: 64)
    monkeypatch.setattr(sel, "_select_hist_cuda", lambda x, d, p, axis=0, plan=None: sel.select_hist_plain(x, d, p, axis))

    def pick(hist, n_valid, rank, digits, pass_, out=None):
        sel.select_pick_plain(hist, n_valid.expand(hist.shape[0]), rank, digits, pass_, out)

    monkeypatch.setattr(sel, "_select_pick_cuda", pick)
    timings = {}
    errs = cs.select_hist_checks(timings)
    assert errs == {"select_hist": 0.0, "select_pick": 0.0}
    assert timings["select_hist"]["passes"] == 4 and len(timings["select_hist"]["ms_per_pass"]) == 4
    assert timings["select_pick"]["library_ms"] is None


# ------------------------------------------------- kernel_bench's hist suite
@pytest.mark.parametrize("detail", [False, True])
def test_hist_child_on_cpu(monkeypatch, detail):
    """The ``hist`` suite of one tree's run at small shapes, the plain
    versions standing in for the kernels: every pass bit for bit, the
    median bit for bit the select kernel's, its launches; ``--detail`` the
    passes at other row counts."""
    import time

    from pydeseq2_tpu_torch import kernel_bench, kernels

    def host_ms(fn, reps, *a):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    monkeypatch.setattr(kernels, "build", lambda: {})
    monkeypatch.setattr(kernel_bench, "ptxas", lambda k, sources=(): {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(kernel_bench, "cuda_ms", host_ms)
    monkeypatch.setattr(kernel_bench, "wall_ms", host_ms)
    monkeypatch.setattr(kernel_bench, "device_ms", lambda fn, reps, name: (host_ms(fn, reps),) * 2)
    monkeypatch.setattr(kernel_bench, "profile_launches", lambda fn, reps: (host_ms(fn, reps), 0.0))
    monkeypatch.setattr(sel, "_hist_slots", lambda *a: 64)
    plans = []

    def plain_hist(x, digits, pass_, axis=0, plan=None):
        plans.append(plan)
        return sel.select_hist_plain(x, digits, pass_, axis)

    def plain_pick(hist, n_valid, rank, digits, pass_, out=None):
        sel.select_pick_plain(hist, n_valid.expand(hist.shape[0]), rank, digits, pass_, out)

    monkeypatch.setattr(sel, "_select_hist_cuda", plain_hist)
    monkeypatch.setattr(sel, "_select_pick_cuda", plain_pick)
    monkeypatch.setattr(kernel_bench, "HIST_SHAPES", (("f32 12x900", 12, 900, None, torch.float32, 1),
                                                      ("f64 12x900 shard of 300", 12, 900, 300, torch.float64, 1)))
    res = kernel_bench.child(detail, ("hist",))
    rows = res["hist"]
    assert set(rows) == {"f32 12x900", "f64 12x900 shard of 300"}
    for label, row in rows.items():
        npass = 4 if label.startswith("f32") else 8
        assert all(row[f"pass {p} bits_equal"] and row[f"pass {p} repeat_equal"] for p in range(npass)), label
        assert all(row[f"pass {p} matched"] > 0 for p in range(npass)), label
        assert row["plan"] == sel._hist_plan(12, 300 if "shard" in label else 900, True, 64)._asdict()
        assert any("kernel_ms rows" in k for k in row) == detail
    whole = rows["f32 12x900"]
    assert whole["median_bits_equal"] and "median_wall_ms" in whole and whole["median_launches"] == {}
    assert "median_bits_equal" not in rows["f64 12x900 shard of 300"]
    assert any(p is not None for p in plans) == detail
    assert {f"hist {k}" for k in rows} <= set(kernel_bench.summary(res))
