"""The ``impute`` and ``newton_box`` kernels' launch plans, wrappers and plain
versions on the CPU (the kernels themselves need a card).

``impute`` runs on the trimmed-moment plans of ``ops/stats.py:_trim_plan``
(one cohort of the row's N samples); ``newton_box`` a block a selected lane
with the row's first ``_box_plan(...).stage`` samples staged. The plain
versions are held to the JAX package's expressions, and ``chip_smoke.py``'s
two plan-check phases are rehearsed with the plain versions standing in for
the kernels.
"""

from __future__ import annotations

import ctypes
import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydeseq2_tpu.ops import irls as j_irls
from pydeseq2_tpu.ops import stats as j_stats
from pydeseq2_tpu_torch import kernel_bench, kernels
from pydeseq2_tpu_torch.ops import irls as irl
from pydeseq2_tpu_torch.ops import refit as rf
from pydeseq2_tpu_torch.ops import stats as st

torch.set_num_threads(1)  # xdist runs several workers on a few cores

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMPUTE_N = (3, 12, 96, 97, 100, 1_000, 10_000, 30_000)
BOX_N = (1, 12, 100, 1_000, 1_638, 1_639, 3_276, 3_277, 4_000, 8_000, 100_000)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N", IMPUTE_N)
def test_impute_plan_covers_and_fits(N, itemsize):
    """The refit tile's plan (4096 rows): the rank count up to 96 samples,
    the radix select above; a warp a row where eight slices fit 64 KB, else
    a block with the keys in shared memory, else (only past 227 KB) the
    workspace; every group's bytes within a block's shared memory."""
    plan = st._trim_plan(itemsize, [N], 4096, True, 132)
    assert (N <= plan.rank_max) == (N <= 96) and plan.rank_max <= st._TRIM_RANK_CAP
    radix = N > plan.rank_max
    warp_bytes = 8 * st._trim_group_bytes(N, itemsize, radix, True, False)
    block_bytes = st._trim_group_bytes(N, itemsize, radix, True, True)
    if not plan.block:
        assert plan.shared and warp_bytes <= st._TRIM_WARP_SMEM and plan.threads == 256
    elif plan.shared:
        assert warp_bytes > st._TRIM_WARP_SMEM and block_bytes <= kernels.SMEM_BLOCK_MAX
    else:
        assert block_bytes > kernels.SMEM_BLOCK_MAX and 1 <= plan.blocks <= 2 * 132
        assert st._trim_group_bytes(N, itemsize, radix, False, True) <= kernels.SMEM_BLOCK_MAX
    want = {(100, 4): "warp", (1_000, 4): "warp", (1_000, 8): "block", (10_000, 4): "block", (30_000, 8): "streamed"}
    if (N, itemsize) in want:
        got = "warp" if not plan.block else ("block" if plan.shared else "streamed")
        assert got == want[(N, itemsize)]


@pytest.fixture
def recorded(monkeypatch):
    """Launches recorded instead of made, on CPU tensors; ``check_sel``
    without its CUDA check."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, args, device: calls.append((name, args)))
    monkeypatch.setattr(kernels, "check_cuda_operands", lambda *a: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "check_sel", lambda name, sel, K: None if sel is None else sel.contiguous())
    return calls


def _assert_marshalled(name, args):
    kinds = {ctypes.c_int: int, ctypes.c_double: float}
    want = kernels._ARGTYPES[kernels.KERNELS[name][1]]
    assert len(args) == len(want), name
    for a, w in zip(args, want):
        if w is ctypes.c_void_p:
            assert a is None or (isinstance(a, int) and not isinstance(a, bool)), (name, a)
        else:
            assert isinstance(a, kinds[w]) and not isinstance(a, bool), (name, a, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [12, 100, 1_000, 30_000])
def test_impute_wrapper_marshals_its_plan(recorded, N, dtype):
    """``_impute_cuda`` hands the launcher the plan's arguments and the
    workspace where the plan streams, reads a bool tile mask in place (no
    copy) and returns a bool ``new_all_zero``; a given plan overrides the
    picked one."""
    K = 5
    tile = torch.ones(K, N, dtype=dtype)
    packed = torch.zeros(K, -(-N // 32), dtype=torch.int32)
    mask = torch.ones(K, dtype=torch.bool)
    imputed, naz = rf._impute_cuda(tile, packed, (True,) * N, torch.ones(N, dtype=dtype), mask)
    plan = st._trim_plan(tile.element_size(), [N], K, True, 132)
    other = plan._replace(block=True, threads=256, shared=False, blocks=3)
    rf._impute_cuda(tile, packed, (True,) * N, torch.ones(N, dtype=dtype), mask, plan=other)
    for (name, a), p in zip(recorded, (plan, other)):
        assert name == "impute"
        _assert_marshalled(name, a)
        assert a[:4] == [int(dtype == torch.float64), K, N, math.floor(0.2 * N)]
        assert a[8] == mask.data_ptr()
        assert a[11:16] == [int(p.block), p.threads, p.rank_max, int(p.shared), p.blocks]
        assert (a[16] is None) == p.shared
    assert recorded[0][1][10] == naz.data_ptr() and naz.dtype == torch.bool and imputed.shape == (K, N)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [2, 3, 5])
def test_box_wrapper_marshals_its_plan(recorded, P, dtype):
    """``_newton_box_cuda`` hands the launcher the plan's stage and the
    selection's own bytes (no copy), and returns bool flags and the passes
    of each lane; a given plan overrides the picked one."""
    K, N = 6, 40
    X = torch.ones(N, P, dtype=dtype)
    args = (torch.ones(K, N, dtype=dtype), torch.ones(N, dtype=dtype), X, torch.full((K,), 0.1, dtype=dtype),
            torch.zeros(K, P, dtype=dtype), 0.5, 30.0, 60)
    sel = torch.arange(K) % 2 == 0
    beta, ok, passes = irl._newton_box_cuda(*args, sel)
    irl._newton_box_cuda(*args, plan=irl._box_plan(N, P, X.element_size())._replace(stage=7))
    (n0, a0), (n1, a1) = recorded
    for name, a in recorded:
        assert name == "newton_box"
        _assert_marshalled(name, a)
        assert a[:4] == [int(dtype == torch.float64), P, K, N] and a[12:15] == [0.5, 30.0, 60]
    assert a0[4] == irl._box_plan(N, P, X.element_size()).stage == N and a1[4] == 7
    assert a0[11] == sel.data_ptr() and a1[11] is None
    assert a0[15] == beta.data_ptr() and a0[16] == ok.data_ptr() and ok.dtype == torch.bool
    assert a0[17] == passes.data_ptr() and passes.dtype == torch.int32 and len(a0) == 18


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", [2, 3, 4, 5])
@pytest.mark.parametrize("N", BOX_N)
def test_box_plan_fits(N, P, itemsize):
    """``newton_box``'s block: 14 warps; the stage the longest prefix of the
    row within ``_BOX_STAGE_BYTES`` (the whole row where it fits), the rest
    streamed; the block's shared memory within 227 KB at every N."""
    plan = irl._box_plan(N, P, itemsize)
    per_sample = (3 + P) * itemsize
    assert plan.threads == 448 and plan.threads % 32 == 0
    assert 0 <= plan.stage <= N and plan.stage * per_sample <= irl._BOX_STAGE_BYTES
    assert plan.stage == N or (plan.stage + 1) * per_sample > irl._BOX_STAGE_BYTES
    assert plan.smem == irl._box_smem_bytes(plan.stage, P, itemsize) <= kernels.SMEM_BLOCK_MAX
    assert irl._box_smem_bytes(0, 8, 8) + irl._BOX_STAGE_BYTES <= kernels.SMEM_BLOCK_MAX  # any P, any type


def _jax_words(bits):
    K, N = bits.shape
    padded = np.zeros((K, -(-N // 32) * 32), dtype=np.uint64)
    padded[:, :N] = bits
    return (padded.reshape(K, -1, 32) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("N", [97, 100])
def test_impute_plain_matches_jax_on_tied_rows(N, dtype):
    """The plain imputation against the JAX expressions
    (``pydeseq2_tpu/fused_stream.py:561-573``) on tie-heavy rows (counts
    0-3 at unit size factors: equal normalised counts at both trimmed
    boundaries), a Poisson row, a row left all zero and padding, at 97
    and 100 samples (the rank count's edge): the same cells and flags."""
    rng = np.random.default_rng(N)
    K = 10
    sf = np.ones(N)
    counts = rng.integers(0, 4, (K, N)).astype(dtype)
    counts[1] = rng.poisson(50.0, N)
    counts[2] = 0.0
    counts[2, 4] = 1e4
    bits = rng.random((K, N)) < 0.1
    bits[2] = False
    bits[2, 4] = True
    replaceable = np.arange(N) % 7 != 6
    mask = np.arange(K) < 8
    words = _jax_words(bits)
    imputed, naz = rf.impute_outliers(torch.as_tensor(counts), torch.as_tensor(words.view(np.int32)),
                                      tuple(replaceable), torch.as_tensor(sf.astype(dtype)), torch.as_tensor(mask))
    cj, sj = jnp.asarray(counts), jnp.asarray(sf.astype(dtype))
    unpacked = ((jnp.asarray(words)[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1).reshape(K, -1)[:, :N]
    swap = jnp.asarray(replaceable)[None, :] & unpacked.astype(bool)
    trim02 = j_stats.trimmed_mean(cj / sj[None, :], trim=0.2, axis=1)
    want = np.asarray(jnp.where(swap, jnp.floor(trim02[:, None] * sj[None, :]), cj))
    assert np.array_equal(imputed.numpy(), want)
    assert np.array_equal(naz.numpy(), (want == 0).all(axis=1) & mask)
    assert naz.numpy().tolist() == [i == 2 for i in range(K)]


def test_box_plain_matches_jax_at_fixed_points(monkeypatch):
    """The box rescue's plain version against JAX's ``newton_box_nbglm`` in
    float64 at P = 3 on ``kernel_bench.box_operands``' lanes (a condition
    without counts in its second level on every 4th lane, whose means there
    fall to the min_mu clamp; means near 1e4 on every 7th). The lanes compared reach the fixed point the kernel
    leaves at: a 60th step that changes nothing (the plain iterate after 59
    steps equals the one after 60, bit for bit). A lane agrees within 1e-7
    relative, or stops at a point whose float64 objective ties JAX's within
    8 rounding units (sqrt(N) eps of the summed size of its terms, the tie
    rule of ``chip_smoke.py``): the two sum over samples in other orders,
    and the backtracking stops where rounding hides the next step."""
    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    box = kernel_bench.box_operands(12, 30, 3, torch.float64, seed=7)
    counts, sf, X, disp = box[:4]
    b60, ok60 = irl._newton_box_plain(*box)
    b59, _ = irl._newton_box_plain(*box[:-1], 59)
    fixed = (b60 == b59).all(1)
    assert int(fixed.sum()) >= 8
    b_j, ok_j = j_irls.newton_box_nbglm(*(jnp.asarray(t.numpy()) for t in box[:5]), *box[5:])
    b_j = torch.as_tensor(np.array(b_j))

    def objective(b):
        mu = torch.clamp(sf[None, :] * torch.exp(b @ X.T), min=0.5)
        r = 1.0 / disp[:, None]
        return ((counts + r) * torch.log1p(mu / r) - counts * torch.log(mu)).sum(1) + 0.5e-6 * (b**2).sum(1)

    close = ((b60 - b_j).abs() <= 1e-9 + 1e-7 * b_j.abs()).all(1)
    unit = math.sqrt(30) * torch.finfo(torch.float64).eps * (1.0 + ((counts + 1) * (1 + torch.log1p(counts))).sum(1))
    tied = (objective(b60) - objective(b_j)).abs() <= 8 * unit
    assert bool((close | tied)[fixed].all()) and int(close[fixed].sum()) >= int(fixed.sum()) - 2
    assert np.array_equal(ok60[fixed].numpy(), np.asarray(ok_j)[fixed.numpy()])
    # the empty level's means fall to the min_mu clamp, where its terms stop moving
    raw = sf[None, 1::2] * torch.exp(b60[::4] @ X[1::2].T)
    assert bool((raw <= 0.5 * (1 + 1e-6)).all()) and bool((b60[::4, 1] < -1.0).all())


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_impute_box", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEVICE = "cpu"
    return mod


def _box_stand_in(counts, sf, X, disp, beta_init, min_mu, max_beta, maxiter, sel=None, plan=None):
    """The plain box solver in ``_newton_box_cuda``'s form: the lanes not
    selected keep their start, no flag, no passes."""
    beta, ok = irl._newton_box_plain(counts, sf, X, disp, beta_init, min_mu, max_beta, maxiter)
    passes = torch.full((counts.shape[0],), 2 * maxiter, dtype=torch.int32)
    if sel is not None:
        beta = torch.where(sel[:, None], beta, beta_init)
        ok = ok & sel
        passes = torch.where(sel, passes, 0)
    return beta, ok, passes


def test_smoke_plan_checks_rehearsed(cs, monkeypatch):
    """``impute_plan_checks`` and ``newton_box_plan_checks`` run through
    on the CPU at small shapes with the plain versions standing in for the
    kernels: every plan and selection is visited, and the float32 tie case
    on each of its draws, and passes the floor and tie rules."""
    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(rf, "_impute_cuda", lambda *a, plan=None: rf._impute_plain(*a))
    monkeypatch.setattr(irl, "_newton_box_cuda", _box_stand_in)
    monkeypatch.setattr(cs, "IMPUTE_PLAN_N", (3, 12, 97))
    monkeypatch.setattr(cs, "IMPUTE_WS_N", 40)
    monkeypatch.setattr(cs, "IMPUTE_PLAN_K", 64)
    monkeypatch.setattr(cs, "NB_TILE", 20)
    monkeypatch.setattr(cs, "BOX_PLAN_N", (12,))
    monkeypatch.setattr(cs, "BOX_PLAN_P", (2, 3))
    monkeypatch.setattr(cs, "N_GRID_WIDE", {torch.float32: 40, torch.float64: 30})
    monkeypatch.setattr(cs, "BOX_TIE_SEEDS", 2)
    plans = cs.impute_plan_checks()
    assert sum(label.endswith(", picked") for label in plans) == 3 * 2 + 1 + 4
    assert any(label.endswith(", radix") for label in plans) and any(label.endswith(", block a row") for label in plans)
    readings = {}
    plans = cs.newton_box_plan_checks(readings)
    assert len(plans) == len(readings) == 2 * 2 * 2 + 1
    assert sum(", seed " in label for label in readings) == 2
    assert all(r["passes_max"] == 120 and r["tie_max_units"] <= r["tie_limit_units"] for r in readings.values())


@pytest.mark.parametrize("detail", [False, True])
def test_bench_suites_on_cpu(monkeypatch, detail):
    """``kernel_bench``'s ``impute`` and ``box`` suites run one tree's child
    on the CPU at small shapes, the plain versions standing in for the
    kernels: every shape gives its row, the floor rule holds, repeats are
    bit for bit, and ``--detail`` adds the other plans and the unstaged
    box."""
    import time

    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    monkeypatch.setattr(kernels, "build", lambda: {})
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernel_bench, "ptxas", lambda k, sources=(): {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(kernel_bench, "cuda_ms", host_ms)
    monkeypatch.setattr(kernel_bench, "wall_ms", host_ms)
    monkeypatch.setattr(kernel_bench, "device_ms", lambda fn, reps, name: (host_ms(fn, reps),) * 2)
    monkeypatch.setattr(rf, "_impute_cuda", lambda *a, plan=None: rf._impute_plain(*a))
    monkeypatch.setattr(irl, "_newton_box_cuda", _box_stand_in)
    monkeypatch.setattr(kernel_bench, "IMPUTE_SHAPES", (("f32 stream", 12, torch.float32, "stream", 1),
                                                        ("f64 atlas", 40, torch.float64, "atlas", 1)))
    monkeypatch.setattr(kernel_bench, "IMPUTE_G", 400)
    monkeypatch.setattr(kernel_bench, "IMPUTE_ROWS", 64)
    monkeypatch.setattr(kernel_bench, "RESCUE_G", 300)
    monkeypatch.setattr(kernel_bench, "BOX_SHAPES", (("f32 4 lanes x 50 P=3", 4, 50, 3, torch.float32, 1),))
    res = kernel_bench.child(detail, ("impute", "box"))
    imp, box = res["impute"], res["box"]
    assert set(imp) == {"f32 stream", "f64 atlas"}
    for row in imp.values():
        assert row["beyond_floor_rule"] == 0 and row["repeat_bits_equal"] and row["rows"] in (4096, 64)
        assert ("kernel_ms radix" in row or "kernel_ms rank count" in row) == detail
    assert imp["f32 stream"]["rows"] == 4096 and imp["f32 stream"]["live_rows"] >= 1
    assert box["f32 4 lanes x 50 P=3"]["passes"] == [120] * 4 and box["f32 4 lanes x 50 P=3"]["repeat_bits_equal"]
    assert all(("kernel_ms unstaged" in r) == detail for r in box.values() if isinstance(r, dict))
    summary = kernel_bench.summary(res)
    assert "impute f64 atlas" in summary and "box f32 4 lanes x 50 P=3" in summary
