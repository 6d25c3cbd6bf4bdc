"""The VST's launch plan and the fine dispersion scan's gene grouping on
the CPU: ``ops/vst.py:_vst_plan`` on each side of its edges, the grouping's
plain key and order (``ops/dispersion.py:_fine_keys_plain``,
``_fine_order_plain``) against numpy, the fine scan's result in any gene
order and against the JAX package in the grouped order, the wrappers'
launches recorded instead of made, and ``kernel_bench``'s ``vst``, ``fine``
and ``dnb`` suites and ``chip_smoke.py``'s ``vst_plan_checks``,
``fine_list_checks`` and ``dnb_plan_checks`` rehearsed with the plain versions standing in for the
kernels (which need a card)."""

from __future__ import annotations

import ctypes
import importlib.util
import math
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydeseq2_tpu.ops import dispersion as j_disp
from pydeseq2_tpu.ops import linreg as j_lin
from pydeseq2_tpu_torch import kernel_bench, kernels
from pydeseq2_tpu_torch.ops import dispersion as dsp
from pydeseq2_tpu_torch.ops import nb
from pydeseq2_tpu_torch.ops import vst as vs

torch.set_num_threads(1)  # xdist runs several workers on a few cores
jax.config.update("jax_enable_x64", True)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"f32": (torch.float32, np.float32, jnp.float32), "f64": (torch.float64, np.float64, jnp.float64)}
LO, HI = math.log(1e-8), math.log(30.0)
K = 32
STEP = (HI - LO) / (K - 1)


# -- the VST's plan -----------------------------------------------------------

@pytest.mark.parametrize(("N", "itemsize", "offset", "want"), [
    (100, 4, 0, (4, 40, 100, 1)),        # 25 float4 a row: 16 a thread leaves 369 blocks, so 4 (40 rows)
    (101, 4, 0, (1, 20, 101, 2)),        # a row length that is not a multiple of 4: scalar, 8 a thread
    (100, 4, 4, (1, 20, 100, 2)),        # a pointer 4 bytes off: scalar
    (1_024, 4, 0, (4, 16, 1_024, 1)),    # one column tile of 4096 bytes; 3750 blocks at 16 a thread
    (1_025, 4, 0, (1, 2, 1_024, 2)),     # two column tiles, scalar
    (2_048, 4, 0, (4, 16, 1_024, 1)),
    (4, 4, 0, (4, 1_024, 4, 1)),         # one vector a row
    (1, 4, 0, (1, 2_048, 1, 2)),
    (100, 8, 0, (2, 20, 100, 1)),
    (101, 8, 8, (1, 20, 101, 2)),
    (512, 8, 0, (2, 16, 512, 1)),
    (513, 8, 0, (1, 4, 512, 2)),
    (10_000, 4, 0, (4, 16, 1_024, 1)),   # the atlas block's rows: 10 column tiles
    (10_000, 8, 0, (2, 16, 512, 1)),
])
def test_vst_plan_edges(N, itemsize, offset, want):
    """16-byte accesses where the row length is a multiple of 16 / itemsize
    and every pointer is 16-byte aligned, one in flight a thread (two for
    single elements); a column tile of at most 4096 bytes, a whole number
    of vectors; 16 vectors a thread where that leaves two waves of blocks
    (2 x 8 x 132), else 4 (single elements 8); the launcher's multiply-high
    split of a tile index exact (rows x vectors-a-row^2 < 2^32)."""
    plan = vs._vst_plan(60_000, N, itemsize, 1 << 20, (1 << 21) + offset)
    assert tuple(plan) == want and plan.items in vs.VST_ITEMS_BUILT
    vt = plan.cols // plan.vec
    assert plan.cols % plan.vec == 0 and plan.cols * itemsize <= vs._VST_TILE_BYTES
    assert plan.rows * vt <= vs._VST_THREADS * 16 or plan.rows == 1
    assert plan.rows * vt * vt < 2**32
    assert vs._vst_plan(3, N, itemsize, 0).rows <= 3  # a short gene list: no empty rows


def test_vst_plan_wave_rule():
    """Ten times the genes at 100 samples leave two waves of blocks at 16
    vectors a thread; a card of fewer SMs takes them at fewer genes."""
    assert vs._vst_plan(600_000, 100, 4, 0).rows == 163
    assert vs._vst_plan(60_000, 100, 4, 0, sms=20).rows == 163
    assert vs._vst_plan(60_000, 100, 4, 0, sms=132).rows == 40


def test_vst_wrapper_makes_one_launch_on_the_bool_operands(monkeypatch):
    """``_vst_cuda`` launches once with the plan appended, handing the
    launcher the bool mask's and flag's own pointers (no conversion), one
    value per argtype; the mean form passes no coefficients or flag; a mask
    that is not bool is refused."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, args, device: calls.append((name, args)))
    monkeypatch.setattr(kernels, "check_cuda_operands", lambda *a: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    G, N = 7, 100
    counts = torch.ones(G, N)
    sf, coeffs, disp = torch.ones(N), torch.tensor([0.05, 2.0]), torch.tensor(0.1)
    mask, flag = torch.ones(G, dtype=torch.bool), torch.tensor(False)
    vs._vst_cuda(counts, sf, coeffs, flag, disp, mask, False)
    vs._vst_cuda(counts, sf, None, None, disp, mask, True)
    assert [c[0] for c in calls] == ["vst", "vst"]
    want = kernels._ARGTYPES["vst_launch"]
    kinds = {ctypes.c_int: int, ctypes.c_double: float}
    for mean_only, (_, args) in enumerate(calls):
        assert len(args) == len(want)
        for a, w in zip(args, want):
            if w is ctypes.c_void_p:
                assert a is None or (isinstance(a, int) and not isinstance(a, bool))
            else:
                assert isinstance(a, kinds[w]) and not isinstance(a, bool)
        assert args[9] == mask.data_ptr() and args[3] == mean_only
        assert args[7] == (None if mean_only else flag.data_ptr())
        assert args[-4:] == list(vs._vst_plan(G, N, 4, counts.data_ptr(), counts.data_ptr()))
    with pytest.raises(TypeError, match="bool"):
        vs._vst_cuda(counts, sf, coeffs, flag, disp, mask.to(torch.uint8), False)


# -- the fine scan's grouping ---------------------------------------------------

def _centres(name: str, seed: int, G: int = 500) -> torch.Tensor:
    """G centres: points of the 32-point grid formed in the working type as
    alpha_mle_batch forms it, la_init, the grid's ends clipped past, values
    one unit off a grid point, and NaN."""
    tdt, ndt, _ = DTYPES[name]
    rng = np.random.default_rng(seed)
    grid = ndt(LO) + np.arange(K).astype(ndt) * ndt(STEP)
    c = grid[rng.integers(0, K, G)]
    kind = rng.integers(0, 8, G)
    c = np.where(kind == 0, ndt((LO + HI) / 2), c)
    c = np.where(kind == 1, np.nextafter(c, ndt(np.inf)), c)
    c = np.where(kind == 2, ndt(HI + 0.3), c)
    c = np.where(kind == 3, ndt(LO - 0.3), c)
    c[::97] = np.nan
    return torch.as_tensor(c.astype(ndt))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["f32", "f64"])
def test_fine_keys_and_order_match_numpy(name, seed):
    """The plain key is the centre's index on the grid where the centre
    equals a grid point (numpy's lookup), else the one extra bucket; the
    order is numpy's stable argsort of the keys and the counts their
    bincount."""
    c = _centres(name, seed)
    ndt = DTYPES[name][1]
    grid = ndt(LO) + np.arange(K).astype(ndt) * ndt(STEP)
    cn = c.numpy()
    hit = cn[:, None] == grid[None, :]
    want = np.where(hit.any(1), hit.argmax(1), K)
    n_grid = dsp._fine_buckets(LO, HI, STEP)
    assert n_grid == K
    keys = dsp._fine_keys_plain(c, LO, STEP, n_grid)
    np.testing.assert_array_equal(keys.numpy(), want)
    order, counts = dsp._fine_order_plain(c, LO, STEP, n_grid)
    assert order.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.argsort(want, kind="stable"))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(want, minlength=K + 1))
    assert counts[-1] >= (cn != cn).sum() and counts[:K].sum() > len(cn) // 4


def test_fine_buckets_cap():
    """The grid's points from its bounds and step; a step far below the
    coarse one is capped at the kernel's shared-memory buckets."""
    assert dsp._fine_buckets(LO, HI, (HI - LO) / 59) == 60
    assert dsp._fine_buckets(LO, HI, 1e-6) == dsp._FINE_MAX_BUCKETS


@pytest.fixture(scope="module")
def fine_inputs():
    """test_torch_dispersion_fine.py's draw: 256 genes x 30 samples with
    their linear-mu dispersion inputs, one all-zero gene (lane 3)."""
    rng = np.random.default_rng(1)
    G, N = 256, 30
    base = rng.lognormal(3.0, 1.5, size=G)
    cond = rng.integers(0, 2, N)
    X = np.column_stack([np.ones(N), cond]).astype(float)
    mu = base[:, None] * np.exp(cond[None, :] * rng.normal(0, 0.5, size=(G, 1)))
    disp = np.clip(rng.lognormal(-2.0, 1.0, size=G), 1e-3, 5.0)
    counts = rng.negative_binomial(1 / disp[:, None], 1 / (1 + disp[:, None] * mu)).astype(float)
    counts[3] = 0.0
    sf = np.exp(rng.normal(0, 0.2, N))
    mu = np.maximum(np.asarray(j_lin.fit_lin_mu_batch(jnp.asarray(counts), jnp.asarray(sf), jnp.asarray(X))), 0.5)
    return counts, X, mu, disp


def _scan_args(fine_inputs, name, perm=None):
    tdt = DTYPES[name][0]
    counts, X, mu, _ = (torch.as_tensor(v, dtype=tdt) for v in fine_inputs)
    if perm is not None:
        counts, mu = counts[perm], mu[perm]
    la_grid = torch.tensor(LO, dtype=tdt) + torch.arange(K, dtype=tdt) * torch.tensor(STEP, dtype=tdt)
    la_hat = torch.zeros(counts.shape[0], dtype=tdt)
    pdv = torch.tensor(1.0, dtype=tdt)
    la1, _ = dsp.scan_coarse(counts, mu, X, la_grid, *dsp._scan_branches(K, STEP, LO), (LO + HI) / 2, True, False,
                             la_hat, pdv)
    return (counts, mu, X, la1, STEP, 8, LO, HI, True, False, la_hat, pdv)


@pytest.mark.parametrize("name", ["f32", "f64"])
def test_scan_grid_in_any_gene_order(fine_inputs, name):
    """Each gene's fine-scan result is its own: on the genes taken in the
    grouping's order (and reversed), scan_grid gives the unpermuted
    result's values bit for bit; the grouping keeps the tile count, so the
    scan kernel's segments are the gene order's."""
    args = _scan_args(fine_inputs, name)
    want = dsp.scan_grid(*args)
    order = dsp._fine_order_plain(args[3], LO, STEP, dsp._fine_buckets(LO, HI, STEP))[0].long()
    assert torch.unique(args[3]).numel() > 3  # the draw's centres fill several buckets
    for perm in (order, order.flip(0)):
        got = dsp.scan_grid(*_scan_args(fine_inputs, name, perm))
        assert torch.equal(got.view(torch.uint8), want[perm].view(torch.uint8))
    G, N = args[0].shape
    assert dsp._scan_segments(G, N, 132) == dsp._scan_segments(order.numel(), N, 132)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_grouped_fine_scan_matches_jax(fine_inputs, name):
    """alpha_mle_batch(fine_length=8, newton_iters=0) (alpha = exp of the
    fine scan's argmin) on the genes in the grouping's order, against the
    JAX package on the same order, on test_alpha_mle_fine_scan_matches_jax's
    draw with its tolerances: the same point on every lane in f64 (1e-12, exp of one la
    in two libraries), 99% of lanes in f32 (near ties)."""
    tdt, ndt, jdt = DTYPES[name]
    center = _scan_args(fine_inputs, name)[3]
    order = dsp._fine_order_plain(center, LO, STEP, dsp._fine_buckets(LO, HI, STEP))[0].numpy()
    counts, X, mu, disp = fine_inputs
    ops = (counts[order], X, mu[order], disp[order])
    kw = dict(fine_length=8, newton_iters=0)
    a_j, _ = j_disp.alpha_mle_batch(*(jnp.asarray(np.asarray(v, ndt)) for v in ops), 1e-8, 30.0, **kw)
    a_t, _ = dsp.alpha_mle_batch(*(torch.as_tensor(np.asarray(v, ndt)) for v in ops), 1e-8, 30.0, **kw)
    share = np.mean(np.isclose(a_t.numpy(), np.asarray(a_j), rtol=1e-12 if name == "f64" else 1e-6, atol=0))
    assert share >= (1.0 if name == "f64" else 0.99), share


def test_scan_grid_makes_two_launches_and_no_host_read(monkeypatch):
    """The CUDA path of scan_grid: the grouping then the scan, sized from G
    and the point count alone: two launches, the scan handed the grouping's
    order and the coarse scan's segments, no value of a tensor read on the
    host (a counting stub on every way one reaches Python)."""
    calls = []

    def record(name, args, device):
        calls.append((name, list(args)))

    monkeypatch.setattr(kernels, "launch", record)
    monkeypatch.setattr(kernels, "check_cuda_operands", lambda *a: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    G, N = 4_000, 100
    counts = torch.ones(G, N)
    X = torch.ones(N, 2)
    center = torch.full((G,), -2.0)
    la_hat, pdv = torch.zeros(G), torch.tensor(1.0)
    reads = []
    for attr in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy", "cpu"):
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, _attr=attr, **k):
            reads.append(_attr)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, attr, counted)
    dsp._scan_grid_cuda(counts, counts, X, center, STEP, 8, LO, HI, True, False, la_hat, pdv)
    assert reads == []
    (g_name, g_args), (s_name, s_args) = calls
    assert (g_name, s_name) == ("disp_scan_group", "disp_scan_fine")
    for name, args in calls:
        want = kernels._ARGTYPES[kernels.KERNELS[name][1]]
        assert len(args) == len(want), name
        for a, w in zip(args, want):
            if w is ctypes.c_void_p:
                assert a is None or (isinstance(a, int) and not isinstance(a, bool)), (name, a)
            else:
                assert isinstance(a, {ctypes.c_int: int, ctypes.c_double: float}[w]) and not isinstance(a, bool)
    assert g_args[1:6] == [G, center.data_ptr(), LO, STEP, K]
    assert s_args[13] == g_args[6]  # the scan reads the grouping's order
    assert s_args[18] == dsp._scan_segments(G, N, 132) == 3  # 125 tiles: the coarse scan's 3 segments


# -- kernel_bench's suites and chip_smoke's checks, rehearsed on the CPU --------

def _on_cpu(monkeypatch):
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
    monkeypatch.setattr(kernel_bench, "device_ms", lambda fn, reps, name: (host_ms(fn, reps),) * 2)
    monkeypatch.setattr(vs, "_vst_cuda", lambda *a, plan=None: vs._vst_plain(*a))
    monkeypatch.setattr(nb, "_dnb_nll_cuda", _dnb_stand_in)


def _dnb_stand_in(counts, mu, alpha, lanes=None):
    """``_dnb_nll_cuda``'s plain stand-in on the CPU (any plan: the plain sum)."""
    return nb._dnb_nll_plain(counts, mu, torch.as_tensor(alpha, dtype=mu.dtype))


@pytest.mark.parametrize("detail", [False, True])
def test_bench_suites_on_cpu(monkeypatch, detail):
    """``kernel_bench``'s ``vst``, ``fine`` and ``dnb`` suites run one
    tree's child on the CPU at small shapes: every shape gives its row,
    the plain versions agree with themselves, the gene lists are what
    their names say (one centre: no warp with both forms; straddling:
    every warp), and the tree's grouping leaves fewer mixed warps;
    ``--detail`` times ``vst`` with each count of vectors in flight."""
    _on_cpu(monkeypatch)
    monkeypatch.setattr(kernel_bench, "VST_SHAPES", (("f32 12x40", 40, 12, torch.float32, 1),
                                                     ("f64 101x30", 30, 101, torch.float64, 1)))
    monkeypatch.setattr(kernel_bench, "FINE_SHAPES", tuple(
        (f"{kind} P={P}", 256, 20, P, dtype, kind, 1)
        for kind, P, dtype in (("coarse", 2, torch.float32), ("one", 1, torch.float64), ("straddle", 2, torch.float32))))
    monkeypatch.setattr(kernel_bench, "DNB_SHAPES", (("f32 12x50", 50, 12, torch.float32, 1),))
    res = kernel_bench.child(detail, ("vst", "fine", "dnb"))
    assert set(res) == {"ptxas", "vst", "fine", "dnb"} | ({"sass_loops"} if detail else set())
    for row in res["vst"].values():
        for case in ("parametric", "used_mean", "mean", "masked"):
            assert row[f"{case}_err"] == 0.0 and row[f"{case}_repeat_bits_equal"] and row[f"{case}_kernel_ms"] > 0
        assert row["plan"]["vec"] == (4 if row["samples"] == 12 else 1)
        assert any(k.startswith("parametric_kernel_ms items=") for k in row) == detail
    rows = res["fine"]
    assert all(r["same_point_share"] == 1.0 and len(r["best_la_bits"]) == 16 for r in rows.values())
    assert rows["one P=1"]["centres"] == 1 and rows["one P=1"]["mixed_warps_gene_order"] == 0.0
    assert rows["straddle P=2"]["mixed_warps_gene_order"] == 1.0
    assert rows["coarse P=2"]["mixed_warps_tree_order"] < rows["coarse P=2"]["mixed_warps_gene_order"]
    assert res["dnb"]["f32 12x50"]["err"] == 0.0 and res["dnb"]["f32 12x50"]["lanes"] == 4
    assert sorted(k for k in res["dnb"]["f32 12x50"] if k.startswith("kernel_ms lanes=")) == (
        sorted(f"kernel_ms lanes={n}" for n in kernel_bench.DNB_LANES) if detail else [])
    summ = kernel_bench.summary(res)
    assert {k.split()[0] for k in summ} == {"vst", "fine", "dnb"}


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_vst_fine", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEVICE = "cpu"
    return mod


def test_smoke_checks_rehearsed(cs, monkeypatch):
    """``vst_plan_checks``, ``fine_list_checks`` and ``dnb_plan_checks`` run
    through on the CPU at small shapes, the plain versions standing in for
    the kernels (the scan's launch in a given order by the plain scan):
    every plan edge and gene list is visited, the la_init list keeps its
    centres, and every dnb_nll plan runs at every row length."""
    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(vs, "_vst_cuda", lambda *a, plan=None: vs._vst_plain(*a))
    monkeypatch.setattr(dsp, "_fine_order_cuda", dsp._fine_order_plain)

    def scan_in_order(name, counts, mu, X, grid_args, K_, cr_reg, prior_reg, la_hat, pdv, coarse):
        center, hw, _, lo_f, hi_f, length, order = grid_args
        return dsp.scan_grid_plain(counts, mu, X, center, hw, length, lo_f, hi_f, cr_reg, prior_reg, la_hat, pdv)

    monkeypatch.setattr(dsp, "_scan_launch", scan_in_order)
    monkeypatch.setattr(cs, "VST_PLAN_CELLS", 3_000)
    monkeypatch.setattr(cs, "G_ATLAS_BLOCK", 3)
    monkeypatch.setattr(cs, "FINE_LIST_SHAPES", ((torch.float32, 320, 2), (torch.float64, 96, 5)))
    monkeypatch.setattr(cs, "N_MAIN", 24)
    plans = cs.vst_plan_checks()
    assert len(plans) == 2 * (7 + 2)
    assert {p["vec"] for p in plans.values()} == {1, 2, 4}
    assert any(p["cols"] < int(label.split(" x ")[1].split()[0]) for label, p in plans.items())
    buckets = cs.fine_list_checks()
    assert len(buckets) == 2 * len(cs.FINE_LISTS)
    for label, b in buckets.items():
        assert sum(b) == int(label.split()[1])  # every gene in one bucket
        if label.endswith("one"):
            assert sum(1 for x in b if x) == 1
    monkeypatch.setattr(nb, "_dnb_nll_cuda", _dnb_stand_in)
    monkeypatch.setattr(cs, "DNB_PLAN_CELLS", 600)
    monkeypatch.setattr(cs, "DNB_PLAN_N", (1, 24, 65, 129, 2_048))
    plans = cs.dnb_plan_checks()
    assert len(plans) == 2 * len(cs.DNB_PLAN_N) * len(kernel_bench.DNB_LANES)
    assert sum(label.endswith("(picked)") for label in plans) == 2 * len(cs.DNB_PLAN_N)
