"""``pydeseq2_tpu_torch.kernel_bench`` on the CPU: its report of registers
and spills, and one tree's run of each suite at small shapes with the plain
versions standing in for the kernels (the kernels themselves need a card)."""

import time

import pytest
import torch

from pydeseq2_tpu_torch import kernel_bench, kernels
from pydeseq2_tpu_torch.ops import sizefactors as sz
from pydeseq2_tpu_torch.ops import trend as tr

torch.set_num_threads(1)  # xdist runs several workers on a few cores

PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116disp_scan_kernelILi2EdEEviiPKT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116disp_scan_kernelILi2EdEEviiPKT0_
    72 bytes stack frame, 132 bytes spill stores, 160 bytes spill loads
ptxas info    : Used 64 registers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116disp_scan_kernelILi1EfEEviiPKT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116disp_scan_kernelILi1EfEEviiPKT0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 560 bytes cmem[0]
ptxas info    : Compiling entry function 'psi_f64_launch_helper' for 'sm_90a'
ptxas info    : Used 30 registers, 380 bytes cmem[0]
"""

# The cluster kernels' entries as nvcc names them (template on type and mode).
PTXAS_CLUSTER = """ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a3ea3f43_14_sizefactors_cu_cbb62a4d16sf_newton_kernelIfLb1EEEvNS_6SfArgsIT_EE' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__9c8daaa2_8_trend_cu_10f1c39d12trend_kernelIdLb0EEEviiiPKT_S3_PKhS3_PhPS1_S7_S6_Pi' for 'sm_90a'
    32 bytes stack frame, 40 bytes spill stores, 116 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a3ea3f43_14_sizefactors_cu_cbb62a4d13sf_nll_kernelIfEEviiPKT_S3_S3_S3_S3_S3_PKhS1_PS1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 35 registers, used 0 barriers
"""


def test_ptxas_rows_per_instantiation(tmp_path, monkeypatch):
    """Registers and spill bytes by template P and type; entries that are
    not an instantiation of a P template are left out."""
    monkeypatch.setattr(kernels, "_lib_path", lambda src: tmp_path / (src + ".so"))
    for src in kernel_bench.SOURCES:
        (tmp_path / (src + ".ptxas.txt")).write_text(PTXAS)
    got = kernel_bench.ptxas(kernels)
    assert got == {src: {"P2 f64": [64, 132, 160], "P1 f32": [40, 0, 0]} for src in kernel_bench.SOURCES}


PTXAS_NEWTON = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118disp_newton_kernelILi2EfLb0EEEviiiiimPKiPKT0_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118disp_newton_kernelILi2EfLb1EEEviiiiimPKiPKT0_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, 560 bytes cmem[0]
"""


def test_ptxas_rows_of_the_newton_split(tmp_path, monkeypatch):
    """``disp_newton``'s unsplit instantiation keeps its key by P and type;
    the one that splits a gene's row over warps adds ``split``."""
    monkeypatch.setattr(kernels, "_lib_path", lambda src: tmp_path / (src + ".so"))
    (tmp_path / "disp_newton.cu.ptxas.txt").write_text(PTXAS_NEWTON)
    got = kernel_bench.ptxas(kernels, ("disp_newton.cu",))
    assert got == {"disp_newton.cu": {"P2 f32": [72, 0, 0], "P2 f32 split": [80, 0, 0]}}


def test_ptxas_rows_of_cluster_kernels(tmp_path, monkeypatch):
    """A cluster kernel's rows are keyed by kernel, type and mode; a kernel
    templated on its type alone by kernel and type."""
    monkeypatch.setattr(kernels, "_lib_path", lambda src: tmp_path / (src + ".so"))
    (tmp_path / "sizefactors.cu.ptxas.txt").write_text(PTXAS_CLUSTER)
    got = kernel_bench.ptxas(kernels, ("sizefactors.cu",))
    assert got == {"sizefactors.cu": {"sf_newton_kernel f32 shared": [64, 4, 4],
                                      "trend_kernel f64 streamed": [64, 40, 116],
                                      "sf_nll_kernel f32": [35, 0, 0]}}


def _on_cpu(monkeypatch):
    """Run a child on the CPU: no build, host timers for the events and the
    profiler, the plain versions for the kernels (any plan)."""
    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    monkeypatch.setattr(kernels, "build", lambda: {})
    monkeypatch.setattr(kernel_bench, "ptxas", lambda k, sources=(): {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(kernel_bench, "cuda_ms", host_ms)
    monkeypatch.setattr(kernel_bench, "device_ms", lambda fn, reps, name: (host_ms(fn, reps),) * 2)


@pytest.mark.parametrize("detail", [False, True])
def test_child_on_cpu(monkeypatch, detail):
    """One tree's run: every shape has its times, and on the CPU (where the
    wrappers run the plain versions) no difference from them; ``--detail``
    adds the one-segment scan on long rows and the Newton divergence
    readings, and on long rows the Newton launch at each split of a gene's
    row over warps with the plan named."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    _on_cpu(monkeypatch)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(dsp, "_newton_card_per_sm", lambda device, itemsize, P, N, wg: dsp._NEWTON_PER_SM)
    monkeypatch.setattr(dsp, "_newton_polish_cuda", lambda *args, plan=None: dsp.newton_polish_plain(*args))
    monkeypatch.setattr(kernel_bench, "SHAPES", (
        ("f32 P=3", 64, 24, 3, torch.float32, 1),
        ("f64 long P=1", 8, 1100, 1, torch.float64, 1),
    ))
    res = kernel_bench.child(detail)
    assert set(res["shapes"]) == {"f32 P=3", "f64 long P=1"}
    for label, row in res["shapes"].items():
        assert row["disp_scan_ms"] > 0 and row["disp_newton_ms"] > 0
        for key in ("scan_la_err", "scan_f_err", "newton_la_err", "newton_f_err"):
            assert row[key] == 0.0, (label, key)
        assert ("disp_newton_branch_sorted_ms" in row) == detail
        assert ("disp_scan_one_segment_ms" in row) == (detail and label.startswith("f64 long"))
        if detail:
            assert 0.0 <= row["mixed_warps_wrapper_order"] <= 1.0
        long_detail = detail and label.startswith("f64 long")
        assert ("disp_newton_split" in row) == ("disp_newton_plan" in row) == long_detail
        if long_detail:
            assert row["disp_newton_plan"] == 1  # 1100 samples: too few to split
            assert sorted(row["disp_newton_split"]) == list(dsp._NEWTON_WARPS)
            for reading in row["disp_newton_split"].values():
                assert reading["device_ms"] > 0 and reading["per_sm"] == dsp._NEWTON_PER_SM
                assert reading["la_err"] == reading["la_gap_unsplit"] == 0.0
                assert reading["genes_not_bit_equal_unsplit"] == 0


@pytest.mark.parametrize("detail", [False, True])
def test_sf_and_trend_child_on_cpu(monkeypatch, detail):
    """The ``sf`` and ``trend`` suites of one tree's run at small shapes:
    times, no difference from the plain versions, the plans picked, the
    plain fit's passes, ``sf_nll`` on the draw and on its zero-heavy copy,
    ``lgamma_table`` beside ``torch.lgamma`` in both types; ``--detail`` the
    other modes, cluster sizes and lane counts."""
    _on_cpu(monkeypatch)
    monkeypatch.setattr(sz, "_lgamma_table_cuda", sz._lgamma_table_plain)
    plans = {}
    monkeypatch.setattr(sz, "_sf_newton_cuda",
                        lambda *a, plan=None: plans.setdefault("sf", []).append(plan) or sz._sf_newton_plain(*a))
    monkeypatch.setattr(sz, "_sf_nll_cuda",
                        lambda *a, plan=None: plans.setdefault("nll", []).append(plan) or sz._sf_nll_plain(*a))
    monkeypatch.setattr(tr, "_trend_fit_cuda",
                        lambda *a, plan=None: plans.setdefault("fit", []).append(plan) or tr._trend_fit_plain(*a))
    monkeypatch.setattr(tr, "_parametric_trend_cuda",
                        lambda *a, plan=None: plans.setdefault("trend", []).append(plan)
                        or tr._parametric_trend_plain(*a))
    monkeypatch.setattr(kernel_bench, "SF_SHAPES", (("f32 12x300", 300, 12, torch.float32, 1),
                                                    ("f64 3x70", 70, 3, torch.float64, 1)))
    monkeypatch.setattr(kernel_bench, "TREND_SHAPES", (("f32 300", 300, torch.float32, 1),
                                                       ("f64 3000", 3_000, torch.float64, 1)))
    res = kernel_bench.child(detail, ("sf", "trend"))
    assert "shapes" not in res and set(res) == {"ptxas", "sf", "trend"} | ({"sass_loops"} if detail else set())
    assert set(res["sf"]) == {"f32 12x300", "f64 3x70", "lgamma_table f32", "lgamma_table f64"}
    for dtype in ("f32", "f64"):
        row = res["sf"].pop(f"lgamma_table {dtype}")
        assert row["max_abs_diff"] == 0.0 and row["lgamma_table_kernel_ms"] > 0 and row["torch_lgamma_kernel_ms"] > 0
        assert row["lgamma_table_ms"] > 0 and row["torch_lgamma_ms"] > 0
    for row in res["sf"].values():
        assert row["sf_newton_ms"] > 0 and row["sf_newton_kernel_ms"] > 0 and row["err"] == 0.0
        assert row["plan"]["K"] >= 1
        assert any(k.startswith("kernel_ms streamed") for k in row) == detail
    assert res["sf"]["f64 3x70"]["plan"] == {"C": 4, "K": 2, "shared": True, "max_clusters": 0}
    for label, row in res["sf"].items():
        for draw in ("sf_nll", "sf_nll zero_heavy"):
            nll = row[draw]
            assert nll["sf_nll_ms"] > 0 and nll["rel_err"] == 0.0 and nll["bit_equal_share"] == 1.0, (label, draw)
            N = int(label.split("x")[0].split()[-1])
            assert nll["plan"] == sz._nll_plan(N, 4 if "f32" in label else 8)._asdict()
            assert any(k.startswith("kernel_ms lanes=") for k in nll) == detail
        assert row["sf_nll zero_heavy"]["zero_share"] > 0.5 > row["sf_nll"]["zero_share"]
    for label, row in res["trend"].items():
        assert row["trend_ms"] > 0 and row["trend_fit_ms"] > 0
        assert row["trend_fit_coef_err"] == 0.0 and row["trend_coef_err"] == 0.0
        assert row["fit_passes"][0] >= 1 and row["fit_passes"][1] >= 1
        assert row["trend_passes"][0] >= row["fit_passes"][0]
        assert all((f"K={K} {mode}" in row) == detail for K in (1, 2, 4, 8, 16) for mode in ("shared", "streamed"))
    assert res["trend"]["f64 3000"]["plan"] == {"K": 8, "shared": True}
    if detail:
        assert any(p is not None and not p.shared for p in plans["sf"])
        assert {p.K for p in plans["fit"] if p is not None} == {1, 2, 4, 8, 16}


@pytest.mark.parametrize("detail", [False, True])
def test_cooks_child_on_cpu(monkeypatch, detail):
    """The ``cooks`` suite of one tree's run at small shapes: times beside
    the sort yardstick, no difference from the plain versions, the plans
    picked; ``--detail`` the other plans and the rank-count sweep."""
    from pydeseq2_tpu_torch.ops import cooks as ck
    from pydeseq2_tpu_torch.ops import stats as st

    _on_cpu(monkeypatch)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    plans = []

    def plain_cooks(*a, plan=None):
        plans.append(plan)
        return ck._cooks_plain(*a)

    def plain_rows(rows, ks, scales=None, cohorts=None, plan=None):
        plans.append(plan)
        return torch.stack([st._trimmed_mean_plain(r, (ks[0] + 0.5) / rows.shape[1], 0) for r in rows])

    monkeypatch.setattr(ck, "_cooks_cuda", plain_cooks)
    monkeypatch.setattr(st, "_trimmed_rows_cuda", plain_rows)
    monkeypatch.setattr(st, "_trimmed_cell_variance_cuda",
                        lambda x, cells, plan=None: plans.append(plan) or st._trimmed_cell_variance_plain(x, cells))
    monkeypatch.setattr(kernel_bench, "COOKS_SHAPES", (("f32 100x300", 300, 100, torch.float32, False, 1),
                                                       ("f32 400x50 refit", 50, 400, torch.float32, True, 1)))
    monkeypatch.setattr(kernel_bench, "TRIM_SHAPES", (("f64 cohorts 300x100", 300, 100, torch.float64, 1),
                                                      ("f32 column 3000", 3_000, 0, torch.float32, 1)))
    monkeypatch.setattr(kernel_bench, "RANK_SWEEP", (8,))
    monkeypatch.setattr(kernel_bench, "RANK_SWEEP_GENES", 20)
    res = kernel_bench.child(detail, ("cooks",))
    assert set(res) == {"ptxas", "cooks", "trimmed_var"} | ({"sass_loops"} if detail else set())
    shapes = {"f32 100x300", "f32 400x50 refit"}
    assert set(res["cooks"]) == shapes | ({"rank sweep f32 cohorts of 8", "rank sweep f64 cohorts of 8"} if detail
                                          else set())
    for label in shapes:
        row = res["cooks"][label]
        assert row["cooks_ms"] > 0 and row["sort_ms"] > 0 and row["disp_rel_err"] == 0.0
        assert row.get("bits_equal", True) and row.get("cooks_rel_err", 0.0) == 0.0
        assert any(k.startswith("kernel_ms") for k in row) == detail
    assert res["cooks"]["f32 100x300"]["plan"] == st._trim_plan(4, [50, 50], 300, True)._asdict()
    for label, row in res["trimmed_var"].items():
        assert row["trimmed_var_ms"] > 0 and row["sort_ms"] > 0 and row["rel_err"] == 0.0, label
    assert res["trimmed_var"]["f32 column 3000"]["plan"] == {"block": True, "threads": 1024, "rank_max": 96,
                                                              "shared": True, "blocks": 0}
    assert any(p is not None for p in plans) == detail


def test_zero_heavy_draw():
    """More than half the cells zero, a count at or above the lgamma
    table's bound in every 100th gene, gene 1 non-integer."""
    counts = torch.full((250, 40), 7.0, dtype=torch.float64)
    z = kernel_bench.zero_heavy(counts)
    assert (z == 0).double().mean() > 0.5
    assert bool((z[::100] >= sz.LGAMMA_TABLE_LEN).any(1).all())
    assert bool((z[1] != torch.round(z[1])).all())
    assert torch.equal(counts, torch.full((250, 40), 7.0, dtype=torch.float64))  # a copy


@pytest.mark.parametrize("detail", [False, True])
def test_grid_child_on_cpu(monkeypatch, detail):
    """The ``grid`` suite of one tree's run at small shapes: the weak tile
    (at the draw's width, where no lane fails Newton at 40 genes, it says
    so; with ``--detail`` a small stand-in tile, every lane then half),
    each shape's times, every lane at the plain version's point, the plan;
    ``--detail`` every cluster size. Then ``grid_nb`` on the rescue tile
    (none at 40 genes; with ``--detail`` a stand-in call with a selection
    and its count) and on its shapes: times, every selected lane at the
    plain version's point, the plan of the selected count; ``--detail``
    every cluster size."""
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.ops import shrink as sh

    _on_cpu(monkeypatch)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    plans = []

    def plain_grid(*a, plan=None):
        plans.append(plan)
        sel = a[11] if len(a) > 11 else None
        out = sh._grid_shrink_plain(*a[:11])
        return out if sel is None else torch.where(sel[:, None], out, torch.full_like(out, float("nan")))

    monkeypatch.setattr(sh, "_grid_shrink_cuda", plain_grid)
    monkeypatch.setattr(kernel_bench, "WEAK_G", 40)
    monkeypatch.setattr(kernel_bench, "RESCUE_G", 40)
    nb_plans = []

    def plain_nb(*a, plan=None):
        nb_plans.append(plan)
        sel = a[8] if len(a) > 8 else None
        out = irl._grid_fit_beta_plain(*a[:8])
        return out if sel is None else torch.where(sel[:, None], out, torch.full_like(out, float("nan")))

    monkeypatch.setattr(irl, "_grid_fit_beta_cuda", plain_nb)
    monkeypatch.setattr(kernel_bench, "GRID_NB_SHAPES", (("f32 5 lanes x 30", 5, 30, torch.float32, 1),))
    if detail:
        tile = kernel_bench.grid_operands(6, 50, torch.float32, "indicator")
        monkeypatch.setattr(kernel_bench, "weak_tile", lambda: (tile, torch.arange(6) % 2 == 0))
        nb = kernel_bench.nb_grid(tile)
        monkeypatch.setattr(kernel_bench, "rescue_tile", lambda: (nb, {"min_mu": 0.5, "sel": torch.arange(6) < 1,
                                                                       "n_sel": 1}))
    # grid_fit_beta_batch on CPU tensors runs the plain version: route it
    # through the stand-in as a CUDA tensor would the kernel
    monkeypatch.setattr(irl, "grid_fit_beta_batch", lambda *a, sel=None, n_sel=None, min_mu=0.5: plain_nb(
        *a, min_mu, 60, -30.0, 30.0, sel, n_sel))
    monkeypatch.setattr(kernel_bench, "GRID_SHAPES", (("f32 3 lanes x 300", 3, 300, torch.float32, "indicator", 1),
                                                      ("f64 20 x 40", 20, 40, torch.float64, "continuous", 1)))
    monkeypatch.setattr(kernel_bench, "GRID_DETAIL_SHAPES", (("f32 9 lanes x 30", 9, 30, torch.float32, "indicator",
                                                              1),))
    # the card's occupancy is not asked here: the plan's register default
    monkeypatch.setattr(sh, "_grid_device_plan", lambda lanes, N, L, dtype, device, kernel="grid_apeglm":
                        sh._grid_plan(lanes, N, L, torch.empty((), dtype=dtype).element_size(), kernel=kernel))
    res = kernel_bench.child(detail, ("grid",))
    assert set(res) == {"ptxas", "grid"} | ({"sass_loops"} if detail else set())
    rows = res["grid"]
    assert {"f32 3 lanes x 300", "f64 20 x 40"} <= set(rows)
    assert ("f32 9 lanes x 30" in rows) == detail
    if detail:
        assert rows["f32 weak tile, every lane"]["lanes"] == 6
        assert rows["f32 weak tile, the pipeline's selection"]["lanes"] == 3
        assert rows["f32 weak tile, the pipeline's selection"]["same_point_share"] == 1.0
    else:
        assert rows["weak tile"] == "no lane failed Newton"
    for label in ("f32 3 lanes x 300", "f64 20 x 40"):
        row = rows[label]
        assert row["grid_apeglm_ms"] > 0 and row["same_point_share"] == 1.0
        assert sum(k.startswith("kernel_ms K=") for k in row) == (4 if detail else 0)
    assert rows["f32 3 lanes x 300"]["plan"] == {"K": 16, "chunk": 512}
    assert any(p is not None for p in plans) == detail
    nb = rows["grid_nb"]
    assert set(nb) == ({"f32 rescue tile, the pipeline's selection", "f32 rescue tile, every lane"} if detail
                       else {"rescue tile"}) | {"f32 5 lanes x 30"}
    for label, row in nb.items():
        if isinstance(row, dict):
            assert row["grid_nb_ms"] > 0 and row["grid_nb_kernel_ms"] > 0 and row["same_point_share"] == 1.0, label
            assert row["plan"]["K"] == 16 and sum(k.startswith("kernel_ms K=") for k in row) == (4 if detail else 0)
    assert nb["f32 5 lanes x 30"]["lanes"] == 5
    if detail:
        assert nb["f32 rescue tile, the pipeline's selection"]["lanes"] == 1
        assert nb["f32 rescue tile, every lane"]["lanes"] == 6
    else:
        assert nb["rescue tile"] == "no lane reached the grid"
    assert any(p is not None for p in nb_plans) == detail


@pytest.mark.parametrize("detail", [False, True])
def test_shrink_child_on_cpu(monkeypatch, detail):
    """The ``shrink`` suite of one tree's run at small shapes: times, the
    digest of the coefficients' bits, the steps, the passes the JAX order
    needs, the evaluations and reads of the row; ``--detail`` the other
    round sizes."""
    from pydeseq2_tpu_torch.ops import shrink as sh

    _on_cpu(monkeypatch)
    rounds = []

    def plain_fit(*fit, cands=None):
        rounds.append(cands)
        beta, ih, conv = sh._nbinom_glm_plain(*fit)
        steps = torch.full((beta.shape[0],), 3, dtype=torch.int32)
        return beta, ih, conv, steps, steps * 9, steps * (9 if cands == 1 else 11), steps * (9 if cands == 1 else 4)

    monkeypatch.setattr(sh, "_nbinom_glm_cuda", plain_fit)
    monkeypatch.setattr(kernel_bench, "SHRINK_SHAPES", (("f32 12x40", 40, 12, torch.float32, 1),
                                                        ("f64 8x30", 30, 8, torch.float64, 1)))
    res = kernel_bench.child(detail, ("shrink",))
    assert set(res) == {"ptxas", "shrink"} | ({"sass_loops"} if detail else set())
    for label, row in res["shrink"].items():
        G = 40 if "f32" in label else 30
        assert row["shrink_ms"] > 0 and row["shrink_kernel_ms"] > 0 and len(row["beta_bits"]) == 16
        assert row["steps_mean"] == 3.0 and row["passes"] == 27 * G and row["evaluations"] == 33 * G
        assert row["rounds"] == 12 * G and row["round"] == (3 if "f32" in label else 1)
        assert sorted(k for k in row if k.startswith("kernel_ms round=")) == (
            [f"kernel_ms round={1 if 'f32' in label else 3}"] if detail else [])
    assert {m for m in rounds if m is not None} == ({1, 3} if detail else set())


def test_shrink_operands_draw(monkeypatch):
    """The suite's fit: the draw's design, one offset a sample, positive
    sizes, the condition's coefficient shrunk."""
    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    X, counts, size, offset, pns, ps, si, maxiter = kernel_bench.shrink_operands(30, 8, torch.float64)
    assert counts.shape == (30, 8) and X.shape == (8, 2) and offset.shape == (8,) and size.shape == (30,)
    assert bool((size > 0).all()) and (pns, ps, si, maxiter) == (15.0, 0.5, 1, 60)


def test_grid_operands_designs(monkeypatch):
    """The suite's designs: the draw's intercept and condition, an
    intercept and a continuous column (no zero), the conditions'
    indicators (a zero in the first column of some rows, one in each)."""
    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    ind = kernel_bench.grid_operands(4, 50, torch.float64, "indicator")[2]
    cont = kernel_bench.grid_operands(4, 50, torch.float64, "continuous")[2]
    zf = kernel_bench.grid_operands(4, 50, torch.float64, "zero-first")[2]
    assert bool((ind[:, 0] == 1).all()) and bool((ind[:, 1] == 0).any())
    assert bool((cont != 0).all())
    assert bool((zf[:, 0] == 0).any()) and bool(((zf[:, 0] == 0) != (zf[:, 1] == 0)).all())


SASS = """
        Function : _Z4termPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0010*/                   FMUL R3, R2, R5 ;                           /* 0x0000000502037220 */
        /*0020*/              @P1 BRA 0x50 ;                                   /* 0x0000000000001947 */
        /*0030*/                   MUFU.EX2 R4, R3 ;                           /* 0x0000000000001947 */
        /*0040*/                   FADD R4, R4, 1 ;                            /* 0x0000000000001947 */
        /*0050*/                   FADD R6, R4, R6 ;                           /* 0x0000000000001947 */
        /*0060*/                   BRA.U !UP0, 0x10 ;                          /* 0x0000000000001947 */
        /*0070*/                   FADD R6, R4, R6 ;                           /* 0x0000000000001947 */
.L_x_1:
        /*0080*/                   FMUL R3, R2, R5 ;                           /* 0x0000000502037220 */
        /*0090*/                   FADD R6, R4, R6 ;                           /* 0x0000000000001947 */
        /*00a0*/              @!P0 BRA `(.L_x_1) ;                             /* 0x0000000000001947 */
        /*00b0*/                   EXIT ;                                      /* 0x0000000000001947 */
        Function : _Z4noneP
        /*0000*/                   EXIT ;                                      /* 0x0000000000001947 */
"""


def test_sass_loops_of_a_listing():
    """A loop's instructions, its shortest and longest trip (the forward
    branch skips two), its MUFU count; branch targets by address and by
    label; a loop without a transcendental and a function without a loop
    report none."""
    assert kernel_bench.sass_functions(SASS) == {
        "_Z4termPf": [{"instructions": 6, "min_path": 4, "max_path": 6, "mufu": 1}], "_Z4noneP": []}


def test_sass_loops_of_every_loop():
    """For a source without transcendentals (select.cu) every loop counts,
    the one with no MUFU instruction too."""
    assert kernel_bench.sass_functions(SASS, mufu_only=False) == {
        "_Z4termPf": [{"instructions": 6, "min_path": 4, "max_path": 6, "mufu": 1},
                      {"instructions": 3, "min_path": 3, "max_path": 3, "mufu": 0}], "_Z4noneP": []}
    assert "select.cu" in kernel_bench.SASS_ALL_LOOPS


def test_sass_loops_without_cuobjdump(monkeypatch):
    monkeypatch.setattr(kernel_bench, "cuobjdump", lambda k: None)
    assert kernel_bench.sass_loops(kernels, ("grid.cu",)) == {}


def test_ptxas_rows_of_round_templates(tmp_path, monkeypatch):
    """A kernel templated on the design width and a round size (``shrink``)
    is keyed by both."""
    monkeypatch.setattr(kernels, "_lib_path", lambda src: tmp_path / (src + ".so"))
    (tmp_path / "shrink.cu.ptxas.txt").write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113shrink_kernelILi2EfLi3EEEviiPKT0_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 64 registers, 560 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113shrink_kernelILi2EdLi1EEEviiPKT0_' for 'sm_90a'\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 80 registers, 560 bytes cmem[0]\n")
    assert kernel_bench.ptxas(kernels, ("shrink.cu",)) == {"shrink.cu": {"P2 f32 M3": [64, 0, 0],
                                                                         "P2 f64 M1": [80, 12, 16]}}


@pytest.mark.parametrize("detail", [False, True])
def test_select_and_irls_child_on_cpu(monkeypatch, detail):
    """The ``select`` and ``irls`` suites of one tree's run at small shapes:
    times beside the sort yardstick, bit-equal to the plain version and to
    a repeated launch, the plans picked; ``irls`` both ways (the wrapper
    alone, ``irls_core`` whole), its agreement with the plain loop and the
    phase-2 tile of a summary run; ``--detail`` the other plans."""
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.ops import select as sel
    from pydeseq2_tpu_torch.ops.nb import nb_nll

    _on_cpu(monkeypatch)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(sel, "_select_k_max", lambda device, itemsize: 16)
    monkeypatch.setattr(irl, "_irls_card_per_sm", lambda device, itemsize, P, lanes: irl._IRLS_PER_SM)
    plans = {"select": [], "irls": []}

    def plain_select(x, ranks, axis, plan=None):
        plans["select"].append(plan)
        return sel.order_stats_select_plain(x, ranks, axis)

    def plain_irls(counts, sf, X, disp, beta_init, log_sf, min_mu, beta_tol, max_beta, maxiter, step_tol,
                   polish_iters, plan=None):
        plans["irls"].append(plan)
        lmm = torch.log(torch.tensor(min_mu, dtype=counts.dtype))
        mu0, lmu0, _ = irl._mu_from_xb(beta_init, X, sf, log_sf[None, :], min_mu, lmm)
        r = 1.0 / disp[:, None]
        const = nb_nll(counts, mu0, disp) - irl._mu_part(counts, counts + r, r, mu0, lmu0)
        beta, fb, it = irl._irls_plain(counts, sf, X, disp, beta_init, const, log_sf[None, :], min_mu, lmm,
                                       beta_tol, max_beta, maxiter, step_tol, polish_iters)
        return beta, fb, torch.full((counts.shape[0],), int(it), dtype=torch.int32)

    monkeypatch.setattr(sel, "_order_stats_select_cuda", plain_select)
    monkeypatch.setattr(irl, "_irls_cuda", plain_irls)
    monkeypatch.setattr(kernel_bench, "SELECT_SHAPES", (("f32 tile 12x300", "tile", 12, 300, torch.float32, 1),
                                                        ("f64 column 500", "column", 1, 500, torch.float64, 1),
                                                        ("f32 keep quantile 400", "quantile", 1, 400, torch.float32,
                                                         1)))
    monkeypatch.setattr(kernel_bench, "IRLS_SHAPES", (("f32 phase 1 12x60 P=3", 60, 12, 3, torch.float32, 8, 1),
                                                      ("f64 phase 1 10x40 P=2", 40, 10, 2, torch.float64, 8, 1)))
    monkeypatch.setattr(kernel_bench, "RESCUE_G", 300)
    res = kernel_bench.child(detail, ("select", "irls"))
    assert set(res) == {"ptxas", "select", "irls"} | ({"sass_loops"} if detail else set())
    for label, row in res["select"].items():
        assert row["bits_equal"] and row["repeat_equal"] and row["select_ms"] > 0 and row["sort_ms"] > 0, label
        assert any(k.startswith("kernel_ms K=") for k in row) == detail
    assert res["select"]["f32 tile 12x300"]["plan"] == sel._select_plan(12, 300, 4)._asdict()
    assert res["select"]["f64 column 500"]["plan"] == {"B": 1, "K": 1, "staged": True}
    irls_labels = {"f32 phase 1 12x60 P=3", "f64 phase 1 10x40 P=2"}
    assert irls_labels <= set(res["irls"]) <= irls_labels | {"f32 phase 2 tile"}
    for label, row in res["irls"].items():
        assert row["close_share"] == 1.0 and row["flags_share"] == 1.0, label
        assert row["max_trips"] == row["plain_trips"] and row["irls_ms"] > 0 and row["irls_core_ms"] > 0
        assert row["plan"] == irl._irls_plan(row["genes"], row["samples"], row["P"])._asdict()
        assert any(k.startswith("kernel_ms lanes=") for k in row) == detail
    assert any(p is not None for p in plans["select"] + plans["irls"]) == detail
    summary = kernel_bench.summary(res)
    assert {f"select {k}" for k in res["select"]} <= set(summary)
