"""The rebuilt ``hat_wald`` and ``lowess`` kernels' plain versions, launch
plans and wrappers against the JAX package, on the CPU.

``csrc/hat_wald.cu`` runs a gene on a lane group sized by the sample count
(``ops/wald.py:_hat_wald_plan``, a function of the shape alone) and, for
the streamed refit, without H and mu buffers (the test alone). Its plain
versions (``hat_diagonals``, ``wald_test_batch``, ``hat_wald`` with and
without ``want_hat``) are held to JAX's ``hat_diagonals`` and
``wald_test_batch`` at the plans' sample counts; the streamed refit gives
the same outputs bit for bit when its call asks for the test alone.
``lowess_pick``'s plain version is held to JAX's ``lowess_device`` and the
cutoff pick at 2, 50 and 64 points with tied distances. The CUDA kernels
are held to these plain versions on the card by ``chip_smoke.py``.
"""

import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydeseq2_tpu.ops import irls as j_irls
from pydeseq2_tpu.ops import stats as j_stats
from pydeseq2_tpu.ops import wald as j_wald
from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops import irls as t_irls
from pydeseq2_tpu_torch.ops import linreg as t_lin
from pydeseq2_tpu_torch.ops import stats as t_stats
from pydeseq2_tpu_torch.ops import wald as t_wald

torch.set_num_threads(1)  # xdist runs several workers on a few cores


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", range(1, 9))
def test_hat_wald_plan_picks(P, itemsize):
    """Lane groups by N at every design width, the lane counts of ``mom``:
    4 lanes to 64 samples, 8 to 128, 32 below 2048, then a block; a row
    stages what its group's share of the block's stage holds (128 / 256 /
    1024 float32 samples a group of 4 / 8 / 32 lanes, 12288 a block; half
    in float64), so every row is whole but past 1024 / 512 samples on 32
    lanes and at atlas widths, and every plan picked is one the kernel is
    built for."""
    plan = t_wald._hat_wald_plan
    f = 4 // itemsize  # 1 in float32, 0 in float64: halves the staged counts
    for N, want in ((1, (4, 1)), (12, (4, 12)), (64, (4, 64)), (65, (8, 65)), (100, (8, 100)), (128, (8, 128)),
                    (129, (32, 129)), (512, (32, 512)), (513, (32, 513 if f else 512)), (1024, (32, 1024 if f else 512)),
                    (1025, (32, 1024 if f else 512)), (2047, (32, 1024 if f else 512)), (2048, (256, 2048)),
                    (10000, (256, 10000 if f else 6144)), (100_000, (256, 12288 if f else 6144))):
        assert plan(N, P, itemsize) == want, N
    for N in range(1, 3000, 7):
        got = plan(N, P, itemsize)
        assert got.lanes == t_lin._mom_plan(N, itemsize).lanes, N
        t_wald._check_plan("hat_wald", got, N, keeps=True)
        t_wald._check_plan("hat_wald", got, N, keeps=False)
    for bad in ((16, 1), (4, 13), (4, -1)):
        with pytest.raises(ValueError):
            t_wald._check_plan("hat_wald", t_wald.HatWaldPlan(*bad), 12, keeps=True)


@pytest.fixture
def recorded(monkeypatch):
    """Launches recorded instead of made, on CPU tensors; any read of the
    card fails."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, args, device: calls.append((name, args)))
    monkeypatch.setattr(kernels, "check_cuda_operands", lambda *a: None)

    def no_card(*a, **k):
        raise AssertionError("the plan read the card")

    monkeypatch.setattr(torch.Tensor, "item", no_card)
    monkeypatch.setattr(torch.Tensor, "tolist", no_card)
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    return calls


def _assert_marshalled(name, args):
    kinds = {ctypes.c_int: int, ctypes.c_double: float, ctypes.c_longlong: int}
    want = kernels._ARGTYPES[kernels.KERNELS[name][1]]
    assert len(args) == len(want), name
    for a, w in zip(args, want):
        if w is ctypes.c_void_p:
            assert a is None or (isinstance(a, int) and not isinstance(a, bool)), (name, a)
        else:
            assert isinstance(a, kinds[w]) and not isinstance(a, bool), (name, a, w)


@pytest.mark.parametrize("N", [12, 100, 1000, 10000])
def test_hat_wald_wrappers_marshal_their_plans(recorded, N):
    """The three entries get the plan of the shape without reading the
    card: ``hat_wald`` and ``hat`` its lanes and staged samples, ``wald``
    its lanes; ``hat_wald`` without H and mu buffers (NULL) where the test
    alone is asked for; a plan override is passed on, and a plan the kernel
    is not built for is refused."""
    G, P = 3, 2
    f32 = torch.float32
    beta, disp, sf, X = torch.ones(G, P, dtype=f32), torch.ones(G, dtype=f32), torch.ones(N, dtype=f32), \
        torch.ones(N, P, dtype=f32)
    contrast, mu, ridge = torch.ones(P, dtype=f32), torch.ones(G, N, dtype=f32), torch.eye(P, dtype=f32)
    plan = t_wald._hat_wald_plan(N, P, 4)
    out = t_wald._hat_wald_cuda(beta, disp, sf, X, contrast, 0.0, 0.5, None)
    alone = t_wald._hat_wald_cuda(beta, disp, sf, X, contrast, 0.0, 0.5, "greater", want_hat=False)
    t_wald._hat_wald_cuda(beta, disp, sf, X, contrast, 0.0, 0.5, None, plan=t_wald.HatWaldPlan(256, 1))
    t_irls._hat_cuda(sf, X, disp, beta, 0.5)
    t_wald._wald_cuda(X, disp, beta, mu, ridge, contrast, 0.0, "lessAbs")
    names = [n for n, _ in recorded]
    assert names == ["hat_wald", "hat_wald", "hat_wald", "hat", "wald"]
    for name, a in recorded:
        _assert_marshalled(name, a)
    (_, fused), (_, test), (_, over), (_, hat), (_, wald) = recorded
    assert tuple(fused[12:14]) == tuple(plan) and fused[14] is not None and fused[15] is not None
    assert out[0].shape == out[1].shape == (G, N)
    assert test[12] == plan.lanes and test[14] is None and test[15] is None and test[11] == 3
    assert alone[0] is None and alone[1] is None and alone[2].shape == (G,)
    assert tuple(over[12:14]) == (256, 1)
    assert tuple(hat[9:11]) == tuple(plan) and hat[11] is not None
    assert wald[12] == plan.lanes and wald[11] == 2
    bad = t_wald.HatWaldPlan(8, N + 1)
    for call in (lambda: t_wald._hat_wald_cuda(beta, disp, sf, X, contrast, 0.0, 0.5, None, plan=bad),
                 lambda: t_irls._hat_cuda(sf, X, disp, beta, 0.5, plan=bad),
                 lambda: t_wald._wald_cuda(X, disp, beta, mu, ridge, contrast, 0.0, None,
                                           plan=t_wald.HatWaldPlan(16, 0))):
        with pytest.raises(ValueError):
            call()
    assert len(recorded) == 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lfc_null_operand_is_made_on_the_device(dtype):
    """The wrappers' (1,) lfc_null operand: a number by a fill (no copy from
    host memory, which would wait for the stream), a tensor cast where it
    is; both the values ``torch.as_tensor`` gives."""
    for v in (0.0, 0.3, -1, torch.tensor(0.3, dtype=torch.float64), torch.tensor(0.7, dtype=torch.float32)):
        got = t_wald._device_scalar(v, dtype, torch.device("cpu"))
        assert got.shape == (1,) and got.dtype == dtype
        assert torch.equal(got, torch.as_tensor(v, dtype=dtype).reshape(1)), v


def test_lowess_wrapper_marshals_its_launch(recorded):
    """``lowess`` gets n, r = ceil(frac n) and 3 rounds, and refuses more
    than 64 points or none."""
    for n in (2, 50, 64):
        t_stats._lowess_pick_cuda(torch.linspace(0, 1, n), torch.arange(n), 0.2)
    for (name, a), n in zip(recorded, (2, 50, 64)):
        _assert_marshalled(name, a)
        assert name == "lowess" and tuple(a[1:4]) == (n, math.ceil(0.2 * n), 3)
    for n in (0, 65):
        with pytest.raises(ValueError):
            t_stats._lowess_pick_cuda(torch.linspace(0, 1, n), torch.arange(n), 0.2)


def _hat_case(G, N, P, seed):
    """f64 operands: an intercept, a condition and P - 2 normal columns
    (the intercept alone at P = 1), coefficients that put the first genes'
    mu below min_mu, lognormal dispersions and size factors."""
    rng = np.random.default_rng(seed)
    cols = [np.ones(N)] + ([(np.arange(N) % 2).astype(float)] if P > 1 else []) + [
        rng.normal(size=N) for _ in range(P - 2)]
    X = np.column_stack(cols)
    beta = np.column_stack([rng.normal(2.0, 2.0, G)] + [rng.normal(0, 0.5, G) for _ in range(P - 1)])
    beta[:3, 0] = -4.0
    disp = rng.lognormal(-2, 1, G)
    sf = np.exp(rng.normal(0, 0.2, N))
    contrast = np.r_[0.0, 1.0, 0.5 * np.ones(P - 2)] if P > 1 else np.ones(1)
    return beta, disp, sf, X, contrast


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=1e-300)


@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("N", [12, 100, 1000])
def test_hat_and_wald_plain_at_plan_edges(N, P):
    """At the sample counts of three plans (4 lanes, 8, 32 staged), f64,
    rtol 1e-10: ``hat_diagonals`` against JAX's; ``wald_test_batch`` on
    JAX's mu against JAX's (two alternatives); the fused ``hat_wald``
    against the pair, and with ``want_hat=False`` its test bit for bit."""
    beta, disp, sf, X, contrast = _hat_case(24, N, P, 40 + N + P)
    tb, td, ts, tx, tc = (torch.as_tensor(a) for a in (beta, disp, sf, X, contrast))
    H_j, mu_j = j_irls.hat_diagonals(None, *(jnp.asarray(a) for a in (sf, X, disp, beta)))
    H_t, mu_t = t_irls.hat_diagonals(None, ts, tx, td, tb)
    _close(H_t, H_j, 1e-10)
    _close(mu_t, mu_j, 1e-10)
    assert np.any(np.asarray(mu_j) < 0.5)
    ridge = 1e-6 * np.eye(P)
    for alt in (None, "lessAbs"):
        want = j_wald.wald_test_batch(jnp.asarray(X), jnp.asarray(disp), jnp.asarray(beta), mu_j, jnp.asarray(ridge),
                                      jnp.asarray(contrast), jnp.asarray(0.1), alt)
        got = t_wald.wald_test_batch(tx, td, tb, torch.as_tensor(np.array(mu_j)), torch.as_tensor(ridge), tc, 0.1,
                                     alt)
        for g_, w_ in zip(got, want):
            _close(g_, w_, 1e-10)
        fused = t_wald.hat_wald(tb, td, ts, tx, tc, torch.tensor(0.1, dtype=torch.float64), alt_hypothesis=alt)
        for g_, w_ in zip(fused, (H_j, mu_j) + tuple(want)):
            _close(g_, w_, 1e-10)
        alone = t_wald.hat_wald(tb, td, ts, tx, tc, torch.tensor(0.1, dtype=torch.float64), alt_hypothesis=alt,
                                want_hat=False)
        assert alone[0] is None and alone[1] is None
        assert all(torch.equal(a, b) for a, b in zip(alone[2:], fused[2:]))


def test_streamed_refit_asks_for_the_test_alone(monkeypatch):
    """``run_summary_streamed(refit_cooks=True)`` gives the same outputs bit
    for bit whether its refit's ``hat_wald`` call asks for the test alone
    (as it does) or for H and mu too; the main pass asks for H (Cook's
    reads it), the refit for the test alone."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused_stream
    from pydeseq2_tpu_torch.synthetic import make_data

    counts, X = make_data(20, 200, seed=5)
    counts = counts.T.copy()
    counts[::25, 0] = counts.max() * 20  # outliers: eight genes refitted
    asked = []
    hat_wald = fused_stream.hat_wald

    def recording(*a, want_hat=True, **k):
        asked.append(want_hat)
        return hat_wald(*a, want_hat=want_hat, **k)

    def always_hat(*a, want_hat=True, **k):
        return hat_wald(*a, **k)

    runs = []
    for fn in (recording, always_hat):
        monkeypatch.setattr(fused_stream, "hat_wald", fn)
        runs.append(pt.run_summary_streamed(counts, X, [0.0, 1.0], refit_cooks=True, dtype=np.float64,
                                            gene_block=64, device="cpu"))
    n_main = asked.index(False)  # the main pass's blocks of 64 genes, then the refit's tiles
    assert n_main == 4 and not any(asked[n_main:])
    assert runs[0]["refitted"].sum() >= 4
    assert runs[0].keys() == runs[1].keys()
    for key, a in runs[0].items():
        assert np.array_equal(np.asarray(a), np.asarray(runs[1][key]), equal_nan=True), key


def _jax_pick(theta, num_rej):
    """``lowess_device`` and the pick of ``pydeseq2_tpu/fused.py:763-768``."""
    rej = num_rej.astype(theta.dtype)
    lo = j_stats.lowess_device(theta, rej, frac=0.2)
    resid = jnp.where(num_rej > 0, rej - lo, jnp.nan)
    thresh = lo.max() - jnp.sqrt(jnp.nanmean(resid**2))
    above = num_rej > thresh
    j = jnp.where(above.any(), jnp.argmax(above), 0)
    return lo, jnp.where(num_rej.max() <= 10, 0, j)


@pytest.mark.parametrize("kind", ["counts", "zeros"])
@pytest.mark.parametrize("n", [2, 50, 64])
def test_lowess_pick_plain_ties(n, kind):
    """The ``lowess`` kernel's plain version against JAX's fit and pick at
    2, 50 and 64 points on a dyadic grid (a point's left and right
    neighbours tie in distance, exactly) with one level repeated (a zero
    distance), rising then level counts or an all-zero row (row 0);
    f64 at 1e-12 and f32 at 1e-3 on the fit (XLA sums in another order),
    the same row."""
    theta = np.arange(n) / 64.0 + 1 / 128
    if n > 2:
        theta[n // 2] = theta[n // 2 - 1]
    rng = np.random.default_rng(41 + n)
    rising = 500 * np.minimum(theta / 0.3, 1.0) + rng.normal(0, 10, n)
    rej = (np.maximum(0, rising).round() if kind == "counts" else np.zeros(n)).astype(np.int64)
    for dt, jt, rtol in ((torch.float64, jnp.float64, 1e-12), (torch.float32, jnp.float32, 1e-3)):
        yest, j = t_stats.lowess_pick(torch.as_tensor(theta, dtype=dt), torch.as_tensor(rej))
        lo, jj = _jax_pick(jnp.asarray(theta, dtype=jt), jnp.asarray(rej))
        assert np.array_equal(np.isnan(yest.numpy()), np.isnan(np.asarray(lo)))
        np.testing.assert_allclose(np.nan_to_num(yest.numpy()), np.nan_to_num(np.asarray(lo)), rtol=rtol, atol=1e-6)
        assert int(j) == int(jj)
        if kind == "zeros":
            assert int(j) == 0


@pytest.mark.parametrize("detail", [False, True])
def test_hat_and_lowess_bench_child_on_cpu(monkeypatch, detail):
    """The ``hat`` and ``lowess`` suites of ``kernel_bench`` at small shapes
    on the CPU (host timers, the plain versions for the kernels): times of
    the four calls, the agreement with the plain versions, the test alone
    bit for bit, the plan; ``--detail`` every other plan and more lowess
    draws."""
    import time

    from pydeseq2_tpu_torch import kernel_bench

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
    plans = []

    def plain_hat_wald(*a, want_hat=True, plan=None):
        plans.append(plan)
        return t_wald._hat_wald_plain(*a, want_hat)

    monkeypatch.setattr(t_wald, "_hat_wald_cuda", plain_hat_wald)
    monkeypatch.setattr(t_irls, "_hat_cuda", lambda *a, plan=None: t_irls._hat_plain(*a))
    monkeypatch.setattr(t_wald, "_wald_cuda", lambda *a, plan=None: t_wald._wald_plain(*a))
    monkeypatch.setattr(t_stats, "_lowess_pick_cuda", t_stats._lowess_pick_plain)
    monkeypatch.setattr(t_stats, "_bh_count_cuda", lambda *a: t_stats._bh_count_plain(*a))
    monkeypatch.setattr(t_stats, "_bh_adjust_cuda", lambda p, o, v, b, c, j, cluster=0: t_stats._bh_adjust_plain(
        p, o, v, b, c, j))
    monkeypatch.setattr(kernel_bench, "HAT_SHAPES", (
        ("f32 100x40 P=2", 40, 100, 2, torch.float32, 1),
        ("f32 12x30 P=5", 30, 12, 5, torch.float32, 1),
        ("f64 600x8 P=1", 8, 600, 1, torch.float64, 1)))
    monkeypatch.setattr(kernel_bench, "BH_G", 400)
    res = kernel_bench.child(detail, ("hat", "lowess"))
    assert set(res) == {"ptxas", "hat", "lowess"} | ({"sass_loops"} if detail else set())
    for label, row in res["hat"].items():
        assert row["repeat_bits_equal"] and row["test_only_bits_equal"], label
        assert max(row["errs"].values()) == 0.0 and set(row["errs"]) == {"H", "mu", "p", "stat", "se"}, label
        for key in ("hat_wald", "hat", "wald", "test_only"):
            assert row[f"{key}_ms"] > 0 and row[f"{key}_kernel_ms"] > 0, (label, key)
        assert row["fill_ms"] > 0, label
        isz = 4 if "f32" in label else 8
        assert row["plan"] == t_wald._hat_wald_plan(row["samples"], row["P"], isz)._asdict()
        assert any(k.startswith("kernel_ms ") for k in row) == detail
    assert any(p is not None for p in plans) == detail
    assert set(res["lowess"]) == {"f32 run 50", "f64 run 50"} | ({"f32 draw 2", "f32 draw 64"} if detail else set())
    for label, row in res["lowess"].items():
        assert row["row"] == row["plain_row"] and row["fit_bits_equal"] and row["repeat_bits_equal"], label
        assert row["lowess_kernel_ms"] > 0 and row["plain_ms"] > 0, label
    assert res["lowess"]["f32 run 50"]["points"] == 50
