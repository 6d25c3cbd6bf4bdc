"""The rebuilt ``bh`` and ``mom`` kernels' plain versions and launch plans
against the JAX package, on the CPU.

BH is split the way its callers use it: the rejection counts of every
cutoff row (``ops/stats.py:bh_rejections``, the ``bh_count`` kernel) and the
adjusted values of the one row the lowess pick chooses (``bh_adjust_row``,
``bh_adjust``, its row index a tensor). Their plain versions are held to
``pydeseq2_tpu.ops.stats.bh_adjust_masked`` and ``(adj < alpha).sum(1)``
bit for bit: ties, NaN p-values inside the mask, unsorted and
non-finite cutoffs, an empty row, and ``alpha`` hit exactly (the test is
strict). ``device_padj`` and the class API's filter follow JAX's in both
modes. ``mom``'s plain version is held to the JAX expressions in every
design width and in its normed-count mode, and its launch plan
(``ops/linreg.py:_mom_plan``) is a function of the shape alone. The CUDA
kernels are held to these plain versions on the card by ``chip_smoke.py``.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydeseq2_tpu.ops import linreg as j_lin
from pydeseq2_tpu.ops import stats as j_stats
from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops import linreg as t_lin
from pydeseq2_tpu_torch.ops import stats as t_stats

torch.set_num_threads(1)  # xdist runs several workers on a few cores


def _draw(G=2500, seed=31):
    """p-values with ties (rounded to 4 digits) and NaNs, base means with
    zeros, a testable mask."""
    rng = np.random.default_rng(seed)
    p = np.where(rng.random(G) < 0.3, rng.uniform(0, 1e-3, G), rng.uniform(0, 1, G))
    p = np.round(p, 4)
    p[rng.random(G) < 0.05] = np.nan
    base_mean = np.where(rng.random(G) < 0.1, 0.0, rng.lognormal(2.0, 2.0, G))
    valid = rng.random(G) < 0.97
    return p, base_mean, valid


def _cutoff_sets(base_mean):
    """Sorted quantile cutoffs (the filter's), the same shuffled, and an
    unsorted set with -inf, a repeat, and NaN, +inf and a cutoff above every
    base mean (three empty rows)."""
    cut = np.quantile(base_mean, np.linspace(0.1, 0.95, 50))
    rng = np.random.default_rng(32)
    edges = np.r_[cut[:44], np.inf, -np.inf, np.nan, cut[5], base_mean.max() * 2, 0.0]
    return {"sorted": cut, "unsorted": rng.permutation(cut), "edges": rng.permutation(edges)}


def _jax_sweep(p, base_mean, valid, cut):
    masks = valid[None, :] if cut is None else (base_mean[None, :] >= cut[:, None]) & valid[None, :]
    return np.asarray(j_stats.bh_adjust_masked(jnp.asarray(p), jnp.asarray(masks)))


def _torch_args(p, base_mean, valid, cut, dtype=torch.float64):
    pt = torch.as_tensor(p, dtype=dtype)
    order = torch.argsort(torch.nan_to_num(pt, nan=2.0), stable=True)
    bm = None if cut is None else torch.as_tensor(base_mean, dtype=dtype)
    cu = None if cut is None else torch.as_tensor(cut, dtype=dtype)
    return pt, order, torch.as_tensor(valid), bm, cu


@pytest.mark.parametrize("cuts", ["none", "sorted", "unsorted", "edges"])
def test_bh_counts_and_rows_against_bh_adjust_masked(cuts):
    """The counts-only sweep equals ``(adj < alpha).sum(1)`` of JAX's
    masked BH, and the one-row pass at every row j (a 0-d tensor) equals
    row j, bit for bit, with ties and NaN p-values inside the mask."""
    p, base_mean, valid = _draw()
    cut = None if cuts == "none" else _cutoff_sets(base_mean)[cuts]
    want = _jax_sweep(p, base_mean, valid, cut)
    args = _torch_args(p, base_mean, valid, cut)
    for alpha in (0.05, 0.1):
        num_rej = t_stats.bh_rejections(*args, alpha=alpha)
        assert num_rej.dtype == torch.int64
        assert np.array_equal(num_rej.numpy(), (want < alpha).sum(1)), alpha
    assert (want < 0.05).sum() > 10 * want.shape[0]
    for j in range(want.shape[0]):
        row = t_stats.bh_adjust_row(*args, j=None if cut is None else torch.tensor(j))
        assert row.shape == (p.shape[0],) and row.dtype == torch.float64
        assert np.array_equal(row.numpy(), want[j], equal_nan=True), j
    if cuts == "edges":
        assert np.isnan(want).all(1).sum() == 3  # the rows of the NaN, +inf and above-every-gene cutoffs
    if cut is not None:
        assert np.array_equal(t_stats.bh_adjust_row(*args).numpy(), want[0], equal_nan=True)


def test_bh_counts_at_alpha_hit_exactly():
    """A scaled value equal to ``alpha`` is not a rejection (strict <):
    64 valid genes, alpha = 1/16 and p = alpha k / 64 exactly at the
    ranks k = 4 and 9, so p * n_valid / rank == alpha there and the
    rejections stop at rank 3; at the next float above alpha they reach
    rank 9."""
    G = 64
    alpha = 0.0625
    p = np.linspace(0.2, 0.9, G)
    p[:3] = [0.0001, 0.0002, 0.0003]
    p[3] = alpha * 4 / G  # rank 4: scaled exactly alpha
    p[4:8] = [0.0075, 0.008, 0.0085, 0.0086]
    p[8] = alpha * 9 / G
    valid = np.ones(G, bool)
    want = _jax_sweep(p, None, valid, None)
    args = _torch_args(p, None, valid, None)
    got = t_stats.bh_rejections(*args, alpha=alpha)
    assert int(got[0]) == int((want < alpha).sum()) == 3
    assert np.array_equal(t_stats.bh_adjust_row(*args).numpy(), want[0], equal_nan=True)
    assert int(t_stats.bh_rejections(*args, alpha=np.nextafter(alpha, 1.0))[0]) == 9


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bh_sweep_contract(dtype):
    """``bh_sweep`` keeps its (rows, G) matrix and counts; its counts are
    ``bh_rejections``' and its rows ``bh_adjust_row``'s, also in float32
    operands, on one gene and on 33."""
    p, base_mean, valid = _draw(seed=33)
    cut = _cutoff_sets(base_mean)["unsorted"]
    for G in (1, 33, p.shape[0]):
        args = _torch_args(p[:G], base_mean[:G], valid[:G], cut, dtype)
        adj, num_rej = t_stats.bh_sweep(*args, alpha=0.05)
        assert adj.shape == (cut.shape[0], G) and adj.dtype == dtype
        assert torch.equal(num_rej, t_stats.bh_rejections(*args, alpha=0.05))
        assert torch.equal(num_rej, (adj < 0.05).sum(1))
        for j in (0, 17, cut.shape[0] - 1):
            assert torch.equal(adj[j].nan_to_num(2.0), t_stats.bh_adjust_row(*args, j=torch.tensor(j)).nan_to_num(2.0))


@pytest.mark.parametrize("independent_filter", [True, False])
def test_device_padj_few_rejections(independent_filter):
    """``device_padj`` against JAX's where no row has more than 10
    rejections (the pick falls back to row 0) and on every gene valid."""
    from pydeseq2_tpu import fused as j_fused
    from pydeseq2_tpu_torch import fused as t_fused

    rng = np.random.default_rng(34)
    G = 1500
    p = rng.uniform(0.01, 1, G)
    p[:5] = 1e-6
    base_mean = rng.lognormal(2.0, 2.0, G)
    mask = np.ones(G, bool)
    got = t_fused.device_padj(torch.as_tensor(p), torch.as_tensor(base_mean), torch.as_tensor(mask), 0.05,
                              independent_filter)
    want = np.asarray(j_fused.device_padj(jnp.asarray(p), jnp.asarray(base_mean), jnp.asarray(mask), 0.05,
                                          independent_filter))
    assert np.array_equal(got.numpy(), want, equal_nan=True)
    assert 0 < np.sum(want < 0.05) <= 10


@pytest.mark.parametrize("alpha", [0.05, 0.1])
def test_class_api_filter_against_jax(alpha):
    """The class API's ``_independent_filter_padj`` and ``_bh_padj`` on the
    CPU against the JAX package's, bit for bit."""
    from pydeseq2_tpu.models import stats as j_models
    from pydeseq2_tpu_torch.models import stats as t_models

    p, base_mean, _ = _draw(seed=35)
    got = t_models._independent_filter_padj(p, base_mean, alpha, device="cpu")
    want = j_models._independent_filter_padj(p, base_mean, alpha)
    assert np.array_equal(got, want, equal_nan=True)
    assert np.array_equal(t_models._bh_padj(p, device="cpu"), j_models._bh_padj(p), equal_nan=True)


@pytest.mark.parametrize("normed", [False, True])
@pytest.mark.parametrize("P", [1, 3, 5])
def test_mom_plain_against_jax(P, normed):
    """``mom_and_mu_coef``'s plain version against the JAX expressions at
    P = 1, 3, 5, on raw or normalised counts (the class API's mode, where
    sf enters only mean(1/sf) and mu). Tolerance as ``test_linreg``
    (pinv by different SVD routines)."""
    rng = np.random.default_rng(36 + P)
    G, N = 120, 24
    X = np.column_stack([np.ones(N)] + [rng.normal(size=N) for _ in range(P - 1)])
    sf = np.exp(rng.normal(0, 0.3, N))
    counts = rng.poisson(rng.lognormal(3, 1, (G, 1)) * sf[None, :]).astype(float)
    counts[7] = 0.0
    normed_counts = counts / sf[None, :]
    c = torch.as_tensor(normed_counts if normed else counts)
    x, s = torch.as_tensor(X), torch.as_tensor(sf)
    rough, moments, coef, mu = t_lin.mom_and_mu_coef(c, s, x, t_lin.ols_pinv(x), 0.5, want_mu=True, normed=normed)
    jn = jnp.asarray(normed_counts)
    coef_j = jn @ j_lin.ols_pinv(jnp.asarray(X)).T
    np.testing.assert_allclose(rough.numpy(), j_lin.fit_rough_dispersions_batch(jn, jnp.asarray(X)), 1e-9, 1e-12)
    np.testing.assert_allclose(moments.numpy(), j_lin.fit_moments_dispersions_batch(jn, jnp.asarray(sf)), 1e-9,
                               1e-12)
    np.testing.assert_allclose(coef.numpy(), coef_j, 1e-9, 1e-9)
    np.testing.assert_allclose(mu.numpy(), np.maximum(sf[None, :] * (np.asarray(coef_j) @ X.T), 0.5), 1e-9)
    assert moments[7] == 0.0


@pytest.mark.parametrize("itemsize", [4, 8])
def test_mom_plan_picks(itemsize):
    """Lane groups by N: 4 lanes to 64 samples and 8 to 128 in registers,
    32 in registers to 512 and staged below 2048, then a block; a staged
    row keeps what its share of shared memory holds."""
    plan = t_lin._mom_plan
    assert plan(12, itemsize) == (4, 0) and plan(64, itemsize) == (4, 0)
    assert plan(65, itemsize) == (8, 0) and plan(100, itemsize) == (8, 0) and plan(128, itemsize) == (8, 0)
    assert plan(129, itemsize) == (32, 0) and plan(512, itemsize) == (32, 0)
    group = 4096 // itemsize
    assert plan(513, itemsize) == (32, min(513, group))
    assert plan(1000, itemsize) == (32, min(1000, group)) and plan(2047, itemsize) == (32, group)
    block = 49152 // itemsize
    assert plan(2048, itemsize) == (256, 2048)
    assert plan(10000, itemsize) == (256, min(10000, block)) and plan(100_000, itemsize) == (256, block)
    for N in range(2, 3000, 7):
        lanes, staged = plan(N, itemsize)
        assert (staged == 0 and N <= 16 * lanes) or (lanes in (32, 256) and 0 < staged <= N)


@pytest.fixture
def recorded(monkeypatch):
    """Launches recorded instead of made, on CPU tensors; any read of the
    card fails."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, args, device: calls.append((name, args)))
    monkeypatch.setattr(kernels, "check_cuda_operands", lambda *a: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)

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
def test_mom_wrapper_marshals_its_plan(recorded, N):
    """``_mom_cuda`` hands the launcher the plan of the shape (lanes,
    staged) without reading the card, and refuses plans not built."""
    G, P = 3, 2
    c = torch.ones(G, N, dtype=torch.float32)
    X = torch.ones(N, P, dtype=torch.float32)
    pinv = torch.ones(P, N, dtype=torch.float32)
    t_lin._mom_cuda(c, torch.ones(N), X, pinv, 0.5, True)
    t_lin._mom_cuda(c, torch.ones(N), X, pinv, 0.5, False, True, plan=t_lin.MomPlan(256, 1))
    (name, a), (_, b) = recorded
    _assert_marshalled(name, a)
    assert name == "mom" and tuple(a[10:12]) == tuple(t_lin._mom_plan(N, 4))
    assert tuple(b[9:12]) == (1, 256, 1) and b[-1] is None and a[-1] is not None
    with pytest.raises(ValueError):
        t_lin._mom_cuda(c, torch.ones(N), X, pinv, 0.5, True, plan=t_lin.MomPlan(4, 0) if N > 64 else
                        t_lin.MomPlan(8, N + 1))


def test_bh_wrappers_marshal_their_launches(recorded):
    """``bh_count`` gets the plan's chunk and batches of at most 256 rows
    (their cutoffs and counts offset); ``bh_adjust`` the row index's
    pointer for one row, NULL for every row; nothing reads the card."""
    G = 60_000
    p = torch.rand(G, dtype=torch.float64)
    order = torch.argsort(p, stable=True)
    valid = torch.ones(G, dtype=torch.bool)
    bm = torch.rand(G, dtype=torch.float32)
    cut = torch.rand(300, dtype=torch.float64)
    t_stats._bh_count_cuda(p, order, valid, bm, cut, 0.05)
    t_stats._bh_adjust_cuda(p, order, valid, bm, cut, torch.tensor(4))
    t_stats._bh_adjust_cuda(p, order, valid, bm, cut, None)
    t_stats._bh_adjust_cuda(p, order, valid, None, None, None)
    names = [n for n, _ in recorded]
    assert names == ["bh_count", "bh_count", "bh_adjust", "bh_adjust", "bh_adjust"]
    for name, a in recorded:
        _assert_marshalled(name, a)
    (_, c0), (_, c1) = recorded[:2]
    assert (c0[1], c1[1]) == (256, 44) and c0[3] == c1[3] == t_stats._bh_count_plan(G).chunk
    assert c1[8] - c0[8] == 256 * 8 and c1[-1] - c0[-1] == 256 * 8
    (_, one), (_, every), (_, plain) = recorded[2:]
    assert one[8] is not None and one[9] == 1 and every[8] is None and every[9] == 300
    assert plain[6] is None and plain[8] is None and plain[9] == 1 and plain[1] == 1


def test_bh_count_plan_covers():
    """Chunks of whole 512-position tiles that cover every position once,
    one a block while at most two blocks an SM take them."""
    for G in (1, 33, 511, 512, 513, 60_000, 135_168, 135_169, 1_000_000):
        chunk, blocks = t_stats._bh_count_plan(G, 132)
        assert chunk % 512 == 0 and (blocks - 1) * chunk < G <= blocks * chunk
        assert blocks <= 2 * 132
        assert chunk == 512 or -(-G // (chunk - 512)) > 2 * 132


@pytest.mark.parametrize("detail", [False, True])
def test_mom_and_bh_bench_child_on_cpu(monkeypatch, detail):
    """The ``mom`` and ``bh`` suites of ``kernel_bench`` at small shapes on
    the CPU (host timers, the plain versions for the kernels): times beside
    the matmul and argsort yardsticks, the plan, the agreement with the
    plain versions; ``--detail`` every other ``mom`` plan."""
    import time

    from pydeseq2_tpu_torch import kernel_bench

    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    monkeypatch.setattr(kernels, "build", lambda: {})
    monkeypatch.setattr(kernel_bench, "ptxas", lambda k, sources=(): {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(kernel_bench, "cuda_ms", host_ms)
    monkeypatch.setattr(kernel_bench, "device_ms", lambda fn, reps, name: (host_ms(fn, reps),) * 2)
    plans = []

    def plain_mom(c, sf, X, pinv, min_mu, want_mu, normed=False, plan=None):
        plans.append(plan)
        return t_lin._mom_plain(c, sf, X, pinv, min_mu, want_mu, normed)

    monkeypatch.setattr(t_lin, "_mom_cuda", plain_mom)
    monkeypatch.setattr(t_stats, "_bh_count_cuda", lambda *a: t_stats._bh_count_plain(*a))
    monkeypatch.setattr(t_stats, "_bh_adjust_cuda", lambda p, o, v, b, c, j, cluster=0: t_stats._bh_adjust_plain(
        p, o, v, b, c, j))
    monkeypatch.setattr(kernel_bench, "MOM_SHAPES", (
        ("f32 12x60 P=2", 60, 12, 2, torch.float32, False, False, 1),
        ("f32 100x40 P=5 mu", 40, 100, 5, torch.float32, True, False, 1),
        ("f64 1000x20 P=1 normed", 20, 1000, 1, torch.float64, False, True, 1)))
    monkeypatch.setattr(kernel_bench, "BH_G", 400)
    res = kernel_bench.child(detail, ("mom", "bh"))
    assert set(res) == {"ptxas", "mom", "bh"} | ({"sass_loops"} if detail else set())
    for label, row in res["mom"].items():
        assert row["max_rel_err"] == 0.0 and row["mom_ms"] > 0 and row["matmul_ms"] > 0, label
        assert row["plan"] == t_lin._mom_plan(row["samples"], 4 if "f32" in label else 8)._asdict()
        assert any(k.startswith("kernel_ms ") for k in row) == detail
    assert any(p is not None for p in plans) == detail
    (row,) = res["bh"].values()
    assert row["genes"] == 400 and row["rows"] == 50 and 0 <= row["picked_row"] < 50
    for key in ("sweep_bits_equal", "one_row_bits_equal", "counts_bits_equal", "picked_row_bits_equal"):
        assert row[key], key
    for key in ("sweep", "one_row", "sweep_f32", "device_padj", "device_padj_bh", "counts", "picked_row",
                "counts_and_row"):
        assert row[f"{key}_ms"] > 0 and row[f"{key}_kernel_ms"] > 0, key
