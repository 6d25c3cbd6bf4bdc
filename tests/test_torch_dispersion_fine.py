"""The port's ``dnb_nll`` and ``alpha_mle_batch(fine_length > 0)`` against
the JAX package, on the CPU (plain PyTorch versions of the ``dnb_nll`` and
``disp_scan_fine`` kernels; ``chip_smoke.py`` holds the kernels to those on
the card). Tolerances are stated per test with their reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma

from pydeseq2_tpu.ops import dispersion as j_disp
from pydeseq2_tpu.ops import linreg as j_lin
from pydeseq2_tpu.ops import nb as j_nb
from pydeseq2_tpu_torch.ops import dispersion as t_disp
from pydeseq2_tpu_torch.ops import nb as t_nb

torch.set_num_threads(1)  # xdist runs several workers on a few cores

DTYPES = {"f64": (np.float64, jnp.float64), "f32": (np.float32, jnp.float32)}


def _j(a, name):
    return jnp.asarray(np.asarray(a, DTYPES[name][0]))


def _t(a, name):
    return torch.as_tensor(np.asarray(a, DTYPES[name][0]))


@pytest.fixture(scope="module")
def dnb_data():
    """40 rows of 30 samples at alpha in [0.05, 1]."""
    rng = np.random.default_rng(7)
    G, N = 40, 30
    alpha = rng.uniform(0.05, 1.0, G)
    mu = rng.lognormal(2.0, 1.0, (G, 1)) * rng.lognormal(0.0, 0.3, (G, N))
    counts = rng.negative_binomial(1 / alpha[:, None], 1 / (1 + alpha[:, None] * mu)).astype(float)
    return counts, mu, alpha


@pytest.mark.parametrize("shape", ["rows", "vector"])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_dnb_nll_matches_jax(dnb_data, name, shape):
    """f64: rtol 1e-10 (both psi evaluations are accurate to ~1e-15; the
    sums differ in order only). f32: the JAX package takes XLA's digamma,
    the port the Stirling-8 psi; each is a few ulps off psi, and psi(1/a) -
    psi(y + 1/a) cancels, so the gap is held against the summed magnitudes
    alpha^-2 sum(|psi(r)| + |psi(y + r)| + |log1p(mu a)| + |(y - mu)/(mu + r)|):
    1e-6 of it, ~8 float32 eps (1.5e-7 read)."""
    counts, mu, alpha = dnb_data
    if shape == "vector":  # JAX's own test: one row, a scalar alpha
        counts, mu, alpha = counts[0], mu[0], float(alpha[0])
    got = t_nb.dnb_nll(_t(counts, name), _t(mu, name), _t(alpha, name)).numpy()
    want = np.asarray(j_nb.dnb_nll(_j(counts, name), _j(mu, name), _j(alpha, name)))
    assert got.shape == want.shape
    if name == "f64":
        np.testing.assert_allclose(got, want, rtol=1e-10)
        return
    a = np.asarray(alpha)[..., None]
    r = 1.0 / a
    scale = (np.abs(digamma(r)) + np.abs(digamma(counts + r)) + np.abs(np.log1p(mu * a))
             + np.abs((counts - mu) / (mu + r))).sum(-1) / np.asarray(alpha) ** 2
    assert np.max(np.abs(got - want) / scale) <= 1e-6


def test_dnb_nll_matches_finite_difference():
    """The port's own: dnb_nll against a central difference of the port's
    nb_nll in float64 (the JAX package's tests/test_ops.py check)."""
    rng = np.random.default_rng(0)
    counts = torch.as_tensor(rng.poisson(15.0, 30).astype(float))
    mu = torch.as_tensor(rng.uniform(5, 25, 30))
    alpha, eps = 0.3, 1e-6
    fd = (float(t_nb.nb_nll(counts, mu, alpha + eps)) - float(t_nb.nb_nll(counts, mu, alpha - eps))) / (2 * eps)
    an = float(t_nb.dnb_nll(counts, mu, alpha))
    assert abs(fd - an) / abs(fd) < 1e-5


@pytest.fixture(scope="module")
def fine_inputs():
    """256 genes x 30 samples with their linear-mu dispersion inputs, one
    all-zero gene (lane 3), as the port's op tests draw them."""
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


def _both(fine_inputs, name, **kw):
    counts, X, mu, disp = fine_inputs
    a_j, c_j = j_disp.alpha_mle_batch(*(_j(v, name) for v in (counts, X, mu, disp)), 1e-8, 30.0, **kw)
    a_t, c_t = t_disp.alpha_mle_batch(*(_t(v, name) for v in (counts, X, mu, disp)), 1e-8, 30.0, **kw)
    return np.asarray(a_j), np.asarray(c_j), a_t.numpy(), c_t.numpy()


@pytest.mark.parametrize("fine_length", [2, 8])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_alpha_mle_fine_scan_matches_jax(fine_inputs, name, fine_length):
    """alpha_mle_batch(fine_length) with the default polish and with none.

    With no polish (newton_iters=0) alpha is exp of the fine scan's argmin,
    so the scan itself is held: the same grid point on every lane in f64
    (1e-12: exp of one la in two libraries), 99% of lanes in f32 (a near tie
    of two points may fall either way; the all-zero gene's objective is flat).
    The converged flag there is the projected Newton decrement of lanes far
    from the optimum: the same flags as JAX on every lane.
    With the polish: JAX takes the autodiff (f, g, h) below 512 samples and
    the port the closed form, the same function; f64 alphas to 1e-6 and the
    same flags; f32 as ``test_alpha_mle_genewise_and_map`` (97% of lanes
    within 1e-3, the median within 5e-5, plateau lanes round apart).
    """
    a_j, c_j, a_t, c_t = _both(fine_inputs, name, fine_length=fine_length, newton_iters=0)
    rtol = 1e-12 if name == "f64" else 1e-6
    share = np.mean(np.isclose(a_t, a_j, rtol=rtol, atol=0))
    assert share >= (1.0 if name == "f64" else 0.99), share
    assert np.array_equal(c_t, c_j)

    a_j, c_j, a_t, c_t = _both(fine_inputs, name, fine_length=fine_length)
    rel = np.abs(a_t - a_j) / a_j
    if name == "f64":
        assert rel.max() < 1e-6, rel.max()
        assert np.array_equal(c_t, c_j)
    else:
        assert np.mean(rel < 1e-3) > 0.97 and np.median(rel) < 5e-5, (np.mean(rel < 1e-3), np.median(rel))


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_fine_scan_flag_on_a_coarse_grid(fine_inputs, name):
    """tests/test_pipeline.py's check of the flag itself: two coarse points,
    a two-point fine scan and no polish leave lanes far from their optimum,
    which must not all report converged, the same lanes as JAX (in f32 but
    for the lanes pinned at min_disp, the Poisson limit, where the objective
    is flat and g and h are float32 rounding noise whose sign decides the
    projection: the autodiff (f, g, h) of JAX and the port's closed form
    flip 13 of the 171 on this draw). step2's
    effect: the flags are the projected Newton decrement at the returned
    point with the fine spacing step2 = 2 step1 / (fine_length - 1) for the
    lanes of non-positive curvature (|g| step2), on every lane. In f32 the
    fine_length = 0 spacing step1 / 3.5 would flag other lanes; in f64 the
    185 lanes with h <= 0 sit far from the threshold either way."""
    _, c_j, a_t, c_t = _both(fine_inputs, name, grid_length=2, fine_length=2, newton_iters=0)
    assert not c_t.all()
    off_bound = a_t > 2e-8 if name == "f32" else np.ones(a_t.shape, bool)
    assert np.array_equal(c_t[off_bound], c_j[off_bound]) and off_bound.sum() >= 80

    # the returned point: the coarse argmin, then the fine scan's
    counts, X, mu, _ = (_t(v, name) for v in fine_inputs)
    lo, hi = np.log(1e-8), np.log(30.0)
    step1 = hi - lo  # grid_length 2
    la_grid = torch.tensor([lo, lo + step1], dtype=mu.dtype)
    pdv = torch.tensor(1.0, dtype=mu.dtype)
    la1, _ = t_disp.scan_coarse(counts, mu, X, la_grid, *t_disp._scan_branches(2, step1, lo), (lo + hi) / 2,
                                True, False, None, pdv)
    la = t_disp.scan_grid(counts, mu, X, la1, step1, 2, lo, hi, True, False, None, pdv)
    assert np.array_equal(torch.exp(la).numpy(), a_t)
    f, g, h = t_disp.fgh_closed(counts, mu, X, la, True, False, None, None)
    pg = torch.where((la <= lo) & (g > 0), 0.0, g)
    pg = torch.where((la >= hi) & (pg < 0), 0.0, pg)
    ftol = max(1e3 * torch.finfo(la.dtype).eps, 1e-9)

    def flags(step2):
        dec = torch.where(h > 0, pg * pg / (2.0 * h.abs()), pg.abs() * step2)
        return (torch.isfinite(f) & (dec <= ftol * (f.abs() + 1.0))).numpy()

    assert np.array_equal(flags(2.0 * step1 / (2 - 1)), c_t)
    if name == "f32":
        assert not np.array_equal(flags(step1 / 3.5), c_t)


def test_fine_scan_keeps_the_center_without_a_finite_point(fine_inputs):
    """The fine scan's first minimum starts from (center, +inf): a lane whose
    objective is NaN at every point keeps its centre."""
    counts, mu, disp = (torch.as_tensor(fine_inputs[i][:8]) for i in (0, 2, 3))
    X = fine_inputs[1]
    mu = mu.clone()
    mu[1] = float("nan")
    center = torch.linspace(-6.0, 1.0, 8, dtype=torch.float64)
    la_hat = torch.log(disp)
    pdv = torch.tensor(1.0, dtype=torch.float64)
    best = t_disp.scan_grid(counts, mu, torch.as_tensor(X), center, 0.5, 5, np.log(1e-8), np.log(30.0),
                            True, False, la_hat, pdv)
    assert best[1] == center[1]
    assert torch.isfinite(best).all()


@pytest.mark.parametrize(("G", "N", "sms", "want"), [
    (60_000, 100, 132, 1),   # the main shape: 1875 tiles fill the card
    (5_000, 10_000, 132, 4),  # the atlas block: 157 tiles x 4 segments
    (4_000, 100, 132, 3),    # 125 tiles: 3 segments of >= 32 samples
    (10_000, 100, 132, 2),
    (30_000, 1_000, 132, 1),
    (100, 100_000, 132, 132),  # 4 tiles: 132 segments
    (2_000, 40, 132, 1),     # a row of 40 samples is not split
])
def test_scan_segments(G, N, sms, want):
    """The scan kernel splits a row only where the gene tiles leave the card
    short of ~4 blocks per SM, and keeps >= 32 samples a segment."""
    assert t_disp._scan_segments(G, N, sms) == want


def test_fine_length_zero_keeps_the_coarse_argmin(fine_inputs):
    """fine_length=0 (the pipelines' setting) runs no fine scan: with no
    polish alpha is exp of a static grid point."""
    counts, X, mu, disp = (torch.as_tensor(v) for v in fine_inputs)
    a, _ = t_disp.alpha_mle_batch(counts, X, mu, disp, 1e-8, 30.0, newton_iters=0)
    lo, hi = np.log(1e-8), np.log(30.0)
    grid = lo + np.arange(32) * ((hi - lo) / 31)
    assert np.all(np.min(np.abs(np.log(a.numpy())[:, None] - grid[None, :]), axis=1) < 1e-12)


jax.config.update("jax_enable_x64", True)


def test_wrappers_marshal_what_the_launchers_take(monkeypatch):
    """The scan, fine-scan, Newton and dnb_nll wrappers hand each C launcher
    one value per argtype: ints for c_int, floats for c_double, an int or
    None for a pointer (nvcc is not here, so this is where a mismatch shows
    before the card). Run on CPU tensors with the launch recorded instead
    of made."""
    import ctypes

    from pydeseq2_tpu_torch import kernels

    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, args, device: calls.append((name, args)))
    monkeypatch.setattr(kernels, "check_cuda_operands", lambda *a: None)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    G, N, P = 300, 3000, 2
    counts = torch.ones(G, N, dtype=torch.float64)
    X = torch.ones(N, P, dtype=torch.float64)
    la_grid = torch.linspace(-18.0, 3.0, 32, dtype=torch.float64)
    pdv = torch.tensor(1.0, dtype=torch.float64)
    la_hat = torch.zeros(G, dtype=torch.float64)
    coarse = torch.empty(32, G, dtype=torch.float64)
    t_disp._scan_launch("disp_scan", counts, counts, X, (la_grid, 32, 8, 12, -7.5), 32, True, True, la_hat,
                        pdv, coarse)
    order = torch.arange(G, dtype=torch.int32)
    t_disp._scan_launch("disp_scan_fine", counts, counts, X, (la_grid[:G], 0.7, 0.2, -18.0, 3.0, 8, order), 8,
                        True, False, la_hat, pdv, None)
    t_nb._dnb_nll_cuda(counts[0], counts[0], torch.tensor(0.3, dtype=torch.float64))
    t_nb._dnb_nll_cuda(counts, counts, la_hat)  # alpha a row vector, by pointer
    t_nb._dnb_nll_cuda(counts, counts, 0.3)  # a float, by value
    t_disp._newton_polish_cuda(counts, counts, X, la_hat, -18.4, 4.6, 0.7, 0.2, 4, True, True, la_hat, pdv)
    t_disp._newton_polish_cuda(counts, counts, X, la_hat, -18.4, 4.6, 0.7, 0.2, 4, True, False, la_hat, pdv,
                               plan=4)  # a gene's row over 4 warps
    kinds = {ctypes.c_int: int, ctypes.c_double: float}
    for name, args in calls:
        want = kernels._ARGTYPES[kernels.KERNELS[name][1]]
        assert len(args) == len(want), name
        for a, w in zip(args, want):
            if w is ctypes.c_void_p:
                assert a is None or (isinstance(a, int) and not isinstance(a, bool)), (name, a)
            else:
                assert isinstance(a, kinds[w]) and not isinstance(a, bool), (name, a, w)
    # 10 tiles of 300 genes leave the card short: the scans split the rows
    assert calls[0][1][16] == calls[1][1][18] == 53
    # the Newton launches' warps a gene: 3000 samples keep one, the plan given is passed on
    assert [args[4] for name, args in calls if name == "disp_newton"] == [1, 4]
