"""Module-by-module parity of the PyTorch port against the JAX package, CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``pydeseq2_tpu_torch`` with ``device="cpu"`` tensors, so
every kernel wrapper runs its plain PyTorch version (the CUDA kernels are
held against those plain versions on the card by ``chip_smoke.py``).
Tolerances are stated per test with their reason.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydeseq2_tpu.ops import dispersion as j_disp
from pydeseq2_tpu.ops import irls as j_irls
from pydeseq2_tpu.ops import linreg as j_lin
from pydeseq2_tpu.ops import nb as j_nb
from pydeseq2_tpu.ops import select as j_sel
from pydeseq2_tpu.ops import smalllinalg as j_sla
from pydeseq2_tpu.ops import stats as j_stats
from pydeseq2_tpu.ops import trend as j_trend
from pydeseq2_tpu.ops import wald as j_wald
from pydeseq2_tpu_torch.ops import dispersion as t_disp
from pydeseq2_tpu_torch.ops import irls as t_irls
from pydeseq2_tpu_torch.ops import linreg as t_lin
from pydeseq2_tpu_torch.ops import nb as t_nb
from pydeseq2_tpu_torch.ops import select as t_sel
from pydeseq2_tpu_torch.ops import smalllinalg as t_sla
from pydeseq2_tpu_torch.ops import stats as t_stats
from pydeseq2_tpu_torch.ops import trend as t_trend
from pydeseq2_tpu_torch.ops import wald as t_wald

torch.set_num_threads(1)  # xdist runs several workers on a few cores

DTYPES = {"f64": (np.float64, jnp.float64, torch.float64), "f32": (np.float32, jnp.float32, torch.float32)}
# Same expressions in both packages; only the summation order over samples
# and the library's last-ulp rounding differ.
RTOL = {"f64": 1e-10, "f32": 2e-5}


def _j(a, name):
    return jnp.asarray(np.asarray(a, DTYPES[name][0]))


def _t(a, name):
    return torch.as_tensor(np.asarray(a, DTYPES[name][0]))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def nb_data():
    """Counts and means of a few genes over both NB branches: dispersions
    from 1e-8 (r = 1e8) to 5, several straddling r = 8."""
    rng = np.random.default_rng(0)
    G, N = 24, 30
    mu = rng.lognormal(2.0, 1.5, size=(G, 1)) * rng.lognormal(0.0, 0.3, size=(G, N))
    alpha = np.concatenate([
        np.geomspace(1e-8, 5.0, G - 6),
        1.0 / 8.0 * np.array([1 - 1e-6, 1 - 1e-12, 1.0, 1 + 1e-12, 1 + 1e-6, 1 + 1e-3]),
    ])
    counts = rng.negative_binomial(1 / np.maximum(alpha[:, None], 1e-4),
                                   1 / (1 + np.maximum(alpha[:, None], 1e-4) * mu)).astype(float)
    X = np.column_stack([np.ones(N), rng.integers(0, 2, N)]).astype(float)
    return counts, mu, alpha, X


@pytest.fixture(scope="module")
def fit_data():
    """A 256 x 30 dataset with its linear-mu dispersion-stage inputs, one
    all-zero gene included."""
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
    return counts, X, sf, disp


@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("P", [1, 2, 3, 5])
def test_sym_linalg(P, name):
    rng = np.random.default_rng(P)
    A = rng.normal(size=(16, P + 3, P))
    M = np.einsum("gnp,gnq->gpq", A, A) + 0.1 * np.eye(P)
    b = rng.normal(size=(16, P))
    rtol = {"f64": 1e-10, "f32": 1e-4}[name]  # f32 closed forms of ill-conditioned M
    _close(t_sla.sym_solve(_t(M, name), _t(b, name)), j_sla.sym_solve(_j(M, name), _j(b, name)), rtol)
    _close(t_sla.sym_inv(_t(M, name)), j_sla.sym_inv(_j(M, name)), rtol)
    _close(t_sla.sym_logdet(_t(M, name)), j_sla.sym_logdet(_j(M, name)), rtol, atol=rtol)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_nb_forms(nb_data, name):
    counts, mu, alpha, _ = nb_data
    c, m, a = (_t(v, name) for v in (counts, mu, alpha))
    cj, mj, aj = (_j(v, name) for v in (counts, mu, alpha))
    rtol = RTOL[name]
    _close(t_nb.nb_nll(c, m, a), j_nb.nb_nll(cj, mj, aj), rtol)
    # The centred objective is compared on the scale of the raw NLL it was
    # centred from; each static branch on the lanes its callers give it
    # (plain for r < 8, stable for r >= 8), the lanes at r = 8 in both.
    scale = np.abs(_np(j_nb.nb_nll(cj, mj, aj)))
    r = 1.0 / alpha
    lanes = {"auto": r > 0, "plain": r < 8.0 * (1 + 1e-3), "stable": r > 8.0 * (1 - 1e-3)}
    for branch, sel in lanes.items():
        want = _np(j_nb.nb_nll_centered(cj, mj, aj, branch=branch))[sel]
        got = _np(t_nb.nb_nll_centered(c, m, a, branch=branch))[sel]
        assert np.all(np.abs(got - want) <= rtol * (scale[sel] + 1.0)), branch
    la = np.log(alpha)
    want = j_nb.nb_nll_centered_fgh(cj, mj, _j(la, name))
    got = t_nb.nb_nll_centered_fgh(c, m, _t(la, name))
    for g_, w_ in zip(got, want):
        w_ = _np(w_)
        assert np.all(np.abs(_np(g_) - w_) <= rtol * (np.abs(w_) + scale + 1.0))


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_gamma_function_forms(name):
    """The dtype-gated Stirling-8 lgamma/psi/psi' (f32) and library calls (f64)."""
    z = np.concatenate([np.geomspace(1e-3, 8.0, 50), np.geomspace(8.0, 2e6, 50)])
    zt, zj = _t(z, name), _j(z, name)
    rtol = RTOL[name]
    _close(t_nb._lgamma_fast(zt), j_nb._lgamma_fast(zj), rtol, atol=rtol)
    for g_, w_ in zip(t_nb._digamma_fast(zt), j_nb._digamma_fast(zj)):
        _close(g_, w_, rtol, atol=rtol)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_linreg(fit_data, name):
    counts, X, sf, _ = fit_data
    rtol = {"f64": 1e-9, "f32": 1e-4}[name]  # pinv by different SVD routines
    normed = counts / sf[None, :]
    _close(t_lin.fit_lin_mu_batch(_t(counts, name), _t(sf, name), _t(X, name)),
           j_lin.fit_lin_mu_batch(_j(counts, name), _j(sf, name), _j(X, name)), rtol)
    _close(t_lin.fit_rough_dispersions_batch(_t(normed, name), _t(X, name)),
           j_lin.fit_rough_dispersions_batch(_j(normed, name), _j(X, name)), rtol, atol=1e-6)
    _close(t_lin.fit_moments_dispersions_batch(_t(normed, name), _t(sf, name)),
           j_lin.fit_moments_dispersions_batch(_j(normed, name), _j(sf, name)), rtol, atol=1e-6)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_select_bit_identical(name):
    """Order statistics equal np.sort's element bit for bit: ties, +/-inf,
    signed zeros and excluded (+inf) entries."""
    rng = np.random.default_rng(5)
    G, N = 301, 7
    x = np.round(rng.normal(size=(G, N)), 1)  # many ties
    x[rng.random((G, N)) < 0.05] = -np.inf
    x[rng.random((G, N)) < 0.05] = np.inf
    x[rng.random((G, N)) < 0.05] = -0.0
    x[:, 6] = np.inf  # a column with nothing valid
    n_valid = np.isfinite(x).sum(0)
    ranks = (np.maximum((n_valid - 1) // 2, 0), n_valid // 2, np.full(N, 17))
    srt = np.sort(x.astype(DTYPES[name][0]), axis=0)
    got = t_sel.order_stats_select(_t(x, name), tuple(torch.as_tensor(k) for k in ranks), axis=0)
    want_j = j_sel.order_stats_select(_j(x, name), tuple(jnp.asarray(k) for k in ranks), axis=0)
    view = np.int64 if name == "f64" else np.int32
    for k, g_, wj in zip(ranks, got, want_j):
        want = srt[k, np.arange(N)]
        assert np.array_equal(_np(g_).view(view), np.asarray(wj).view(view))
        # np.sort orders -0.0 and 0.0 as equal; the key order puts -0.0 first.
        assert np.array_equal(_np(g_), want)
    med = t_sel.masked_median_select(_t(x, name), torch.as_tensor(n_valid), axis=0)
    med_j = j_sel.masked_median_select(_j(x, name), jnp.asarray(n_valid), axis=0)
    assert np.array_equal(_np(med), np.asarray(med_j), equal_nan=True)
    assert np.isnan(_np(med)[6])


def test_nanmedian_averages_the_middle_pair():
    """torch.nanmedian returns the lower middle value for an even count;
    the port's nanmedian averages the pair, as jnp.nanmedian does."""
    x = np.array([4.0, np.nan, 1.0, 3.0, 2.0, np.nan])
    assert float(torch.nanmedian(torch.as_tensor(x))) == 2.0
    assert float(t_stats.nanmedian(torch.as_tensor(x))) == float(jnp.nanmedian(jnp.asarray(x))) == 2.5
    assert math.isnan(float(t_stats.nanmedian(torch.full((4,), float("nan"), dtype=torch.float64))))


def test_trimmed_mean_masked():
    rng = np.random.default_rng(6)
    v = rng.lognormal(size=3001)
    sel = rng.random(3001) < 0.7
    _close(t_stats.trimmed_mean_masked(torch.as_tensor(v), torch.as_tensor(sel), 0.001),
           j_stats.trimmed_mean_masked(jnp.asarray(v), jnp.asarray(sel), 0.001), 1e-12)


def test_first_argmin_matches_jnp_argmin():
    """First minimum, and a NaN counts as the minimum (all-zero and padding
    lanes carry NaN objectives into the coarse-cache argmin)."""
    f = np.array([[3.0, 1.0, np.nan, 2.0, 5.0],
                  [1.0, 1.0, 0.0, np.nan, 5.0],
                  [1.0, 4.0, np.nan, 2.0, 5.0]])
    got = t_disp.first_argmin(torch.as_tensor(f))
    assert np.array_equal(_np(got), np.asarray(jnp.argmin(jnp.asarray(f), axis=0)))


@pytest.fixture(scope="module")
def disp_inputs(fit_data):
    counts, X, sf, disp = fit_data
    mu = np.maximum(np.asarray(j_lin.fit_lin_mu_batch(jnp.asarray(counts), jnp.asarray(sf), jnp.asarray(X))), 0.5)
    return counts, X, mu, disp


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_alpha_mle_genewise_and_map(disp_inputs, name):
    """Genewise fit with return_coarse, then MAP reusing the coarse cache.

    f64: the JAX package takes the autodiff (f, g, h) below N = 512 and the
    port the closed form; both are the same function, so alphas agree to
    1e-6 relative and flags exactly, except on the all-zero gene (lane 3):
    it runs to the max_disp bound, where one ulp of la decides whether the
    projected-gradient flag sees the bound (the pipeline masks that gene).
    f32: the two forms round differently near likelihood plateaus, so 97%
    of lanes within 1e-3 and the median lane within 5e-5.
    """
    counts, X, mu, disp = disp_inputs
    args_j = (_j(counts, name), _j(X, name), _j(mu, name), _j(disp, name), 1e-8, 30.0)
    args_t = (_t(counts, name), _t(X, name), _t(mu, name), _t(disp, name), 1e-8, 30.0)
    a_j, c_j, coarse_j = j_disp.alpha_mle_batch(*args_j, return_coarse=True)
    a_t, c_t, coarse_t = t_disp.alpha_mle_batch(*args_t, return_coarse=True)
    _close(coarse_t, coarse_j, RTOL[name] * 10, atol=RTOL[name] * 10 * np.abs(np.asarray(coarse_j)).max())
    m_j, mc_j = j_disp.alpha_mle_batch(*args_j, prior_disp_var=0.7, prior_reg=True, coarse_cache=coarse_j)
    m_t, mc_t = t_disp.alpha_mle_batch(*args_t, prior_disp_var=0.7, prior_reg=True, coarse_cache=coarse_t)
    for got, want, gc, wc in ((a_t, a_j, c_t, c_j), (m_t, m_j, mc_t, mc_j)):
        got, want = _np(got), np.asarray(want)
        rel = np.abs(got - want) / want
        if name == "f64":
            assert rel.max() < 1e-6, rel.max()
            keep = np.arange(len(got)) != 3
            assert np.array_equal(_np(gc)[keep], np.asarray(wc)[keep])
        else:
            assert np.mean(rel < 1e-3) > 0.97 and np.median(rel) < 5e-5, (np.mean(rel < 1e-3), np.median(rel))


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_alpha_mle_scan_without_cache_and_prior(disp_inputs, name):
    """The coarse scan itself with the prior (no cache): the same grid
    point on 99% of lanes (exp of the same la differs by a few ulps between
    the two libraries, hence 1e-12 in f64 and 1e-6 in f32)."""
    counts, X, mu, disp = disp_inputs
    kw = dict(prior_disp_var=0.5, prior_reg=True, newton_iters=0)
    a_j, _ = j_disp.alpha_mle_batch(_j(counts, name), _j(X, name), _j(mu, name), _j(disp, name), 1e-8, 30.0, **kw)
    a_t, _ = t_disp.alpha_mle_batch(_t(counts, name), _t(X, name), _t(mu, name), _t(disp, name), 1e-8, 30.0, **kw)
    rtol = 1e-12 if name == "f64" else 1e-6
    assert np.mean(np.isclose(_np(a_t), np.asarray(a_j), rtol=rtol, atol=0)) > 0.99


@pytest.fixture(scope="module")
def irls_inputs(fit_data):
    counts, X, sf, disp = fit_data
    beta_init = np.asarray(j_irls.irls_beta_init(jnp.asarray(counts), jnp.asarray(sf), jnp.asarray(X)))
    return counts, X, sf, disp, beta_init


@pytest.mark.parametrize("maxiter", [3, 250])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_irls_core(irls_inputs, name, maxiter):
    """Masked IRLS with the f32 step_tol stop and gradient-gated polish;
    maxiter=3 leaves lanes that hit the cap (flagged for the fallback).
    f64: the same flags and trip count, betas to 1e-8. f32: betas to 1e-4
    absolute (one IRLS step at the f32 stopping noise); a lane whose
    deviance ratio sits at beta_tol within f32 rounding may stop one trip
    apart. After 3 trips many lanes are at that threshold (1e-6 is a few
    f32 ulps of the deviance), so there the cap flags agree on 85%; run to
    the end they agree exactly."""
    counts, X, sf, disp, beta_init = irls_inputs
    bt = 1e-8 if name == "f64" else 1e-6
    out_j = j_irls.irls_core(_j(counts, name), _j(sf, name), _j(X, name), _j(disp, name),
                             _j(beta_init, name), beta_tol=bt, maxiter=maxiter, return_iters=True)
    out_t = t_irls.irls_core(_t(counts, name), _t(sf, name), _t(X, name), _t(disp, name),
                             _t(beta_init, name), beta_tol=bt, maxiter=maxiter, return_iters=True)
    atol = 1e-8 if name == "f64" else 1e-4
    _close(out_t[0], out_j[0], 0.0, atol=atol)
    agree = np.mean(_np(out_t[1]) == np.asarray(out_j[1]))
    assert agree >= (0.85 if (name, maxiter) == ("f32", 3) else 1.0), agree
    assert np.array_equal(_np(out_t[2]), ~_np(out_t[1]))
    assert int(out_t[3]) == int(out_j[3])
    if maxiter == 3:
        assert _np(out_t[1]).any()


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_irls_beta_init(fit_data, name):
    counts, X, sf, _ = fit_data
    rtol = {"f64": 1e-10, "f32": 1e-4}[name]
    _close(t_irls.irls_beta_init(_t(counts, name), _t(sf, name), _t(X, name)),
           j_irls.irls_beta_init(_j(counts, name), _j(sf, name), _j(X, name)), rtol, atol=rtol)


def _rescue_tile(irls_inputs):
    """12 lanes of the fit data; lane 5 holds one count of 969,890 among
    single digits (the outlier gene of chip_smoke.py's card-against-CPU
    summary), with its own IRLS start."""
    counts, X, sf, disp, beta_init = irls_inputs
    rng = np.random.default_rng(18)
    c, d, b0 = counts[:12].copy(), disp[:12].copy(), beta_init[:12].copy()
    c[5] = rng.integers(0, 10, c.shape[1])
    c[5, 4] = 969890.0
    d[5] = 0.5
    b0[5] = np.asarray(j_irls.irls_beta_init(jnp.asarray(c[5:6]), jnp.asarray(sf), jnp.asarray(X)))[0]
    return c, sf, X, d, b0


def _box_objective(counts, sf, X, disp, beta):
    """The rescue's ridged NB NLL in float64 (irls.py:308-317 plus the
    lgamma bulk, which cancels in comparisons)."""
    mu = np.maximum(sf[None, :] * np.exp(beta @ X.T), 0.5)
    return np.asarray(j_nb.nb_nll(jnp.asarray(counts), jnp.asarray(mu), jnp.asarray(disp))) + 0.5e-6 * (beta**2).sum(1)


def test_rescue_tiers(irls_inputs):
    """Projected-Newton box solver and the 2-D grid, on a few lanes (f64),
    the outlier lane among them. ``sel`` marks the lanes a caller uses; the
    plain versions ignore it, so every lane still equals JAX's."""
    args = _rescue_tile(irls_inputs)
    sel = torch.zeros(12, dtype=torch.bool)
    sel[[3, 5]] = True
    b_j, ok_j = j_irls.newton_box_nbglm(*(jnp.asarray(a) for a in args))
    b_t, ok_t = t_irls.newton_box_nbglm(*(torch.as_tensor(a) for a in args), sel=sel)
    _close(b_t, b_j, 1e-7, atol=1e-9)
    assert np.array_equal(_np(ok_t), np.asarray(ok_j))
    assert bool(ok_j[5])  # the outlier lane converges in f64
    g_j = j_irls.grid_fit_beta_batch(*(jnp.asarray(a) for a in args[:4]))
    g_t = t_irls.grid_fit_beta_batch(*(torch.as_tensor(a) for a in args[:4]), sel=sel)
    _close(g_t, g_j, 1e-12, atol=1e-12)


def test_rescue_tiers_f32(irls_inputs):
    """The rescue tiers in float32 against JAX's float32. The box solver's
    backtracking accepts a step where the f32 objective drops, i.e. at its
    rounding noise, which is ~1e-7 of the lane's count total (its terms are
    y log mu; ~1 at the outlier lane), and its exit test |projected
    gradient| < 1e-5 lies below the f32 gradient noise here, so flags are
    not compared; the coefficients must reach the same minimum: float64
    objectives within 1e-6 (1 + sum y) of each other. The grid may pick a
    neighbouring fine point (one step, 2/59 of a coarse step) where the two
    f32 objectives tie: within one fine step and with float64 objectives as
    close."""
    args = [np.asarray(a, np.float32) for a in _rescue_tile(irls_inputs)]
    c64, sf64, X64, d64 = (np.asarray(a, np.float64) for a in args[:4])
    b_j, _ = j_irls.newton_box_nbglm(*(jnp.asarray(a) for a in args))
    b_t, _ = t_irls.newton_box_nbglm(*(torch.as_tensor(a) for a in args))
    tol = 1e-6 * (1.0 + c64.sum(1))
    f_j = _box_objective(c64, sf64, X64, d64, np.asarray(b_j, np.float64))
    f_t = _box_objective(c64, sf64, X64, d64, _np(b_t).astype(np.float64))
    assert np.all(np.abs(f_t - f_j) <= tol)
    g_j = np.asarray(j_irls.grid_fit_beta_batch(*(jnp.asarray(a) for a in args[:4])), np.float64)
    g_t = _np(t_irls.grid_fit_beta_batch(*(torch.as_tensor(a) for a in args[:4]))).astype(np.float64)
    assert np.all(np.abs(g_t - g_j) <= 2.0 * (60.0 / 59.0) / 59.0 * 1.001)
    assert np.all(np.abs(_box_objective(c64, sf64, X64, d64, g_t) - _box_objective(c64, sf64, X64, d64, g_j)) <= tol)


@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("alt", [None, "greaterAbs", "lessAbs", "greater", "less"])
def test_hat_and_wald(irls_inputs, name, alt):
    counts, X, sf, disp, beta_init = irls_inputs
    beta = beta_init + 0.01
    rtol = RTOL[name] * 10
    H_t, mu_t = t_irls.hat_diagonals(_t(counts, name), _t(sf, name), _t(X, name), _t(disp, name), _t(beta, name))
    H_j, mu_j = j_irls.hat_diagonals(_j(counts, name), _j(sf, name), _j(X, name), _j(disp, name), _j(beta, name))
    _close(H_t, H_j, rtol, atol=rtol)
    _close(mu_t, mu_j, rtol)
    ridge = 1e-6 * np.eye(2)
    contrast = np.array([0.3, 1.0])
    out_t = t_wald.wald_test_batch(_t(X, name), _t(disp, name), _t(beta, name), mu_t, _t(ridge, name),
                                   _t(contrast, name), _t(0.2, name), alt)
    out_j = j_wald.wald_test_batch(_j(X, name), _j(disp, name), _j(beta, name), mu_j, _j(ridge, name),
                                   _j(contrast, name), _j(0.2, name), alt)
    for g_, w_ in zip(out_t, out_j):
        _close(g_, w_, rtol, atol=1e-300 if name == "f64" else 1e-30)


def test_trend_grad_matches_jax_grad():
    """The closed-form gradient of the trend loss equals jax.grad of the JAX
    loss, with lanes clamped below the 1e-12 bound and one exactly at it."""
    rng = np.random.default_rng(7)
    G = 200
    cov = rng.lognormal(-2, 1, size=G)
    cov[:3] = [0.0, 0.0, 1e-3]
    y = rng.lognormal(-2, 1, size=G)
    valid = rng.random(G) < 0.9
    valid[:3] = True
    x = np.stack([np.ones(G), cov], axis=1)

    def loss_j(c):
        mu_safe = jnp.maximum(jnp.asarray(x) @ c, 1e-12)
        per = jnp.asarray(y) / mu_safe + jnp.log(mu_safe)
        return jnp.sum(jnp.where(jnp.asarray(valid), per, 0.0)) / valid.sum()

    for c in ([1e-12, 2.0], [0.5, -1e3], [0.3, 0.7]):  # tie, clamped lanes, interior
        want = np.asarray(jax.grad(loss_j)(jnp.asarray(c)))
        xt = torch.as_tensor(x)
        n = torch.tensor(float(valid.sum()), dtype=torch.float64)
        got = t_trend.trend_grad(torch.tensor(c, dtype=torch.float64), xt, torch.as_tensor(y), torch.as_tensor(valid), n)
        _close(got, want, 1e-12, atol=1e-14)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_gamma_glm_trend_fit(name):
    rng = np.random.default_rng(8)
    G = 400
    mean = rng.lognormal(3, 1.5, size=G)
    y = (0.05 + 2.0 / mean) * rng.lognormal(0, 0.5, size=G)
    valid = rng.random(G) < 0.95
    c_j, p_j, ok_j = j_trend.gamma_glm_trend_fit(_j(1 / mean, name), _j(y, name), jnp.asarray(valid))
    c_t, p_t, ok_t = t_trend.gamma_glm_trend_fit(_t(1 / mean, name), _t(y, name), torch.as_tensor(valid))
    rtol = {"f64": 1e-8, "f32": 1e-3}[name]  # 2x2 solves by different LU routines
    _close(c_t, c_j, rtol)
    _close(p_t, p_j, rtol)
    assert bool(ok_t) == bool(ok_j)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_size_factors_ratio_and_poscounts(name):
    """Median-of-ratios and poscounts size factors, with a padding lane and
    zero-rich genes (the poscounts median is ragged per sample)."""
    from pydeseq2_tpu import fused as j_fused
    from pydeseq2_tpu_torch import fused as t_fused

    rng = np.random.default_rng(9)
    counts = rng.negative_binomial(2, 0.05, size=(300, 12)).astype(float)
    counts[rng.random(counts.shape) < 0.15] = 0.0
    mask = np.ones(300, bool)
    mask[4] = False
    rtol = {"f64": 1e-12, "f32": 1e-5}[name]
    sf_t, filt_t = t_fused._size_factors(_t(counts, name), torch.as_tensor(mask))
    sf_j, filt_j = j_fused._size_factors(_j(counts, name), jnp.asarray(mask))
    _close(sf_t, sf_j, rtol)
    assert np.array_equal(_np(filt_t), np.asarray(filt_j))
    _close(t_fused._poscounts_size_factors(_t(counts, name), torch.as_tensor(mask)),
           j_fused._poscounts_size_factors(_j(counts, name), jnp.asarray(mask)), rtol)


# --- summary slice: trimmed moments, Cook's, BH, lowess, padj, hat + Wald ---

from pydeseq2_tpu_torch.ops import cooks as t_cooks  # noqa: E402


def test_trigamma_f64_against_scipy():
    """The prior variance's trigamma((N - P) / 2) in float64 is the series
    of ``_psi_series_f64`` (torch.polygamma(1, .) is ~1e-9 relative off)."""
    from scipy.special import polygamma

    x = np.array([0.5, 1.0, 1.5, 4.0, 49.0])
    got = _np(t_nb._psi_series_f64(torch.as_tensor(x))[1])
    np.testing.assert_allclose(got, polygamma(1, x), rtol=1e-14, atol=0)


def _tied_cohort_data(n, seed):
    """(n, 40) sample-major normalised counts with heavy ties."""
    rng = np.random.default_rng(seed)
    return np.round(rng.lognormal(2.0, 1.0, size=(n, 40)) / 4.0) * 4.0 / rng.uniform(0.5, 2.0, size=(n, 1))


@pytest.mark.parametrize("n", [3, 10, 30, 1100])
def test_trimmed_variance(n):
    """Sort-slice trimmed moments against the JAX package's; n = 1100 takes
    its sort-free select path (same kept multiset, another summation order,
    hence 1e-12)."""
    x = _tied_cohort_data(n, n)
    _close(t_stats.trimmed_mean(torch.as_tensor(x), 0.125), j_stats.trimmed_mean(jnp.asarray(x), 0.125), 1e-12)
    _close(t_stats.trimmed_variance(torch.as_tensor(x)), j_stats.trimmed_variance(jnp.asarray(x)), 1e-12)


def test_trimmed_cell_variance_bins():
    """Cohorts of 3, 10 and 30 samples take the three (trim, scale) bins."""
    x = _tied_cohort_data(43, 11)
    cells = np.array([2] * 3 + [0] * 10 + [1] * 30)
    np.random.default_rng(12).shuffle(cells)
    _close(t_stats.trimmed_cell_variance(torch.as_tensor(x), cells),
           j_stats.trimmed_cell_variance(jnp.asarray(x), cells), 1e-12)


def _jax_cooks_block(counts, sf, mu, H, non_zero, P, cohort_ids, use_for_max, cutoff):
    """``pydeseq2_tpu/fused.py:695-716`` (inline in the JAX program)."""
    normed = counts / sf[None, :]
    if cohort_ids is not None:
        idx = np.where(np.asarray(use_for_max))[0]
        v = j_stats.trimmed_cell_variance(normed[:, idx].T, np.asarray(cohort_ids))
    else:
        v = j_stats.trimmed_variance(normed.T, axis=0)
    m = normed.mean(axis=1)
    disp_c = jnp.maximum((v - m) / m**2, 0.04)
    V = mu + disp_c[:, None] * mu**2
    cooks = (counts - mu) ** 2 / (V * P) * H / (1.0 - H) ** 2
    ufm = jnp.asarray(np.asarray(use_for_max), dtype=bool)
    flagged = (jnp.where(ufm[None, :], cooks, -jnp.inf) > cutoff).any(axis=1)
    max_count = jnp.take_along_axis(counts, jnp.argmax(cooks, axis=1)[:, None], axis=1)
    flagged = flagged & ((counts > max_count).sum(axis=1) < 3)
    return jnp.where(non_zero[:, None], cooks, jnp.nan), flagged & non_zero, disp_c


@pytest.mark.parametrize("layout", ["cohorts", "global", "global_1100"])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_cooks_outliers(name, layout):
    """Cook's distances, robust dispersion and outlier flags against the JAX
    block, with injected outliers, an all-zero gene and samples outside
    use_for_max. Cohorts of 3, 10 and 30 (the three bins) or one global
    cohort; 1100 samples take the JAX select path. f64: 1e-10 and equal
    flags; f32: 1e-4 (trimmed sums in another order feed (v - m) / m^2)."""
    rng = np.random.default_rng(13)
    N = 1100 if layout == "global_1100" else 48
    G = 60
    sf = np.exp(rng.normal(0, 0.2, N))
    mu = rng.lognormal(3.0, 1.0, size=(G, 1)) * sf[None, :]
    counts = rng.negative_binomial(5, 5 / (5 + mu)).astype(float)
    counts[:8, 0] = mu[:8, 0] * 40 + 100  # outliers
    counts[9] = 0.0
    H = rng.uniform(0.01, 0.3, size=(G, N))
    # Gene 8: the largest distance (high leverage) sits on a sample with 3
    # higher counts beside it, so the gene is not flagged.
    counts[8, :4] = mu[8, :4] * np.array([10, 40, 40, 40]) + 100
    H[8, :4] = [0.9, 0.001, 0.001, 0.001]
    non_zero = ~(counts == 0).all(axis=1)
    if layout == "cohorts":
        use_for_max = np.ones(N, bool)
        use_for_max[[1, 7, 20, 33, 40]] = False
        cohort_ids = tuple(int(c) for c in rng.permutation([5] * 3 + [2] * 10 + [9] * 30))
    else:
        use_for_max, cohort_ids = np.ones(N, bool), None
    cutoff = 4.8
    want = _jax_cooks_block(*(_j(a, name) for a in (counts, sf, mu, H)), jnp.asarray(non_zero), 2,
                            cohort_ids, tuple(use_for_max), _j(cutoff, name))
    got = t_cooks.cooks_outliers(*(_t(a, name) for a in (counts, sf, mu, H)), torch.as_tensor(non_zero), 2,
                                 cohort_ids, tuple(use_for_max), _t(cutoff, name))
    rtol = 1e-10 if name == "f64" else 1e-4
    assert np.array_equal(np.isnan(_np(got[0])), np.isnan(np.asarray(want[0])))
    _close(np.nan_to_num(_np(got[0])), np.nan_to_num(np.asarray(want[0])), rtol)
    _close(_np(got[2])[non_zero], np.asarray(want[2])[non_zero], rtol)
    assert np.array_equal(_np(got[1]), np.asarray(want[1]))
    assert _np(got[1])[:8].all() and not _np(got[1])[8:10].any()


def test_cohort_layout():
    """The kernel's cohort description: members in first-seen id order with
    their bin's (trim, scale), -1 outside use_for_max; None is one cohort
    of every sample with trimmed_variance's fixed 0.125 and 1.51."""
    use_for_max = (True, False, True, True, True, True, False, True, True)
    cohort, trims, scales = t_cooks.cohort_layout((7, 3, 7, 7, 3, 3, 3), use_for_max, 9)
    assert cohort == (0, -1, 1, 0, 0, 1, -1, 1, 1)
    assert trims == (1 / 3, 1 / 4) and scales == (2.04, 1.86)
    perm, offsets, ntrim, scale, ufm = t_cooks._layout_tensors(
        cohort, trims, scales, use_for_max, torch.device("cpu"), torch.float32)
    assert perm.tolist() == [0, 3, 4, 2, 5, 7, 8] and offsets.tolist() == [0, 3, 7]
    assert ntrim.tolist() == [1, 1] and scale.dtype == torch.float32 and ufm.tolist() == [int(u) for u in use_for_max]
    assert t_cooks.cohort_layout(None, (False,) * 5, 5) == ((0,) * 5, (0.125,), (1.51,))


def test_first_argmax_matches_jnp_argmax():
    f = np.array([[3.0, 5.0, np.nan, 5.0], [1.0, 1.0, 0.0, 1.0], [-np.inf, -np.inf, -np.inf, -np.inf]])
    got = t_cooks.first_argmax(torch.as_tensor(f))
    assert np.array_equal(_np(got), np.asarray(jnp.argmax(jnp.asarray(f), axis=1)))


def _bh_inputs(G=3000, seed=14):
    rng = np.random.default_rng(seed)
    p = np.where(rng.random(G) < 0.3, rng.uniform(0, 1e-3, G), rng.uniform(0, 1, G))
    p = np.round(p, 4)  # ties
    p[rng.random(G) < 0.05] = np.nan
    base_mean = np.where(rng.random(G) < 0.1, 0.0, rng.lognormal(2.0, 2.0, G))
    mask = rng.random(G) < 0.97
    return p, base_mean, mask


def test_bh_sweep_plain_against_bh_adjust_masked():
    """The sweep's plain version on a p with NaN inside the mask, one row
    and (50, G) rows over one shared order, with ties: a NaN p counts as
    unmasked, and the same products, quotients and minima as the JAX
    package's ``bh_adjust_masked`` give equal bits."""
    p, base_mean, mask = _bh_inputs()
    cut = np.quantile(base_mean, np.linspace(0, 0.95, 50))
    pt_ = torch.as_tensor(p)
    order = torch.argsort(pt_, stable=True)
    for label, bm, cuts, m in (
        ("1 row", None, None, mask[None, :]),
        ("50 rows", base_mean, cut, (base_mean[None, :] >= cut[:, None]) & mask[None, :]),
    ):
        got, num_rej = t_stats._bh_sweep_plain(
            pt_, order, torch.as_tensor(mask), None if bm is None else torch.as_tensor(bm),
            None if cuts is None else torch.as_tensor(cuts), 0.05)
        want = np.asarray(j_stats.bh_adjust_masked(jnp.asarray(p), jnp.asarray(m)))
        assert np.array_equal(_np(got), want, equal_nan=True), label
        assert np.array_equal(_np(num_rej), (want < 0.05).sum(1)), label
        assert np.nanmax(_np(got)) <= 1.0 and np.isnan(_np(got)[:, np.isnan(p)]).all(), label


def test_bh_sweep_matches_masked_bh():
    """The kernel's plain version: masks formed from base_mean and the
    cutoffs row by row, one shared stable order, rejection counts."""
    p, base_mean, mask = _bh_inputs()
    valid = ~np.isnan(p) & mask
    p_filled = np.nan_to_num(p, nan=1.0)
    cut = np.quantile(base_mean, np.linspace(0, 0.95, 50))
    pt_ = torch.as_tensor(p_filled)
    order = torch.argsort(pt_, stable=True)
    adj, num_rej = t_stats.bh_sweep(pt_, order, torch.as_tensor(valid), torch.as_tensor(base_mean),
                                    torch.as_tensor(cut), alpha=0.05)
    want = np.asarray(j_stats.bh_adjust_masked(
        jnp.asarray(p_filled), jnp.asarray((base_mean[None, :] >= cut[:, None]) & valid[None, :])))
    assert np.array_equal(_np(adj), want, equal_nan=True)
    assert np.array_equal(_np(num_rej), (want < 0.05).sum(1))
    adj1, _ = t_stats.bh_sweep(pt_, order, torch.as_tensor(valid))
    want1 = np.asarray(j_stats.bh_adjust_masked(jnp.asarray(p_filled), jnp.asarray(valid)))
    assert np.array_equal(_np(adj1)[0], want1, equal_nan=True)


def test_nanquantile_rounds_as_jnp():
    """JAX's "linear" quantile, lo (1 - w) + hi w, bit for bit (torch's
    lerp rounds differently), NaN ignored."""
    _, base_mean, mask = _bh_inputs()
    for name in ("f64", "f32"):
        x = np.where(mask, base_mean, np.nan)
        q = np.linspace(0.1, 0.95, 50)
        got = t_stats.nanquantile(_t(x, name), _t(q, name))
        want = jnp.nanquantile(_j(x, name), _j(q, name))
        assert np.array_equal(_np(got), np.asarray(want)), name


@pytest.mark.parametrize("kind", ["counts", "zeros"])
def test_lowess_device(kind):
    """50 points (the filtering grid), including all-zero targets, where
    the robustness weights vanish and both give the same NaN/finite mask."""
    rng = np.random.default_rng(15)
    theta = np.linspace(0.05, 0.95, 50)
    y = np.zeros(50) if kind == "zeros" else np.maximum(0, 400 * (1 - theta) + rng.normal(0, 20, 50)).round()
    got = t_stats.lowess_device(torch.as_tensor(theta), torch.as_tensor(y), frac=0.2)
    want = j_stats.lowess_device(jnp.asarray(theta), jnp.asarray(y), frac=0.2)
    assert np.array_equal(np.isnan(_np(got)), np.isnan(np.asarray(want)))
    _close(np.nan_to_num(_np(got)), np.nan_to_num(np.asarray(want)), 1e-12, atol=1e-9)


@pytest.mark.parametrize("independent_filter", [True, False])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_device_padj(name, independent_filter):
    """Both modes against ``pydeseq2_tpu.fused.device_padj`` with padding,
    zero base means and NaN p-values; > 10 rejections, so the lowess pick
    chooses the row. The adjustment is float64 in both whatever the input."""
    from pydeseq2_tpu import fused as j_fused
    from pydeseq2_tpu_torch import fused as t_fused

    p, base_mean, mask = _bh_inputs()
    got = t_fused.device_padj(_t(p, name), _t(base_mean, name), torch.as_tensor(mask), 0.05, independent_filter)
    want = np.asarray(j_fused.device_padj(_j(p, name), _j(base_mean, name), jnp.asarray(mask), 0.05,
                                          independent_filter))
    assert _np(got).dtype == want.dtype == np.float64
    assert np.array_equal(_np(got), want, equal_nan=True)
    assert np.sum(want < 0.05) > 10


def test_summary_host_inputs():
    """Equal dicts for a single-factor, a multi-factor (one cohort of 2),
    a continuous design (no cohort) and a DataFrame design."""
    import pandas as pd

    from pydeseq2_tpu.fused import summary_host_inputs as j_host
    from pydeseq2_tpu_torch.fused import summary_host_inputs as t_host

    rng = np.random.default_rng(16)
    cond = rng.integers(0, 2, 20).astype(float)
    group = np.r_[np.zeros(18), np.ones(2)]
    designs = [
        np.column_stack([np.ones(20), cond]),
        np.column_stack([np.ones(20), group, cond]),
        np.column_stack([np.ones(20), cond, rng.normal(size=20)]),
        pd.DataFrame({"intercept": np.ones(20), "cond": cond}),
    ]
    for X in designs:
        assert t_host(X) == j_host(X)


@pytest.mark.parametrize("alt", [None, "greaterAbs", "lessAbs", "greater", "less"])
@pytest.mark.parametrize("P", [2, 3, 5])
def test_hat_wald_plain(P, alt):
    """The ``hat_wald`` kernel's plain version against the JAX pair it
    replaces: hat_diagonals, then wald_test_batch on the UNthresholded mu,
    f64, every alternative hypothesis, a multi-entry contrast."""
    rng = np.random.default_rng(17 + P)
    G, N = 40, 24
    X = np.column_stack([np.ones(N), rng.integers(0, 2, (N, P - 2)), rng.normal(size=N)])
    beta = np.column_stack([rng.normal(2.0, 2.0, G), rng.normal(0, 0.5, (G, P - 1))])
    beta[:3, 0] = -4.0  # mu below min_mu: thresholded in H only
    disp = rng.lognormal(-2, 1, G)
    sf = np.exp(rng.normal(0, 0.2, N))
    contrast = np.r_[0.0, 0.5, np.ones(P - 2)]
    got = t_wald.hat_wald(*(torch.as_tensor(a) for a in (beta, disp, sf, X, contrast)), torch.tensor(0.1, dtype=torch.float64),
                          min_mu=0.5, alt_hypothesis=alt)
    H_j, mu_j = j_irls.hat_diagonals(None, *(jnp.asarray(a) for a in (sf, X, disp, beta)))
    want = (H_j, mu_j) + tuple(j_wald.wald_test_batch(
        jnp.asarray(X), jnp.asarray(disp), jnp.asarray(beta), mu_j, jnp.asarray(1e-6 * np.eye(P)),
        jnp.asarray(contrast), jnp.asarray(0.1), alt))
    assert np.any(_np(got[1]) < 0.5)
    for g_, w_ in zip(got, want):
        _close(g_, w_, 1e-10, atol=1e-300)


# --- streamed refit slice: mom, trend, lowess pick, imputation, refit bits ---

from pydeseq2_tpu_torch.ops import refit as t_refit  # noqa: E402


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_mom_and_mu_coef(fit_data, name):
    """The ``mom`` kernel's plain version against the JAX expressions it
    replaces (``fused_stream.py:289-314``): rough and moment dispersions of
    the normalised counts, the OLS coefficients against pinv(X) and the
    clamped linear mu, with an all-zero gene (moments 0/0 -> 0). Tolerance
    as ``test_linreg`` (pinv by different SVD routines)."""
    counts, X, sf, _ = fit_data
    rtol = {"f64": 1e-9, "f32": 1e-4}[name]
    c, s, x = _t(counts, name), _t(sf, name), _t(X, name)
    rough, moments, coef, mu = t_lin.mom_and_mu_coef(c, s, x, t_lin.ols_pinv(x), 0.5, want_mu=True)
    normed = _j(counts, name) / _j(sf, name)[None, :]
    coef_j = normed @ j_lin.ols_pinv(_j(X, name)).T
    _close(rough, j_lin.fit_rough_dispersions_batch(normed, _j(X, name)), rtol, atol=1e-6)
    _close(moments, j_lin.fit_moments_dispersions_batch(normed, _j(sf, name)), rtol, atol=1e-6)
    _close(coef, coef_j, rtol, atol=1e-6)
    _close(mu, jnp.maximum(_j(sf, name)[None, :] * (coef_j @ _j(X, name).T), 0.5), rtol)
    assert _np(moments)[3] == 0.0
    assert t_lin.mom_and_mu_coef(c, s, x, t_lin.ols_pinv(x), 0.5, want_mu=False)[3] is None


def _trend_data(kind):
    """Genewise dispersions on a 1/mean trend ("fit"), or flat ones whose
    fitted slope hits the 1e-10 floor, so the trend falls back to the mean
    ("fallback"); NaN and all-zero genes among them."""
    rng = np.random.default_rng(18)
    G = 500
    mean = rng.lognormal(3, 1.5, size=G)
    if kind == "fit":
        gw = (0.05 + 2.0 / mean) * rng.lognormal(0, 0.5, size=G)
    else:
        gw = 0.1 * (mean / mean.mean()) ** 0.3 * rng.lognormal(0, 0.3, size=G)
    non_zero = rng.random(G) < 0.97
    gw[~non_zero] = np.nan
    mean[~non_zero] = 0.0
    return mean, gw, non_zero


@pytest.mark.parametrize("kind", ["fit", "fallback"])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_fit_fused_trend(name, kind):
    """The ``trend`` kernel's plain version (every exclusion round and
    Newton trip) against ``pydeseq2_tpu.fused.fit_fused_trend``: the same
    failed flag and round count, coefficients and fitted values within
    1e-8 (f64) / 1e-3 (f32) (2 x 2 solves by different LU routines)."""
    from pydeseq2_tpu import fused as j_fused
    from pydeseq2_tpu_torch import fused as t_fused

    mean, gw, nz = _trend_data(kind)
    want = j_fused.fit_fused_trend(_j(mean, name), _j(gw, name), jnp.asarray(nz), 1e-8, "parametric",
                                   return_rounds=True)
    got = t_fused.fit_fused_trend(_t(mean, name), _t(gw, name), torch.as_tensor(nz), 1e-8, "parametric")
    rounds = t_trend.parametric_trend(_t(mean, name), _t(gw, name), torch.as_tensor(nz), got[3])[3]
    rtol = {"f64": 1e-8, "f32": 1e-3}[name]
    assert bool(got[2]) == bool(want[2]) == (kind == "fallback")
    assert int(rounds) == int(want[4])
    _close(got[1], want[1], rtol)
    _close(got[3], want[3], rtol)
    m = nz
    _close(_np(got[0])[m], np.asarray(want[0])[m], rtol)


def _jax_pick(theta, num_rej):
    """``lowess_device`` and the pick of ``pydeseq2_tpu/fused.py:763-768``."""
    rej = num_rej.astype(theta.dtype)
    lo = j_stats.lowess_device(theta, rej, frac=0.2)
    resid = jnp.where(num_rej > 0, rej - lo, jnp.nan)
    thresh = lo.max() - jnp.sqrt(jnp.nanmean(resid**2))
    above = num_rej > thresh
    j = jnp.where(above.any(), jnp.argmax(above), 0)
    return lo, jnp.where(num_rej.max() <= 10, 0, j)


@pytest.mark.parametrize("kind", ["counts", "zeros", "few"])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_lowess_pick(name, kind):
    """The ``lowess`` kernel's plain version: the fit and the cutoff row
    against the JAX expressions; every count 0 (NaN threshold) and counts
    never above 10 both pick row 0. Rejections that rise as filtering drops
    low-count genes, then level off, pick a later row. Tolerance on the fit
    1e-12 (f64) / 1e-3 (f32): XLA sums the 50 weights in another order, and
    the robustness weights (resid / 6 median) carry that rounding on."""
    rng = np.random.default_rng(19)
    theta = np.linspace(0.05, 0.95, 50)
    rising = 500 * np.minimum(theta / 0.4, 1.0) * (1 - 0.3 * theta) + rng.normal(0, 10, 50)
    rej = {"counts": np.maximum(0, rising).round(), "zeros": np.zeros(50),
           "few": rng.integers(0, 11, 50)}[kind].astype(np.int64)
    yest, j = t_stats.lowess_pick(_t(theta, name), torch.as_tensor(rej))
    lo, jj = _jax_pick(_j(theta, name), jnp.asarray(rej))
    assert np.array_equal(np.isnan(_np(yest)), np.isnan(np.asarray(lo)))
    _close(np.nan_to_num(_np(yest)), np.nan_to_num(np.asarray(lo)), {"f64": 1e-12, "f32": 1e-3}[name], atol=1e-6)
    assert int(j) == int(jj)
    assert (int(j) > 0) == (kind == "counts")


def _jax_words(bits):
    """The JAX package's uint32 exceed words (``fused_stream.py:427-433``)."""
    G, N = bits.shape
    n_words = -(-N // 32)
    padded = jnp.pad(jnp.asarray(bits), ((0, 0), (0, n_words * 32 - N)))
    weights = jnp.asarray([1 << k for k in range(32)], jnp.uint32)
    return np.asarray(jnp.sum(padded.reshape(-1, n_words, 32) * weights[None, None, :], axis=-1, dtype=jnp.uint32))


def test_exceed_bits_layout_matches_jax():
    """int32 words with the JAX package's uint32 bit pattern (bit k of word
    w: sample 32 w + k), a partial last word and bit 31 set, and back."""
    rng = np.random.default_rng(20)
    bits = rng.random((7, 70)) < 0.3
    bits[:, 31] = True
    words = t_cooks.pack_bits(torch.as_tensor(bits))
    assert words.dtype == torch.int32 and words.shape == (7, 3)
    assert np.array_equal(_np(words).view(np.uint32), _jax_words(bits))
    assert np.array_equal(_np(t_cooks.unpack_bits(words, 70)), bits)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_cooks_refit_outputs(name):
    """The refit-mode outputs of the Cook's block against the JAX
    expressions (``fused_stream.py:422-445``): exceed words bit for bit,
    ``replaced`` and ``cooks_outlier_refit`` equal; the distances are not
    written with ``want_distances=False``."""
    rng = np.random.default_rng(21)
    N, G = 48, 60
    sf = np.exp(rng.normal(0, 0.2, N))
    mu = rng.lognormal(3.0, 1.0, size=(G, 1)) * sf[None, :]
    counts = rng.negative_binomial(5, 5 / (5 + mu)).astype(float)
    counts[:8, 0] = mu[:8, 0] * 40 + 100
    counts[:4, 40] = mu[:4, 40] * 40 + 100  # outliers in a sample that is not replaceable
    counts[9] = 0.0
    H = rng.uniform(0.01, 0.3, size=(G, N))
    non_zero = ~(counts == 0).all(axis=1)
    use_for_max = np.ones(N, bool)
    use_for_max[[1, 7]] = False
    cohort_ids = tuple(int(c) for c in np.r_[[0] * 30, [1] * 16])
    replaceable = np.ones(N, bool)
    replaceable[40:] = False
    cutoff = 4.8
    args = [_t(a, name) for a in (counts, sf, mu, H)]
    got = t_cooks.cooks_outliers(*args, torch.as_tensor(non_zero), 2, cohort_ids, tuple(use_for_max),
                                 _t(cutoff, name), replaceable=tuple(replaceable), want_distances=False)
    assert got[0] is None and len(got) == 6
    # JAX: the raw distances of the block, then the refit-mode bits.
    cj = _j(counts, name)
    _, _, disp_c = _jax_cooks_block(cj, *(_j(a, name) for a in (sf, mu, H)), jnp.asarray(non_zero), 2,
                                    cohort_ids, tuple(use_for_max), _j(cutoff, name))
    muj, Hj = _j(mu, name), _j(H, name)
    cooks = (cj - muj) ** 2 / ((muj + disp_c[:, None] * muj**2) * 2) * Hj / (1.0 - Hj) ** 2
    exceeds = np.asarray(cooks > _j(cutoff, name))
    veto = (cj > jnp.take_along_axis(cj, jnp.argmax(cooks, axis=1)[:, None], axis=1)).sum(axis=1) < 3
    nr = jnp.asarray(use_for_max & ~replaceable)
    refit_flag = (jnp.where(nr[None, :], cooks, -jnp.inf) > _j(cutoff, name)).any(axis=1) & veto & non_zero
    assert np.array_equal(_np(got[3]).view(np.uint32), _jax_words(exceeds))
    assert np.array_equal(_np(got[4]), exceeds.any(axis=1) & non_zero)
    assert np.array_equal(_np(got[5]), np.asarray(refit_flag))
    assert _np(got[4])[:8].all() and _np(got[5])[:4].all() and not _np(got[5])[4:8].any()


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_impute_outliers(name):
    """The ``impute`` kernel's plain version against the JAX expressions
    (``fused_stream.py:563-573``): bits unpacked from the JAX words, the
    trimmed mean (0.2) of the normalised row, floor-imputed counts in
    replaceable samples only, and the all-zero flag on masked-in rows (row
    2 becomes all zero; rows 10-11 are padding)."""
    rng = np.random.default_rng(22)
    K, N = 12, 40
    sf = np.exp(rng.normal(0, 0.2, N))
    counts = rng.negative_binomial(3, 0.1, size=(K, N)).astype(float)
    bits = rng.random((K, N)) < 0.1
    counts[2] = 0.0
    counts[2, 5] = 1e6
    bits[2] = False
    bits[2, 5] = True
    replaceable = np.ones(N, bool)
    replaceable[30:] = False
    bits[:, 33] = True  # exceeds, not replaceable: kept
    tile_mask = np.arange(K) < 10
    words = _jax_words(bits)
    imputed, naz = t_refit.impute_outliers(_t(counts, name), torch.as_tensor(words.view(np.int32)),
                                           tuple(replaceable), _t(sf, name), torch.as_tensor(tile_mask))
    cj, sj = _j(counts, name), _j(sf, name)
    unpacked = ((jnp.asarray(words)[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1).reshape(K, -1)[:, :N]
    swap = jnp.asarray(replaceable)[None, :] & unpacked.astype(bool)
    trim02 = j_stats.trimmed_mean(cj / sj[None, :], trim=0.2, axis=1)
    want = jnp.where(swap, jnp.floor(trim02[:, None] * sj[None, :]), cj)
    assert np.array_equal(_np(imputed), np.asarray(want))
    assert np.array_equal(_np(naz), np.asarray((want == 0).all(axis=1) & tile_mask))
    assert _np(naz).tolist() == [i == 2 for i in range(K)]
