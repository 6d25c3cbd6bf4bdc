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


def test_rescue_tiers(irls_inputs):
    """Projected-Newton box solver and the 2-D grid, on a few lanes (f64)."""
    counts, X, sf, disp, beta_init = irls_inputs
    sl = slice(0, 12)
    args = (counts[sl], sf, X, disp[sl])
    b_j, ok_j = j_irls.newton_box_nbglm(*(jnp.asarray(a) for a in args), jnp.asarray(beta_init[sl]))
    b_t, ok_t = t_irls.newton_box_nbglm(*(torch.as_tensor(a) for a in args), torch.as_tensor(beta_init[sl]))
    _close(b_t, b_j, 1e-7, atol=1e-9)
    assert np.array_equal(_np(ok_t), np.asarray(ok_j))
    g_j = j_irls.grid_fit_beta_batch(*(jnp.asarray(a) for a in args))
    g_t = t_irls.grid_fit_beta_batch(*(torch.as_tensor(a) for a in args))
    _close(g_t, g_j, 1e-12, atol=1e-12)


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
