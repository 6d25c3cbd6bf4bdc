"""TorchInference's eight methods against JaxInference, and the trimmed
statistics against the JAX package's, CPU.

The same numpy inputs go through ``pydeseq2_tpu.jax_inference.JaxInference``
(float64) and ``pydeseq2_tpu_torch.TorchInference(device="cpu")``, whose
kernel wrappers run their plain PyTorch versions. Inputs: a negative-binomial
draw of 60 samples x 240 genes over a two-factor design (seed 7), with a few
extreme counts so that some IRLS lanes need the rescue tiers; size factors,
MoM dispersions and mu come from JaxInference itself, so each method sees
the operands the class API hands it.

Tolerances: rtol 1e-6 on floats (atol 1e-12 where a value may be ~0),
flags exact, as the earlier slices are held, but for the ties each test
states.
"""

import math

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu.ops.stats as j_stats
import pydeseq2_tpu_torch.ops.stats as t_stats
from pydeseq2_tpu.jax_inference import JaxInference
from pydeseq2_tpu.preprocessing import deseq2_norm
from pydeseq2_tpu_torch import DefaultInference, TorchInference
from pydeseq2_tpu_torch.ops.shrink import nbinom_fn_batch

torch.set_num_threads(1)  # xdist runs several workers on a few cores

N, G = 60, 240


@pytest.fixture(scope="module")
def study():
    rng = np.random.default_rng(7)
    cond = np.repeat([0.0, 1.0], N // 2)
    group = np.tile([0.0, 1.0, 1.0], N // 3)
    X = np.stack([np.ones(N), group, cond], axis=1)
    base = rng.lognormal(3.0, 1.5, G)
    lfc = rng.normal(0.0, 0.8, G)
    mu = base[None, :] * np.exp(np.outer(cond, lfc)) * rng.lognormal(0.0, 0.2, N)[:, None]
    disp = rng.uniform(0.02, 0.6, G)
    counts = rng.negative_binomial(1.0 / disp[None, :], 1.0 / (1.0 + mu * disp[None, :])).astype(np.int64)
    counts[:, 0] = 0
    counts[3, 5], counts[40, 9] = 50000, 0
    counts[:, 11] = 0
    counts[7, 11] = 900  # one non-zero sample: a lane the IRLS leaves to the rescue tiers
    counts = counts[:, (counts > 0).any(axis=0)]
    _, sf = deseq2_norm(pd.DataFrame(counts + 1))
    sf = np.asarray(sf)
    normed = counts / sf[:, None]
    jinf = JaxInference(dtype=jnp.float64)
    mom = np.clip(np.minimum(jinf.fit_rough_dispersions(normed, X), jinf.fit_moments_dispersions(normed, sf)),
                  1e-8, 10.0)
    mu_hat = jinf.lin_reg_mu(counts, sf, X, 0.5)
    genewise = np.clip(jinf.alpha_mle(counts, X, mu_hat, mom, 1e-8, float(N))[0], 1e-8, float(N))
    return {"counts": counts, "X": X, "sf": sf, "normed": normed, "mom": mom, "mu_hat": mu_hat,
            "genewise": genewise, "jinf": jinf, "tinf": TorchInference(device="cpu")}


def _close(got, want, rtol=1e-6, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def test_defaults_are_float64():
    """float64 unless told otherwise (on "cuda" unless told otherwise:
    ``test_torch_imports.py::test_default_device_raises_without_cuda``)."""
    assert TorchInference(device="cpu").dtype == torch.float64
    assert DefaultInference(device="cpu", dtype=np.float32).dtype == torch.float32


def test_lin_reg_mu(study):
    s = study
    got = s["tinf"].lin_reg_mu(s["counts"], s["sf"], s["X"], 0.5)
    assert isinstance(got, torch.Tensor) and got.shape == (N, s["counts"].shape[1])
    _close(got, s["mu_hat"])


def test_moments_methods(study):
    s, j = study, study["jinf"]
    _close(s["tinf"].fit_rough_dispersions(s["normed"], s["X"]), j.fit_rough_dispersions(s["normed"], s["X"]),
           atol=1e-12)
    _close(s["tinf"].fit_moments_dispersions(s["normed"], s["sf"]), j.fit_moments_dispersions(s["normed"], s["sf"]),
           atol=1e-12)
    with pytest.raises(ValueError, match="no replicates"):
        s["tinf"].fit_rough_dispersions(s["normed"][:3], s["X"][:3])


def test_gene_major_operands_need_no_copy(study):
    """A (N, G) tensor that transposes a contiguous (G, N) one, as the
    methods return, goes back in without a copy."""
    t = torch.as_tensor(study["counts"].T.astype(np.float64)).contiguous()
    assert study["tinf"]._gene_major(t.T).data_ptr() == t.data_ptr()


@pytest.mark.parametrize("design", ["full_rank", "rank_deficient"])
def test_irls(study, design):
    s, j = study, study["jinf"]
    X = s["X"] if design == "full_rank" else np.concatenate([s["X"], s["X"][:, 2:]], axis=1)
    disp = s["mom"]
    want = j.irls(s["counts"], s["sf"], X, disp, 0.5, 1e-8)
    got = s["tinf"].irls(s["counts"], s["sf"], X, disp, 0.5, 1e-8)
    assert all(isinstance(a, torch.Tensor) for a in got)
    if design == "full_rank":
        assert not want[3].all(), "expected lanes that the IRLS leaves to the rescue tiers"
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    _close(got[0], want[0], atol=1e-9)
    _close(got[1], want[1])
    _close(got[2], want[2], atol=1e-12)


@pytest.mark.parametrize("kind", ["genewise", "map"])
def test_alpha_mle(study, kind):
    """Flags exact but on a lane pinned at max_disp: there the JAX package
    polishes with autodiff (f, g, h) below 512 samples and the port with the
    closed form, which round apart, and the last Newton step lands on the
    bound (projected gradient 0, converged) or a few ulps below it (the
    planted one-sample lane: JAX 59.99999999999993, the port 60)."""
    s, j = study, study["jinf"]
    kw = {} if kind == "genewise" else {"prior_disp_var": 0.4, "cr_reg": True, "prior_reg": True}
    want = j.alpha_mle(s["counts"], s["X"], s["mu_hat"], s["mom"], 1e-8, float(N), **kw)
    got = s["tinf"].alpha_mle(s["counts"], s["X"], s["mu_hat"], s["mom"], 1e-8, float(N), **kw)
    _close(got[0], want[0])
    differ = got[1].numpy() != want[1]
    at_bound = np.isclose(want[0], float(N), rtol=1e-12)
    assert not (differ & ~at_bound).any()


@pytest.mark.parametrize("alt", [None, "greaterAbs", "lessAbs", "greater", "less"])
def test_wald_test(study, alt):
    s, j = study, study["jinf"]
    beta, mu, _, _ = j.irls(s["counts"], s["sf"], s["X"], s["mom"], 0.5, 1e-8)
    ridge = np.diag(1.0 / np.square([2.0, 1.5, 0.8]))  # a prior-LFC ridge, as DeseqStats passes
    contrast = np.array([0.0, 0.0, 1.0])
    lfc_null = 0.3 if alt is not None else 0.0
    want = j.wald_test(s["X"], s["mom"], beta, mu, ridge, contrast, lfc_null, alt)
    got = s["tinf"].wald_test(s["X"], s["mom"], beta, mu, ridge, contrast, lfc_null, alt)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-14)


def test_dispersion_trend_gamma_glm(study):
    s, j = study, study["jinf"]
    means = s["normed"].mean(0)
    alphas, _ = j.alpha_mle(s["counts"], s["X"], s["mu_hat"], s["mom"], 1e-8, float(N))
    cov = pd.Series(1.0 / means)
    cov.iloc[4] = np.inf  # non-finite lanes are left out of the fit
    want = j.dispersion_trend_gamma_glm(cov, pd.Series(alphas))
    got = s["tinf"].dispersion_trend_gamma_glm(cov, pd.Series(alphas))
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert bool(got[2]) == want[2]


@pytest.mark.parametrize("prior_scale", [1.0, 0.02])
def test_lfc_shrink_nbinom_glm(study, prior_scale):
    """Shrink index 2 of the three-column design (no grid), then of the
    intercept + condition design with a narrow prior, where Newton leaves
    lanes to the apeGLM grid, with the genewise dispersions DeseqStats
    passes. A lane at min_disp (size 1e8) has an objective of ~1e11, where
    Newton's stop, relative to |f|, fires with gradients of ~1e-4 left and
    the two sides stop at different such points: those lanes are held on
    the objective (rtol 1e-9, the stop's own tolerance), the rest on beta."""
    s, j = study, study["jinf"]
    X = s["X"] if prior_scale == 1.0 else s["X"][:, [0, 2]]
    si = X.shape[1] - 1
    args = (X, s["counts"], 1.0 / s["genewise"], np.log(s["sf"]), 15.0, prior_scale, "L-BFGS-B", si)
    want = j.lfc_shrink_nbinom_glm(*args)
    got = s["tinf"].lfc_shrink_nbinom_glm(*args)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    if prior_scale != 1.0:
        assert not want[2].all(), "expected lanes that Newton leaves to the grid"
    flat = s["genewise"] <= 1e-6
    _close(got[0][~flat], want[0][~flat], atol=1e-9)
    _close(got[1][~flat], want[1][~flat], atol=1e-12)
    t = [torch.as_tensor(a) for a in (X, s["counts"].T[flat].astype(float), 1.0 / s["genewise"][flat],
                                      np.log(s["sf"]))]
    f_got, f_want = (nbinom_fn_batch(torch.as_tensor(b[flat]), t[0], t[1], t[2], t[3], 15.0, prior_scale, si)
                     for b in (got[0].numpy(), want[0]))
    _close(f_got, f_want, rtol=1e-9)


def _tied(n, g, seed):
    """(n, g) normalised-count-like values with heavy ties."""
    rng = np.random.default_rng(seed)
    return np.round(rng.lognormal(2.0, 1.0, size=(n, g)) / 4.0) * 4.0 / rng.uniform(0.5, 2.0, size=(n, 1))


@pytest.mark.parametrize("n", [50, 1500])
def test_trimmed_statistics_match_jax(n):
    """n = 50 takes JAX's sort path, n = 1500 its select path; the port's
    plain versions follow each (the kept sums in float64, hence 1e-12)."""
    x = _tied(n, 9, n)
    for trim in (0.1, 0.125, 0.2):
        _close(t_stats.trimmed_mean(torch.as_tensor(x), trim), j_stats.trimmed_mean(jnp.asarray(x), trim), 1e-12)
    _close(t_stats.trimmed_variance(torch.as_tensor(x)), j_stats.trimmed_variance(jnp.asarray(x)), 1e-12)
    cells = np.random.default_rng(n).integers(0, 3, n)
    cells[:3] = [0, 1, 2]
    _close(t_stats.trimmed_cell_variance(torch.as_tensor(x), cells),
           j_stats.trimmed_cell_variance(jnp.asarray(x), cells), 1e-12)


@pytest.mark.parametrize("g", [500, 3000])
def test_trim_mean_and_mad_of_a_column(g):
    """The mean trend's 0.001-trimmed mean over one column of dispersions
    and the prior's MAD, with jnp.median's NaN propagation."""
    v = np.random.default_rng(g).lognormal(-2.0, 1.0, g)
    _close(t_stats.scipy_style_trim_mean(torch.as_tensor(v), 0.001),
           j_stats.scipy_style_trim_mean(jnp.asarray(v), 0.001), 1e-12)
    _close(t_stats.mean_absolute_deviation(torch.as_tensor(np.log(v))),
           j_stats.mean_absolute_deviation(jnp.asarray(np.log(v))), 1e-12)
    v[3] = np.nan
    assert math.isnan(float(t_stats.mean_absolute_deviation(torch.as_tensor(v))))
    assert math.isnan(float(j_stats.mean_absolute_deviation(jnp.asarray(v))))


def test_operands_are_contiguous(study):
    """The kernels take contiguous operands: a design from pandas is
    column-major, and the backend hands it over row-major."""
    X = np.asfortranarray(study["X"])
    assert not X.flags.c_contiguous
    assert study["tinf"]._t(X).is_contiguous()
    t = torch.as_tensor(study["counts"].T.astype(np.float64)).contiguous()
    assert study["tinf"]._gene_major(t.T).is_contiguous()
