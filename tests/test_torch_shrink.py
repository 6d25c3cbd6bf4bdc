"""apeGLM shrinkage: the port's ``ops/shrink.py`` and ``run_lfc_shrink_streamed``
against the JAX package, CPU.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``pydeseq2_tpu_torch`` on CPU tensors, so the kernel
wrappers run their plain PyTorch versions (``chip_smoke.py`` holds the
``shrink`` and ``grid_apeglm`` kernels against those on the card).

Tolerances:
- objective, gradient, Hessian (f64): 1e-12 relative, on the scale of the
  largest entry of the lane (the gradient cancels near the optimum);
- Newton MAP fit, f64: identical ``converged``, coefficients and inverse
  Hessian to 1e-8 (both run the same steps; sums over samples differ in
  order); f32: coefficients to 1e-4 absolute where both converge and
  ``converged`` on 99% of the lanes (the backtracking accept and the
  |g| < 1e-6 flag sit at the f32 rounding noise of the objective and
  gradient; an unconverged lane stops where that noise stops it: gene 2,
  one count of 1e6, ends 0.03 apart);
- the 2-D grid, f64: 1e-12 (the same grid points win), on the draw's
  design, on an intercept with a continuous covariate and on the two
  conditions' indicators;
- the streamed slice, f64: rtol 1e-6 on every key, identical NaN masks and
  flags (as the pipeline tests);
- against R's apeGLM: ``tests/test_shrinkage.py``'s 2% on log2 fold changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu_torch as pt
from pydeseq2_tpu.fused import summary_host_inputs as jax_host_inputs
from pydeseq2_tpu.fused import summary_pipeline as jax_summary_pipeline
from pydeseq2_tpu.fused_stream import run_lfc_shrink_streamed as jax_run_shrink
from pydeseq2_tpu.ops import shrink as j_shrink
from pydeseq2_tpu_torch import fused_stream as t_stream
from pydeseq2_tpu_torch.ops import shrink as t_shrink
from pydeseq2_tpu_torch.ops.shrink import _apeglm_prior_variance
from pydeseq2_tpu_torch.synthetic import make_data

torch.set_num_threads(1)  # xdist runs several workers on a few cores

_NP = {"f64": np.float64, "f32": np.float32}
PNS, PS = 15.0, 0.4


def _draw(n_samples, n_genes, lfc_sd, seed):
    """(counts (G, N), design (N, 2)) of ``make_data`` with fold changes of
    standard deviation ``lfc_sd``."""
    counts, X = make_data(n_samples, n_genes, seed=seed, lfc_sd=lfc_sd)
    return counts.T.copy(), X


@pytest.fixture(scope="module")
def shrink_inputs():
    """300 genes x 20 samples with their size, offset and random
    coefficients; gene 2 holds one count of 1e6 among zeros, gene 5 is all
    zero."""
    counts, X = _draw(20, 300, 0.5, 11)
    counts[2] = 0.0
    counts[2, 0] = 1e6
    counts[5] = 0.0
    rng = np.random.default_rng(12)
    size = 1.0 / np.clip(rng.lognormal(-2, 1, 300), 1e-3, 5.0)
    offset = rng.normal(0, 0.2, 20)
    beta = rng.normal(0, 2.0, (300, 2))
    return counts, X, size, offset, beta


def _args(inputs, name, lib):
    counts, X, size, offset, _ = inputs
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return tuple(conv(np.asarray(a, _NP[name])) for a in (X, counts, size, offset))


@pytest.mark.parametrize("fn", ["nbinom_fn_batch", "_grad", "_hess"])
def test_objective_gradient_hessian_f64(shrink_inputs, fn):
    X, counts, size, offset = _args(shrink_inputs, "f64", "jax")
    beta = shrink_inputs[4]
    want = np.asarray(getattr(j_shrink, fn)(jnp.asarray(beta), X, counts, size, offset, PNS, PS, 1))
    Xt, ct, st, ot = _args(shrink_inputs, "f64", "torch")
    got = getattr(t_shrink, fn)(torch.as_tensor(beta), Xt, ct, st, ot, PNS, PS, 1).numpy()
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    scale = scale.reshape((-1,) + (1,) * (want.ndim - 1))
    assert np.all(np.abs(got - want) <= 1e-12 * scale)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_nbinom_glm_batch(shrink_inputs, name):
    bj, ihj, cj = (np.asarray(a) for a in j_shrink.nbinom_glm_batch(*_args(shrink_inputs, name, "jax"), PNS, PS, 1))
    bt, iht, ct = (a.numpy() for a in t_shrink.nbinom_glm_batch(*_args(shrink_inputs, name, "torch"), PNS, PS, 1))
    if name == "f64":
        assert np.array_equal(ct, cj)
        np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-8)
        np.testing.assert_allclose(iht, ihj, rtol=1e-8, atol=1e-12)
    else:
        both = ct & cj
        np.testing.assert_allclose(bt[both], bj[both], rtol=0, atol=1e-4)
        assert np.mean(ct == cj) >= 0.99
    assert cj.mean() > 0.9


def test_grid_fit_shrink_beta_batch_f64(shrink_inputs):
    """The grid on 24 lanes, the extreme genes 2 and 5 among them, with the
    pipeline's scale (the objective at 0, floored at 1)."""
    X, counts, size, offset = _args(shrink_inputs, "f64", "jax")
    sl = slice(0, 24)
    cnst = jnp.maximum(j_shrink.nbinom_fn_batch(jnp.zeros((24, 2)), X, counts[sl], size[sl], offset, PNS, PS, 1), 1.0)
    want = np.asarray(j_shrink.grid_fit_shrink_beta_batch(counts[sl], offset, X, size[sl], PNS, PS, cnst))
    Xt, ct, st, ot = _args(shrink_inputs, "f64", "torch")
    got = t_shrink.grid_fit_shrink_beta_batch(ct[sl], ot, Xt, st[sl], PNS, PS, torch.as_tensor(np.array(cnst)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("design", ["continuous", "zero-first"])
def test_grid_fit_shrink_beta_batch_designs_f64(shrink_inputs, design):
    """The grid on the same 24 lanes with a design whose rows hold no zero
    (an intercept and a continuous covariate) and one with a zero in the
    first column (the two conditions' indicators): the CUDA kernel skips
    by-independent terms by design row, and its plain version must hold to
    JAX on either."""
    counts, X, size, offset, _ = shrink_inputs
    if design == "continuous":
        X = np.column_stack([np.ones(X.shape[0]), np.random.default_rng(14).normal(0.0, 1.0, X.shape[0])])
    else:
        X = np.column_stack([1.0 - X[:, 1], X[:, 1]])
    sl = slice(0, 24)
    Xj, cj, sj, oj = (jnp.asarray(np.asarray(a, np.float64)) for a in (X, counts, size, offset))
    cnst = jnp.maximum(j_shrink.nbinom_fn_batch(jnp.zeros((24, 2)), Xj, cj[sl], sj[sl], oj, PNS, PS, 1), 1.0)
    want = np.asarray(j_shrink.grid_fit_shrink_beta_batch(cj[sl], oj, Xj, sj[sl], PNS, PS, cnst))
    Xt, ct, st, ot = (torch.as_tensor(np.asarray(a, np.float64)) for a in (X, counts, size, offset))
    got = t_shrink.grid_fit_shrink_beta_batch(ct[sl], ot, Xt, st[sl], PNS, PS, torch.as_tensor(np.array(cnst)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_apeglm_prior_variance():
    from pydeseq2_tpu.models.stats import _apeglm_prior_variance as jax_prior_variance

    rng = np.random.default_rng(13)
    lfc = rng.normal(0, 0.4, 500)
    lfc[:7] = np.nan
    se = rng.uniform(0.05, 0.5, 500)
    assert _apeglm_prior_variance(lfc, se) == jax_prior_variance(lfc, se)
    assert _apeglm_prior_variance(np.zeros(10), np.ones(10)) == 1e-6  # g(lo) < 0


@pytest.fixture(scope="module")
def slice_inputs():
    """600 genes x 20 samples, fold changes of SD 0.2 (two genes fail
    Newton under the fitted prior), one count of 1e6 among zeros (gene 2)
    and an all-zero gene (5), through JAX's f64 ``summary_pipeline``."""
    counts, X = _draw(20, 600, 0.2, 1)
    counts[2] = 0.0
    counts[2, 0] = 1e6
    counts[5] = 0.0
    host = jax_host_inputs(X)
    out = jax.device_get(jax_summary_pipeline(
        jnp.asarray(counts), jnp.asarray(X), jnp.asarray([0.0, 1.0]), jnp.asarray(0.0),
        jnp.asarray(host["cooks_cutoff"]), cohort_ids=host["cohort_ids"], use_for_max=host["use_for_max"],
        max_disp=20.0,
    ))
    return counts, X, out


def test_streamed_shrink_slice_f64(slice_inputs, monkeypatch):
    """The port's ``run_lfc_shrink_streamed(device="cpu")`` against JAX's:
    three blocks of 256 (a padded tail of 168 lanes), the adaptive prior,
    and failed Newton lanes that both sides hand to the grid."""
    counts, X, out = slice_inputs
    kw = dict(mle_lfc=out["lfc"][:, 1], mle_se=out["se"], gene_block=256, dtype=np.float64)
    want = jax_run_shrink(counts, X, 1, out["dispersions"], out["size_factors"], **kw)

    grid_lanes = []
    grid = t_stream.grid_fit_shrink_beta_batch

    def counted(*args, sel=None, **kwargs):
        grid_lanes.append(int(sel.sum()))
        return grid(*args, sel=sel, **kwargs)

    monkeypatch.setattr(t_stream, "grid_fit_shrink_beta_batch", counted)
    got = pt.run_lfc_shrink_streamed(counts, X, 1, out["dispersions"], out["size_factors"], device="cpu", **kw)
    assert got.keys() == want.keys()
    assert got["gene_block"] == want["gene_block"] == 256
    assert got["prior_scale"] == want["prior_scale"]
    for k in ("lfc", "se", "converged"):
        a, b = np.asarray(want[k]), got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            assert np.array_equal(np.isnan(a), np.isnan(b)), k
            m = ~np.isnan(a)
            np.testing.assert_allclose(b[m], a[m], rtol=1e-6, atol=1e-300, err_msg=k)
        else:
            assert np.array_equal(a, b), k
    failed = ~want["converged"] & np.isfinite(out["dispersions"])
    assert failed.any() and sum(grid_lanes) == failed.sum()
    assert np.isnan(got["lfc"][5]).all() and np.isnan(got["se"][5])


def test_streamed_shrink_default_block_f32(slice_inputs):
    """The default ``gene_block`` (one block of 600 here) in float32:
    shrunk LFCs within 1e-3 of JAX's f32 run (f32 Newton stalls at its
    rounding noise, ``test_nbinom_glm_batch``), the same NaN mask."""
    counts, X, out = slice_inputs
    kw = dict(mle_lfc=out["lfc"][:, 1], mle_se=out["se"], dtype=np.float32)
    want = jax_run_shrink(counts, X, 1, out["dispersions"], out["size_factors"], **kw)
    got = pt.run_lfc_shrink_streamed(counts, X, 1, out["dispersions"], out["size_factors"], device="cpu",
                                     dtype=torch.float32, **{k: v for k, v in kw.items() if k != "dtype"})
    assert got["gene_block"] == want["gene_block"] == 600
    assert got["lfc"].dtype == np.float32
    assert np.array_equal(np.isnan(got["lfc"]), np.isnan(want["lfc"]))
    m = ~np.isnan(want["lfc"][:, 1]) & want["converged"]
    np.testing.assert_allclose(got["lfc"][m, 1], want["lfc"][m, 1], rtol=0, atol=1e-3)


def test_shrink_against_r_golden(counts_df, metadata):
    """apeGLM on the single-factor fixture with the inputs of the JAX class
    API (dispersions, size factors, MLE LFC and SE), as
    ``tests/test_fused_stream.py`` builds them, against R at 2%."""
    from conftest import data_path
    from pydeseq2_tpu import DeseqDataSet, DeseqStats

    dds = DeseqDataSet(counts=counts_df, metadata=metadata, design="~condition", refit_cooks=False, quiet=True)
    dds.deseq2()
    ds = DeseqStats(dds, contrast=["condition", "B", "A"], quiet=True)
    ds.summary()
    ci = int(ds.LFC.columns.get_loc("condition[T.B]"))
    out = pt.run_lfc_shrink_streamed(
        counts_df.values.T.astype(float), dds.obsm["design_matrix"], ci, dds.var["dispersions"].values,
        dds.obs["size_factors"].values, mle_lfc=ds.LFC.values[:, ci].copy(), mle_se=ds.SE.values.copy(),
        gene_block=4, dtype=np.float64, device="cpu",
    )
    r = pd.read_csv(data_path("single_factor", "r_test_lfc_shrink_res.csv"), index_col=0)
    got = out["lfc"][:, ci] / np.log(2)
    assert (np.abs(r.log2FoldChange.values - got) / np.abs(r.log2FoldChange.values)).max() < 0.02


def test_shrink_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    counts, X = _draw(6, 20, 0.5, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.run_lfc_shrink_streamed(counts, X, 1, np.full(20, 0.1), np.ones(6), adapt=False)
