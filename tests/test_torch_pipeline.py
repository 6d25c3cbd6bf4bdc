"""Whole-slice parity: the port's ``wald_pipeline`` against the JAX one, CPU.

Each case feeds the same numpy inputs to ``pydeseq2_tpu.fused.wald_pipeline``
and to ``pydeseq2_tpu_torch.wald_pipeline(device="cpu")`` and compares the
output dicts key by key. JAX programs are compiled once per module fixture.

Tolerances:
- f64: rtol 1e-6 on every float output (dispersions, LFC, SE, statistics,
  p-values included), identical NaN masks, identical ``irls_converged``,
  ``rescue_overflow`` and ``trend_used_mean``. Both sides evaluate the same
  expressions; what remains is summation order and the JAX package's
  autodiff (f, g, h) below N = 512 against the port's closed form.
- f32 port against JAX f32: p < 0.05 calls agree on > 99% of genes and the
  median relative statistic error is < 1e-3 (f32 rounding of the
  dispersion optima on likelihood plateaus moves a few genes).
- f32 port against JAX f64: the bar of ``tests/test_f32.py`` (concordance
  > 0.98, median relative statistic error < 0.02 where |stat| > 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydeseq2_tpu_torch as pt
from pydeseq2_tpu.fused import wald_pipeline as jax_wald_pipeline
from pydeseq2_tpu.utils import load_example_data
from pydeseq2_tpu_torch.synthetic import make_data

torch.set_num_threads(1)  # xdist runs several workers on a few cores

_NP = {"f64": np.float64, "f32": np.float32}
_TORCH = {"f64": torch.float64, "f32": torch.float32}


def _run_jax(counts, X, contrast, name, gene_mask=None, **static):
    d = _NP[name]
    out = jax_wald_pipeline(
        jnp.asarray(counts, d), jnp.asarray(X, d), jnp.asarray(contrast, d), jnp.asarray(0.0, d),
        None if gene_mask is None else jnp.asarray(gene_mask), **static,
    )
    return jax.device_get(out)


def _run_port(counts, X, contrast, name, gene_mask=None, **static):
    kw = pt.inputs_from_numpy(counts, X, contrast, 0.0, gene_mask, dtype=_TORCH[name], device="cpu", **static)
    return pt.outputs_to_numpy(pt.wald_pipeline(**kw))


def _assert_f64_parity(jo, po):
    assert jo.keys() == po.keys()
    for k in jo:
        a, b = np.asarray(jo[k]), po[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        if a.dtype.kind == "f":
            assert np.array_equal(np.isnan(a), np.isnan(b)), k
            m = ~np.isnan(a)
            np.testing.assert_allclose(b[m], a[m], rtol=1e-6, atol=1e-300, err_msg=k)
        else:
            assert np.array_equal(a, b), k


def _synthetic():
    counts_df = load_example_data(modality="raw_counts", dataset="synthetic")
    meta = load_example_data(modality="metadata", dataset="synthetic")
    counts = counts_df.values.T.astype(float)  # gene-major
    cond = (meta["condition"].values == "B").astype(float)
    group = (meta["group"].values == "Y").astype(float)
    return counts, cond, group


@pytest.fixture(scope="module")
def synthetic():
    return _synthetic()


@pytest.fixture(scope="module")
def drawn():
    """512 x 40 make_data draw with an all-zero gene (5) and a padding lane (7)."""
    counts, X = make_data(40, 512, seed=3)
    counts = counts.T.copy()
    counts[5] = 0.0
    mask = np.ones(512, bool)
    mask[7] = False
    return counts, X, mask


@pytest.fixture(scope="module")
def drawn_outputs(drawn):
    counts, X, mask = drawn
    out = {}
    for name, bt in (("f64", 1e-8), ("f32", 1e-6)):
        static = dict(max_disp=40.0, beta_tol=bt)
        out[name] = (
            _run_jax(counts, X, [0.0, 1.0], name, mask, **static),
            _run_port(counts, X, [0.0, 1.0], name, mask, **static),
        )
    return out


def test_synthetic_single_factor_f64(synthetic):
    counts, cond, _ = synthetic
    X = np.column_stack([np.ones_like(cond), cond])
    static = dict(max_disp=float(max(10, counts.shape[1])), beta_tol=1e-8)
    _assert_f64_parity(_run_jax(counts, X, [0.0, 1.0], "f64", **static),
                       _run_port(counts, X, [0.0, 1.0], "f64", **static))


def test_multifactor_irls_mu_init_f64(synthetic):
    counts, cond, group = synthetic
    X = np.column_stack([np.ones_like(cond), group, cond])
    static = dict(max_disp=float(max(10, counts.shape[1])), beta_tol=1e-8, mu_init="irls")
    _assert_f64_parity(_run_jax(counts, X, [0.0, 0.0, 1.0], "f64", **static),
                       _run_port(counts, X, [0.0, 0.0, 1.0], "f64", **static))


def test_drawn_with_zero_gene_and_padding_f64(drawn_outputs):
    jo, po = drawn_outputs["f64"]
    _assert_f64_parity(jo, po)
    for k in ("genewise_dispersions", "dispersions", "p_values", "statistics", "se"):
        assert np.isnan(po[k][5]) and np.isnan(po[k][7]), k
    assert np.isnan(po["lfc"][5]).all() and np.isnan(po["lfc"][7]).all()


def test_drawn_f32_against_jax_f32(drawn_outputs):
    jo, po = drawn_outputs["f32"]
    assert jo.keys() == po.keys()
    for k in jo:
        assert np.asarray(jo[k]).dtype == po[k].dtype, k
    pj, pp = np.asarray(jo["p_values"]), po["p_values"]
    assert np.array_equal(np.isnan(pj), np.isnan(pp))
    m = np.isfinite(pj)
    concordance = np.mean((pp[m] < 0.05) == (pj[m] < 0.05))
    assert concordance > 0.99, concordance
    sj, sp = np.asarray(jo["statistics"])[m], po["statistics"][m]
    rel = np.abs(sp - sj) / np.abs(sj)
    assert np.median(rel) < 1e-3, np.median(rel)


def test_drawn_f32_against_jax_f64(drawn_outputs):
    jo64 = drawn_outputs["f64"][0]
    po32 = drawn_outputs["f32"][1]
    pv64, pv32 = np.asarray(jo64["p_values"]), po32["p_values"]
    st64, st32 = np.asarray(jo64["statistics"]), po32["statistics"]
    m = np.isfinite(pv64)
    concordance = np.mean((pv32[m] < 0.05) == (pv64[m] < 0.05))
    assert concordance > 0.98, concordance
    sig = m & (np.abs(st64) > 2)
    rel = np.abs(st32[sig] - st64[sig]) / np.abs(st64[sig])
    assert np.median(rel) < 0.02, np.median(rel)
