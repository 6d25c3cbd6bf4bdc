"""Whole-slice parity: the port's ``summary_pipeline`` against the JAX one, CPU.

Each case feeds the same numpy inputs, with each package's own
``summary_host_inputs`` of the design, to
``pydeseq2_tpu.fused.summary_pipeline`` and to
``pydeseq2_tpu_torch.summary_pipeline(device="cpu")``, so every kernel
wrapper runs its plain PyTorch version, and compares the output dicts key
by key. Each JAX program compiles once (module fixtures; six compiles).

Tolerances:
- f64: rtol 1e-6 on every float output (Cook's distances and ``padj``
  included), identical NaN masks and identical ``cooks_outlier``: both
  sides evaluate the same expressions, and what remains is summation order
  (see ``test_torch_pipeline.py``).
- f32 port against JAX f32: ``padj < 0.05`` calls agree on > 99% of the
  genes (f32 rounding of the dispersion optima moves a few genes).
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
from pydeseq2_tpu.utils import load_example_data
from pydeseq2_tpu_torch.synthetic import make_data

torch.set_num_threads(1)  # xdist runs several workers on a few cores

_NP = {"f64": np.float64, "f32": np.float32}
_TORCH = {"f64": torch.float64, "f32": torch.float32}


def _host(X, host_inputs=pt.summary_host_inputs):
    host = host_inputs(X)
    return {"cohort_ids": host["cohort_ids"], "use_for_max": host["use_for_max"]}, host["cooks_cutoff"]


def _run_jax(counts, X, contrast, name, gene_mask=None, **static):
    d = _NP[name]
    host, cutoff = _host(X, jax_host_inputs)
    out = jax_summary_pipeline(
        jnp.asarray(counts, d), jnp.asarray(X, d), jnp.asarray(contrast, d), jnp.asarray(0.0, d),
        jnp.asarray(cutoff), None if gene_mask is None else jnp.asarray(gene_mask), **host, **static,
    )
    return jax.device_get(out)


def _run_port(counts, X, contrast, name, gene_mask=None, **static):
    host, cutoff = _host(X)
    kw = pt.inputs_from_numpy(counts, X, contrast, 0.0, gene_mask, cooks_cutoff=cutoff, dtype=_TORCH[name],
                              device="cpu", **host, **static)
    return pt.outputs_to_numpy(pt.summary_pipeline(**kw))


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


@pytest.fixture(scope="module")
def synthetic():
    counts_df = load_example_data(modality="raw_counts", dataset="synthetic")
    meta = load_example_data(modality="metadata", dataset="synthetic")
    counts = counts_df.values.T.astype(float)  # gene-major
    cond = (meta["condition"].values == "B").astype(float)
    group = (meta["group"].values == "Y").astype(float)
    return counts, cond, group


@pytest.mark.parametrize("independent_filter", [True, False])
def test_synthetic_single_factor_f64(synthetic, independent_filter):
    counts, cond, _ = synthetic
    X = np.column_stack([np.ones_like(cond), cond])
    static = dict(max_disp=float(max(10, counts.shape[1])), independent_filter=independent_filter)
    jo = _run_jax(counts, X, [0.0, 1.0], "f64", **static)
    po = _run_port(counts, X, [0.0, 1.0], "f64", **static)
    _assert_f64_parity(jo, po)
    assert np.isfinite(po["padj"]).all()


def test_multifactor_outliers_irls_f64(synthetic):
    """``~group + condition`` with two injected outliers (as
    ``test_fused_summary.py`` injects them): four cohorts, the Cook's mask
    fires and the flagged genes' p-values and padj become NaN."""
    counts, cond, group = synthetic
    counts = counts.copy()
    counts[0, 0] = counts.max() * 10 + 100
    counts[3, 5] = counts.max() * 8 + 50
    X = np.column_stack([np.ones_like(cond), group, cond])
    assert len(set(_host(X)[0]["cohort_ids"])) == 4
    static = dict(max_disp=float(max(10, counts.shape[1])), mu_init="irls")
    jo = _run_jax(counts, X, [0.0, 0.0, 1.0], "f64", **static)
    po = _run_port(counts, X, [0.0, 0.0, 1.0], "f64", **static)
    _assert_f64_parity(jo, po)
    assert po["cooks_outlier"].sum() >= 1
    assert np.isnan(po["p_values"][po["cooks_outlier"]]).all()


@pytest.fixture(scope="module")
def drawn():
    """2000 x 40 make_data draw with an all-zero gene (5) and a padding lane (7)."""
    counts, X = make_data(40, 2000, seed=4)
    counts = counts.T.copy()
    counts[5] = 0.0
    mask = np.ones(2000, bool)
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


def test_drawn_with_zero_gene_and_padding_f64(drawn_outputs):
    jo, po = drawn_outputs["f64"]
    _assert_f64_parity(jo, po)
    # More than 10 rejections in the picked row, so num_rej.max() > 10 and
    # the lowess pick, not the shortcut to row 0, chose it.
    assert np.sum(po["padj"] < 0.05) > 10
    for k in ("padj", "p_values"):
        assert np.isnan(po[k][5]) and np.isnan(po[k][7]), k
    assert np.isnan(po["cooks"][5]).all() and np.isnan(po["cooks"][7]).all()


def test_drawn_f32_against_jax_f32(drawn_outputs):
    jo, po = drawn_outputs["f32"]
    assert jo.keys() == po.keys()
    for k in jo:
        assert np.asarray(jo[k]).dtype == po[k].dtype, k
    aj, ap = np.asarray(jo["padj"]), po["padj"]
    m = np.isfinite(aj) & np.isfinite(ap)
    assert m.mean() > 0.9
    concordance = np.mean((ap[m] < 0.05) == (aj[m] < 0.05))
    assert concordance > 0.99, concordance


def test_continuous_design_global_trimmed_variance_f64():
    """A continuous covariate: no cohort has 3 replicates, so
    ``cohort_ids`` is None and the Cook's dispersion takes the global
    trimmed variance over all samples (trim 0.125, scale 1.51)."""
    from conftest import data_path

    counts_df = pd.read_csv(data_path("continuous", "test_counts.csv"), index_col=0)
    meta = pd.read_csv(data_path("continuous", "test_metadata.csv"), index_col=0)
    counts = counts_df.values.astype(float)  # gene-major already
    X = np.column_stack([
        np.ones(len(meta)), (meta["group"].values == "Y").astype(float),
        (meta["condition"].values == "B").astype(float), meta["measurement"].values,
    ])
    host = pt.summary_host_inputs(X)
    assert host["cohort_ids"] is None and host["mu_init"] == "irls"
    static = dict(max_disp=float(max(10, counts.shape[1])), mu_init="irls")
    jo = _run_jax(counts, X, [0.0, 0.0, 0.0, 1.0], "f64", **static)
    po = _run_port(counts, X, [0.0, 0.0, 0.0, 1.0], "f64", **static)
    _assert_f64_parity(jo, po)
    assert not po["cooks_outlier"].any()
