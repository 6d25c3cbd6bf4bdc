"""The port's DeseqDataSet / DeseqStats against the JAX classes and the R
goldens, CPU: the single-factor and wide fixtures.

The same counts go through ``pydeseq2_tpu``'s class API (float64) and the
port's with ``TorchInference(device="cpu")``, so every kernel wrapper runs
its plain PyTorch version. ``results_df`` is held to the JAX one at rtol
1e-6 with equal NaN masks (flags exact), and to the R DESeq2 goldens in
``tests/data/`` at the JAX tests' 2% (``tests/test_pipeline.py``). Module
fixtures run each JAX configuration once.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu as jp
import pydeseq2_tpu_torch as pt
from conftest import assert_res_almost_equal, data_path

torch.set_num_threads(1)  # xdist runs several workers on a few cores


def run_class_api(mod, counts, metadata, design, contrast, stats_kw=None, inference=None, **dds_kw):
    """deseq2() then summary() through one package's class API."""
    kw = dict(dds_kw)
    if inference is not None:
        kw["inference"] = inference
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dds = mod.DeseqDataSet(counts=counts, metadata=metadata, design=design, quiet=True, **kw)
        dds.deseq2()
        ds = mod.DeseqStats(dds, contrast=contrast, quiet=True, **(stats_kw or {}))
        ds.summary()
    return dds, ds


def cpu(dtype=torch.float64):
    return pt.TorchInference(dtype=dtype, device="cpu")


def assert_frames_close(got: pd.DataFrame, want: pd.DataFrame, rtol=1e-6):
    assert list(got.columns) == list(want.columns)
    assert got.index.equals(want.index)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-300, equal_nan=True, err_msg=c)


@pytest.fixture(scope="module")
def single(counts_df_m, metadata_m):
    args = (counts_df_m, metadata_m, "~condition", ["condition", "B", "A"])
    return {"port": run_class_api(pt, *args, inference=cpu()), "jax": run_class_api(jp, *args)}


@pytest.fixture(scope="module")
def counts_df_m():
    return pt.utils.load_example_data(modality="raw_counts", dataset="synthetic")


@pytest.fixture(scope="module")
def metadata_m():
    return pt.utils.load_example_data(modality="metadata", dataset="synthetic")


def test_single_factor_matches_jax(single):
    (pd_, ps), (jd, js) = single["port"], single["jax"]
    assert_frames_close(ps.results_df, js.results_df)
    for col in ("genewise_dispersions", "fitted_dispersions", "MAP_dispersions", "dispersions", "_normed_means"):
        np.testing.assert_allclose(pd_.var[col], jd.var[col], rtol=1e-6, err_msg=col)
    for col in ("_genewise_converged", "_MAP_converged", "_LFC_converged", "_outlier_genes", "replaced",
                "refitted", "_pvalue_cooks_outlier"):
        np.testing.assert_array_equal(pd_.var[col].to_numpy(), jd.var[col].to_numpy(), err_msg=col)
    np.testing.assert_allclose(pd_.obs["size_factors"], jd.obs["size_factors"], rtol=1e-12)
    pd.testing.assert_series_equal(pd_.uns["trend_coeffs"], jd.uns["trend_coeffs"], rtol=1e-6)
    assert pd_.uns["prior_disp_var"] == pytest.approx(jd.uns["prior_disp_var"], rel=1e-6)


@pytest.mark.parametrize("slot, key", [("layers", "normed_counts"), ("layers", "_mu_hat"), ("layers", "cooks"),
                                       ("obsm", "_mu_LFC"), ("obsm", "_hat_diagonals")])
def test_public_layers_are_numpy_and_match_jax(single, slot, key):
    """The (N, G) layers a user reads are exported as numpy once each."""
    got, want = getattr(single["port"][0], slot)[key], getattr(single["jax"][0], slot)[key]
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-300, equal_nan=True)


def test_single_factor_r_golden(single):
    r_res = pd.read_csv(data_path("single_factor", "r_test_res.csv"), index_col=0)
    assert_res_almost_equal(single["port"][1].results_df, r_res, 0.02)


def test_mean_fit_and_no_filtering_r_goldens(counts_df_m, metadata_m):
    _, ds = run_class_api(pt, counts_df_m, metadata_m, "~condition", ["condition", "B", "A"],
                          inference=cpu(), fit_type="mean")
    r_res = pd.read_csv(data_path("single_factor", "r_test_res_mean_curve.csv"), index_col=0)
    assert_res_almost_equal(ds.results_df, r_res, 0.02)
    _, ds = run_class_api(pt, counts_df_m, metadata_m, "~condition", ["condition", "B", "A"],
                          stats_kw={"independent_filter": False}, inference=cpu())
    r_res = pd.read_csv(data_path("single_factor", "r_test_res_no_independent_filtering.csv"), index_col=0)
    assert_res_almost_equal(ds.results_df, r_res, 0.02)


@pytest.mark.parametrize("alt_hypothesis", ["lessAbs", "greaterAbs", "less", "greater"])
def test_alt_hypothesis_r_golden(single, alt_hypothesis):
    """summary() under each alternative on the same fit (the Wald-only
    kernel entry on the card), the checks of ``tests/test_pipeline.py``."""
    ds = pt.DeseqStats(single["port"][0], contrast=["condition", "B", "A"],
                       lfc_null=-0.5 if alt_hypothesis == "less" else 0.5, alt_hypothesis=alt_hypothesis, quiet=True)
    ds.summary()
    r_res = pd.read_csv(data_path("single_factor", f"r_test_res_{alt_hypothesis}.csv"), index_col=0)
    res = ds.results_df
    assert (res.pvalue.isna() == r_res.pvalue.isna()).all()
    assert (res.padj.isna() == r_res.padj.isna()).all()
    assert (abs(r_res.log2FoldChange - res.log2FoldChange) / abs(r_res.log2FoldChange)).max() < 0.02
    stat = res.stat.abs() if alt_hypothesis == "lessAbs" else res.stat
    assert (abs(r_res.stat - stat) / abs(r_res.stat)).max() < 0.02
    m = r_res.stat != 0
    assert (abs(r_res.pvalue[m] - res.pvalue[res.stat != 0]) / r_res.pvalue[m]).max() < 0.02


def test_prior_lfc_var_ridge_matches_jax(single):
    """A prior-LFC ridge reaches the Wald-only entry as its (P, P) ridge."""
    prior = np.array([3.0, 1.2])
    got = pt.DeseqStats(single["port"][0], contrast=["condition", "B", "A"], prior_LFC_var=prior, quiet=True)
    want = jp.DeseqStats(single["jax"][0], contrast=["condition", "B", "A"], prior_LFC_var=prior, quiet=True)
    got.summary()
    want.summary()
    assert_frames_close(got.results_df, want.results_df)


@pytest.mark.parametrize("low_memory", [False, True])
def test_wide_matches_jax_and_r_golden(low_memory):
    counts = pd.read_csv(data_path("wide", "test_counts.csv"), index_col=0).T
    metadata = pd.read_csv(data_path("wide", "test_metadata.csv"), index_col=0)
    args = (counts, metadata, "~group + condition", ["condition", "B", "A"])
    pd_, ps = run_class_api(pt, *args, inference=cpu(), low_memory=low_memory)
    r_res = pd.read_csv(data_path("wide", "r_test_res.csv"), index_col=0)
    assert_res_almost_equal(ps.results_df, r_res, 0.02)
    if low_memory:
        assert "cooks" not in pd_.layers and "_mu_LFC" not in pd_.obsm
        return
    _, js = run_class_api(jp, *args)
    assert_frames_close(ps.results_df, js.results_df)


def test_class_api_defaults_to_the_card(counts_df_m, metadata_m):
    """With no inference the dataset asks DefaultInference for float64 on
    "cuda", which raises without a card; DeseqStats inherits the dataset's
    backend."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.DeseqDataSet(counts=counts_df_m, metadata=metadata_m, design="~condition", quiet=True)
