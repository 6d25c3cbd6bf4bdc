"""Whole-slice parity of the Cook's refit: the port's
``run_summary_streamed(refit_cooks=True)`` against the JAX one, CPU, and
the multifactor outlier R golden through the port alone.

The JAX refit cases of ``tests/test_fused_stream.py`` on the same 10-gene
fixture with ``gene_block=4`` (3 blocks, one padded): two planted outliers
whose genes are replaced and refitted, a gene left all zero by the
replacement, and ``mu_init="irls"`` on the continuous design. float64,
tolerances as ``test_torch_stream.py`` (rtol 1e-6 on floats, flags exact).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu_torch as pt
from conftest import data_path
from pydeseq2_tpu.utils import load_example_data
from test_torch_stream import KW, assert_parity, run_both

torch.set_num_threads(1)  # xdist runs several workers on a few cores


@pytest.fixture(scope="module")
def synthetic():
    counts_df = load_example_data(modality="raw_counts", dataset="synthetic")
    meta = load_example_data(modality="metadata", dataset="synthetic")
    cond = (meta["condition"].values == "B").astype(float)
    return counts_df.values.T.astype(float), np.column_stack([np.ones_like(cond), cond])


def _outliers(counts):
    """``test_fused_stream.py:332-334``: samples 0 and 3 of genes 0 and 5."""
    counts = counts.copy()
    counts[0, 0] = 1_000_000
    counts[5, 3] = 500_000
    return counts


def _new_all_zero(counts):
    """``test_fused_stream.py:356-358``: gene 2 zero but one huge count."""
    counts = counts.copy()
    counts[2, :] = 0
    counts[2, 7] = 1_000_000
    return counts


@pytest.mark.parametrize("case", ["outliers", "new_all_zero"])
def test_refit_matches_jax(synthetic, case):
    counts, X = synthetic
    counts = {"outliers": _outliers, "new_all_zero": _new_all_zero}[case](counts)
    jo, po = run_both(counts, X, [0.0, 1.0], refit_cooks=True)
    assert_parity(jo, po)
    if case == "outliers":
        assert po["refitted"].tolist() == [i in (0, 5) for i in range(10)]
    else:
        assert po["new_all_zeroes"].tolist() == [i == 2 for i in range(10)]
        # zero LFC, SE and statistic (its p-value 1 is then Cook's-masked)
        assert po["lfc"][2].tolist() == [0.0, 0.0] and po["se"][2] == 0.0 and po["statistics"][2] == 0.0


def test_irls_mu_init_continuous_design():
    """The continuous-covariate study (~group + condition + measurement):
    no design row repeats, so mu_init resolves to "irls" (the pass-1 IRLS
    init with rescue) and no sample is replaceable."""
    counts = pd.read_csv(data_path("continuous", "test_counts.csv"), index_col=0).values.astype(float)
    meta = pd.read_csv(data_path("continuous", "test_metadata.csv"), index_col=0)
    X = np.column_stack([
        np.ones(len(meta)), (meta["group"].values == "Y").astype(float),
        (meta["condition"].values == "B").astype(float), meta["measurement"].values,
    ])
    assert pt.summary_host_inputs(X)["mu_init"] == "irls"
    jo, po = run_both(counts, X, [0.0, 0.0, 0.0, 1.0], refit_cooks=True)
    assert_parity(jo, po)
    assert not po["replaced"].any()


def test_multifactor_outlier_r_golden():
    """The R DESeq2 golden of the multifactor outlier scenario (reference
    tests/test_pydeseq2.py:434-509) through the port alone: ~group +
    condition with two planted outliers and a third condition level, max
    relative error < 0.04 on log2FoldChange, pvalue and padj, NaN masks
    equal, and at least one gene refitted."""
    r_res = pd.read_csv(data_path("multi_factor", "r_test_res_outliers.csv"), index_col=0)
    counts_df = load_example_data(modality="raw_counts", dataset="synthetic")
    meta = load_example_data(modality="metadata", dataset="synthetic")
    counts_df.loc["sample1", "gene1"] = 2000
    counts_df.loc["sample11", "gene7"] = 1000
    meta.loc["sample1", "condition"] = "C"
    # The design DeseqDataSet builds for "~group + condition": Intercept,
    # group[T.Y], condition[T.B], condition[T.C].
    X = np.column_stack([
        np.ones(len(meta)), (meta["group"].values == "Y").astype(float),
        (meta["condition"].values == "B").astype(float), (meta["condition"].values == "C").astype(float),
    ])
    cvec = np.array([0.0, 0.0, 1.0, 0.0])
    res = pt.run_summary_streamed(counts_df.values.T.astype(float), X, cvec, refit_cooks=True, device="cpu", **KW)
    assert int(res["refitted"].sum()) > 0
    l2fc = res["lfc"] @ cvec / np.log(2.0)
    for col, got in (("log2FoldChange", l2fc), ("pvalue", res["p_values"]), ("padj", res["padj"])):
        r = r_res[col].values
        assert np.array_equal(np.isnan(r), np.isnan(got)), col
        assert np.nanmax(np.abs(r - got) / np.abs(r)) < 0.04, col
