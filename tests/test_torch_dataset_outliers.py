"""The port's class API on the outlier fixtures, CPU: Cook's distances, the
outlier replacement and refit, against the JAX classes and the R goldens.

The multi-factor and continuous fixtures with two planted outliers (the
cases of ``tests/test_pipeline.py``): float64 against ``pydeseq2_tpu`` at
rtol 1e-6 (flags, the replaced and refitted sets, the new all-zero genes
exact) and against R at the JAX tests' 4%; float32 against R at 4%, where
the JAX package's own float32 run reads 0.0362 on the multi-factor padj
(``TPU_CONFORMANCE.json`` ``api_refit_outliers``). Zero genes and a gene
that goes all-zero on replacement follow ``tests/test_edge_cases.py``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu as jp
import pydeseq2_tpu_torch as pt
from conftest import assert_res_almost_equal, data_path
from test_torch_dataset import assert_frames_close, cpu, run_class_api

torch.set_num_threads(1)  # xdist runs several workers on a few cores


def _plant(counts, metadata):
    counts, metadata = counts.copy(), metadata.copy()
    counts.loc["sample1", "gene1"] = 2000
    counts.loc["sample11", "gene7"] = 1000
    metadata.loc["sample1", "condition"] = "C"
    return counts, metadata


def _fixture(name):
    if name == "multi_factor":
        counts = pt.utils.load_example_data("raw_counts")
        metadata = pt.utils.load_example_data("metadata")
        design, contrast = "~group + condition", ["condition", "B", "A"]
    else:
        counts = pd.read_csv(data_path("continuous", "test_counts.csv"), index_col=0).T
        metadata = pd.read_csv(data_path("continuous", "test_metadata.csv"), index_col=0)
        design = "~group + condition + measurement"
        contrast = np.zeros(5)
        contrast[-1] = 1.0
    counts, metadata = _plant(counts, metadata)
    return counts, metadata, design, contrast


@pytest.fixture(scope="module", params=["multi_factor", "continuous"])
def outliers(request):
    args = _fixture(request.param)
    return {"name": request.param, "args": args, "port": run_class_api(pt, *args, inference=cpu()),
            "jax": run_class_api(jp, *args)}


def test_outlier_fixtures_match_jax(outliers):
    (pd_, ps), (jd, js) = outliers["port"], outliers["jax"]
    assert_frames_close(ps.results_df, js.results_df)
    for col in ("replaced", "refitted", "_pvalue_cooks_outlier", "_outlier_genes"):
        np.testing.assert_array_equal(pd_.var[col].to_numpy(), jd.var[col].to_numpy(), err_msg=col)
    assert hasattr(pd_, "counts_to_refit") == hasattr(jd, "counts_to_refit")
    if hasattr(jd, "counts_to_refit"):
        np.testing.assert_array_equal(pd_.counts_to_refit.X, jd.counts_to_refit.X)
    assert ("replace_cooks" in pd_.layers) == ("replace_cooks" in jd.layers)
    for key in ("cooks", "replace_cooks") if "replace_cooks" in jd.layers else ("cooks",):
        np.testing.assert_allclose(pd_.layers[key], jd.layers[key], rtol=1e-6, atol=1e-300, equal_nan=True)
    np.testing.assert_allclose(pd_.varm["LFC"].to_numpy(), jd.varm["LFC"].to_numpy(), rtol=1e-6, atol=1e-12)


def test_outlier_fixtures_r_golden(outliers):
    r_res = pd.read_csv(data_path(outliers["name"], "r_test_res_outliers.csv"), index_col=0)
    assert_res_almost_equal(outliers["port"][1].results_df, r_res, 0.04)


@pytest.mark.parametrize("name", ["multi_factor", "continuous"])
def test_outlier_fixtures_f32_r_golden(name):
    """float32 solvers (the dataset's own tensors stay float64, as in JAX)."""
    _, ds = run_class_api(pt, *_fixture(name), inference=cpu(torch.float32))
    r_res = pd.read_csv(data_path(name, "r_test_res_outliers.csv"), index_col=0)
    assert_res_almost_equal(ds.results_df, r_res, 0.04)
    worst = float((abs(r_res.padj - ds.results_df.padj) / r_res.padj).max())
    print(f"{name} f32 padj max rel err against R: {worst:.4f} (tolerance 0.04)")


def test_zero_genes_are_nan():
    counts = pt.utils.load_example_data("raw_counts")
    metadata = pt.utils.load_example_data("metadata")
    silenced = counts.columns[np.random.RandomState(42).choice(counts.shape[1], counts.shape[1] // 3, replace=False)]
    counts[silenced] = 0
    dds, ds = run_class_api(pt, counts, metadata, "~condition", ["condition", "B", "A"], inference=cpu())
    assert dds.var.loc[silenced, "dispersions"].isna().all()
    assert dds.varm["LFC"].loc[silenced].isna().all().all()
    rows = ds.results_df.loc[silenced]
    assert (rows["baseMean"] == 0).all()
    for col in ("log2FoldChange", "lfcSE", "stat", "pvalue", "padj"):
        assert rows[col].isna().all(), col


def test_new_all_zero_gene():
    """A gene whose only non-zero count is replaced goes all-zero: zero LFC,
    SE and stat, NaN p-value and padj (``tests/test_edge_cases.py``)."""
    counts = pt.utils.load_example_data("raw_counts")
    metadata = pt.utils.load_example_data("metadata")
    keep = [f"sample{i}" for i in [*range(1, 11), *range(91, 101)]]
    metadata = metadata.loc[keep]
    counts = counts.loc[keep].copy()
    counts["geneX"] = 0
    counts.loc["sample100", "geneX"] = 100
    dds, ds = run_class_api(pt, counts, metadata, "~condition", ["condition", "B", "A"], inference=cpu())
    assert list(dds.new_all_zeroes_genes) == ["geneX"]
    row = ds.results_df.loc["geneX"]
    for col in ("baseMean", "log2FoldChange", "lfcSE", "stat"):
        assert row[col] == 0, col
    assert np.isnan(row["pvalue"]) and np.isnan(row["padj"])
