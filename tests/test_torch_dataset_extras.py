"""The port's class API beyond deseq2() + summary(), CPU: apeGLM shrinkage,
the VST, and the iterative size factors, against the JAX classes and the R
goldens.

Float64, ``TorchInference(device="cpu")``. Against ``pydeseq2_tpu``: rtol
1e-6, flags exact. Against R: the JAX tests' bars (``tests/
test_shrinkage.py``, ``test_vst.py``, ``test_norm.py``: 2%). The shrinkage
cases inject R's size factors, dispersions and MLE LFCs before shrinking, as
the JAX tests do.

The iterative size factors' ``method="device"`` branch hands the port's
``trimmed_sf_newton`` a per-gene OLS coefficient (derived from the
dispersion fit's mu) where JAX passes a (G, N) baseline mean; the test
holds the two branches to each other at rtol 1e-6.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu as jp
import pydeseq2_tpu_torch as pt
from conftest import data_path
from test_torch_dataset import assert_frames_close, cpu

torch.set_num_threads(1)  # xdist runs several workers on a few cores


@pytest.fixture(scope="module")
def study():
    return pt.utils.load_example_data("raw_counts"), pt.utils.load_example_data("metadata")


def _shrink(mod, counts, metadata, adapt, inference=None):
    """deseq2(), R's size factors, dispersions and MLE LFCs injected, summary(),
    R's SEs, then lfc_shrink (``tests/test_shrinkage.py:_run_shrink``)."""
    folder = "single_factor"
    r_res = pd.read_csv(data_path(folder, "r_test_res.csv"), index_col=0)
    r_sf = pd.read_csv(data_path(folder, "r_test_size_factors.csv"), index_col=0).squeeze()
    r_disp = pd.read_csv(data_path(folder, "r_test_dispersions.csv"), index_col=0).squeeze()
    kw = {} if inference is None else {"inference": inference}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dds = mod.DeseqDataSet(counts=counts, metadata=metadata, design="~condition", quiet=True, **kw)
        dds.deseq2()
        dds.obs["size_factors"] = r_sf.values
        dds.var["dispersions"] = r_disp.values
        dds.varm["LFC"].iloc[:, 1] = r_res.log2FoldChange.values * np.log(2)
        res = mod.DeseqStats(dds, contrast=["condition", "B", "A"], quiet=True)
        res.summary()
        res.SE = r_res.lfcSE * np.log(2)
        res.lfc_shrink(coeff="condition[T.B]", adapt=adapt)
    return res


@pytest.mark.parametrize("adapt", [True, False])
def test_lfc_shrink_matches_jax_and_r(study, adapt):
    got, want = _shrink(pt, *study, adapt, cpu()), _shrink(jp, *study, adapt)
    assert_frames_close(got.results_df, want.results_df)
    np.testing.assert_array_equal(got._LFC_shrink_converged.to_numpy(), want._LFC_shrink_converged.to_numpy())
    name = "r_test_lfc_shrink_res.csv" if adapt else "r_test_lfc_shrink_no_apeAdapt_res.csv"
    r = pd.read_csv(data_path("single_factor", name), index_col=0)
    assert (abs(r.log2FoldChange - got.results_df.log2FoldChange) / abs(r.log2FoldChange)).max() < 0.02


@pytest.mark.parametrize("case", ["blind", "use_design", "mean"])
def test_vst_matches_jax_and_r(study, case):
    counts, metadata = study
    kw = {"use_design": case == "use_design", "fit_type": "mean" if case == "mean" else None}
    out = {}
    for name, mod, extra in (("port", pt, {"inference": cpu()}), ("jax", jp, {})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dds = mod.DeseqDataSet(counts=counts, metadata=metadata, design="~condition", quiet=True, **extra)
            if case == "use_design":
                dds.deseq2()
            dds.vst(**kw)
        out[name] = dds
    got, want = out["port"].layers["vst_counts"], out["jax"].layers["vst_counts"]
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    r_name = {"blind": "r_vst.csv", "use_design": "r_vst_with_design.csv", "mean": "r_mean_vst.csv"}[case]
    r_vst = pd.read_csv(data_path("single_factor", r_name), index_col=0).T
    assert (np.abs(r_vst - got) / r_vst).max().max() < 0.02
    # external counts through the fitted transform
    ext = counts[0:25].to_numpy()
    np.testing.assert_allclose(out["port"].vst_transform(ext), out["jax"].vst_transform(ext), rtol=1e-6)


def test_iterative_size_factors_device_matches_jax(study):
    """The ``method="device"`` branch: the port's trimmed_sf_newton (per-gene
    coefficient in, ``(log_sf, keep)`` out) against JAX's (baseline means
    in, log size factors out), from the same dispersion fits."""
    counts, metadata = study
    out = {}
    for name, mod, extra in (("port", pt, {"inference": cpu()}), ("jax", jp, {})):
        dds = mod.DeseqDataSet(counts=counts, metadata=metadata, design="~condition", quiet=True, **extra)
        dds._fit_iterate_size_factors(method="device")
        out[name] = dds
    np.testing.assert_allclose(out["port"].obs["size_factors"], out["jax"].obs["size_factors"], rtol=1e-6)
    np.testing.assert_allclose(out["port"].layers["normed_counts"], out["jax"].layers["normed_counts"], rtol=1e-6)


def test_iterative_size_factors_powell_r_golden(study):
    counts, metadata = study
    r_sf = pd.read_csv(data_path("single_factor", "r_iterative_size_factors.csv"), index_col=0).squeeze()
    dds = pt.DeseqDataSet(counts=counts, metadata=metadata, design="~condition", quiet=True, inference=cpu())
    dds._fit_iterate_size_factors()
    assert (abs(r_sf.values - dds.obs["size_factors"].values) / abs(r_sf.values)).max() < 0.02


def test_zero_inflated_switches_to_iterative(study):
    """Every gene with a zero: ratio size factors are undefined and
    fit_size_factors warns and fits them iteratively (``tests/
    test_edge_cases.py:test_zero_inflated``); the normalised counts are
    exported once, at the end."""
    counts, metadata = study
    counts = counts.copy()
    rows = np.random.RandomState(42).choice(len(counts), counts.shape[-1])
    counts.iloc[rows, :] = 0
    dds = pt.DeseqDataSet(counts=counts, metadata=metadata, quiet=True, inference=cpu())
    with pytest.warns(UserWarning, match="iterative"):
        dds.fit_size_factors()
    np.testing.assert_allclose(dds.layers["normed_counts"], counts.to_numpy() / dds.obs["size_factors"].values[:, None])
