"""The port's host layers against the JAX package's, CPU.

``formula``, ``container``, ``preprocessing`` and ``utils`` of
``pydeseq2_tpu_torch`` against their ``pydeseq2_tpu`` counterparts on the
same inputs, mirroring the relevant cases of ``test_formula.py`` and
``test_norm.py``. The formula and container modules are copies, so design
matrices, contrasts and subsets are held exactly; the normalisation runs
PyTorch on the CPU (the ``select`` kernel's plain version), held at rtol
1e-12 in float64 (both take the same order statistics; the log-means are
sums in another order).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu.preprocessing as j_pre
import pydeseq2_tpu.utils as j_utils
import pydeseq2_tpu_torch.preprocessing as t_pre
import pydeseq2_tpu_torch.utils as t_utils
from conftest import data_path
from pydeseq2_tpu.container import DeseqDataContainer as JContainer
from pydeseq2_tpu.formula import DesignMatrix as JDesign
from pydeseq2_tpu_torch.container import DeseqDataContainer as TContainer
from pydeseq2_tpu_torch.formula import DesignMatrix as TDesign

torch.set_num_threads(1)  # xdist runs several workers on a few cores


@pytest.fixture
def meta():
    rng = np.random.default_rng(0)
    return pd.DataFrame(
        {
            "condition": ["A", "B", "A", "B", "A", "B", "A", "B"],
            "group": ["X", "X", "Y", "Y", "X", "Y", "Y", "X"],
            "batch": ["p", "q", "q", "p", "p", "q", "p", "q"],
            "dose": rng.uniform(0, 5, 8),
        },
        index=[f"s{i}" for i in range(8)],
    )


FORMULAS = [
    "~condition",
    "~group + condition",
    "~condition + dose",
    "~group + condition + group:condition",
    "~group * condition",
    "~0 + condition",
    "~condition - 1",
    "~C(condition, ref='B') + group",
    "~group * condition * batch",
    "~(group + condition) * batch",
    "~group * condition - group:condition",
    "~(group + condition + batch) ** 2",
    "~group / condition",
]


@pytest.mark.parametrize("formula", FORMULAS)
def test_design_matrix_matches_jax(meta, formula):
    t, j = TDesign(meta, formula), JDesign(meta, formula)
    pd.testing.assert_frame_equal(t.matrix, j.matrix)
    assert t.variables == j.variables


@pytest.mark.parametrize("args", [("condition", "A", "B"), ("condition", "B", "A"), ("group", "Y", "X")])
def test_contrast_and_cond_match_jax(meta, args):
    t, j = TDesign(meta, "~group * condition"), JDesign(meta, "~group * condition")
    np.testing.assert_array_equal(t.contrast(*args), j.contrast(*args))
    np.testing.assert_array_equal(t.cond(group="Y", condition="B"), j.cond(group="Y", condition="B"))


@pytest.mark.parametrize("bad", ["~condition +", "~log(dose)", "~C(condition, levels=['A'])"])
def test_formula_errors_match_jax(meta, bad):
    with pytest.raises(Exception) as t_err:
        TDesign(meta, bad)
    with pytest.raises(Exception) as j_err:
        JDesign(meta, bad)
    assert type(t_err.value) is type(j_err.value)


def test_container_slicing_matches_jax(counts_df, metadata):
    t, j = TContainer(counts_df.to_numpy(), metadata, pd.DataFrame(index=counts_df.columns)), \
        JContainer(counts_df.to_numpy(), metadata, pd.DataFrame(index=counts_df.columns))
    for c in (t, j):
        c.layers["normed"] = c.X / 2.0
        c.varm["w"] = np.arange(c.n_vars)
    for sel in (lambda c: c.subset_genes(["gene2", "gene5"]), lambda c: c.subset_obs(slice(3, 9)),
                lambda c: c[2:7, [0, 4]], lambda c: c.copy()):
        a, b = sel(t), sel(j)
        np.testing.assert_array_equal(a.X, b.X)
        pd.testing.assert_frame_equal(a.obs, b.obs)
        pd.testing.assert_frame_equal(a.var, b.var)
        np.testing.assert_array_equal(a.layers["normed"], b.layers["normed"])
        np.testing.assert_array_equal(a.varm["w"], b.varm["w"])
    with pytest.raises(ValueError):
        t.layers["bad"] = np.zeros((3, 3))


def test_load_example_data_matches_jax():
    for modality in ("raw_counts", "metadata"):
        pd.testing.assert_frame_equal(t_utils.load_example_data(modality), j_utils.load_example_data(modality))
    pd.testing.assert_frame_equal(t_utils.load_example_data("metadata", debug=True),
                                  j_utils.load_example_data("metadata", debug=True))


@pytest.mark.parametrize("kind", ["nan", "negative", "float", "string"])
def test_invalid_counts_rejected_as_jax(kind):
    bad = {"nan": np.array([[1.0, np.nan]]), "negative": np.array([[1, -1]]),
           "float": np.array([[1.5, 2.0]]), "string": np.array([["a", "b"]])}[kind]
    with pytest.raises(ValueError) as t_err:
        t_utils.test_valid_counts(bad)
    with pytest.raises(ValueError) as j_err:
        j_utils.test_valid_counts(bad)
    assert str(t_err.value) == str(j_err.value)


def test_host_statistics_match_jax(metadata):
    rng = np.random.default_rng(1)
    x = rng.lognormal(2.0, 1.0, (30, 7))
    np.testing.assert_array_equal(t_utils.trimmed_mean_numpy(x, 0.2, axis=0), j_utils.trimmed_mean_numpy(x, 0.2, axis=0))
    counts = rng.poisson(8.0, (12, 5))
    mu = rng.uniform(2.0, 12.0, (12, 5))
    alpha = rng.uniform(0.05, 1.0, 5)
    np.testing.assert_array_equal(t_utils.nb_nll_numpy(counts, mu, alpha), j_utils.nb_nll_numpy(counts, mu, alpha))
    design = pd.get_dummies(metadata["condition"]).astype(float)
    pd.testing.assert_series_equal(t_utils.n_or_more_replicates(design, 50), j_utils.n_or_more_replicates(design, 50))
    coeffs = pd.Series([0.1, 2.0], index=["a0", "a1"])
    np.testing.assert_array_equal(t_utils.dispersion_trend(x[0], coeffs), j_utils.dispersion_trend(x[0], coeffs))


def test_size_factors_ratio_and_transform_match_jax(counts_df):
    train, test = counts_df[25:75], counts_df[0:25]
    lm_t, fg_t = t_pre.deseq2_norm_fit(train, device="cpu")
    lm_j, fg_j = j_pre.deseq2_norm_fit(train)
    np.testing.assert_allclose(lm_t, lm_j, rtol=1e-12)
    np.testing.assert_array_equal(fg_t, fg_j)
    n_t, sf_t = t_pre.deseq2_norm_transform(test, lm_j, fg_j, device="cpu")
    n_j, sf_j = j_pre.deseq2_norm_transform(test, lm_j, fg_j)
    assert isinstance(n_t, pd.DataFrame) and isinstance(sf_t, pd.Series)
    pd.testing.assert_frame_equal(n_t, n_j, rtol=1e-12)
    pd.testing.assert_series_equal(sf_t, sf_j, rtol=1e-12)
    r_sf = pd.read_csv(data_path("single_factor", "r_test_size_factors.csv"), index_col=0)["x"].values
    np.testing.assert_array_almost_equal(t_pre.deseq2_norm(counts_df, device="cpu")[1], r_sf)


def test_poscounts_match_jax_and_r(counts_df):
    lm_t, ok_t = t_pre.poscounts_norm_fit(counts_df, device="cpu")
    lm_j, ok_j = j_pre.poscounts_norm_fit(counts_df)
    np.testing.assert_allclose(lm_t, lm_j, rtol=1e-12)
    np.testing.assert_array_equal(ok_t, ok_j)
    sf_t = t_pre.poscounts_size_factors(counts_df, lm_j, ok_j, device="cpu")
    np.testing.assert_allclose(sf_t, j_pre.poscounts_size_factors(counts_df, lm_j, ok_j), rtol=1e-12)
    r_sf = pd.read_csv(data_path("single_factor", "r_test_size_factors_poscount.csv"), index_col=0)["sizeFactor"]
    np.testing.assert_array_almost_equal(sf_t, r_sf.values)

