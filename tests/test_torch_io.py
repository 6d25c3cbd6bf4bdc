"""Save, load and resume of the port's fitted datasets, CPU.

Mirrors ``tests/test_io.py``: the dataset and results round trips and the
stage resume, here at every stage boundary of ``deseq2()`` (after the size
factors, genewise dispersions, trend, prior, MAP dispersions, LFCs, Cook's
distances and the refit) on a draw with two planted outliers that the refit
replaces. The port's dataset keeps its gene-major intermediates in a
private device store that ``load_dataset`` rebuilds from the public slots;
each resumed run of the remaining stages, then ``DeseqStats.summary()``,
equals the uninterrupted run at rtol 1e-12 in float64. One resume is held to
the JAX package's save / load / resume at rtol 1e-6, and the saved file
holds no tensor.
"""

import pickle
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu as jp
import pydeseq2_tpu_torch as pt
from pydeseq2_tpu import io as jio
from pydeseq2_tpu_torch import io as pio

torch.set_num_threads(1)  # xdist runs several workers on a few cores

CONTRAST = ["condition", "B", "A"]
# deseq2()'s stages in order (reference pydeseq2/dds.py:516-562).
STAGES = ("fit_size_factors", "fit_genewise_dispersions", "fit_dispersion_trend", "fit_dispersion_prior",
          "fit_MAP_dispersions", "fit_LFC", "calculate_cooks", "refit", "cooks_outlier")
VAR_COLUMNS = ("_normed_means", "genewise_dispersions", "fitted_dispersions", "MAP_dispersions", "dispersions")
FLAGS = ("replaced", "refitted", "_pvalue_cooks_outlier", "_outlier_genes")


def cpu():
    return pt.TorchInference(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def draw():
    """The single-factor fixture with two planted outliers
    (``tests/test_api.py:97``), which the refit replaces (its dispersion
    trend falls back to the mean, in both packages)."""
    counts = pt.utils.load_example_data("raw_counts").copy()
    metadata = pt.utils.load_example_data("metadata")
    counts.iloc[0, 0] = 1_000_000
    counts.iloc[5, 3] = 500_000
    return counts, metadata


@pytest.fixture(scope="module")
def plain_draw():
    """The single-factor fixture as it is: a parametric trend, no gene
    replaced."""
    return pt.utils.load_example_data("raw_counts"), pt.utils.load_example_data("metadata")


def make(mod, draw, **kw):
    counts, metadata = draw
    return mod.DeseqDataSet(counts=counts, metadata=metadata, design="~condition", quiet=True, **kw)


def run_stages(dds, stages):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in stages:
            getattr(dds, name)()


def summary(mod, dds):
    ds = mod.DeseqStats(dds, contrast=CONTRAST, quiet=True)
    ds.summary()
    return ds.results_df


def fit(draw):
    dds = make(pt, draw, inference=cpu())
    run_stages(dds, STAGES)
    return dds, summary(pt, dds)


@pytest.fixture(scope="module")
def uninterrupted(draw):
    dds, res = fit(draw)
    assert dds.var["refitted"].sum() > 0  # the draw must refit
    return dds, res


@pytest.fixture(scope="module")
def uninterrupted_plain(plain_draw):
    dds, res = fit(plain_draw)
    assert dds.uns["disp_function_type"] == "parametric" and not dds.var["replaced"].any()
    return dds, res


def assert_same_fit(got, want, rtol):
    (gd, gr), (wd, wr) = got, want
    assert gr.index.equals(wr.index) and list(gr.columns) == list(wr.columns)
    for c in wr.columns:
        g, w = gr[c].to_numpy(), wr[c].to_numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-300, err_msg=c)
    for c in VAR_COLUMNS:
        np.testing.assert_allclose(gd.var[c].to_numpy(float), wd.var[c].to_numpy(float), rtol=rtol, atol=1e-300,
                                   equal_nan=True, err_msg=c)
    for c in FLAGS:
        np.testing.assert_array_equal(gd.var[c].to_numpy(), wd.var[c].to_numpy(), err_msg=c)
    np.testing.assert_allclose(gd.varm["LFC"].to_numpy(), wd.varm["LFC"].to_numpy(), rtol=rtol, atol=1e-300)


def tensors_in(obj) -> int:
    """Number of torch.Tensor objects anywhere in a saved state."""
    if isinstance(obj, torch.Tensor):
        return 1
    if isinstance(obj, dict):
        return sum(tensors_in(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(tensors_in(v) for v in obj)
    if isinstance(obj, pd.DataFrame):
        return sum(tensors_in(list(obj[c])) for c in obj.columns if obj[c].dtype == object)
    if isinstance(obj, pd.Series) and obj.dtype == object:
        return tensors_in(list(obj))
    return 0


def test_dataset_roundtrip(tmp_path, uninterrupted):
    dds, _ = uninterrupted
    pio.save_dataset(dds, tmp_path / "dds.pkl")
    dds2 = pio.load_dataset(tmp_path / "dds.pkl", inference=cpu())

    np.testing.assert_array_equal(dds2.X, dds.X)
    np.testing.assert_array_equal(dds2.var["dispersions"].to_numpy(), dds.var["dispersions"].to_numpy())
    np.testing.assert_array_equal(dds2.varm["LFC"].to_numpy(), dds.varm["LFC"].to_numpy())
    np.testing.assert_array_equal(dds2.non_zero_idx, dds.non_zero_idx)
    assert list(dds2.new_all_zeroes_genes) == list(dds.new_all_zeroes_genes)
    # The device store comes back entry for entry, in the dtype its stage made.
    for entry in ("normed", "_mu_hat", "_mu_LFC", "_hat_diagonals", "cooks", "replace_cooks"):
        got, want = dds2._dev[entry], dds._dev[entry]
        assert got.dtype == want.dtype and got.is_contiguous(), entry
        assert torch.equal(got, want), entry

    # The reloaded dataset supports downstream statistics without refitting.
    res = summary(pt, dds2)
    assert np.isfinite(res.pvalue.dropna()).all() and res.pvalue.notna().any()


def test_saved_state_holds_no_tensor(tmp_path, uninterrupted):
    dds, _ = uninterrupted
    dds.uns["_planted"] = torch.arange(3.0)  # a tensor left in a public slot
    try:
        pio.save_dataset(dds, tmp_path / "dds.pkl")
    finally:
        del dds.uns["_planted"]
    with open(tmp_path / "dds.pkl", "rb") as f:
        state = pickle.load(f)
    assert tensors_in(state) == 0
    np.testing.assert_array_equal(state["uns"]["_planted"], np.arange(3.0))


@pytest.mark.parametrize("which", ["outliers", "plain"])
@pytest.mark.parametrize("boundary", range(1, len(STAGES)), ids=lambda k: f"after_{STAGES[k - 1]}")
def test_stage_resume(tmp_path, request, boundary, which):
    """A dataset saved after any stage resumes, through the stages left and
    summary(), to the uninterrupted result at rtol 1e-12: on the outlier
    draw (mean trend, two genes refitted) and on the plain one (parametric
    trend, nothing replaced)."""
    draw = request.getfixturevalue("draw" if which == "outliers" else "plain_draw")
    uninterrupted = request.getfixturevalue("uninterrupted" if which == "outliers" else "uninterrupted_plain")
    dds = make(pt, draw, inference=cpu())
    run_stages(dds, STAGES[:boundary])
    pio.save_dataset(dds, tmp_path / "partial.pkl")
    del dds

    dds2 = pio.load_dataset(tmp_path / "partial.pkl", inference=cpu())
    run_stages(dds2, STAGES[boundary:])
    assert_same_fit((dds2, summary(pt, dds2)), uninterrupted, rtol=1e-12)


def test_resume_through_deseq2(tmp_path, draw, uninterrupted):
    """``deseq2()`` on a reloaded dataset (it runs every stage again, as the
    reference's does) gives the uninterrupted result too."""
    dds = make(pt, draw, inference=cpu())
    run_stages(dds, STAGES[:2])
    pio.save_dataset(dds, tmp_path / "partial.pkl")
    dds2 = pio.load_dataset(tmp_path / "partial.pkl", inference=cpu())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dds2.deseq2()
    assert_same_fit((dds2, summary(pt, dds2)), uninterrupted, rtol=1e-12)


def test_unsaved_slot_is_recomputed(tmp_path, draw, uninterrupted):
    """A slot that was not saved stays out of the store, and the stage that
    needs it recomputes it: here the normalised counts and the dispersion
    fit's mu, dropped before the save after the genewise dispersions."""
    dds = make(pt, draw, inference=cpu())
    run_stages(dds, STAGES[:2])
    del dds.layers["normed_counts"], dds.layers["_mu_hat"]
    pio.save_dataset(dds, tmp_path / "partial.pkl")
    dds2 = pio.load_dataset(tmp_path / "partial.pkl", inference=cpu())
    assert "normed" not in dds2._dev and "_mu_hat" not in dds2._dev
    with pytest.raises(KeyError), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dds2.fit_MAP_dispersions()  # needs the dispersion fit's mu
    run_stages(dds2, STAGES[1:])  # the genewise stage again makes it
    assert_same_fit((dds2, summary(pt, dds2)), uninterrupted, rtol=1e-12)


def test_resume_matches_jax(tmp_path, draw):
    """The port's save / load / resume after the genewise dispersions
    against the JAX package's, rtol 1e-6; the refit of the planted outliers
    is not resumed in JAX, whose reload keeps no record of the genes a refit
    left all zero, so both stop before it and run it after the reload."""
    out = {}
    for name, mod, io, kw in (("port", pt, pio, {"inference": cpu()}), ("jax", jp, jio, {})):
        dds = make(mod, draw, **kw)
        run_stages(dds, STAGES[:2])
        io.save_dataset(dds, tmp_path / f"{name}.pkl")
        dds2 = io.load_dataset(tmp_path / f"{name}.pkl", **kw)
        run_stages(dds2, STAGES[2:])
        out[name] = (dds2, summary(mod, dds2))
    assert out["port"][0].var["refitted"].sum() > 0
    assert_same_fit(out["port"], out["jax"], rtol=1e-6)


def test_default_inference_needs_a_card(tmp_path, uninterrupted):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    pio.save_dataset(uninterrupted[0], tmp_path / "dds.pkl")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pio.load_dataset(tmp_path / "dds.pkl")


def test_results_roundtrip(tmp_path, uninterrupted):
    res = uninterrupted[1]
    for name in ("res.csv", "res.pkl"):
        pio.save_results(res, tmp_path / name)
        back = pio.load_results(tmp_path / name)
        assert list(back.columns) == list(res.columns) and list(back.index) == list(res.index)
        for c in res.columns:
            np.testing.assert_allclose(back[c].to_numpy(), res[c].to_numpy(), rtol=1e-12, equal_nan=True)
