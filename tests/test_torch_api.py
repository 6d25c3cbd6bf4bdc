"""The port's one-call ``run_deseq2`` against the JAX package's, CPU.

The same DataFrames go through ``pydeseq2_tpu.run_deseq2`` (float64) and
``pydeseq2_tpu_torch.run_deseq2(device="cpu", dtype=torch.float64)``, where
every kernel wrapper runs its plain PyTorch version: every column of the
results at rtol 1e-6 with equal NaN masks, and the flags (``refitted``,
``cooks_outlier``) exact, on the default refit route with two planted
outliers, the no-refit route, poscounts, iterative and control-gene size
factors and the zero-inflated switch to iterative mode. The size factors
are also held to the R goldens (2%, ``tests/test_api.py``), float32 to the
R results under ``tests/test_f32.py``'s scheme (2%; 4% on the
multi-factor outlier fixture, as ``tests/test_pipeline.py``), and each
route to the direct pipeline call it makes, bit for bit. Module fixtures
run each JAX configuration once.
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

CONTRAST = ["condition", "B", "A"]
COLUMNS = ["baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue", "padj"]


def both(counts, metadata, design="~condition", **kw):
    """(port, jax) results of ``run_deseq2(..., return_state=True)``, each a
    (DataFrame, state) pair; warnings recorded, not raised."""
    out = {}
    for name, mod, extra in (("port", pt, {"device": "cpu", "dtype": torch.float64}), ("jax", jp, {})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res, state = mod.run_deseq2(counts, metadata, design, contrast=CONTRAST, return_state=True,
                                        **kw, **extra)
        out[name] = (res, state, [str(w.message) for w in caught])
    return out


def assert_frames_close(got: pd.DataFrame, want: pd.DataFrame, rtol=1e-6):
    assert list(got.columns) == COLUMNS and list(want.columns) == COLUMNS
    assert got.index.equals(want.index)
    for c in COLUMNS:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        assert g.dtype == np.float64, c
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-300, equal_nan=True, err_msg=c)


def assert_parity(runs, flags=("cooks_outlier",)):
    (pr, ps, _), (jr, js, _) = runs["port"], runs["jax"]
    assert_frames_close(pr, jr)
    for k in flags:
        np.testing.assert_array_equal(np.asarray(ps[k]), np.asarray(js[k]), err_msg=k)
    np.testing.assert_allclose(np.asarray(ps["size_factors"]), np.asarray(js["size_factors"]), rtol=1e-6)


@pytest.fixture(scope="module")
def data():
    return pt.utils.load_example_data("raw_counts"), pt.utils.load_example_data("metadata")


@pytest.fixture(scope="module")
def outlier_counts(data):
    """``tests/test_api.py:97``: two planted outliers that the refit replaces."""
    counts = data[0].copy()
    counts.iloc[0, 0] = 1_000_000
    counts.iloc[5, 3] = 500_000
    return counts


@pytest.fixture(scope="module")
def refit_runs(outlier_counts, data):
    return both(outlier_counts, data[1])


@pytest.fixture(scope="module")
def no_refit_runs(data):
    return both(*data, refit_cooks=False)


@pytest.fixture(scope="module")
def poscounts_runs(data):
    return {refit: both(*data, size_factors_fit_type="poscounts", refit_cooks=refit) for refit in (False, True)}


@pytest.fixture(scope="module")
def iterative_runs(data):
    return both(*data, size_factors_fit_type="iterative", refit_cooks=False)


def r_size_factors(name):
    return pd.read_csv(data_path("single_factor", name), index_col=0).squeeze().to_numpy()


def test_package_exports():
    for name in ("run_deseq2", "DeseqDataSet", "DeseqStats", "DeseqDataContainer", "Inference", "TorchInference",
                 "DefaultInference", "deseq2_norm", "deseq2_norm_fit", "deseq2_norm_transform", "__version__"):
        assert hasattr(pt, name), name
    assert pt.__all__[0] == "run_deseq2" and jp.__all__[0] == "run_deseq2"
    assert callable(pt.io.save_dataset) and callable(pt.io.load_dataset)


def test_utils_exports():
    from pydeseq2_tpu_torch.utils import (  # noqa: F401
        dispersion_trend,
        get_num_processes,
        load_example_data,
        n_or_more_replicates,
        test_valid_counts,
        trimmed_mean_numpy,
    )

    assert get_num_processes(5) == 5
    assert get_num_processes() >= 1


def test_default_refit_matches_jax(refit_runs):
    """The reference's default pipeline: Cook's replacement and refit of
    the two planted outliers' genes, the same genes as the JAX package."""
    assert_parity(refit_runs, flags=("refitted", "replaced", "new_all_zeroes", "cooks_outlier"))
    refitted = refit_runs["port"][1]["refitted"]
    assert refitted.tolist() == [i in (0, 3) for i in range(len(refitted))]


def test_no_refit_matches_jax(no_refit_runs):
    assert_parity(no_refit_runs)


def test_state_keys_match_jax(refit_runs, no_refit_runs):
    for runs in (refit_runs, no_refit_runs):
        assert set(runs["port"][1]) == set(runs["jax"][1])


@pytest.mark.parametrize("refit", [False, True])
def test_poscounts_matches_r_and_jax(poscounts_runs, refit):
    runs = poscounts_runs[refit]
    assert_parity(runs, flags=("refitted", "cooks_outlier") if refit else ("cooks_outlier",))
    sf = np.asarray(runs["port"][1]["size_factors"])
    r_sf = r_size_factors("r_test_size_factors_poscount.csv")
    assert (abs(r_sf - sf) / abs(r_sf)).max() < 0.02


def test_iterative_matches_r_and_jax(iterative_runs):
    assert_parity(iterative_runs)
    sf = np.asarray(iterative_runs["port"][1]["size_factors"])
    r_sf = r_size_factors("r_iterative_size_factors.csv")
    assert (abs(r_sf - sf) / abs(r_sf)).max() < 0.02


def test_control_genes_match_staged_and_jax(data):
    counts, metadata = data
    zero_free = counts.columns[(counts > 0).all(axis=0)][:2].tolist()
    dds = pt.DeseqDataSet(counts=counts, metadata=metadata, design="~condition", quiet=True,
                          inference=pt.TorchInference(device="cpu"))
    dds.fit_size_factors(control_genes=zero_free)
    expected = dds.obs["size_factors"].to_numpy()
    assert np.isfinite(expected).all()
    runs = both(counts, metadata, control_genes=zero_free, refit_cooks=False)
    np.testing.assert_allclose(np.asarray(runs["port"][1]["size_factors"]), expected, rtol=1e-6)
    assert_parity(runs)


def test_zero_inflated_switches_to_iterative(data):
    """Ratio undefined (every gene has a zero): the reference's switch to
    iterative mode, with its warning, on both packages."""
    counts, metadata = data
    rows = np.random.RandomState(42).choice(len(counts), counts.shape[-1])
    zi = counts.copy()
    zi.iloc[rows, :] = 0
    runs = both(zi, metadata, refit_cooks=False)
    for name in ("port", "jax"):
        assert any("Switching to iterative mode" in m for m in runs[name][2]), name
    assert_parity(runs)
    with pytest.warns(UserWarning, match="Switching to iterative mode"):
        pt.run_deseq2(zi, metadata, contrast=CONTRAST, refit_cooks=False, device="cpu")


@pytest.mark.parametrize("refit", [True, False])
def test_routes_equal_direct_calls(outlier_counts, data, refit):
    """Each route returns what the pipeline it calls returns on the same
    counts, bit for bit: run_summary_streamed(refit_cooks=True), or
    summary_pipeline and one host copy."""
    counts, metadata = (outlier_counts, data[1]) if refit else data
    res = pt.run_deseq2(counts, metadata, contrast=CONTRAST, refit_cooks=refit, device="cpu")
    X = np.column_stack([np.ones(len(metadata)), (metadata["condition"] == "B").to_numpy(float)])
    c = np.array([0.0, 1.0])
    if refit:
        out = pt.run_summary_streamed(counts.to_numpy(float).T, X, c, dtype=np.float64, refit_cooks=True,
                                      max_disp=float(max(10, len(X))), beta_tol=1e-8, device="cpu")
    else:
        host = pt.summary_host_inputs(X)
        out = pt.outputs_to_numpy(pt.summary_pipeline(
            **pt.inputs_from_numpy(counts.to_numpy(float).T, X, c, 0.0, cooks_cutoff=host["cooks_cutoff"],
                                   device="cpu", cohort_ids=host["cohort_ids"], use_for_max=host["use_for_max"],
                                   max_disp=float(max(10, len(X))))))
    want = {"baseMean": out["base_mean"], "log2FoldChange": out["lfc"] @ c / np.log(2),
            "lfcSE": out["se"] / np.log(2), "stat": out["statistics"], "pvalue": out["p_values"], "padj": out["padj"]}
    for col, w in want.items():
        np.testing.assert_array_equal(res[col].to_numpy(), w, err_msg=col)


@pytest.mark.parametrize("refit", [True, False])
def test_f32_single_factor_r_golden(data, refit):
    """float32 on both routes against the R results, ``tests/test_f32.py``'s
    scheme: equal NaN masks, relative error < 2% on log2FoldChange, pvalue
    and padj."""
    res = pt.run_deseq2(*data, contrast=CONTRAST, refit_cooks=refit, dtype=torch.float32, device="cpu")
    r_res = pd.read_csv(data_path("single_factor", "r_test_res.csv"), index_col=0)
    assert_res_almost_equal(res, r_res, 0.02)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_multifactor_outliers_r_golden(dtype):
    """The multi-factor outlier scenario (``tests/test_pipeline.py``): two
    planted outliers and a third condition level through the refit route,
    against R at 4%; float32 padj sits near that limit (ROADMAP "f32 margin
    to watch")."""
    counts = pt.utils.load_example_data("raw_counts")
    metadata = pt.utils.load_example_data("metadata")
    counts.loc["sample1", "gene1"] = 2000
    counts.loc["sample11", "gene7"] = 1000
    metadata.loc["sample1", "condition"] = "C"
    res, state = pt.run_deseq2(counts, metadata, "~group + condition", contrast=CONTRAST, dtype=dtype,
                               return_state=True, device="cpu")
    assert state["refitted"].sum() > 0
    r_res = pd.read_csv(data_path("multi_factor", "r_test_res_outliers.csv"), index_col=0)
    assert_res_almost_equal(res, r_res, 0.04)
    worst = float((abs(r_res.padj - res.padj) / r_res.padj).max())
    print(f"{dtype} padj max rel err against R: {worst:.4f} (tolerance 0.04)")


def test_validation_errors(data):
    counts, metadata = data
    with pytest.raises(ValueError, match="contrast"):
        pt.run_deseq2(counts, metadata, device="cpu")
    with pytest.raises(ValueError, match="same length"):
        pt.run_deseq2(counts, metadata, contrast=np.array([0.0, 1.0, 0.0]), device="cpu")
    for alt in ("greaterAbs", "lessAbs"):
        with pytest.raises(ValueError, match="positive lfc_null"):
            pt.run_deseq2(counts, metadata, contrast=CONTRAST, lfc_null=-1.0, alt_hypothesis=alt, device="cpu")
    with pytest.raises(ValueError, match="size_factors_fit_type"):
        pt.run_deseq2(counts, metadata, contrast=CONTRAST, size_factors_fit_type="median", device="cpu")


def test_mesh_must_be_a_device_mesh(data):
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.run_deseq2(*data, contrast=CONTRAST, mesh=object(), device="cpu")


def test_cuda_raises_without_a_card(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.run_deseq2(*data, contrast=CONTRAST)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.run_deseq2(*data, contrast=CONTRAST, device="cuda", refit_cooks=False)


def test_contrast_vector_and_quiet(data, capsys):
    """An explicit contrast vector gives the named contrast's results;
    ``quiet=False`` prints the DataFrame."""
    named = pt.run_deseq2(*data, contrast=CONTRAST, refit_cooks=False, device="cpu")
    vec = pt.run_deseq2(*data, contrast=np.array([0.0, 1.0]), refit_cooks=False, device="cpu", quiet=False)
    pd.testing.assert_frame_equal(named, vec)
    assert "log2FoldChange" in capsys.readouterr().out


def test_streamed_wrappers_take_a_dataframe_design(outlier_counts, data):
    """A DataFrame's array is column-major, and ``torch.tensor`` keeps its
    strides: the streamed wrappers make the design contiguous, as the
    kernels need, so a DataFrame design gives the array's result bit for
    bit."""
    from pydeseq2_tpu_torch import fused_stream

    metadata = data[1]
    design = pd.DataFrame({"Intercept": 1.0, "condition[T.B]": (metadata["condition"] == "B").to_numpy(float)},
                          index=metadata.index)
    assert not design.to_numpy().flags.c_contiguous
    seen = []
    inner = fused_stream.summary_pipeline_streamed

    def spy(counts, X, *args, **kwargs):
        seen.append(X.is_contiguous())
        return inner(counts, X, *args, **kwargs)

    kw = dict(dtype=np.float64, refit_cooks=True, max_disp=10.0, beta_tol=1e-8, device="cpu")
    counts = outlier_counts.to_numpy(float).T
    fused_stream.summary_pipeline_streamed = spy
    try:
        a = pt.run_summary_streamed(counts, design, np.array([0.0, 1.0]), **kw)
    finally:
        fused_stream.summary_pipeline_streamed = inner
    b = pt.run_summary_streamed(counts, np.ascontiguousarray(design.to_numpy()), np.array([0.0, 1.0]), **kw)
    assert seen == [True]
    for k in ("lfc", "se", "p_values", "padj", "dispersions"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_smoke_phases_rehearsed_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phases 3l and 4h run through on the CPU at a small
    size (the card's side on the CPU too; no kernel launches here, so the
    routes' kernel lists are emptied): the Python of the card's run."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_api_rehearsal", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cs.DEVICE, cs.N_MAIN, cs.G_MAIN, cs.G_CPU_CMP = "cpu", 24, 600, 400
    cs.STREAM_KERNELS = cs.SUMMARY_KERNELS = ()
    routes = cs.api_path(1)
    assert routes["refit"]["refitted"] > 0 and routes["no refit"]["max_rel_vs_direct"] == 0.0
    assert routes["refit"]["launches"] == dict.fromkeys(pt.kernels.KERNELS, 0)
    assert routes["refit"]["profile_ms"]["pipeline"] > 0
    cs.api_card_vs_cpu()


@pytest.mark.parametrize("kind", ["int", "nan", "float", "negative", "string", "object nan"])
def test_counts_validation_as_jax(data, kind):
    """The entry point's validation of a counts DataFrame: an integer frame
    passes, and each invalid one raises the JAX package's error."""
    from pydeseq2_tpu.utils import test_valid_counts as jax_valid
    from pydeseq2_tpu_torch.utils import test_valid_counts as port_valid

    counts = data[0].iloc[:4, :3].copy()
    if kind == "nan":
        counts = counts.astype(float)
        counts.iloc[1, 1] = np.nan
    elif kind == "float":
        counts = counts.astype(float) + 0.5
    elif kind == "negative":
        counts.iloc[0, 0] = -1
    elif kind == "string":
        counts = counts.astype(str)
    elif kind == "object nan":
        counts = counts.astype(object)
        counts.iloc[2, 0] = None
    if kind == "int":
        assert port_valid(counts) is None and jax_valid(counts) is None
        return
    with pytest.raises(ValueError) as port_err:
        port_valid(counts)
    with pytest.raises(ValueError) as jax_err:
        jax_valid(counts)
    assert str(port_err.value) == str(jax_err.value)
