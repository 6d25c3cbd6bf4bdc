"""Whole-slice parity: the port's ``run_summary_streamed`` against the JAX one, CPU.

The same numpy inputs go to ``pydeseq2_tpu.fused_stream.run_summary_streamed``
and to ``pydeseq2_tpu_torch.run_summary_streamed(device="cpu")``, so every
kernel wrapper runs its plain PyTorch version. The 10-gene synthetic
fixture with ``gene_block=4`` gives 3 gene blocks, one of them padded, as
``tests/test_fused_stream.py`` runs it. float64; each JAX program compiles
once per set of static arguments (module fixtures). The refit cases are in
``test_torch_stream_refit.py``, so that xdist spreads the JAX compiles over
two workers.

Tolerance: rtol 1e-6 on every float output with identical NaN masks, and
exact equality on the flags (``cooks_outlier``, ``irls_converged``,
``replaced``, ``refitted``, ``new_all_zeroes``) and counts: both sides
evaluate the same expressions and differ only in summation order.
"""

import numpy as np
import pytest
import torch

import pydeseq2_tpu_torch as pt
from pydeseq2_tpu.fused_stream import run_summary_streamed as jax_run_summary_streamed
from pydeseq2_tpu.utils import load_example_data

torch.set_num_threads(1)  # xdist runs several workers on a few cores

KW = dict(gene_block=4, dtype=np.float64, max_disp=100.0)


def assert_parity(jo: dict, po: dict) -> None:
    """Same keys; float outputs at rtol 1e-6 with equal NaN masks and
    dtypes; everything else equal."""
    assert jo.keys() == po.keys(), set(jo) ^ set(po)
    for k in jo:
        a, b = np.asarray(jo[k]), np.asarray(po[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            assert np.array_equal(np.isnan(a), np.isnan(b)), k
            m = ~np.isnan(a)
            np.testing.assert_allclose(b[m], a[m], rtol=1e-6, atol=1e-300, err_msg=k)
        else:
            assert np.array_equal(a, b), k


def run_both(counts, X, contrast, **kw) -> tuple[dict, dict]:
    kw = {**KW, **kw}
    jo = jax_run_summary_streamed(counts, X, contrast, **kw)
    po = pt.run_summary_streamed(counts, X, contrast, device="cpu", **kw)
    return jo, po


@pytest.fixture(scope="module")
def synthetic():
    """The 100-sample x 10-gene synthetic study, gene-major, ~condition."""
    counts_df = load_example_data(modality="raw_counts", dataset="synthetic")
    meta = load_example_data(modality="metadata", dataset="synthetic")
    cond = (meta["condition"].values == "B").astype(float)
    return counts_df.values.T.astype(float), np.column_stack([np.ones_like(cond), cond])


CASES = {
    "plain": {},
    # No cohort of 1000 replicates: refit_cooks is a no-op with empty flags.
    "no_replaceable_cohort": dict(refit_cooks=True, min_replicates=1000),
    "stats_layer_off": dict(stats_layer=False),
    "sample_block": dict(sample_block=30),  # 100 samples: 4 blocks, the last clamped to 70-99
    "bh_only": dict(independent_filter=False),
}


@pytest.mark.parametrize("case", CASES)
def test_streamed_matches_jax(synthetic, case):
    counts, X = synthetic
    jo, po = run_both(counts, X, [0.0, 1.0], **CASES[case])
    assert_parity(jo, po)
    if case == "stats_layer_off":
        assert "padj" not in po and "cooks_outlier" not in po
    else:
        assert np.isfinite(po["padj"]).all()
    if case == "no_replaceable_cohort":
        assert not po["replaced"].any() and not po["refitted"].any()


def test_n_genes_prepadding(synthetic):
    """Counts pre-padded to 13 rows with ``n_genes=10``: the pad lanes stay
    out of every global reduction and the outputs are sliced to 10, equal
    to JAX's and to the port's unpadded run."""
    counts, X = synthetic
    padded = np.vstack([counts, np.zeros((3, counts.shape[1]))])
    jo, po = run_both(padded, X, [0.0, 1.0], n_genes=10)
    assert_parity(jo, po)
    plain = pt.run_summary_streamed(counts, X, [0.0, 1.0], device="cpu", **KW)
    for k in ("size_factors", "dispersions", "p_values", "padj"):
        np.testing.assert_allclose(po[k], plain[k], rtol=1e-12, err_msg=k)
    with pytest.raises(ValueError, match="n_genes"):
        pt.run_summary_streamed(padded, X, [0.0, 1.0], device="cpu", n_genes=14, **KW)


def test_tensor_counts_input(synthetic):
    """Counts handed over as a tensor on the run's device give the numpy
    run's result."""
    counts, X = synthetic
    a = pt.run_summary_streamed(torch.as_tensor(counts), X, [0.0, 1.0], device="cpu", **KW)
    b = pt.run_summary_streamed(counts, X, [0.0, 1.0], device="cpu", **KW)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_sf_fit_type_iterative_matches_jax(synthetic):
    """``sf_fit_type="iterative"`` on counts where ratio size factors exist:
    the iterative factors are injected without a warning, as in JAX."""
    import warnings

    counts, X = synthetic
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jo, po = run_both(counts, X, [0.0, 1.0], sf_fit_type="iterative")
    assert_parity(jo, po)
    ratio = pt.run_summary_streamed(counts, X, [0.0, 1.0], device="cpu", **KW)
    assert not np.allclose(po["size_factors"], ratio["size_factors"], rtol=1e-6)
