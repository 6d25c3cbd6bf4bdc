"""The port's blind VST against the JAX package, CPU.

The same numpy inputs go through ``pydeseq2_tpu.fused.vst_pipeline`` /
``pydeseq2_tpu.fused_stream.run_vst_streamed`` and their counterparts in
``pydeseq2_tpu_torch`` with ``device="cpu"``, so the ``vst`` wrapper (and
every kernel wrapper upstream of it) runs its plain PyTorch version. The
100-sample x 10-gene synthetic study; float64; each JAX program compiles
once per set of static arguments.

Tolerances: rtol 1e-6 with equal NaN masks on the pipelines, as the other
slices are held; 1e-12 on the transform alone, whose two sides evaluate
the same expressions and differ by the last-ulp rounding of XLA's log,
sqrt and asinh expansions (1e-5 in float32). The R goldens
(``r_vst.csv``, ``r_mean_vst.csv``) are held at < 2% relative, the JAX
package's bar (``tests/test_vst.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import pydeseq2_tpu_torch as pt
from conftest import data_path
from pydeseq2_tpu.fused import vst_pipeline as jax_vst_pipeline
from pydeseq2_tpu.fused_stream import run_vst_streamed as jax_run_vst_streamed
from pydeseq2_tpu.utils import load_example_data
from pydeseq2_tpu_torch.ops.vst import vst_transform
from test_torch_stream import assert_parity

torch.set_num_threads(1)  # xdist runs several workers on a few cores

MAX_DISP = 100.0  # max(10, N) for the 100-sample study


@pytest.fixture(scope="module")
def study():
    """The synthetic study's counts, gene-major (10, 100)."""
    return load_example_data(modality="raw_counts", dataset="synthetic").values.T.astype(float)


def _jax_transform(counts, sf, coeffs, used_mean, mean_disp, trend_type):
    """The transform as ``pydeseq2_tpu/fused.py:882-909`` spells it."""
    normed = counts / sf[None, :]
    mean_vst = (2.0 * jnp.arcsinh(jnp.sqrt(mean_disp * normed)) - jnp.log(mean_disp) - jnp.log(4.0)) / jnp.log(2.0)
    if trend_type == "mean":
        return mean_vst
    a0, a1 = coeffs[0], coeffs[1]
    parametric = jnp.log2((1.0 + a1 + 2.0 * a0 * normed + 2.0 * jnp.sqrt(a0 * normed * (1.0 + a1 + a0 * normed)))
                          / (4.0 * a0))
    return jnp.where(used_mean, mean_vst, parametric)


TRANSFORM_CASES = {
    "parametric_f64": ("parametric", False, np.float64, 1e-12),
    "used_mean_f64": ("parametric", True, np.float64, 1e-12),
    "mean_f64": ("mean", False, np.float64, 1e-12),
    "parametric_f32": ("parametric", False, np.float32, 1e-5),
}


@pytest.mark.parametrize("case", TRANSFORM_CASES)
def test_vst_transform_matches_jax_expression(case):
    """The plain transform against JAX's expression on drawn counts, size
    factors and trend (zero counts included), with masked rows NaN."""
    trend_type, used_mean, dtype, rtol = TRANSFORM_CASES[case]
    rng = np.random.default_rng(5)
    counts = rng.negative_binomial(2.0, 0.05, (40, 16)).astype(dtype)
    sf = np.exp(rng.normal(0.0, 0.4, 16)).astype(dtype)
    coeffs = np.array([0.07, 1.9], dtype)
    mean_disp = np.array(0.3, dtype)
    mask = np.arange(40) % 6 != 0
    want = np.asarray(_jax_transform(jnp.asarray(counts), jnp.asarray(sf), jnp.asarray(coeffs), jnp.asarray(used_mean),
                                     jnp.asarray(mean_disp), trend_type))
    got = vst_transform(torch.as_tensor(counts), torch.as_tensor(sf), torch.as_tensor(coeffs),
                        torch.tensor(used_mean), torch.as_tensor(mean_disp), torch.as_tensor(mask), trend_type).numpy()
    assert got.dtype == dtype
    assert np.isnan(got[~mask]).all() and np.isfinite(got[mask]).all()
    np.testing.assert_allclose(got[mask], want[mask], rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_log2_is_spelled_as_jax_lowers_it(dtype):
    """jnp.log2(x) lowers to log(x) / log(2) in the dtype; torch.log2
    rounds differently on some inputs. The parametric branch must equal the
    spelled division bit for bit (and so not torch.log2)."""
    rng = np.random.default_rng(0)
    counts = torch.as_tensor(rng.negative_binomial(2.0, 0.02, (50, 40)), dtype=dtype)
    sf = torch.ones(40, dtype=dtype)
    a0, a1 = torch.tensor(0.05, dtype=dtype), torch.tensor(1.3, dtype=dtype)
    arg = (1.0 + a1 + 2.0 * a0 * counts + 2.0 * torch.sqrt(a0 * counts * (1.0 + a1 + a0 * counts))) / (4.0 * a0)
    got = vst_transform(counts, sf, torch.stack([a0, a1]), torch.tensor(False), torch.tensor(0.1, dtype=dtype),
                        torch.ones(50, dtype=torch.bool))
    assert torch.equal(got, torch.log(arg) / torch.tensor(math.log(2.0), dtype=dtype))
    assert not torch.equal(got, torch.log2(arg))


PIPELINE_CASES = {
    "parametric": dict(trend_type="parametric"),
    "mean": dict(trend_type="mean"),
    "parametric_masked_lanes": dict(trend_type="parametric", pad=3),  # 3 zero padding lanes masked out
}


@pytest.mark.parametrize("case", PIPELINE_CASES)
def test_vst_pipeline_matches_jax(study, case):
    kw = dict(PIPELINE_CASES[case])
    counts, mask = study, None
    pad = kw.pop("pad", 0)
    if pad:
        counts = np.vstack([counts, np.zeros((pad, counts.shape[1]))])
        mask = np.arange(counts.shape[0]) < study.shape[0]
    jo = jax_vst_pipeline(jnp.asarray(counts), None if mask is None else jnp.asarray(mask), max_disp=MAX_DISP, **kw)
    po = pt.vst_pipeline(counts, mask, max_disp=MAX_DISP, device="cpu", **kw)
    assert_parity(jo, po)
    if pad:
        assert np.isnan(po["vst_counts"][-pad:].numpy()).all()


@pytest.mark.parametrize(("trend_type", "golden"), [("parametric", "r_vst.csv"), ("mean", "r_mean_vst.csv")])
def test_vst_pipeline_r_golden(study, trend_type, golden):
    """Within 2% of R DESeq2's blind VST (vst(blind=TRUE))."""
    r_vst = pd.read_csv(data_path("single_factor", golden), index_col=0).values
    got = pt.vst_pipeline(study, trend_type=trend_type, device="cpu")["vst_counts"].numpy()
    assert (np.abs(r_vst - got) / r_vst).max() < 0.02


STREAM_CASES = {
    # 10 genes in blocks of 4 (the last padded), medians over 30-sample blocks
    "parametric": dict(gene_block=4, sample_block=30),
    "mean": dict(gene_block=4, trend_type="mean"),
    # 13 rows pre-padded with n_genes=10, the port's counts handed over as a tensor
    "prepadded_tensor": dict(gene_block=4, n_genes=10, pad=3),
}


@pytest.mark.parametrize("case", STREAM_CASES)
def test_run_vst_streamed_matches_jax(study, case):
    kw = dict(STREAM_CASES[case])
    counts = study
    pad = kw.pop("pad", 0)
    if pad:
        counts = np.vstack([counts, np.zeros((pad, counts.shape[1]))])
    jo = jax_run_vst_streamed(counts, dtype=np.float64, max_disp=MAX_DISP, **kw)
    port_counts = torch.as_tensor(counts) if pad else counts
    po = pt.run_vst_streamed(port_counts, dtype=np.float64, max_disp=MAX_DISP, device="cpu", **kw)
    assert_parity(jo, po)
    assert po["vst_counts"].shape == study.shape
    if kw.get("trend_type", "parametric") == "parametric":
        mono = pt.vst_pipeline(study, max_disp=MAX_DISP, device="cpu")
        np.testing.assert_allclose(po["vst_counts"], mono["vst_counts"].numpy(), rtol=1e-6)
