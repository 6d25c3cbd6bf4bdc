"""The port's iterative size factors against the JAX package, CPU.

The same numpy inputs, made from a seed, go through
``pydeseq2_tpu.ops.sizefactors`` and ``pydeseq2_tpu_torch.ops.sizefactors``
with ``device="cpu"``, so the ``sf_nll`` and ``sf_newton`` wrappers run
their plain PyTorch versions. float64; each JAX program compiles once per
static shape (module fixtures).

Tolerances: rtol 1e-10 on the trimmed solve and 1e-8 on the iterative size
factors, with equal keep sets and round counts; the zero-inflated
``run_summary_streamed`` is held as ``test_torch_stream.py`` holds the
streamed summary (rtol 1e-6, equal flags). Both sides evaluate the
same expressions and differ only in the order of the sums, the
pseudo-inverse of the intercept column and the last-ulp rounding of exp,
log and lgamma; the iterative fit runs two dispersion fits a round, whose
grid argmin and Newton steps pass that rounding on. The R golden is held
at < 2% relative, the JAX package's own bar (``tests/test_norm.py:51``).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from conftest import data_path
from pydeseq2_tpu.ops.nb import nb_nll as jax_nb_nll
from pydeseq2_tpu.ops.sizefactors import iterative_size_factors as jax_iterative
from pydeseq2_tpu.ops.sizefactors import trimmed_sf_newton as jax_trimmed
import pydeseq2_tpu_torch as pt
from pydeseq2_tpu.fused_stream import run_summary_streamed as jax_run_summary_streamed
from pydeseq2_tpu.utils import load_example_data
from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops import dispersion
from pydeseq2_tpu_torch.ops import sizefactors as sz
from test_torch_stream import assert_parity

torch.set_num_threads(1)  # xdist runs several workers on a few cores


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def zero_per_gene():
    """The 37 x 9 draw of ``tests/test_norm.py:74-76``: a zero in every gene."""
    rng = np.random.default_rng(3)
    counts = rng.poisson(15.0, (37, 9)).astype(np.float64)
    counts[np.arange(37), np.arange(37) % 9] = 0.0
    return counts


@pytest.fixture(scope="module")
def solve_inputs():
    """A trimmed solve's operands: 60 NB genes x 12 samples, per-gene OLS
    coefficients, dispersions, starting log size factors and a mask."""
    rng = np.random.default_rng(11)
    G, N = 60, 12
    mean = rng.lognormal(3.0, 1.0, G)
    disp = np.clip(rng.lognormal(-2.0, 1.0, G), 1e-3, 5.0)
    sf = np.exp(rng.normal(0.0, 0.3, N))
    counts = rng.negative_binomial(1.0 / disp[:, None], 1.0 / (1.0 + disp[:, None] * mean[:, None] * sf[None, :]))
    log_sf0 = rng.normal(0.0, 0.2, N)
    log_sf0 -= log_sf0.mean()
    coef = (counts / np.exp(log_sf0)[None, :]).mean(axis=1) * rng.uniform(0.9, 1.1, G)
    mask = rng.uniform(size=G) < 0.8
    return counts.astype(np.float64), coef, disp, log_sf0, mask


def _jax_keep(counts, base_mu, disp, log_sf, mask, quant=0.95):
    """The keep set of ``pydeseq2_tpu/ops/sizefactors.py:65-83`` at log_sf,
    from the JAX package's nb_nll."""
    nll = np.asarray(jax_nb_nll(jnp.asarray(counts), jnp.asarray(base_mu * np.exp(log_sf)[None, :]),
                                jnp.asarray(disp)))
    s = np.sort(np.where(mask, nll, np.inf))
    h = (mask.sum() - 1) * quant
    lo, hi = int(np.floor(h)), int(np.ceil(h))
    q = s[lo] * (1.0 - (h - lo)) + s[hi] * (h - lo)
    return (nll < q) & mask


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_trimmed_sf_newton_matches_jax(solve_inputs, masked):
    """The plain trimmed solve (6 rounds x 8 Newton steps) against JAX's on
    the same baseline means: log size factors at rtol 1e-10 and the same
    keep set in the last round."""
    counts, coef, disp, log_sf0, mask = solve_inputs
    mask = mask if masked else np.ones_like(mask)
    base_mu = np.maximum(np.exp(log_sf0)[None, :] * coef[:, None], 0.5) * np.exp(-log_sf0)[None, :]
    jmask = jnp.asarray(mask) if masked else None
    want = np.asarray(jax_trimmed(jnp.asarray(counts), jnp.asarray(base_mu), jnp.asarray(disp),
                                  jnp.asarray(log_sf0), mask=jmask))
    s5 = np.asarray(jax_trimmed(jnp.asarray(counts), jnp.asarray(base_mu), jnp.asarray(disp), jnp.asarray(log_sf0),
                                outer_iters=sz.OUTER_ITERS - 1, mask=jmask))
    got, keep = sz.trimmed_sf_newton(_t(counts), _t(coef), _t(disp), _t(log_sf0),
                                     mask=torch.as_tensor(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    want_keep = _jax_keep(counts, base_mu, disp, s5, mask)
    assert np.array_equal(keep.numpy(), want_keep)
    assert 0 < keep.sum() < mask.sum()


@pytest.fixture(scope="module")
def jax_whole(zero_per_gene):
    sf, n_it = jax_iterative(jnp.asarray(zero_per_gene))
    return np.asarray(sf), int(n_it)


CASES = {
    "whole_g": {},
    "gene_block_8": dict(gene_block=8),  # 5 blocks, the last one of 5 genes
    "padded_masked": dict(gene_block=8, pad=5),  # 42 lanes, 5 padding lanes masked out
}


@pytest.mark.parametrize("case", CASES)
def test_iterative_size_factors_matches_jax(zero_per_gene, jax_whole, case):
    """Whole-G, over gene blocks and on pre-padded, masked counts: the same
    rounds as JAX and size factors at rtol 1e-8; every case equals the JAX
    whole-G result at that tolerance too."""
    kw = dict(CASES[case])
    counts, mask = zero_per_gene, None
    pad = kw.pop("pad", 0)
    if pad:
        counts = np.concatenate([counts, np.zeros((pad, counts.shape[1]))])
        mask = np.arange(counts.shape[0]) < zero_per_gene.shape[0]
    if kw or pad:
        want, want_it = jax_iterative(jnp.asarray(counts), None if mask is None else jnp.asarray(mask), **kw)
        want, want_it = np.asarray(want), int(want_it)
    else:
        want, want_it = jax_whole
    got, n_it = sz.iterative_size_factors(counts, mask, device="cpu", **kw)
    assert n_it == want_it
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)
    np.testing.assert_allclose(got.numpy(), jax_whole[0], rtol=1e-8)


def test_gene_block_changes_no_value(zero_per_gene):
    """The port's gene blocks only tile the dispersion fits and the plain
    solve's rows: the factors agree with whole G to rounding (rtol 1e-12)."""
    whole, n_whole = sz.iterative_size_factors(zero_per_gene, device="cpu")
    for block in (5, 36):
        got, n_it = sz.iterative_size_factors(zero_per_gene, gene_block=block, device="cpu")
        assert n_it == n_whole
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-12)


@pytest.mark.parametrize("gene_block", [None, 8], ids=["whole_g", "gene_block_8"])
def test_round_map_fit_reuses_the_genewise_scan(zero_per_gene, monkeypatch, gene_block):
    """A round runs one coarse scan a slice, the genewise fit's, and its MAP
    fit takes that scan's objective (``STATS.coarse_reuses`` one a slice a
    round); the factors and rounds are bit for bit those of the uncached
    route, which scans again for MAP."""
    n_slices = len(sz._row_slices(zero_per_gene.shape[0], gene_block))
    scans = []
    scan = dispersion.scan_coarse
    monkeypatch.setattr(dispersion, "scan_coarse", lambda *a, **k: scans.append(1) or scan(*a, **k))
    kernels.STATS.reset()
    got, n_it = sz.iterative_size_factors(zero_per_gene, gene_block=gene_block, device="cpu")
    assert n_it >= 3 and len(scans) == kernels.STATS.coarse_reuses == n_it * n_slices

    fit = sz.alpha_mle_batch

    def uncached(*a, coarse_cache=None, return_coarse=False, **k):
        out = fit(*a, **k)
        return (*out, None) if return_coarse else out

    monkeypatch.setattr(sz, "alpha_mle_batch", uncached)
    scans.clear()
    kernels.STATS.reset()
    want, want_it = sz.iterative_size_factors(zero_per_gene, gene_block=gene_block, device="cpu")
    assert len(scans) == 2 * want_it * n_slices and kernels.STATS.coarse_reuses == 0
    assert n_it == want_it
    assert got.numpy().tobytes() == want.numpy().tobytes()
    kernels.STATS.reset()


def test_iterative_size_factors_r_golden():
    """The synthetic study's iterative size factors within 2% of R DESeq2's
    (``r_iterative_size_factors.csv``), at the pipelines' max_disp."""
    counts_df = load_example_data(modality="raw_counts", dataset="synthetic")
    r_sf = pd.read_csv(data_path("single_factor", "r_iterative_size_factors.csv"), index_col=0).squeeze()
    got, _ = sz.iterative_size_factors(counts_df.values.T.astype(float), max_disp=float(max(10, counts_df.shape[0])),
                                       device="cpu")
    rel = np.abs(got.numpy() - r_sf.values) / np.abs(r_sf.values)
    assert rel.max() < 0.02, rel.max()


def test_pick_sf_gene_block():
    """Whole G up to 1 GB of counts; past it the streamed pipelines' even
    split of a ~4 GB budget of 20 temporaries a cell, rounded up to 8, in
    the counts' itemsize (numpy or torch dtypes)."""
    assert sz.pick_sf_gene_block(60_000, 100, np.float32) is None
    assert sz.pick_sf_gene_block(60_000, 4_000, torch.float32) is None  # 0.96 GB
    assert sz.pick_sf_gene_block(60_000, 10_000, np.float32) == 5_000  # 12 blocks
    assert sz.pick_sf_gene_block(60_000, 10_000, torch.float64) == 2_504  # 24 blocks of 2500, rounded up
    assert sz.pick_sf_gene_block(2_000, 200_000, np.float32) == 1_000  # at least 1024 rows: two blocks of 1000


def test_zero_inflated_switches_to_iterative_as_jax():
    """Counts with a zero in every gene (the draw of
    ``tests/test_fused_stream.py:180-190``): both packages warn and switch
    to the iterative size factors, then match key by key."""
    rng = np.random.default_rng(0)
    counts = rng.poisson(20.0, (24, 12)).astype(float)
    counts[np.arange(24), np.arange(24) % 12] = 0.0
    X = np.column_stack([np.ones(12), rng.integers(0, 2, 12)]).astype(float)
    kw = dict(gene_block=8, dtype=np.float64)
    with pytest.warns(UserWarning, match="Switching to iterative mode"):
        jo = jax_run_summary_streamed(counts, X, [0.0, 1.0], **kw)
    with pytest.warns(UserWarning, match="Switching to iterative mode"):
        po = pt.run_summary_streamed(counts, X, [0.0, 1.0], device="cpu", **kw)
    assert_parity(jo, po)
    assert np.isfinite(po["size_factors"]).all() and np.isfinite(po["p_values"]).sum() > 0
