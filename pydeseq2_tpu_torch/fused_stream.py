"""The port's DESeq2 pipelines: the per-tile fit as gene-streamed passes,
and every entry point that runs them, with O(gene_block x N) temporaries.

Port of ``pydeseq2_tpu/fused_stream.py`` and of the entry points of
``pydeseq2_tpu/fused.py``. One set of passes fits DESeq2 for every
pipeline: the log-stats sweep and the size factors, the genewise pass
(:func:`_genewise_pass`), the trend and prior (:func:`_trend_and_prior`),
and the analyse pass (:func:`_analyse_pass`: MAP dispersions, IRLS with
rescue, hat + Wald, the Cook's flags), then padj. They serve the streamed
summary (:func:`summary_pipeline_streamed`, ``:188``) and its host wrapper
:func:`run_summary_streamed` (``:783``, the default path of
``api.run_deseq2``), which refits the genes whose Cook's outliers were
replaced (:func:`refit_pipeline_streamed`, ``:504``); and the single-tile
:func:`wald_pipeline` and :func:`summary_pipeline`, which run them over the
tile as one gene block. Beside them: the apeGLM LFC shrinkage
(:func:`lfc_shrink_pipeline_streamed`, ``:975``, and
:func:`run_lfc_shrink_streamed`, ``:1085``) and the blind VST
(:func:`vst_pipeline`; :func:`vst_pipeline_streamed`, ``:1184``, and
:func:`run_vst_streamed`, ``:1285``). The raw counts stay on the device
once; every per-gene stage runs over ``gene_block`` row slices in a Python
loop (``lax.map`` in the JAX program), and the global reductions (size
factors, trend, prior, the BH sweep) run between the passes on O(G) data,
so each block sees the inputs the whole tile would give it. The stage
helpers the passes share are in :mod:`~pydeseq2_tpu_torch.fused`, the
kernels' wrappers in ``ops/``. The ``lax.cond``/``while_loop`` conditions
that stay on the host are marked where they are read. On zero-inflated
counts :func:`run_summary_streamed` switches to the iterative size factors
(:mod:`~pydeseq2_tpu_torch.ops.sizefactors`).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.fused import (
    _column_median,
    _irls_with_rescue,
    _padj,
    _trend_prior,
    fit_fused_trend,
    summary_host_inputs,
)
from pydeseq2_tpu_torch.ops.cooks import cooks_outliers
from pydeseq2_tpu_torch.ops.dispersion import alpha_mle_batch, map_dispersions
from pydeseq2_tpu_torch.ops.irls import irls_beta_init
from pydeseq2_tpu_torch.ops.linreg import mom_and_mu_coef, mu_from_coef, ols_pinv
from pydeseq2_tpu_torch.ops.refit import impute_outliers
from pydeseq2_tpu_torch.ops.sizefactors import iterative_size_factors, pick_sf_gene_block
from pydeseq2_tpu_torch.ops.shrink import (
    _apeglm_prior_variance,
    _hess,
    grid_fit_shrink_beta_batch,
    nbinom_fn_batch,
    nbinom_glm_batch,
)
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv
from pydeseq2_tpu_torch.ops.vst import vst_transform
from pydeseq2_tpu_torch.ops.wald import hat_wald
from pydeseq2_tpu_torch.parallel.mesh import (
    LaneGroup,
    all_gather_rows,
    all_reduce_sum,
    gather_gene_dict,
    resolve_mesh_device,
)
from pydeseq2_tpu_torch.tracing import read, span, traced

# The ~4 GB device budget of the JAX package's block sizing: ~20 live
# (block, N) temporaries of <= 8 bytes (80 bytes a cell).
_BLOCK_BUDGET_BYTES = 4_000_000_000
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _auto_gene_block(G: int, N: int) -> int:
    """G split evenly into blocks whose ~20 live (block, N) temporaries of
    <= 8 bytes fit the ~4 GB budget, rounded up to 8."""
    raw = int(max(1024, min(G, _BLOCK_BUDGET_BYTES // (80 * N))))
    n_blocks = -(-G // raw)
    return ((-(-G // n_blocks) + 7) // 8) * 8


def _mesh_layout(G: int, B: int, R: int) -> tuple[int, int, int]:
    """How ``R`` ranks stream G genes whose unsharded run takes blocks of
    ``B``: ``(local block, block_ranks, shard rows)``. Each unsharded block
    stays one IRLS tile of B lanes, so the rescue's K and lanes are the
    unsharded run's. Where there are at least R blocks, each rank takes
    whole blocks (``block_ranks`` 1; all-padding blocks fill the last
    ranks). Otherwise each block is split evenly over ``block_ranks``
    consecutive ranks, the fewest groups (a divisor of R, at least the
    blocks) whose split divides B, the blocks padded with all-padding ones
    to the group count (with one group a rank, whole blocks again)."""
    n_blocks = -(-G // B)
    if n_blocks >= R:
        return B, 1, -(-n_blocks // R) * B
    groups = next(d for d in range(n_blocks, R + 1) if R % d == 0 and B % (R // d) == 0)
    q = R // groups
    return B // q, q, B // q


def _mesh_tile(gene_mask, mesh) -> LaneGroup:
    """The IRLS tile of a mesh run of the single pipeline: every rank's
    lanes, in rank order, up to the last gene of ``gene_mask`` over the
    mesh. The trailing pad lanes (``shard_gene_major``'s) are then never
    flagged, and the rescue's K is the unsharded run's, from the G genes.
    One collective and one host read."""
    R, S = mesh.size(), gene_mask.shape[0]
    pos = torch.arange(1, S + 1, device=gene_mask.device) + mesh.get_local_rank() * S
    tile = LaneGroup(mesh, 0, R, R * S)
    return tile._replace(lanes=max(tile.counts(torch.where(gene_mask, pos, 0).max())))


@traced("deseq2.stage")
def _stage_counts(counts, dtype, n_genes, gene_block, dev):
    """The host wrappers' counts: on ``dev`` in ``dtype`` (a torch or numpy
    float dtype; a tensor already there is not copied), with zero rows
    appended up to a multiple of the gene block. ``n_genes`` is the number
    of leading real genes of pre-padded counts. ``gene_block=None`` splits
    them evenly into blocks whose ~20 live (block, N) temporaries of <= 8
    bytes fit the ~4 GB budget, rounded up to 8 (the whole gene axis up to
    ~1000 samples). Returns ``(counts, G, gene_block)``, G the real genes."""
    tdtype = dtype if isinstance(dtype, torch.dtype) else {np.dtype(np.float32): torch.float32,
                                                           np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
    if isinstance(counts, torch.Tensor):
        counts = counts.to(device=dev, dtype=tdtype)
    else:
        counts = torch.tensor(np.asarray(counts, _NP_DTYPE[tdtype]), device=dev)
    G_phys, N = counts.shape
    G = G_phys
    if n_genes is not None:
        if not 0 < n_genes <= G:
            raise ValueError(f"n_genes={n_genes} outside (0, {G}]")
        G = n_genes
    if gene_block is None:
        gene_block = _auto_gene_block(G, N)
    padded_G = math.ceil(G_phys / gene_block) * gene_block
    if padded_G != G_phys:
        counts = torch.cat([counts, counts.new_zeros((padded_G - G_phys, N))])
    return counts.contiguous(), G, gene_block


@traced("deseq2.to_host")
def _to_host(tensors: dict) -> dict:
    """Numpy copies of a dict of tensors in ONE device-to-host copy: every
    tensor is widened to one dtype, joined, copied, split and cast back.
    The dtype is float32 where every tensor is float32 or bool (a (G, N)
    VST result then crosses at its own width), else float64 (exact for the
    bools, small integers, float32 and float64 held here)."""
    if not tensors:
        return {}
    narrow = all(v.dtype in (torch.float32, torch.bool) for v in tensors.values())
    wide = torch.float32 if narrow else torch.float64
    flat = torch.cat([v.reshape(-1).to(wide) for v in tensors.values()])
    with read("to_host"):
        flat = flat.cpu().numpy()
    out, at = {}, 0
    for k, v in tensors.items():
        n = v.numel()
        out[k] = flat[at:at + n].reshape(tuple(v.shape)).astype(str(v.dtype).removeprefix("torch."))
        at += n
    return out


# ---------------------------------------------------------------- size factors
def _block_starts(N: int, sample_block: int) -> list[int]:
    """Column-block starts; the last block's start is clamped to N - block,
    so it overlaps the one before and recomputes a few columns (each
    column's median depends on that column only)."""
    return [min(b * sample_block, N - sample_block) for b in range(-(-N // sample_block))]


def _median_of_col_blocks(counts, med_of_cols, sample_block):
    N = counts.shape[1]
    if sample_block is None or sample_block >= N:
        return med_of_cols(counts)
    med = torch.zeros(N, dtype=counts.dtype, device=counts.device)
    for s in _block_starts(N, sample_block):
        med[s:s + sample_block] = med_of_cols(counts[:, s:s + sample_block])
    return med


def _streamed_size_factors(counts, gene_mask, logmeans, sample_block=None, mesh=None):
    """Median-of-ratios size factors over the genes with finite log-means,
    sample-blocked (``pydeseq2_tpu/fused_stream.py:64``): excluded genes sit
    at +inf and the two middle order statistics come from the ``select``
    kernel, a column block at a time; with ``mesh``, from the radix passes
    summed over the ranks (``fused._column_median``)."""
    filtered = ~torch.isinf(logmeans) & gene_mask
    m = filtered.sum()

    def med_of_cols(cols):
        ratios = torch.where(filtered[:, None], torch.log(cols) - logmeans[:, None],
                             torch.full_like(cols, float("inf")))
        return _column_median(ratios, m, mesh)

    return torch.exp(_median_of_col_blocks(counts, med_of_cols, sample_block))


def _streamed_poscounts_size_factors(counts, usable, logmeans, sample_block=None, mesh=None):
    """Poscounts size factors, sample-blocked (``pydeseq2_tpu/fused_stream.py:117``):
    each sample's median runs over the usable genes positive in it, then the
    factors are rescaled to geometric mean 1. ``mesh``: as
    :func:`_streamed_size_factors`."""

    def med_of_cols(cols):
        in_med = usable[:, None] & (cols > 0)
        ratios = torch.where(in_med, torch.log(torch.where(cols > 0, cols, torch.ones_like(cols))) - logmeans[:, None],
                             torch.full_like(cols, float("inf")))
        return _column_median(ratios, in_med.sum(dim=0), mesh)

    sf = torch.exp(_median_of_col_blocks(counts, med_of_cols, sample_block))
    return sf / torch.exp(torch.mean(torch.log(sf)))


# ---------------------------------------------------------- streamed summary
def _log_stats(counts, gene_mask, gene_block, sf_fit_type):
    """The cheap full sweep: per-gene log-means (over positive counts with
    the full-N divisor for poscounts, -inf where a gene has a zero
    otherwise) and the non-zero mask (``fused_stream.py:255-270``)."""
    logmeans, non_zero = [], []
    for b in range(0, counts.shape[0], gene_block):
        c = counts[b:b + gene_block]
        if sf_fit_type == "poscounts":
            pos = c > 0
            logmeans.append(torch.where(pos, torch.log(torch.where(pos, c, torch.ones_like(c))),
                                        torch.zeros_like(c)).mean(dim=1))
        else:
            logmeans.append(torch.log(c).mean(dim=1))
        non_zero.append((c > 0).any(dim=1) & gene_mask[b:b + gene_block])
    return torch.cat(logmeans), torch.cat(non_zero)


def _mu_init(c, sf, X, pinv, min_mu, min_disp, max_disp, beta_tol, mu_init, group=None):
    """MoM dispersions, the mu-init coefficients and mu of one tile: ``(mom,
    beta_coef, mu_hat, overflow)``. The coefficients are the OLS fit
    ("linear", mu from the same ``mom`` launch) or the IRLS fit with rescue
    ("irls"); :func:`_mu_hat` rebuilds mu from them in a later pass
    (``fused_stream.py:287-314``)."""
    linear = mu_init != "irls"
    rough, moments, coef, mu_hat = mom_and_mu_coef(c, sf, X, pinv, min_mu, want_mu=linear)
    mom = torch.clamp(torch.minimum(rough, moments), min_disp, max_disp)
    if linear:
        return mom, coef, mu_hat, torch.zeros((), dtype=torch.int64, device=c.device)
    coef, _, overflow = _irls_with_rescue(c, sf, X, mom, irls_beta_init(c, sf, X), min_mu=min_mu, beta_tol=beta_tol,
                                          group=group)
    return mom, coef, _mu_hat(coef, sf, X, min_mu, mu_init), overflow


def _mu_hat(coef, sf, X, min_mu, mu_init):
    """mu from the init coefficients: UNthresholded sf e^{X b} after the
    IRLS init (the reference irls_solver's return), else the clamped OLS
    fit."""
    if mu_init == "irls":
        return sf[None, :] * torch.exp(coef @ X.T)
    return mu_from_coef(coef, sf, X, min_mu)


@traced("deseq2.genewise")
def _genewise_pass(counts, sf, X, pinv, gene_block, min_mu, min_disp, max_disp, beta_tol, mu_init, group=None):
    """Streamed pass 1: per block, base means, the mu init and the genewise
    dispersion MLE with its coarse-grid objective cache, which the MAP fit
    of pass 2 reuses (``fused_stream.py:316-332``). ``group``: the lane
    group of each block's IRLS tile where blocks are split over ranks."""
    base_mean, genewise, coarse, coefs, overflow = [], [], [], [], []
    for b in range(0, counts.shape[0], gene_block):
        c = counts[b:b + gene_block]
        base_mean.append((c / sf[None, :]).mean(dim=1))
        mom, coef, mu_hat, of = _mu_init(c, sf, X, pinv, min_mu, min_disp, max_disp, beta_tol, mu_init, group)
        gw, _, cache = alpha_mle_batch(c, X, mu_hat, mom, min_disp, max_disp, cr_reg=True, prior_reg=False,
                                       return_coarse=True)
        genewise.append(torch.clamp(gw, min_disp, max_disp))
        coarse.append(cache)
        coefs.append(coef)
        overflow.append(of)
    return torch.cat(base_mean), torch.cat(genewise), coarse, coefs, torch.stack(overflow).sum()


@traced("deseq2.trend_prior")
def _trend_and_prior(base_mean, genewise_m, non_zero, min_disp, trend_type, max_rounds, N, P, mesh=None):
    """The global reductions between the passes: the dispersion trend (one
    ``trend`` launch, at most ``max_rounds`` rounds) and the prior
    (``fused_stream.py:334-350``), over the gathered gene axis with
    ``mesh``."""
    return _trend_prior(base_mean, genewise_m, non_zero, min_disp, trend_type, max_rounds, N, P, mesh)


@traced("deseq2.map")
def _shrunk_dispersions(c, X, mu_hat, genewise, fitted, cache, prior_disp_var, squared_logres, min_disp, max_disp):
    """One block's :func:`~pydeseq2_tpu_torch.ops.dispersion.map_dispersions`:
    ``(map, dispersions)``."""
    return map_dispersions(c, X, mu_hat, genewise, fitted, cache, prior_disp_var, squared_logres, min_disp, max_disp)


@traced("deseq2.analyse")
def _analyse_pass(counts, non_zero, sf, X, contrast, lfc_null, cooks_cutoff, genewise_m, fitted_m,
                  coarse, coefs, prior_disp_var, squared_logres, *, gene_block, cohort_ids, use_for_max,
                  replaceable, min_mu, min_disp, max_disp, beta_tol, alt_hypothesis, mu_init, stats_layer,
                  group=None, tile_outputs=False):
    """Streamed pass 2: per block, MAP dispersions, IRLS with rescue, hat
    diagonals + Wald and the Cook's flags (``fused_stream.py:352-460``). The
    Cook's distances live only inside the ``cooks`` launch; with
    ``replaceable`` it also emits the refit-mode outputs. ``tile_outputs``
    keeps each block's (rows, N) ``mu``, ``hat_diagonals`` and, with the
    Cook's flags, the distances ``cooks``."""
    P = X.shape[1]
    blocks = []
    for k, b in enumerate(range(0, counts.shape[0], gene_block)):
        sl = slice(b, b + gene_block)
        c, nz = counts[sl], non_zero[sl]
        nan = torch.full((c.shape[0],), float("nan"), dtype=c.dtype, device=c.device)
        map_disp, dispersions = _shrunk_dispersions(
            c, X, _mu_hat(coefs[k], sf, X, min_mu, mu_init), genewise_m[sl], fitted_m[sl], coarse[k],
            prior_disp_var, squared_logres, min_disp, max_disp)
        dispersions = torch.where(nz, dispersions, nan)
        disp_safe = torch.nan_to_num(dispersions, nan=0.5)
        beta, converged, lfc_overflow = _irls_with_rescue(c, sf, X, disp_safe, irls_beta_init(c, sf, X),
                                                          min_mu=min_mu, beta_tol=beta_tol, group=group)
        H, mu, pv, st, se = hat_wald(beta, disp_safe, sf, X, contrast, lfc_null, min_mu=min_mu,
                                     alt_hypothesis=alt_hypothesis)
        res = {
            "dispersions": dispersions,
            "MAP_dispersions": torch.where(nz, map_disp, nan),
            "lfc": torch.where(nz[:, None], beta, nan[:, None]),
            "p_values": torch.where(nz, pv, nan),
            "statistics": torch.where(nz, st, nan),
            "se": torch.where(nz, se, nan),
            "irls_converged": converged,
            "_lfc_overflow": lfc_overflow,
        }
        if tile_outputs:
            res["mu"], res["hat_diagonals"] = mu, H
        if stats_layer:
            flags = cooks_outliers(c, sf, mu, H, nz, P, cohort_ids, use_for_max, cooks_cutoff,
                                   replaceable=replaceable, want_distances=tile_outputs)
            res["cooks_outlier"] = flags[1]
            if tile_outputs:
                res["cooks"] = flags[0]
            if replaceable is not None:
                res["exceeds_packed"], res["replaced"], res["cooks_outlier_refit"] = flags[3:]
        blocks.append(res)
    lfc_overflow = torch.stack([blk.pop("_lfc_overflow") for blk in blocks]).sum()
    if len(blocks) == 1:  # the single pipelines' one block: no copy of its (G, N) outputs
        return blocks[0], lfc_overflow
    return {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}, lfc_overflow


def summary_pipeline_streamed(
    counts: torch.Tensor,
    design_matrix: torch.Tensor,
    contrast: torch.Tensor,
    lfc_null: torch.Tensor,
    cooks_cutoff: torch.Tensor,
    gene_mask: torch.Tensor | None = None,
    size_factors: torch.Tensor | None = None,
    *,
    gene_block: int = 8192,
    sample_block: int | None = None,
    cohort_ids: tuple[int, ...] | None = None,
    use_for_max: tuple[bool, ...] | None = None,
    replaceable: tuple[bool, ...] | None = None,
    alpha: float = 0.05,
    cooks_filter: bool = True,
    independent_filter: bool = True,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    beta_tol: float = 1e-8,
    trend_type: str = "parametric",
    trend_rounds: int = 8,
    alt_hypothesis: str | None = None,
    mu_init: str = "linear",
    stats_layer: bool = True,
    refit_mode: bool = False,
    sf_fit_type: str = "ratio",
    tile_outputs: bool = False,
    mesh=None,
    group: LaneGroup | None = None,
) -> dict:
    """Counts -> padj with O(gene_block x N) temporaries, on the device of
    ``counts``.

    The arguments and semantics of :func:`pydeseq2_tpu_torch.summary_pipeline`
    plus ``gene_block`` (G must be a multiple of it: pad with
    ``gene_mask=False`` lanes, as :func:`run_summary_streamed` does) and
    ``sample_block`` (size-factor medians over column blocks). Tensors of
    one float dtype on one device. ``stats_layer=False`` skips the Cook's
    flags and padj; ``size_factors`` (N,) skips the estimator.
    ``refit_mode=True`` (with ``replaceable``, the (N,) samples in cohorts
    of at least ``min_replicates``) prepares the Cook's refit instead of
    finishing: per-gene ``replaced``, the packed exceed bits
    ``exceeds_packed`` and ``cooks_outlier_refit``; p-value masking and
    padj are left to the caller, which merges the refit first. Returns the
    dict of ``pydeseq2_tpu/fused_stream.py:188`` as tensors; no (G, N)
    result unless ``tile_outputs``, which adds the (G, N) ``mu``,
    ``hat_diagonals`` and, with the stats layer, the Cook's distances
    ``cooks`` (what :func:`summary_pipeline` returns). The trend runs at
    most max(``trend_rounds``, 20) rounds.

    ``mesh`` (the JAX "pod" shape: gene-sharded over ranks and streamed
    within each): every rank calls with its shard of the gene axis, every
    shard the same size, and streams it in blocks of ``gene_block``; the
    size factors, trend, prior and padj run over every rank's genes, and
    per-gene outputs are the shard's; each block is its own IRLS tile, or
    with ``group`` (a :class:`~pydeseq2_tpu_torch.parallel.mesh.LaneGroup`
    the caller builds, the shard then one block) this rank's share of the
    group's tile, whose rescue shares one lane quota.
    """
    G, N = counts.shape
    X = design_matrix
    P = X.shape[1]
    if gene_mask is None:
        gene_mask = torch.ones(G, dtype=torch.bool, device=counts.device)
    if use_for_max is None:
        use_for_max = (True,) * N
    if G % gene_block:
        raise ValueError(f"pad G={G} to a multiple of gene_block={gene_block}")
    if refit_mode and replaceable is None:
        raise ValueError("refit_mode needs the replaceable mask")
    if group is not None and G != gene_block:
        raise ValueError(f"a lane group needs a shard of one gene block, not G={G} in blocks of {gene_block}")

    with span("deseq2.size_factors"):
        logmeans, non_zero = _log_stats(counts, gene_mask, gene_block, sf_fit_type)
        if size_factors is not None:
            sf = size_factors
        elif sf_fit_type == "poscounts":
            usable = torch.isfinite(logmeans) & (logmeans > 0) & gene_mask
            sf = _streamed_poscounts_size_factors(counts, usable, logmeans, sample_block, mesh)
        else:
            sf = _streamed_size_factors(counts, gene_mask, logmeans, sample_block, mesh)

    base_mean, genewise, coarse, coefs, mu_overflow = _genewise_pass(
        counts, sf, X, ols_pinv(X), gene_block, min_mu, min_disp, max_disp, beta_tol, mu_init, group)
    genewise_m = torch.where(non_zero, genewise, torch.full_like(genewise, float("nan")))
    fitted_m, trend_coeffs, trend_used_mean, mean_disp, squared_logres, prior_disp_var = _trend_and_prior(
        base_mean, genewise_m, non_zero, min_disp, trend_type, max(trend_rounds, 20), N, P, mesh)

    flat, lfc_overflow = _analyse_pass(
        counts, non_zero, sf, X, contrast, lfc_null, cooks_cutoff, genewise_m, fitted_m, coarse, coefs,
        prior_disp_var, squared_logres, gene_block=gene_block, cohort_ids=cohort_ids,
        use_for_max=tuple(bool(u) for u in use_for_max), replaceable=replaceable if refit_mode else None,
        min_mu=min_mu, min_disp=min_disp, max_disp=max_disp, beta_tol=beta_tol, alt_hypothesis=alt_hypothesis,
        mu_init=mu_init, stats_layer=stats_layer, group=group, tile_outputs=tile_outputs)
    out = {
        "rescue_overflow": all_reduce_sum((mu_overflow + lfc_overflow).reshape(1), mesh)[0],
        "size_factors": sf,
        "base_mean": base_mean,
        "genewise_dispersions": genewise_m,
        "fitted_dispersions": fitted_m,
        "trend_coeffs": trend_coeffs,
        "trend_used_mean": trend_used_mean,
        "mean_disp": mean_disp,
        "squared_logres": squared_logres,
        "prior_disp_var": prior_disp_var,
        **flat,
    }
    if stats_layer and not refit_mode:
        p = out["p_values"]
        if cooks_filter:
            p = torch.where(out["cooks_outlier"], torch.full_like(p, float("nan")), p)
            out["p_values"] = p
        out["padj"] = _padj_program(p, base_mean, gene_mask, alpha, independent_filter, mesh)
    return out


# ------------------------------------------------------- one tile: one block
def _one_block(counts, design_matrix, contrast, lfc_null, cooks_cutoff, gene_mask, size_factors, device, mesh,
               **knobs) -> dict:
    """:func:`summary_pipeline_streamed` over a (G, N) tile as one gene
    block, every operand moved to ``device`` (the mesh's with ``mesh``) in
    the dtype of ``counts``, contiguous; with ``mesh`` the IRLS tile is
    :func:`_mesh_tile`'s. Returns the single pipelines' keys and the
    ``cooks_outlier`` and ``padj`` of the stats layer."""
    dev = resolve_mesh_device(device, mesh)
    counts = torch.as_tensor(counts, device=dev).contiguous()
    G = counts.shape[0]

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, dtype=counts.dtype, device=dev).contiguous()

    gene_mask = (torch.ones(G, dtype=torch.bool, device=dev) if gene_mask is None
                 else torch.as_tensor(gene_mask, dtype=torch.bool, device=dev))
    out = summary_pipeline_streamed(
        counts, on_dev(design_matrix), on_dev(contrast), on_dev(lfc_null), on_dev(cooks_cutoff), gene_mask,
        on_dev(size_factors), gene_block=G, tile_outputs=True, mesh=mesh,
        group=None if mesh is None else _mesh_tile(gene_mask, mesh), **knobs)
    del out["MAP_dispersions"], out["mean_disp"]
    return out


def wald_pipeline(
    counts,
    design_matrix,
    contrast,
    lfc_null,
    gene_mask=None,
    size_factors=None,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    beta_tol: float = 1e-8,
    trend_type: str = "parametric",
    trend_rounds: int = 8,
    alt_hypothesis: str | None = None,
    mu_init: str = "linear",
    sf_fit_type: str = "ratio",
    device: str | torch.device | None = None,
    *,
    mesh=None,
) -> dict:
    """One-call DESeq2 Wald pipeline on ``device`` (default ``"cuda"``):
    size factors -> MoM dispersions -> mu init -> genewise dispersions ->
    trend -> prior -> MAP dispersions -> IRLS LFCs -> hat diagonals + Wald
    test, the passes of :func:`summary_pipeline_streamed` over the tile as
    one gene block without the stats layer.

    counts (G, N) float32/float64, gene-major; design_matrix (N, P);
    contrast (P,); lfc_null a natural-log scalar; gene_mask (G,) bool with
    False for padding lanes; size_factors (N,) to bypass the estimator.
    Tensors or arrays; every operand moves to ``device`` in the dtype of
    ``counts``. Raises if CUDA is requested and absent. Returns the dict of
    ``pydeseq2_tpu.fused.wald_pipeline`` (same keys) as tensors on
    ``device``; :func:`pydeseq2_tpu_torch.outputs_to_numpy` converts it.

    ``mesh`` (:func:`~pydeseq2_tpu_torch.parallel.mesh.make_gene_mesh`):
    every rank calls with its shard of the gene axis (``counts`` and
    ``gene_mask`` from :func:`~pydeseq2_tpu_torch.parallel.mesh.shard_gene_major`,
    every shard the same size) and the same replicated design, contrast and
    size factors, on the mesh's device (a ``device`` that disagrees
    raises). The global stages run over every rank's genes, as the JAX
    package's sharded program does; per-gene outputs are the shard's,
    ``rescue_overflow`` the whole run's. The IRLS rescue takes its lane
    quota over the lanes up to the last gene of ``gene_mask``, so the
    trailing pad lanes leave it as the unsharded run's.
    """
    return _one_block(
        counts, design_matrix, contrast, lfc_null, None, gene_mask, size_factors, device, mesh, min_mu=min_mu,
        min_disp=min_disp, max_disp=max_disp, beta_tol=beta_tol, trend_type=trend_type, trend_rounds=trend_rounds,
        alt_hypothesis=alt_hypothesis, mu_init=mu_init, sf_fit_type=sf_fit_type, stats_layer=False)


def summary_pipeline(
    counts,
    design_matrix,
    contrast,
    lfc_null,
    cooks_cutoff,
    gene_mask=None,
    size_factors=None,
    *,
    cohort_ids: tuple[int, ...] | None = None,
    use_for_max: tuple[bool, ...] | None = None,
    alpha: float = 0.05,
    cooks_filter: bool = True,
    independent_filter: bool = True,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    beta_tol: float = 1e-8,
    trend_type: str = "parametric",
    trend_rounds: int = 8,
    alt_hypothesis: str | None = None,
    mu_init: str = "linear",
    sf_fit_type: str = "ratio",
    device: str | torch.device | None = None,
    mesh=None,
) -> dict:
    """Counts -> padj on ``device`` (default ``"cuda"``): the DESeq2
    ``deseq2()`` + ``summary()`` workflow with ``refit_cooks=False``.

    :func:`wald_pipeline`, then Cook's distances and the Cook's outlier
    mask (reference pydeseq2/dds.py:986-1110) and the adjusted p-values, BH
    with or without independent filtering (reference pydeseq2/ds.py:486-542),
    all of it the passes of :func:`summary_pipeline_streamed` over the tile
    as one gene block. ``cooks_cutoff`` (the F(0.99, P, N - P) quantile),
    ``cohort_ids`` and ``use_for_max`` come from :func:`summary_host_inputs`;
    the other arguments are :func:`wald_pipeline`'s. Returns the dict of
    ``pydeseq2_tpu.fused.summary_pipeline``: the Wald keys plus ``cooks``
    (G, N), ``cooks_outlier`` (G,), the outlier-masked ``p_values`` and
    ``padj`` (float64 whatever the dtype of ``counts``, as the JAX package
    adjusts in float64). The Cook's block and ``device_padj`` read nothing
    back to the host. ``mesh``: as :func:`wald_pipeline`'s; the adjusted
    p-values are computed on the gathered gene axis.
    """
    return _one_block(
        counts, design_matrix, contrast, lfc_null, cooks_cutoff, gene_mask, size_factors, device, mesh,
        cohort_ids=cohort_ids, use_for_max=use_for_max, alpha=alpha, cooks_filter=cooks_filter,
        independent_filter=independent_filter, min_mu=min_mu, min_disp=min_disp, max_disp=max_disp,
        beta_tol=beta_tol, trend_type=trend_type, trend_rounds=trend_rounds, alt_hypothesis=alt_hypothesis,
        mu_init=mu_init, sf_fit_type=sf_fit_type)


# --------------------------------------------------------------- Cook's refit
def refit_pipeline_streamed(
    counts_tile: torch.Tensor,
    exceeds_packed: torch.Tensor,
    tile_mask: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    contrast: torch.Tensor,
    lfc_null: torch.Tensor,
    trend_coeffs: torch.Tensor,
    trend_used_mean: torch.Tensor,
    mean_disp: torch.Tensor,
    prior_disp_var: torch.Tensor,
    squared_logres: torch.Tensor,
    *,
    refit_block: int = 4096,
    replaceable: tuple[bool, ...],
    alt_hypothesis: str | None = None,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    beta_tol: float = 1e-8,
    mu_init: str = "linear",
) -> dict:
    """Impute the Cook's outlier counts of the flagged genes and refit them,
    a ``refit_block`` of tile rows at a time (``pydeseq2_tpu/fused_stream.py:504``).

    The (K, N) tile holds the genes whose ``replaced`` flag fired, padded to
    a multiple of ``refit_block`` with ``tile_mask=False`` rows. Per block:
    the ``impute`` kernel; genes left all zero are reported
    (``new_all_zero``), not refitted; then the genewise dispersion MLE (MoM
    and mu init), the PARENT trend at the new base means (not refitted),
    MAP shrinkage with the parent prior, IRLS and the Wald test (reference
    dds.py:1392-1441). The global inputs (trend, prior, size factors) come
    from the main pass, so the refit is gene-parallel.
    """
    K, N = counts_tile.shape
    X = design_matrix
    sf = size_factors
    if K % refit_block:
        raise ValueError(f"pad the refit tile K={K} to a multiple of refit_block={refit_block}")
    pinv = ols_pinv(X)
    blocks = []
    for b in range(0, K, refit_block):
        sl = slice(b, b + refit_block)
        m = tile_mask[sl]
        imputed, new_all_zero = impute_outliers(counts_tile[sl], exceeds_packed[sl], replaceable, sf, m)
        live = m & ~new_all_zero
        base_mean2 = (imputed / sf[None, :]).mean(dim=1)
        mom, _, mu_hat, of0 = _mu_init(imputed, sf, X, pinv, min_mu, min_disp, max_disp, beta_tol, mu_init)
        genewise2, _, coarse = alpha_mle_batch(imputed, X, mu_hat, mom, min_disp, max_disp,
                                               cr_reg=True, prior_reg=False, return_coarse=True)
        genewise2 = torch.clamp(genewise2, min_disp, max_disp)
        # The parent trend at the NEW normed means (reference dds.py:1421-1433).
        fitted2 = torch.where(trend_used_mean, mean_disp, trend_coeffs[0] + trend_coeffs[1] / base_mean2)
        map2, dispersions2 = _shrunk_dispersions(imputed, X, mu_hat, genewise2, fitted2, coarse, prior_disp_var,
                                                 squared_logres, min_disp, max_disp)
        disp_safe = torch.nan_to_num(dispersions2, nan=0.5)
        beta2, converged2, of1 = _irls_with_rescue(imputed, sf, X, disp_safe, irls_beta_init(imputed, sf, X),
                                                   min_mu=min_mu, beta_tol=beta_tol)
        _, _, pv2, st2, se2 = hat_wald(beta2, disp_safe, sf, X, contrast, lfc_null, min_mu=min_mu,
                                       alt_hypothesis=alt_hypothesis, want_hat=False)
        nan = torch.full_like(base_mean2, float("nan"))

        def nanl(a):
            return torch.where(live, a, nan)

        blocks.append({
            "new_all_zero": new_all_zero,
            "base_mean": torch.where(m, base_mean2, nan),
            "genewise_dispersions": nanl(genewise2),
            "fitted_dispersions": nanl(fitted2),
            "MAP_dispersions": nanl(map2),
            "dispersions": nanl(dispersions2),
            "lfc": torch.where(live[:, None], beta2, nan[:, None]),
            "p_values": nanl(pv2),
            "statistics": nanl(st2),
            "se": nanl(se2),
            "irls_converged": converged2,
            "_overflow": of0 + of1,
        })
    overflow = torch.stack([blk.pop("_overflow") for blk in blocks]).sum()
    out = {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}
    out["rescue_overflow"] = overflow
    return out


@traced("deseq2.padj")
def _padj_program(p, base_mean, gene_mask, alpha, independent_filter, mesh=None):
    """padj on the merged arrays (``fused_stream.py:661``), NaN off the mask;
    over the gathered gene axis with ``mesh``."""
    padj = _padj(p, base_mean, gene_mask, alpha, independent_filter, mesh)
    return torch.where(gene_mask, padj, torch.full_like(padj, float("nan")))


def _refit_block_size(N: int) -> int:
    """Rows per refit block: the main pass's ~4 GB budget, 256 to 4096 rows,
    rounded up to 8 (``fused_stream.py:701-702``)."""
    block = int(min(4096, max(256, _BLOCK_BUDGET_BYTES // (80 * N))))
    return ((block + 7) // 8) * 8


def _gather_refit_tile(counts_dev, exceeds_packed, idx, refit_block):
    """The compacted refit tile, gathered on the device: the flagged genes'
    rows and exceed words, padded to a multiple of ``refit_block`` with
    copies of row 0 masked out (``fused_stream.py:697-710``)."""
    n_rep = len(idx)
    K = math.ceil(n_rep / refit_block) * refit_block
    dev = counts_dev.device
    gather = torch.as_tensor(np.pad(idx, (0, K - n_rep)), device=dev)
    tile_mask = torch.arange(K, device=dev) < n_rep
    return counts_dev.index_select(0, gather), exceeds_packed.index_select(0, gather), tile_mask


def _gather_refit_tile_mesh(counts_local, exceeds_local, idx, refit_block, mesh):
    """:func:`_gather_refit_tile` over a gene mesh: the same tile, whole on
    every rank. Each rank sends its local row 0 and its flagged genes' rows
    and exceed words, padded to the largest count a rank holds (the counts
    come from ``idx``, which every rank knows), in two collectives reached
    on every rank; the pad rows are global row 0, rank 0's first slot."""
    S = counts_local.shape[0]
    R, r = mesh.size(), mesh.get_local_rank()
    owner = idx // S
    per_rank = np.bincount(owner, minlength=R)
    width = 1 + int(per_rank.max())
    mine = idx[owner == r] - r * S
    take = torch.as_tensor(np.concatenate([[0], mine, np.zeros(width - 1 - len(mine), np.int64)]),
                           dtype=torch.int64, device=counts_local.device)
    rows = all_gather_rows(counts_local.index_select(0, take), mesh).reshape(R * width, -1)
    words = all_gather_rows(exceeds_local.index_select(0, take), mesh).reshape(R * width, -1)
    first = np.cumsum(per_rank) - per_rank  # each rank's first flagged gene in idx
    pos = owner * width + 1 + (np.arange(len(idx)) - first[owner])
    return _gather_refit_tile(rows, words, pos, refit_block)


# The streamed summary's outputs that are the same on every rank of a mesh.
_REPLICATED = frozenset(("rescue_overflow", "size_factors", "trend_coeffs", "trend_used_mean", "mean_disp",
                         "squared_logres", "prior_disp_var"))


def _stage_shard(counts, dtype, G: int, gene_block: int, mesh, dev):
    """This rank's shard of the first G rows of whole ``counts`` (an array
    or a tensor), zero-padded, on ``dev`` in ``dtype``, laid out by
    :func:`_mesh_layout` for the unsharded block ``gene_block``: ``(shard,
    local block, group)``, ``group`` the
    :class:`~pydeseq2_tpu_torch.parallel.mesh.LaneGroup` of this rank's
    block where the layout splits one block over several ranks, else
    None."""
    tdtype = dtype if isinstance(dtype, torch.dtype) else {np.dtype(np.float32): torch.float32,
                                                           np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
    block, block_ranks, S = _mesh_layout(G, gene_block, mesh.size())
    lo = S * mesh.get_local_rank()
    hi = min(lo + S, G)
    part = counts[lo:hi] if hi > lo else counts[:0]
    if isinstance(part, torch.Tensor):
        part = part.to(device=dev, dtype=tdtype)
    else:
        part = torch.tensor(np.asarray(part, _NP_DTYPE[tdtype]), device=dev)
    if part.shape[0] < S:
        part = torch.cat([part, part.new_zeros((S - part.shape[0], part.shape[1]))])
    group = None
    if block_ranks > 1:
        first = mesh.get_local_rank() // block_ranks * block_ranks
        group = LaneGroup(mesh, first, block_ranks, block * block_ranks)
    return part.contiguous(), block, group


_REFIT_COLUMNS = ("base_mean", "genewise_dispersions", "fitted_dispersions", "MAP_dispersions", "dispersions",
                  "p_values", "statistics", "se")


def _merge_refit(res, rnp, idx, G):
    """Overwrite the refitted genes' columns of the host result ``res`` with
    the refit's ``rnp`` (both numpy); genes left all zero get zero means and
    LFC and neutral Wald statistics (reference dds.py:1381-1384,
    ds.py:356-360). Returns (refitted, new_all_zeroes), (G,) bools."""
    refitted = np.zeros(G, dtype=bool)
    new_all_zero = np.zeros(G, dtype=bool)
    naz = rnp["new_all_zero"]
    live = ~naz
    refitted[idx[live]] = True
    new_all_zero[idx[naz]] = True
    for col in _REFIT_COLUMNS + ("lfc", "irls_converged"):
        res[col] = np.array(res[col])
        res[col][idx[live]] = rnp[col][live]
    res["base_mean"][idx[naz]] = 0.0
    res["lfc"][idx[naz]] = 0.0
    res["se"][idx[naz]] = 0.0
    res["statistics"][idx[naz]] = 0.0
    res["p_values"][idx[naz]] = 1.0
    res["rescue_overflow"] = res["rescue_overflow"] + rnp["rescue_overflow"]
    return refitted, new_all_zero


@traced("deseq2.refit")
def _apply_streamed_refit(res, out, counts_dev, X, contrast, lfc_null, host, knobs, G, mesh=None):
    """Gather the flagged genes, refit them, merge, mask, adjust
    (``pydeseq2_tpu/fused_stream.py:670``; reference dds.py:1042-1064 then
    ds.py:223-301). ``res`` is the host result of the main pass, ``out``
    its device tensors; refitted genes keep ``cooks_outlier_refit``, and
    padj runs on the merged arrays over the G real genes. With ``mesh``,
    ``res`` is whole and ``counts_dev`` and ``exceeds_packed`` the shard's:
    the refit tile is gathered whole and every rank refits it and adjusts
    the whole gene axis, with no collective past the gather (whose ``if``
    reads ``res``, the same on every rank)."""
    # Host-evaluated: which genes to refit (the gather's index list).
    idx = np.where(res["replaced"])[0]
    refitted = np.zeros(G, dtype=bool)
    new_all_zero = np.zeros(G, dtype=bool)
    if len(idx) > 0:
        refit_block = _refit_block_size(X.shape[0])
        if mesh is None:
            tile, packed, tile_mask = _gather_refit_tile(counts_dev, out["exceeds_packed"], idx, refit_block)
        else:
            tile, packed, tile_mask = _gather_refit_tile_mesh(counts_dev, out["exceeds_packed"], idx, refit_block,
                                                              mesh)
        r = refit_pipeline_streamed(
            tile, packed, tile_mask, out["size_factors"], X, contrast, lfc_null, out["trend_coeffs"],
            out["trend_used_mean"], out["mean_disp"], out["prior_disp_var"], out["squared_logres"],
            refit_block=refit_block, replaceable=host["replaceable"], alt_hypothesis=knobs.get("alt_hypothesis"),
            min_mu=knobs.get("min_mu", 0.5), min_disp=knobs.get("min_disp", 1e-8),
            max_disp=knobs.get("max_disp", 10.0), beta_tol=knobs.get("beta_tol", 1e-8),
            mu_init=knobs.get("mu_init", "linear"),
        )
        rnp = {k: v[:len(idx)] if v.ndim >= 1 else v for k, v in _to_host(r).items()}
        refitted, new_all_zero = _merge_refit(res, rnp, idx, G)
    res["refitted"] = refitted
    res["new_all_zeroes"] = new_all_zero
    outlier = np.where(refitted, res.pop("cooks_outlier_refit"), res["cooks_outlier"])
    res["cooks_outlier"] = outlier
    p = np.array(res["p_values"])
    if knobs.get("cooks_filter", True):
        p[outlier] = np.nan
        res["p_values"] = p
    dev = counts_dev.device
    padj = _padj_program(
        torch.as_tensor(p, device=dev), torch.as_tensor(res["base_mean"].astype(p.dtype), device=dev),
        torch.ones(G, dtype=torch.bool, device=dev), knobs.get("alpha", 0.05),
        knobs.get("independent_filter", True),
    )
    with read("padj"):
        res["padj"] = padj.cpu().numpy()
    return res


@traced("deseq2.study")
def run_summary_streamed(
    counts,
    design_matrix,
    contrast,
    lfc_null: float = 0.0,
    gene_block: int | None = None,
    dtype=np.float32,
    refit_cooks: bool = False,
    min_replicates: int = 7,
    n_genes: int | None = None,
    device: str | torch.device | None = None,
    mesh=None,
    **knobs,
) -> dict:
    """Counts -> padj on ``device`` (default ``"cuda"``; raises if CUDA is
    requested and absent), streamed over gene blocks, with the Cook's
    outlier replacement and refit of R DESeq2's default pipeline when
    ``refit_cooks``. Port of ``pydeseq2_tpu/fused_stream.py:783``: the same
    arguments, and the same keys as numpy.

    counts (G, N) gene-major raw counts, a numpy array or a tensor (kept on
    its device when that is ``device``); design_matrix (N, P) array or
    DataFrame (cohorts come from its rows); contrast (P,); lfc_null in
    natural log; ``dtype`` a numpy or torch float dtype. ``gene_block=None``
    splits G evenly into blocks whose ~20 live (block, N) temporaries fit
    ~4 GB, rounded up to 8; the size-factor medians go over 1024-sample
    blocks once counts pass 1 GB. ``n_genes`` is the number of leading real
    genes of pre-padded counts. ``refit_cooks`` runs the main pass in refit
    mode, gathers the flagged genes on the device, refits them
    (:func:`refit_pipeline_streamed`), merges, masks and adjusts; it adds
    ``replaced``, ``refitted`` and ``new_all_zeroes``. ``min_replicates``
    is the cohort size from which a sample is replaceable. ``knobs`` go to
    :func:`summary_pipeline_streamed`.

    Where ratio size factors are asked for and every gene has a zero
    (median-of-ratios is undefined), it warns and switches to the iterative
    size factors, as with ``sf_fit_type="iterative"``
    (:func:`~pydeseq2_tpu_torch.ops.sizefactors.iterative_size_factors` on
    the device-resident counts, its dispersion fits over gene blocks past 1
    GB of counts); their result is injected as ``size_factors``.

    ``mesh`` (:func:`~pydeseq2_tpu_torch.parallel.mesh.make_gene_mesh`):
    every rank calls with the same whole ``counts`` and arguments, moves
    only its shard of the gene axis to its device (the mesh's; a ``device``
    that disagrees raises), streams it (:func:`_mesh_layout`: each of the
    unsharded run's gene blocks stays one IRLS tile), and returns the whole
    result. The iterative size factors run whole on every rank, and so does
    the refit of the gathered tile.
    """
    dev = resolve_mesh_device(device, mesh)
    if mesh is None:
        counts, G, gene_block = _stage_counts(counts, dtype, n_genes, gene_block, dev)
        whole, group = counts, None
    else:
        whole = counts
        G = n_genes or counts.shape[0]
        gene_block = gene_block or _auto_gene_block(G, counts.shape[1])
        unsharded_block = gene_block
        counts, gene_block, group = _stage_shard(counts, dtype, G, unsharded_block, mesh, dev)
    N = counts.shape[1]
    padded_G = counts.shape[0] * (1 if mesh is None else mesh.size())  # the whole padded gene axis
    np_dtype = _NP_DTYPE[counts.dtype]
    # The design's host inputs, while the card still copies the counts: the
    # size-factor check below is the study's first host read.
    if isinstance(design_matrix, torch.Tensor):
        design_matrix = _host(design_matrix)
    host = summary_host_inputs(design_matrix, min_replicates)
    sf_req = knobs.get("sf_fit_type", "ratio")
    with span("deseq2.size_factors"):
        if knobs.get("size_factors") is None and sf_req in ("ratio", "iterative"):
            # Host-evaluated: does any gene have no zero (median-of-ratios
            # defined)? Over every rank's genes: a collective every rank reaches.
            n_defined = all_reduce_sum((counts > 0).all(dim=1).any().to(torch.int64).reshape(1), mesh)
            with read("sf_defined"):
                ratio_undefined = sf_req == "ratio" and not bool(n_defined[0] > 0)
            if sf_req == "iterative" or ratio_undefined:
                if mesh is not None:  # the iterative solve runs whole on every rank
                    whole, _, _ = _stage_counts(whole, dtype, G, unsharded_block, dev)
                if ratio_undefined:
                    warnings.warn(
                        "Every gene contains at least one zero, cannot compute log geometric means. Switching to "
                        "iterative mode.",
                        UserWarning,
                        stacklevel=3,  # the caller, past the span's wrapper
                    )
                # The iterative solver's own max_disp default is max(10, N),
                # not the pipeline's (fused_stream.py:871).
                knobs["size_factors"], _ = iterative_size_factors(
                    whole, torch.arange(whole.shape[0], device=dev) < G, min_disp=knobs.get("min_disp", 1e-8),
                    max_disp=knobs.get("max_disp", float(max(10, N))), min_mu=knobs.get("min_mu", 0.5),
                    gene_block=pick_sf_gene_block(whole.shape[0], N, counts.dtype), device=dev)
                knobs["sf_fit_type"] = "ratio"  # unused once the factors are injected
    lo = 0 if mesh is None else counts.shape[0] * mesh.get_local_rank()
    gene_mask = torch.arange(lo, lo + counts.shape[0], device=dev) < G

    knobs.setdefault("mu_init", host["mu_init"])
    if "sample_block" not in knobs and G * N * np.dtype(np_dtype).itemsize > 1_000_000_000:
        knobs["sample_block"] = min(N, 1024)
    if isinstance(knobs.get("size_factors"), torch.Tensor):
        knobs["size_factors"] = knobs["size_factors"].to(device=dev, dtype=counts.dtype)
    elif knobs.get("size_factors") is not None:
        knobs["size_factors"] = torch.tensor(_host(knobs["size_factors"], np_dtype), device=dev)
    # Refitting runs only when some cohort can absorb a replacement
    # (reference dds.py:1315-1320: no replaceable sample, no refit).
    refit_active = refit_cooks and any(host["replaceable"])
    if refit_active:
        if not knobs.get("stats_layer", True):
            raise ValueError("refit_cooks needs the stats layer (Cook's flags)")
        knobs["refit_mode"] = True
        knobs["replaceable"] = host["replaceable"]

    def on_dev(a):
        # A contiguous copy: pandas arrays may be read-only, and a
        # DataFrame's array is column-major (torch.tensor keeps its strides).
        return torch.tensor(np.asarray(a, np_dtype), device=dev).contiguous()

    X = on_dev(getattr(design_matrix, "values", design_matrix))  # a DataFrame's array
    contrast_t, lfc_null_t = on_dev(contrast), on_dev(lfc_null)
    out = summary_pipeline_streamed(
        counts, X, contrast_t, lfc_null_t, on_dev(host["cooks_cutoff"]), gene_mask, gene_block=gene_block,
        cohort_ids=host["cohort_ids"], use_for_max=host["use_for_max"], mesh=mesh, group=group,
        **knobs)
    # exceeds_packed stays on the device for the refit gather; the rest
    # comes to the host in one copy (with a mesh, after one gather of the
    # per-gene outputs).
    keep = {k: v for k, v in out.items() if k != "exceeds_packed"}
    if mesh is not None:
        keep.update(gather_gene_dict({k: v for k, v in keep.items() if k not in _REPLICATED}, mesh))
    res = _to_host(keep)
    res = {k: v[:G] if k != "size_factors" and v.ndim >= 1 and v.shape[0] == padded_G else v
           for k, v in res.items()}
    if refit_active:
        res = _apply_streamed_refit(res, out, counts, X, contrast_t, lfc_null_t, host, knobs, G, mesh)
    elif refit_cooks:
        for k in ("replaced", "refitted", "new_all_zeroes"):
            res[k] = np.zeros(G, dtype=bool)
    res["gene_block"] = gene_block if mesh is None else unsharded_block
    if int(res.get("rescue_overflow", 0)) > 0:
        warnings.warn(
            f"{int(res['rescue_overflow'])} IRLS lanes still unconverged after the full 250-trip budget "
            "exceeded the compacted rescue tile: they skipped the Newton/grid rescue tiers and kept their "
            "final IRLS iterate (converged=False). This only happens when >~1.5% of genes fail to converge "
            "in IRLS.",
            UserWarning,
            stacklevel=3,  # the caller, past the span's wrapper
        )
    return res


# ----------------------------------------------------------- apeGLM shrinkage
def _grid_tile(c, s, m, conv, offset, X, prior_scale, pns, shrink_index):
    """The grid rescue's tile of a block (fused_stream.py:1031-1045): K =
    min(B, max(256, B/64)) lanes, failed lanes first (a stable sort keeps
    ascending lane order among ties). Returns ``(idx, counts, size,
    objective scale at 0, sel)``, ``sel`` marking the failed valid lanes."""
    B, P = c.shape[0], X.shape[1]
    K = min(B, max(256, B // 64))
    idx = torch.argsort(conv.to(torch.int8), stable=True)[:K]
    ci, si = c[idx], s[idx]
    zeros = torch.zeros((K, P), dtype=c.dtype, device=c.device)
    cnst = torch.clamp(nbinom_fn_batch(zeros, X, ci, si, offset, pns, prior_scale, shrink_index), min=1.0)
    return idx, ci, si, cnst, ~conv[idx] & m[idx]


def _shrink_block(c, s, m, offset, X, prior_scale, pns, shrink_index):
    """One gene block: Newton MAP fit, then for P == 2 the grid on the
    failed lanes of a compacted tile (fused_stream.py:1023-1072)."""
    beta, ih, conv = nbinom_glm_batch(X, c, s, offset, pns, prior_scale, shrink_index=shrink_index)
    # Host-evaluated lax.cond (fused_stream.py:1063-1065).
    if X.shape[1] == 2 and bool((~conv & m).any()):
        idx, ci, si, cnst, sel = _grid_tile(c, s, m, conv, offset, X, prior_scale, pns, shrink_index)
        b_grid = grid_fit_shrink_beta_batch(ci, offset, X, si, pns, prior_scale, cnst,
                                            shrink_index=shrink_index, sel=sel)
        new_b = torch.where(sel[:, None], b_grid, beta[idx])
        ih_g = sym_inv(_hess(new_b, X, ci, si, offset, pns, prior_scale, shrink_index))
        beta, ih = beta.clone(), ih.clone()
        beta[idx] = new_b
        ih[idx] = torch.where(sel[:, None, None], ih_g, ih[idx])
    se = torch.sqrt(torch.abs(ih[:, shrink_index, shrink_index]))
    nan = torch.tensor(float("nan"), dtype=c.dtype, device=c.device)
    return {"lfc": torch.where(m[:, None], beta, nan), "se": torch.where(m, se, nan), "converged": conv}


def lfc_shrink_pipeline_streamed(
    counts: torch.Tensor,
    size: torch.Tensor,
    offset: torch.Tensor,
    design_matrix: torch.Tensor,
    prior_scale: float,
    gene_mask: torch.Tensor,
    *,
    gene_block: int = 8192,
    shrink_index: int = 1,
    prior_no_shrink_scale: float = 15.0,
) -> dict:
    """apeGLM MAP shrinkage streamed over gene blocks, on the device of
    ``counts``.

    counts (G, N) gene-major raw counts, G a multiple of ``gene_block``;
    size (G,) NB size = 1/dispersion; offset (N,) log size factors;
    prior_scale min(sqrt(prior_var), 1); gene_mask (G,) bool. Returns
    ``lfc`` (G, P) MAP coefficients (natural log), ``se`` (G,) posterior SD
    of the shrunk coefficient and ``converged`` (G,), Newton's flag even
    where the grid replaced the coefficients. CUDA tensors launch the
    ``shrink`` and ``grid_apeglm`` kernels. Contract:
    ``pydeseq2_tpu/fused_stream.py:975``.
    """
    G = counts.shape[0]
    if G % gene_block:
        raise ValueError(f"pad G={G} to a multiple of gene_block={gene_block}")
    blocks = [
        _shrink_block(counts[b:b + gene_block], size[b:b + gene_block], gene_mask[b:b + gene_block], offset,
                      design_matrix, prior_scale, prior_no_shrink_scale, shrink_index)
        for b in range(0, G, gene_block)
    ]
    return {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}


def _host(a, dtype=None) -> np.ndarray:
    """A host numpy copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def run_lfc_shrink_streamed(
    counts,
    design_matrix,
    coeff_idx: int,
    dispersions,
    size_factors,
    mle_lfc=None,
    mle_se=None,
    adapt: bool = True,
    gene_block: int | None = None,
    dtype=torch.float32,
    prior_no_shrink_scale: float = 15.0,
    n_genes: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Host wrapper: apeGLM-shrink coefficient ``coeff_idx`` on ``device``
    (default ``"cuda"``; raises if CUDA is requested and absent).

    Feed it the outputs of ``summary_pipeline``: ``dispersions``,
    ``size_factors`` and, with ``adapt``, the MLE ``lfc`` column and ``se``
    that the adaptive prior variance is fitted from on the host (reference
    pydeseq2/ds.py:384-397). Arrays or tensors; ``dtype`` is a torch or
    numpy float dtype. ``n_genes`` is the number of leading valid lanes when
    ``counts`` was pre-padded. Genes with NaN dispersions return NaN.
    Returns numpy ``lfc`` (G, P), ``se``, ``converged``, plus
    ``prior_scale`` and ``gene_block``. Port of
    ``pydeseq2_tpu/fused_stream.py:1085``.
    """
    dev = resolve_device(device)
    counts, G, gene_block = _stage_counts(counts, dtype, n_genes, gene_block, dev)
    padded_G = counts.shape[0]
    np_dtype = _NP_DTYPE[counts.dtype]
    if not isinstance(design_matrix, torch.Tensor):
        design_matrix = getattr(design_matrix, "values", design_matrix)  # a DataFrame's array
    design = _host(design_matrix, np_dtype)
    prior_scale = 1.0
    if adapt:
        if mle_lfc is None or mle_se is None:
            raise ValueError("adapt=True needs mle_lfc and mle_se")
        prior_var = _apeglm_prior_variance(_host(mle_lfc, float), _host(mle_se, float))
        prior_scale = min(float(np.sqrt(prior_var)), 1.0)
    gene_mask = np.arange(padded_G) < G

    disp = _host(dispersions, np_dtype)
    ok = np.isfinite(disp) & (disp > 0)
    size = np.ones(padded_G, dtype=np_dtype)
    size[:G][ok] = 1.0 / disp[ok]
    gene_mask = gene_mask & np.pad(ok, (0, padded_G - G))

    def on_dev(a):
        # A contiguous copy: pandas arrays may be read-only, and a
        # DataFrame's array is column-major (torch.tensor keeps its strides).
        return torch.tensor(a, device=dev).contiguous()

    out = lfc_shrink_pipeline_streamed(
        counts,
        on_dev(size),
        on_dev(np.log(_host(size_factors, np_dtype))),
        on_dev(design),
        prior_scale,
        on_dev(gene_mask),
        gene_block=gene_block,
        shrink_index=int(coeff_idx),
        prior_no_shrink_scale=prior_no_shrink_scale,
    )
    res = {k: v[:G].cpu().numpy() for k, v in out.items()}
    res["prior_scale"] = prior_scale
    res["gene_block"] = gene_block
    return res


# -------------------------------------------------------------- blind VST
def _vst_genewise_pass(counts, sf, X, pinv, gene_block, min_mu, min_disp, max_disp):
    """Streamed pass 1 of the VST: per block, base means and the genewise
    dispersion MLE at mu = max(sf base_mean, min_mu) (``fused_stream.py:
    1224-1239``; not the OLS mu)."""
    base_mean, genewise = [], []
    for b in range(0, counts.shape[0], gene_block):
        c = counts[b:b + gene_block]
        bm = (c / sf[None, :]).mean(dim=1)
        rough, moments, _, _ = mom_and_mu_coef(c, sf, X, pinv, min_mu, want_mu=False)
        mom = torch.clamp(torch.minimum(rough, moments), min_disp, max_disp)
        mu_hat = torch.clamp(sf[None, :] * bm[:, None], min=min_mu)
        gw, _ = alpha_mle_batch(c, X, mu_hat, mom, min_disp, max_disp, cr_reg=True, prior_reg=False)
        base_mean.append(bm)
        genewise.append(torch.clamp(gw, min_disp, max_disp))
    return torch.cat(base_mean), torch.cat(genewise)


def vst_pipeline(
    counts,
    gene_mask=None,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    trend_type: str = "parametric",
    trend_rounds: int = 8,
    device: str | torch.device = "cuda",
) -> dict:
    """Blind variance-stabilising transform of a (G, N) counts tile on
    ``device`` (default ``"cuda"``; raises if CUDA is requested and absent).

    Port of ``pydeseq2_tpu/fused.py:828`` (reference pydeseq2/dds.py:349-514
    with ``use_design=False``): median-of-ratios size factors, the MoM
    dispersions and linear mu under the intercept-only design (one ``mom``
    launch), the genewise dispersion MLE, the parametric (or mean) trend,
    then the transform (the ``vst`` kernel, :mod:`~pydeseq2_tpu_torch.ops.vst`).
    Unlike :func:`vst_pipeline_streamed`, the genewise fit takes the OLS mu
    of the ``mom`` launch, as the JAX package's does. counts float32/float64,
    a tensor or array; gene_mask (G,) bool, False on padding lanes. Returns
    tensors: ``vst_counts`` (G, N), ``size_factors``, ``base_mean``,
    ``genewise_dispersions``, and ``trend_coeffs`` with ``trend_used_mean``
    (parametric) or ``mean_disp`` (mean).
    """
    dev = resolve_device(device)
    counts = torch.as_tensor(counts, device=dev).contiguous()
    G, N = counts.shape
    dtype = counts.dtype
    gene_mask = (torch.ones(G, dtype=torch.bool, device=dev) if gene_mask is None
                 else torch.as_tensor(gene_mask, dtype=torch.bool, device=dev))
    X = torch.ones((N, 1), dtype=dtype, device=dev)  # blind: intercept-only design

    logmeans, non_zero = _log_stats(counts, gene_mask, G, "ratio")
    sf = _streamed_size_factors(counts, gene_mask, logmeans)
    base_mean = (counts / sf[None, :]).mean(dim=1)
    rde, mde, _, mu_hat = mom_and_mu_coef(counts, sf, X, ols_pinv(X), min_mu)
    mom = torch.clamp(torch.minimum(rde, mde), min_disp, max_disp)
    genewise, _ = alpha_mle_batch(counts, X, mu_hat, mom, min_disp, max_disp, cr_reg=True, prior_reg=False)
    genewise = torch.clamp(genewise, min_disp, max_disp)
    genewise_m = torch.where(non_zero, genewise, torch.full_like(genewise, float("nan")))
    _, coeffs, used_mean, mean_disp = fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type,
                                                      max_rounds=max(trend_rounds, 20))
    out = {"size_factors": sf, "base_mean": base_mean, "genewise_dispersions": genewise_m}
    if trend_type == "parametric":
        out["trend_coeffs"] = coeffs
        out["trend_used_mean"] = used_mean
    else:
        out["mean_disp"] = mean_disp
    out["vst_counts"] = vst_transform(counts, sf, coeffs, used_mean, mean_disp, gene_mask, trend_type)
    return out


def vst_pipeline_streamed(
    counts: torch.Tensor,
    gene_mask: torch.Tensor | None = None,
    *,
    gene_block: int = 8192,
    sample_block: int | None = None,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    trend_type: str = "parametric",
) -> dict:
    """Blind variance-stabilising transform streamed over gene blocks, on
    the device of ``counts`` (G, N), G a multiple of ``gene_block``.

    Port of ``pydeseq2_tpu/fused_stream.py:1184``: the log-stats sweep,
    median-of-ratios size factors (over ``sample_block`` columns at a
    time), the genewise dispersions per block (:func:`_vst_genewise_pass`),
    one trend, then the transform per block (the ``vst`` kernel) into one
    (G, N) output. Returns tensors: ``vst_counts``, ``size_factors``,
    ``base_mean``, ``genewise_dispersions``, ``mean_disp`` and, for the
    parametric trend, ``trend_coeffs`` and ``trend_used_mean``.
    """
    G, N = counts.shape
    if gene_mask is None:
        gene_mask = torch.ones(G, dtype=torch.bool, device=counts.device)
    if G % gene_block:
        raise ValueError(f"pad G={G} to a multiple of gene_block={gene_block}")
    X = torch.ones((N, 1), dtype=counts.dtype, device=counts.device)

    logmeans, non_zero = _log_stats(counts, gene_mask, gene_block, "ratio")
    sf = _streamed_size_factors(counts, gene_mask, logmeans, sample_block)
    base_mean, genewise = _vst_genewise_pass(counts, sf, X, ols_pinv(X), gene_block, min_mu, min_disp, max_disp)
    genewise_m = torch.where(non_zero, genewise, torch.full_like(genewise, float("nan")))
    _, coeffs, used_mean, mean_disp = fit_fused_trend(base_mean, genewise_m, non_zero, min_disp, trend_type)

    vst = torch.empty_like(counts)
    for b in range(0, G, gene_block):
        sl = slice(b, b + gene_block)
        vst[sl] = vst_transform(counts[sl], sf, coeffs, used_mean, mean_disp, gene_mask[sl], trend_type)
    out = {"vst_counts": vst, "size_factors": sf, "base_mean": base_mean, "genewise_dispersions": genewise_m,
           "mean_disp": mean_disp}
    if trend_type == "parametric":
        out["trend_coeffs"] = coeffs
        out["trend_used_mean"] = used_mean
    return out


def run_vst_streamed(
    counts,
    gene_block: int | None = None,
    dtype=np.float32,
    n_genes: int | None = None,
    device: str | torch.device = "cuda",
    **knobs,
) -> dict:
    """Blind VST on ``device`` (default ``"cuda"``; raises if CUDA is
    requested and absent), streamed over gene blocks. Port of
    ``pydeseq2_tpu/fused_stream.py:1285``: the same arguments, and the same
    keys as numpy, plus ``gene_block``.

    counts (G, N) gene-major raw counts, a numpy array or a tensor (kept on
    its device when that is ``device``); ``dtype`` a numpy or torch float
    dtype; ``gene_block=None`` picks the streamed summary's even split;
    ``n_genes`` is the number of leading real genes of pre-padded counts;
    the size-factor medians go over 1024-sample blocks once counts pass 1
    GB. ``knobs`` go to :func:`vst_pipeline_streamed`. Every output comes to
    the host in one copy.
    """
    dev = resolve_device(device)
    counts, G, gene_block = _stage_counts(counts, dtype, n_genes, gene_block, dev)
    padded_G, N = counts.shape
    if "sample_block" not in knobs and G * N * counts.element_size() > 1_000_000_000:
        knobs["sample_block"] = min(N, 1024)
    out = vst_pipeline_streamed(counts, torch.arange(padded_G, device=dev) < G, gene_block=gene_block, **knobs)
    res = {k: v[:G] if k != "size_factors" and v.ndim >= 1 and v.shape[0] == padded_G else v
           for k, v in _to_host(out).items()}
    res["gene_block"] = gene_block
    return res
