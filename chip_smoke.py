"""Smoke run of pydeseq2_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the twenty-four hand-written kernels from ``pydeseq2_tpu_torch/csrc``
with ``nvcc`` for sm_90a (one process per source, in parallel), then:

1. prints the card (name and power limit, as nvidia-smi reports them) and
   the build times;
2. holds each kernel against its plain PyTorch version on the card, on the
   inputs the pipelines give it at 100 samples x 60000 genes in float32
   (and at 100 x 4000 in float64; Cook's also at 1500 samples in one
   cohort), with the tolerance stated beside each check, and times kernel,
   plain version and, where one PyTorch call computes the same function,
   that call; the IRLS rescue tiers on the tile the summary run hands them
   (every lane, then the pipeline's selection), ``shrink`` at full width on
   the operands the shrink path hands it and ``grid_apeglm`` on its
   failed-first tile; both grid kernels also at 8000 (float32) and 4000
   (float64) samples; ``mom``, ``trend``, ``lowess``, ``impute`` and the
   refit mode of ``cooks`` on the operands one
   ``run_summary_streamed(refit_cooks=True)`` run hands them (100 x 60000
   float32 and 100 x 4000 float64, an outlier planted in every 100th gene);
   ``sf_nll`` and ``sf_newton`` (one round's steps, then the whole trimmed
   solve by each route: the same keep sets) on the operands the first
   trimmed solve of a zero-inflated run of the same refit path hands them;
   ``vst`` (parametric, ``used_mean`` forced each way, the mean form, masked
   rows) and ``mom``, ``disp_scan``, ``disp_newton``, ``trend`` at P = 1 on
   the operands one ``vst_pipeline`` run hands them (same two scales);
   ``trend_fit``, ``trimmed_var`` (Cook's cohorts of ~50, and one column of
   the genewise dispersions), the ``hat`` and ``wald`` entries and ``mom``
   in its normed-count mode on the operands one class-API deseq2() +
   summary() run hands them (same two scales, planted outliers);
   ``disp_scan_fine`` (the fine scan of ``alpha_mle_batch(fine_length=8)``
   around the coarse argmin) and ``dnb_nll`` (at the genewise dispersions)
   on the main draw's operands (same two scales); ``disp_scan`` and
   ``disp_newton`` at the atlas iterative fit's shape (5000 genes x 10000
   samples, P = 1, float32), checked and timed;
3. runs ``wald_pipeline`` at 100 x 60000 float32 on the card through its
   public entry point: warm wall time, genes/s, IRLS trip counts, rescue
   overflow, share of finite p-values, the share of ``_irls_with_rescue``
   in one more run, and the launch count of each of its kernels in one run
   (each must be > 0);
3b. runs ``summary_pipeline`` (counts -> padj) the same way: warm wall,
   genes/s, Cook's outliers, share of finite padj, the independent-filtering
   row picked, and the launch count of its nine kernels in one run;
3c. runs ``run_lfc_shrink_streamed`` (apeGLM) on phase 3b's results the
   same way: warm wall, genes/s, prior scale, converged share, lanes sent
   to the grid and the launches of ``shrink`` (must be > 0) and
   ``grid_apeglm``;
3d. runs ``summary_pipeline`` then ``run_lfc_shrink_streamed`` on a draw
   with weak effects, where Newton fails on some lanes (coverage of the
   grid rescue): ``grid_apeglm`` must launch, and both apeGLM kernels are
   held to their plain versions on that run's operands;
3e. runs ``run_summary_streamed(refit_cooks=True)`` the same way on a draw
   with planted outliers, the counts already on the card: warm wall,
   genes/s, the refit tile, the genes replaced and refitted, and the
   launches of its eleven kernels in one run (each must be > 0);
3f. the same at 1000 x 60000, where the automatic gene block streams two
   blocks of 30000 genes;
3g. runs ``vst_pipeline`` (the blind VST) at 100 x 60000 float32 the same
   way: warm wall, genes/s and the launches of its six kernels in one run;
3h. runs ``run_vst_streamed`` at 1000 x 60000 float32 (two gene blocks);
3i. runs phase 3e on a zero-inflated draw (a zero in every gene): each run
   must warn and switch to the iterative size factors, whose two kernels
   must launch beside the eleven; the rounds of the iterative fit;
3j. runs the class API at 100 x 60000 float32 with planted outliers:
   ``DeseqDataSet(...).deseq2()``, ``DeseqStats(...).summary()``,
   ``lfc_shrink()`` and ``vst()``: the warm wall of each step, the peak
   device memory, the device-to-host bytes of deseq2() (torch.profiler),
   the launches of one run (each of CLASS_KERNELS must be > 0), and
   ``results_df`` against ``run_summary_streamed(refit_cooks=True)`` on the
   same counts (the same refitted genes, the gaps of CLASS_VS_STREAM);
3k. runs ``alpha_mle_batch(fine_length=8)`` then ``dnb_nll`` at 100 x
   60000 float32: warm wall, the launches of FINE_KERNELS in one run (each
   must be > 0), and the dispersions against ``fine_length=0``;
4. runs ``wald_pipeline`` in float64 at 100 x 2000 on the card and on the
   CPU (plain versions) and compares the two key by key;
4b. does the same for ``summary_pipeline`` with injected outliers, with and
   without independent filtering, every gene at rtol 1e-6 (a gene whose
   rescue exit differs is accounted for from the card's rescue inputs);
4c. runs the f64 shrink path on the card and on the CPU on 4b's result;
4d. runs the f64 streamed refit on the card and on the CPU at 100 x 2000
   with planted outliers: the same genes replaced and refitted, every
   float output (padj included) at rtol 1e-6;
4e. does the same for the iterative size factors (whole-G and over gene
   blocks: the same rounds), the zero-inflated streamed refit,
   ``vst_pipeline`` (both trend types) and ``run_vst_streamed``;
4f. runs the float64 class API (deseq2, summary, lfc_shrink, vst) on the
   card and on the CPU at 100 x 2000 with planted outliers: the same flags
   and every float column at rtol 1e-6;
4g. runs float64 ``alpha_mle_batch(fine_length=8)`` (MLE and MAP) and
   ``dnb_nll`` on the card and on the CPU at 100 x 2000;
5. prints one JSON line with the kernels' numbers, the card line, and last
   the result line ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result
line. It exits non-zero at once where no CUDA card is visible.
"""

from __future__ import annotations

import inspect
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12  # float64 outside the tensor cores
# Special-function units (reciprocal, log2, exp2): 16 a clock per SM (4 per
# SM sub-partition, the Hopper white paper), 132 SMs at the 1.98 GHz boost
# clock. The dispersion kernels' phase-2 log lines state an SFU time beside
# their bound, from the SFU operations their source issues per sample (an
# estimate, not a count of the compiled code, and not in the kernels line).
SFU_OPS_PER_S = 132 * 16 * 1.98e9

DEVICE = "cuda"
G_MAIN, N_MAIN = 60_000, 100
G_F64 = 4_000
G_CPU_CMP = 2_000
N_WIDE, G_WIDE = 1_500, 3_000  # Cook's past the JAX select switch (n >= 1024)
# The atlas iterative fit's dispersion shape (PERF.md section 4): one block
# of 5000 genes of 10000 samples, intercept-only design, float32.
N_ATLAS, G_ATLAS_BLOCK = 10_000, 5_000
# The fine scan's points in phases 2 and 3k (alpha_mle_batch(fine_length=8),
# the JAX package's documented fine setting).
FINE_LENGTH = 8
# The kernels wald_pipeline launches; summary_pipeline adds cooks, bh and
# lowess. Both launch the rescue tiers' kernels (newton_box, grid_nb) only
# where a lane stays flagged after IRLS, as at 100 x 60000 (1-2 lanes).
WALD_KERNELS = ("select", "disp_scan", "disp_newton", "irls", "hat_wald", "newton_box", "grid_nb", "mom", "trend")
SUMMARY_KERNELS = WALD_KERNELS + ("cooks", "bh", "lowess")
# The kernels run_summary_streamed(refit_cooks=True) must launch (phases 3e,
# 3f): the rescue tiers again only where a lane stays flagged.
STREAM_KERNELS = ("select", "disp_scan", "disp_newton", "irls", "hat_wald", "cooks", "bh", "mom", "trend", "lowess",
                  "impute")
N_STREAM_WIDE = 1_000  # phases 3f, 3h: auto gene_block splits 60000 genes into 2 blocks of 30000
# The kernels the blind VST launches (phases 3g, 3h): the size-factor
# medians, MoM, the genewise fit and the trend at P = 1, and the transform.
VST_KERNELS = ("select", "mom", "disp_scan", "disp_newton", "trend", "vst")
# The kernels of phase 3k: alpha_mle_batch(fine_length=8), then dnb_nll at
# its dispersions.
FINE_KERNELS = ("disp_scan", "disp_scan_fine", "disp_newton", "dnb_nll")
# Planted Cook's outliers of the streamed refit runs: one cell at 20x its
# row's maximum in every OUTLIER_EVERY-th gene.
OUTLIER_EVERY = 100
# Coverage only, not a cited study: a draw with weak effects (fold changes
# of SD 0.1), whose narrow fitted prior makes Newton fail on some lanes, so
# that the shrink path's grid rescue runs (phases 2 and 3d; PERF.md section
# 4 gives the share). The kernel table times grid_apeglm on the main draw's
# failed-first tile with every lane selected.
WEAK_LFC_SD = 0.1
# Samples past one staged chunk of the grid kernels (csrc/grid.cu, 512).
N_GRID_WIDE = {torch.float32: 8_000, torch.float64: 4_000}
# Two coefficient sets tie when their float64 objectives differ by at most
# TIE_UNITS rounding units of the lane, sqrt(N) eps x the summed size of
# its terms (noise_unit); PERF.md section 6 gives the ties and the
# one-fine-step gaps read on the H100.
TIE_UNITS = 8.0
# Phase 3j holds the class API's results_df to run_summary_streamed's on the
# same counts (f32 both): the largest |log2 fold change| gap, the 99th
# percentile of the relative padj gap, and the shares of genes whose padj <
# 0.05 call and whose NaN mask agree, over genes refitted alike. The two
# paths differ by design in float32 rounding: the class API keeps its
# normalised counts and Cook's distances in float64 and runs one IRLS phase,
# the streamed path works in float32 with two.
CLASS_VS_STREAM = {"lfc_abs": 1e-3, "padj_rel_p99": 1e-3, "call_agreement": 0.999, "nan_mask_agreement": 0.999}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` warm calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def stage_inputs(counts, X, max_disp):
    """The tensors the pipeline hands to each kernel (size factors, MoM,
    linear mu), computed with the port's own stage functions."""
    from pydeseq2_tpu_torch.fused import _size_factors
    from pydeseq2_tpu_torch.ops.linreg import (
        fit_lin_mu_batch,
        fit_moments_dispersions_batch,
        fit_rough_dispersions_batch,
    )

    G = counts.shape[0]
    mask = torch.ones(G, dtype=torch.bool, device=counts.device)
    log_counts = torch.log(counts)
    logmeans = log_counts.mean(dim=1)
    filtered = ~torch.isinf(logmeans) & mask
    log_ratios = torch.where(
        filtered[:, None], log_counts - logmeans[:, None], torch.full_like(log_counts, math.inf)
    )
    n_valid = filtered.sum()
    sf, _ = _size_factors(counts, mask)
    normed = counts / sf[None, :]
    mom = torch.clamp(
        torch.minimum(fit_rough_dispersions_batch(normed, X), fit_moments_dispersions_batch(normed, sf)),
        1e-8, max_disp,
    )
    mu = fit_lin_mu_batch(counts, sf, X, 0.5)
    return log_ratios, n_valid, sf, mom, mu


def scan_check(name: str, scan_args) -> tuple[float, torch.Tensor]:
    """``disp_scan`` against its plain version on ``scan_args``: (max abs
    error, the kernel's argmin la)."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    f32 = scan_args[1].dtype == torch.float32
    la_grid = scan_args[3]
    la1_k, fk = dsp.scan_coarse(*scan_args)
    la1_p, fp = dsp.scan_coarse_plain(*scan_args)
    # Tolerance: both sum ~N terms of size up to |f| in different orders and
    # take log1p/lgamma from different math libraries: a few ulps of the
    # largest term, so 2e-5 (f32) / 1e-11 (f64) of (1 + |f|).
    rtol = 2e-5 if f32 else 1e-11
    scale = 1.0 + fp.abs()
    err = ((fk - fp).abs() / scale).max().item()
    check(err <= rtol, f"disp_scan {name}: objective rel err {err:.3g} > {rtol}")
    # The argmin may differ only at near ties: the kernel's choice must be
    # within the same tolerance of the plain minimum.
    idx_k = ((la1_k[None, :] - la_grid[:, None]).abs().argmin(0))
    f_at_k = fp.gather(0, idx_k[None])[0]
    tie_err = ((f_at_k - fp.amin(0)) / (1.0 + fp.amin(0).abs())).max().item()
    check(tie_err <= 2 * rtol, f"disp_scan {name}: argmin off a near tie ({tie_err:.3g})")
    log(f"  disp_scan {name}: objective rel err {err:.3g} (tol {rtol}), argmin tie err {tie_err:.3g}")
    return (fk - fp).abs().max().item(), la1_k


def newton_check(name: str, newton_args):
    """``disp_newton`` against its plain version on ``newton_args``: (max
    abs la error, kernel outputs, plain outputs)."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    f32 = newton_args[1].dtype == torch.float32
    outk = dsp.newton_polish(*newton_args)
    outp = dsp.newton_polish_plain(*newton_args)
    # Tolerance: the objective at the polished point, 2e-3 (f32) / 1e-10
    # (f64) of (1 + |f|). Below r = 8 the centred f32 objective sums terms
    # of size lgamma(y + r) ~ 1e4 to a total ~1e2, so its rounding noise is
    # ~1e-4 of |f|, and the Newton acceptance (f_cand < f) decides at that
    # noise; on likelihood plateaus that moves la far while f stays flat, so
    # f is held tightly and la only on 99% of lanes.
    ftol = 2e-3 if f32 else 1e-10
    fdiff = (outk[1] - outp[1]).abs() / (1.0 + outp[1].abs())
    ferr = fdiff.max().item()
    check(ferr <= ftol, f"disp_newton {name}: objective rel err {ferr:.3g} > {ftol}")
    ladiff = (outk[0] - outp[0]).abs()
    la_close = (ladiff <= (1e-3 if f32 else 1e-6)).float().mean().item()
    check(la_close >= 0.99, f"disp_newton {name}: only {la_close:.4f} of la agree")
    q = torch.tensor([0.5, 0.99, 0.999], dtype=fdiff.dtype, device=fdiff.device)
    log(f"  disp_newton {name}: f rel diff quantiles (50/99/99.9%) {fdiff.quantile(q).tolist()}, "
        f"la diff {ladiff.quantile(q.to(ladiff.dtype)).tolist()}")
    log(f"  disp_newton {name}: objective rel err {ferr:.3g} (tol {ftol}), la within tol on {la_close:.4f}")
    return (outk[0] - outp[0]).abs().max().item(), outk, outp


def fine_check(name: str, fine_args) -> float:
    """``disp_scan_fine`` against its plain version on ``fine_args``: the
    max abs la error. The kernel's point must be one of the lane's grid
    points, and where the two choose different points, the plain objective
    there must tie with the plain minimum within scan_check's tolerance."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    counts, mu, X, center, hw, length, lo_f, hi_f, cr_reg, prior_reg, la_hat, pdv = fine_args
    f32 = mu.dtype == torch.float32
    la_k = dsp.scan_grid(*fine_args)
    la_p = dsp.scan_grid_plain(*fine_args)
    dt, dev = mu.dtype, mu.device
    lo, hi, hw_t, step = (torch.tensor(v, dtype=dt, device=dev) for v in (lo_f, hi_f, hw, 2.0 * hw / (length - 1)))
    ks = torch.arange(length, dtype=dt, device=dev)
    grid = torch.clamp(center[None, :] - hw_t + ks[:, None] * step, lo, hi)
    check(bool((grid == la_k[None, :]).any(0).all()), f"disp_scan_fine {name}: a point off the lane's grid")
    f_k = dsp._alpha_objective(la_k, counts, X, mu, la_hat, pdv, cr_reg, prior_reg, "auto")
    f_p = dsp._alpha_objective(la_p, counts, X, mu, la_hat, pdv, cr_reg, prior_reg, "auto")
    check(bool(torch.equal(torch.isnan(f_k), torch.isnan(f_p))), f"disp_scan_fine {name}: NaN lanes differ")
    rtol = 2e-5 if f32 else 1e-11  # scan_check's: the same objective, sums in another order
    tie_err = ((f_k - f_p) / (1.0 + f_p.abs())).nan_to_num(0.0).abs().max().item()
    check(tie_err <= 2 * rtol, f"disp_scan_fine {name}: argmin off a near tie ({tie_err:.3g})")
    same = (la_k == la_p).double().mean().item()
    log(f"  disp_scan_fine {name} ({counts.shape[0]}, {counts.shape[1]}), {length} points: the same point on "
        f"{same:.5f} of lanes, argmin tie err {tie_err:.3g} (tol {2 * rtol})")
    return (la_k - la_p).abs().max().item()


def dnb_scale(counts, mu, alpha):
    """alpha^-2 sum_n (|psi(r)| + |psi(y + r)| + |log1p(mu a)| + |(y - mu)/(mu + r)|),
    r = 1/alpha: the size of the terms dnb_nll sums."""
    from pydeseq2_tpu_torch.ops import nb

    r = 1.0 / alpha[:, None]
    return (nb._psi_fast(r).abs() + nb._psi_fast(counts + r).abs() + torch.log1p(mu * alpha[:, None]).abs()
            + ((counts - mu) / (mu + r)).abs()).sum(-1) / alpha**2


def dnb_check(name: str, counts, mu, alpha) -> tuple[float, float]:
    """``dnb_nll`` against its plain version: (max abs error, max error
    relative to the summed magnitudes). Both evaluate the same terms with
    the same psi; alpha^-2 amplifies psi(1/a) - psi(y + 1/a), which cancels
    as alpha -> 0, so the gap is held against alpha^-2 sum(|psi(r)| +
    |psi(y + r)| + |log1p(mu a)| + |(y - mu)/(mu + r)|): 1e-5 (f32) / 1e-13
    (f64), a few rounding units of that sum in float32 (~80 eps) and
    float64 (~450 eps) for terms summed in another order."""
    from pydeseq2_tpu_torch.ops import nb

    f32 = mu.dtype == torch.float32
    got = nb.dnb_nll(counts, mu, alpha)
    want = nb._dnb_nll_plain(counts, mu, alpha)
    scale = dnb_scale(counts, mu, alpha)
    tol = 1e-5 if f32 else 1e-13
    check(bool(torch.equal(torch.isfinite(got), torch.isfinite(want))), f"dnb_nll {name}: non-finite lanes differ")
    fin = torch.isfinite(want)
    err = ((got - want).abs() / scale)[fin].max().item()
    check(err <= tol, f"dnb_nll {name}: error {err:.3g} of the summed magnitudes > {tol}")
    abs_err = (got - want)[fin].abs().max().item()
    log(f"  dnb_nll {name} ({counts.shape[0]}, {counts.shape[1]}): error {err:.3g} of the summed magnitudes "
        f"(tol {tol}), max abs {abs_err:.3g}, alpha in [{alpha.min().item():.3g}, {alpha.max().item():.3g}]")
    return abs_err, err


def scan_cost(G: int, N: int, P: int, K: int, bnd_start: int, bnd_end: int, isz: int) -> tuple[int, int, int]:
    """(bytes, operations, SFU operations) of one coarse scan: counts and mu
    read once, the (K, G) cache written; per sample and point the stable
    form 30 operations, the auto/plain forms 38/40 (Stirling-8 lgamma 32 +
    6), the Cox-Reid weight and Gram 3 + P + 2 P(P+1)/2; SFU: the stable
    form's five reciprocals and two log1p, the auto form's lgamma_st8 (a
    reciprocal, three logs), a reciprocal and a log1p, the plain form's
    lgamma_st8 and a log, the weight's reciprocal."""
    n_stable, n_auto, n_plain = bnd_start, bnd_end - bnd_start, K - bnd_end
    ops_cr = 3 + P + P * (P + 1)
    return (2 * G * N * isz + K * G * isz,
            G * N * (30 * n_stable + 38 * n_auto + 40 * n_plain + K * ops_cr),
            G * N * (7 * n_stable + 6 * n_auto + 5 * n_plain + K))


def fine_cost(G: int, N: int, P: int, n_plain_pairs: int, n_stable_pairs: int, isz: int) -> tuple[int, int, int]:
    """(bytes, operations, SFU operations) of one fine scan: counts, mu and
    the centres read once, best_la written; each (gene, point) runs the
    auto form's plain part (r < 8) or the stable form, as scan_cost."""
    ops_cr = 3 + P + P * (P + 1)
    pairs = n_plain_pairs + n_stable_pairs
    return (2 * G * N * isz + 2 * G * isz,
            N * (38 * n_plain_pairs + 30 * n_stable_pairs + pairs * ops_cr),
            N * (6 * n_plain_pairs + 7 * n_stable_pairs + pairs))


def newton_cost(G: int, N: int, P: int, plain_frac: float, isz: int) -> tuple[int, int, int]:
    """(bytes, operations, SFU operations) of one Newton polish: counts and
    mu read once, la read and four outputs written; 5 evaluations per gene,
    per sample the stable fgh 85 operations and 16 SFU (13 reciprocals, two
    log1p, the weight), the plain fgh 127 and 30 (Stirling-8 lgamma, psi,
    psi'), the branch from the final la of each gene; the Cox-Reid weights
    and three Grams."""
    ntri = P * (P + 1) // 2
    ops_cr = 10 + 3 * (2 * ntri) + ntri
    return (2 * G * N * isz + 5 * G * isz,
            int(5 * G * N * ((1 - plain_frac) * 85 + plain_frac * 127 + ops_cr)),
            int(5 * G * N * ((1 - plain_frac) * 16 + plain_frac * 30)))


def dnb_cost(G: int, N: int, isz: int) -> tuple[int, int, int]:
    """(bytes, operations, SFU operations) of dnb_nll: counts and mu read
    once, alpha read and the result written; per sample psi_st8 (~35
    operations: eight reciprocals and their sum, the series, a log) and ~10
    more (log1p, the ratio, the sums); SFU: 8 + 1 reciprocals and a log in
    psi, the log1p and the division."""
    return 2 * G * N * isz + 2 * G * isz, G * N * 45, G * N * 12


def log_sfu(key: str, sfu: int) -> None:
    """Log the special-function units' time of ``sfu`` operations at the
    card's peak: an estimate from the source, beside the measured rows."""
    log(f"  {key}: SFU estimate {sfu / SFU_OPS_PER_S * 1e3:.4f} ms")


def kernel_checks(dtype, G, N, reps, timings):
    """Phase 2: every kernel against its plain version on the same inputs.

    Returns {name: max_abs_err} and fills ``timings`` (float32 only)."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.ops import nb
    from pydeseq2_tpu_torch.ops import select as sel
    from pydeseq2_tpu_torch.ops.nb import nb_nll
    from pydeseq2_tpu_torch.synthetic import make_data

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    dev = torch.device(DEVICE)
    counts_np, X_np = make_data(N, G)
    counts = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=dev)
    X = torch.as_tensor(X_np, dtype=dtype, device=dev)
    P = X.shape[1]
    max_disp = float(max(10, N))
    log_ratios, n_valid, sf, mom, mu = stage_inputs(counts, X, max_disp)
    errs = {}

    # -- kernel 1: order statistics (size-factor medians, prior medians) ----
    k_lo = torch.clamp((n_valid - 1) // 2, min=0)
    k_hi = n_valid // 2
    ks = (k_lo, k_hi)
    got = sel.order_stats_select(log_ratios, ks, axis=0)
    want = sel.order_stats_select_plain(log_ratios, ks, axis=0)
    # Exact: the kernel must return the very element a sort puts at each rank.
    for a, b in zip(got, want):
        check(torch.equal(sel._monotone_key(a), sel._monotone_key(b)), f"select {name}: not bit-identical")
    torch.manual_seed(0)
    col = torch.where(torch.rand(G, device=dev) < 0.1, math.inf, torch.randn(G, device=dev, dtype=dtype))
    n_col = torch.isfinite(col).sum()
    ks1 = (torch.clamp((n_col - 1) // 2, min=0), n_col // 2)
    for a, b in zip(sel.order_stats_select(col[:, None], ks1), sel.order_stats_select_plain(col[:, None], ks1)):
        check(torch.equal(sel._monotone_key(a), sel._monotone_key(b)), f"select {name}: 1-column not bit-identical")
    errs["order_stats_select"] = 0.0
    if f32:
        timings["order_stats_select"] = {
            "ms": cuda_ms(lambda: sel.order_stats_select(log_ratios, ks, axis=0), reps),
            "plain_ms": cuda_ms(lambda: sel.order_stats_select_plain(log_ratios, ks, axis=0), reps),
            "library_ms": cuda_ms(lambda: torch.sort(log_ratios, dim=0), reps),
            "bytes": log_ratios.numel() * log_ratios.element_size(),
            # 4 passes x (key map 3 + 2 ranks x (mask, compare, digit) 6) per element
            "ops": 4 * 9 * G * N,
        }
    log(f"  select {name}: bit-identical to the sorted keys at ({G}, {N}) and ({G}, 1)")

    # -- kernel 2: coarse dispersion scan (genewise fit inputs) -----------
    lo_f, hi_f = math.log(1e-8), math.log(max_disp)
    K = 32
    step1_f = (hi_f - lo_f) / (K - 1)
    lo = torch.tensor(lo_f, dtype=dtype, device=dev)
    la_grid = lo + torch.arange(K, dtype=dtype, device=dev) * torch.tensor(step1_f, dtype=dtype, device=dev)
    bnd_start, bnd_end = dsp._scan_branches(K, step1_f, lo_f)
    la_hat = torch.log(torch.clamp(mom, 1e-8, max_disp))
    pdv = torch.tensor(1.0, dtype=dtype, device=dev)
    scan_args = (counts, mu, X, la_grid, bnd_start, bnd_end, (lo_f + hi_f) / 2, True, False, la_hat, pdv)
    errs["disp_scan"], la1_k = scan_check(name, scan_args)
    isz = counts.element_size()
    if f32:
        nbytes, ops, sfu = scan_cost(G, N, P, K, bnd_start, bnd_end, isz)
        timings["disp_scan"] = {
            "ms": cuda_ms(lambda: dsp.scan_coarse(*scan_args), reps),
            "plain_ms": cuda_ms(lambda: dsp.scan_coarse_plain(*scan_args), max(1, reps // 5)),
            "library_ms": None, "bytes": nbytes, "ops": ops,
        }
        log_sfu("disp_scan", sfu)

    # -- kernel 3: dispersion Newton (genewise fit from the scan's argmin) -
    step2_f = step1_f / 3.5
    newton_args = (counts, mu, X, la1_k, lo_f, hi_f, step1_f, step2_f, 4, True, False, la_hat, pdv)
    errs["disp_newton"], outk, outp = newton_check(name, newton_args)
    if f32:
        plain_gene = torch.exp(-outp[0]) < 8.0
        nbytes, ops, sfu = newton_cost(G, N, P, plain_gene.double().mean().item(), isz)
        timings["disp_newton"] = {
            "ms": cuda_ms(lambda: dsp.newton_polish(*newton_args), reps),
            "plain_ms": cuda_ms(lambda: dsp.newton_polish_plain(*newton_args), max(1, reps // 5)),
            "library_ms": None, "bytes": nbytes, "ops": ops,
        }
        log_sfu("disp_newton", sfu)

    # -- the fine scan of alpha_mle_batch(fine_length=8) around the coarse argmin
    fine_args = (counts, mu, X, la1_k, step1_f, FINE_LENGTH, lo_f, hi_f, True, False, la_hat, pdv)
    errs["disp_scan_fine"] = fine_check(name, fine_args)
    if f32:
        hw_t, st_t = (torch.tensor(v, dtype=dtype, device=dev) for v in (step1_f, 2.0 * step1_f / (FINE_LENGTH - 1)))
        ks = torch.arange(FINE_LENGTH, dtype=dtype, device=dev)
        fgrid = torch.clamp(la1_k[None, :] - hw_t + ks[:, None] * st_t, lo, torch.tensor(hi_f, dtype=dtype, device=dev))
        n_pl = int((torch.exp(-fgrid) < 8.0).sum())
        nbytes, ops, sfu = fine_cost(G, N, P, n_pl, FINE_LENGTH * G - n_pl, isz)
        timings["disp_scan_fine"] = {
            "ms": cuda_ms(lambda: dsp.scan_grid(*fine_args), reps),
            "plain_ms": cuda_ms(lambda: dsp.scan_grid_plain(*fine_args), max(1, reps // 5)),
            "library_ms": None, "bytes": nbytes, "ops": ops,
        }
        log_sfu("disp_scan_fine", sfu)

    # -- dnb_nll at the genewise fit's dispersions
    alpha = torch.exp(outk[0])
    errs["dnb_nll"], _ = dnb_check(name, counts, mu, alpha)
    if f32:
        nbytes, ops, sfu = dnb_cost(G, N, isz)
        timings["dnb_nll"] = {
            "ms": cuda_ms(lambda: nb.dnb_nll(counts, mu, alpha), reps),
            "plain_ms": cuda_ms(lambda: nb._dnb_nll_plain(counts, mu, alpha), reps),
            "library_ms": None, "bytes": nbytes, "ops": ops,
        }
        log_sfu("dnb_nll", sfu)

    # -- kernel 4: IRLS (phase 1 of the LFC fit: every lane, 8 trips) ------
    disp = torch.clamp(torch.exp(outk[0]), 1e-8, max_disp)
    beta_init = irl.irls_beta_init(counts, sf, X)
    beta_tol = 1e-6 if f32 else 1e-8
    step_tol = 1e-5 if f32 else 0.0
    log_sf = torch.log(sf)[None, :]
    log_min_mu = torch.log(torch.tensor(0.5, dtype=dtype, device=dev))
    mu0, log_mu0, _ = irl._mu_from_xb(beta_init, X, sf, log_sf, 0.5, log_min_mu)
    r = 1.0 / disp[:, None]
    nll_const = nb_nll(counts, mu0, disp) - irl._mu_part(counts, counts + r, r, mu0, log_mu0)
    results = {}
    for maxiter in (8, 250):
        bk, fbk, trips = irl._irls_cuda(counts, sf, X, disp, beta_init, nll_const, log_sf[0], 0.5,
                                        beta_tol, 30.0, maxiter, step_tol, 2)
        bp, fbp, it_p = irl._irls_plain(counts, sf, X, disp, beta_init, nll_const, log_sf, 0.5,
                                        log_min_mu, beta_tol, 30.0, maxiter, step_tol, 2)
        # Tolerance: a rounding difference in the deviance ratio can move a
        # lane's stop by one trip, a change of order beta_tol/step_tol in the
        # iterate; 99.9% of lanes must agree to 1e-4 (f32) / 1e-7 (f64) and
        # the fallback flags on 99.9%.
        btol = 1e-4 if f32 else 1e-7
        close = ((bk - bp).abs().amax(1) <= btol).double().mean().item()
        flags = (fbk == fbp).double().mean().item()
        check(close >= 0.999, f"irls {name} maxiter={maxiter}: only {close:.5f} of lanes agree")
        check(flags >= 0.999, f"irls {name} maxiter={maxiter}: flags agree on {flags:.5f}")
        max_trips = int(trips.max())
        # A lane whose stop moved by one trip can move the slowest lane by one.
        check(abs(max_trips - int(it_p)) <= 1, f"irls {name}: slowest lane {max_trips} trips, plain loop {int(it_p)}")
        results[maxiter] = (close, flags, (bk - bp).abs().max().item(), trips)
        log(f"  irls {name} maxiter={maxiter}: lanes within {btol}: {close:.5f}, flags agree {flags:.5f}, "
            f"slowest lane {max_trips} trips (plain loop {int(it_p)})")
    errs["irls"] = results[8][2]
    if f32:
        trips = results[8][3].double()
        ntri = P * (P + 1) // 2
        per_pass = 2 * P + 26 + 2 * ntri + 2 * P
        timings["irls"] = {
            "ms": cuda_ms(lambda: irl._irls_cuda(counts, sf, X, disp, beta_init, nll_const, log_sf[0], 0.5,
                                                 beta_tol, 30.0, 8, step_tol, 2), reps),
            "plain_ms": cuda_ms(lambda: irl._irls_plain(counts, sf, X, disp, beta_init, nll_const, log_sf,
                                                        0.5, log_min_mu, beta_tol, 30.0, 8, step_tol, 2),
                                max(1, reps // 5)),
            "library_ms": None,
            "bytes": counts.numel() * counts.element_size() + 6 * G * counts.element_size(),
            # (trips + 1) IRLS passes per gene at per_pass ops per element,
            # plus 3 polish passes of ~(25 + 2 ntri) ops
            "ops": int(N * ((trips + 1).sum().item() * per_pass + 3 * G * (25 + 2 * ntri))),
            "trips_mean": trips.mean().item(),
        }
    return errs


def wide_dispersion_checks(reps: int, timings: dict) -> None:
    """Phase 2, the atlas shape: ``disp_scan`` and ``disp_newton`` against
    their plain versions at the atlas iterative fit's dispersion shape (one
    block of G_ATLAS_BLOCK genes x N_ATLAS samples, P = 1, float32), with
    scan_check's and newton_check's tolerances, and timed; the rows of the
    kernels line gain ``wide_ms`` and ``wide_plain_ms``."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp
    from pydeseq2_tpu_torch.synthetic import make_data

    G, N = G_ATLAS_BLOCK, N_ATLAS
    dtype = torch.float32
    dev = torch.device(DEVICE)
    counts = torch.as_tensor(make_data(N, G)[0].T.copy(), dtype=dtype, device=dev)
    X = torch.ones((N, 1), dtype=dtype, device=dev)
    max_disp = float(max(10, N))
    _, _, _, mom, mu = stage_inputs(counts, X, max_disp)
    lo_f, hi_f = math.log(1e-8), math.log(max_disp)
    K = 32
    step1_f = (hi_f - lo_f) / (K - 1)
    lo = torch.tensor(lo_f, dtype=dtype, device=dev)
    la_grid = lo + torch.arange(K, dtype=dtype, device=dev) * torch.tensor(step1_f, dtype=dtype, device=dev)
    bnd_start, bnd_end = dsp._scan_branches(K, step1_f, lo_f)
    la_hat = torch.log(torch.clamp(mom, 1e-8, max_disp))
    pdv = torch.tensor(1.0, dtype=dtype, device=dev)
    scan_args = (counts, mu, X, la_grid, bnd_start, bnd_end, (lo_f + hi_f) / 2, True, False, la_hat, pdv)
    _, la1 = scan_check(f"f32 atlas block {G} x {N} P=1", scan_args)
    newton_args = (counts, mu, X, la1, lo_f, hi_f, step1_f, step1_f / 3.5, 4, True, False, la_hat, pdv)
    _, _, outp = newton_check(f"f32 atlas block {G} x {N} P=1", newton_args)
    isz = counts.element_size()
    for key, fn, plain, cost in (
        ("disp_scan", dsp.scan_coarse, dsp.scan_coarse_plain, scan_cost(G, N, 1, K, bnd_start, bnd_end, isz)),
        ("disp_newton", dsp.newton_polish, dsp.newton_polish_plain,
         newton_cost(G, N, 1, (torch.exp(-outp[0]) < 8.0).double().mean().item(), isz)),
    ):
        args = scan_args if key == "disp_scan" else newton_args
        nbytes, ops, sfu = cost
        t = timings[key]
        t["wide_ms"] = cuda_ms(lambda: fn(*args), reps)
        t["wide_plain_ms"] = cuda_ms(lambda: plain(*args), 1)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        log(f"  {key} atlas block: {t['wide_ms']:.4f} ms (plain {t['wide_plain_ms']:.4f}), bound "
            f"{bound:.4f} ms, SFU estimate {sfu / SFU_OPS_PER_S * 1e3:.4f} ms")


def psi_check() -> None:
    """The kernels' float64 psi and psi' against torch.digamma/polygamma."""
    from pydeseq2_tpu_torch import kernels

    x = torch.cat([
        torch.logspace(-3, 0, 400, dtype=torch.float64),
        torch.linspace(1.0, 12.0, 400, dtype=torch.float64),
        torch.logspace(1.1, 7, 400, dtype=torch.float64),
    ]).to(DEVICE)
    psi = torch.empty_like(x)
    tri = torch.empty_like(x)
    kernels.call_helper("psi_f64", [x.data_ptr(), x.numel(), psi.data_ptr(), tri.data_ptr()], x.device)
    # Reference: scipy on the host. PyTorch's polygamma(1, .) keeps three
    # Bernoulli terms after six shifts (~1e-9 relative) on CPU and card.
    from scipy.special import digamma, polygamma

    xs = x.cpu().numpy()
    ref_psi = torch.as_tensor(digamma(xs), device=x.device)
    ref_tri = torch.as_tensor(polygamma(1, xs), device=x.device)
    # ~1e-14 relative, absolute near the root of psi (x ~ 1.4616) where any
    # evaluation has unbounded relative error.
    e_psi = ((psi - ref_psi).abs() / torch.clamp(ref_psi.abs(), min=1.0)).max().item()
    e_tri = ((tri - ref_tri).abs() / ref_tri.abs()).max().item()
    check(e_psi <= 2e-14 and e_tri <= 2e-14, f"f64 psi/psi' errors {e_psi:.3g}/{e_tri:.3g}")
    log(f"  f64 psi max err {e_psi:.3g}, psi' max rel err {e_tri:.3g} (tol 2e-14)")


def main_path(reps: int):
    """Phase 3: the public entry point at full width, float32."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_MAIN)
    kw = pt.inputs_from_numpy(
        counts_np.T, X_np, np.array([0.0, 1.0]), 0.0, dtype=torch.float32, device=DEVICE,
        max_disp=float(max(10, N_MAIN)), beta_tol=1e-6,
    )
    out = pt.wald_pipeline(**kw)  # warm-up (allocator, library handles)
    torch.cuda.synchronize()
    walls = []
    launches = None
    trips = None
    for i in range(reps):
        if i == 0:
            kernels.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pt.wald_pipeline(**kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
            trips = [int(t) for t in kernels.STATS.irls_trips]
    res = pt.outputs_to_numpy(out)
    for name in WALD_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the Wald path")
    pv = res["p_values"]
    check(pv.shape == (G_MAIN,) and res["lfc"].shape == (G_MAIN, 2), "output shapes")
    finite = float(np.isfinite(pv).mean())
    check(finite > 0.9, f"only {finite:.4f} of p-values are finite")
    check(np.all((pv[np.isfinite(pv)] >= 0) & (pv[np.isfinite(pv)] <= 1)), "p-values outside [0, 1]")
    best = min(walls)
    rescue_s, rescue_wall = rescue_share(pt.wald_pipeline, kw)
    log(f"  wall (warm) {[round(w, 4) for w in walls]} s, best {best:.4f} s, "
        f"{G_MAIN / best:.1f} genes/s; _irls_with_rescue {rescue_s * 1e3:.3f} ms of a {rescue_wall * 1e3:.3f} ms "
        f"run (share {rescue_s / rescue_wall:.4f})")
    log(f"  launches in one run {launches}; IRLS slowest-lane trips per launch {trips}")
    log(f"  rescue_overflow {int(res['rescue_overflow'])}, finite p-values {finite:.5f}, "
        f"irls_converged {float(res['irls_converged'].mean()):.5f}, "
        f"trend_used_mean {bool(res['trend_used_mean'])}")
    return {"walls_s": walls, "best_s": best, "genes_per_s": G_MAIN / best, "launches": launches,
            "irls_trips": trips, "rescue_overflow": int(res["rescue_overflow"]), "finite_p": finite,
            "rescue_share": rescue_s / rescue_wall}


def fine_path(reps: int) -> dict:
    """Phase 3k: this slice's own path at 100 x 60000 float32,
    ``alpha_mle_batch(fine_length=8)`` (coarse scan, fine scan, Newton
    polish) then ``dnb_nll`` at its dispersions, through the public
    functions: warm wall, the launches of FINE_KERNELS in one run (each
    must be > 0), finite outputs, the converged share; reported beside them,
    the dispersions and their objective against ``fine_length=0``'s."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import dispersion as dsp
    from pydeseq2_tpu_torch.ops import nb
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_MAIN)
    counts = torch.as_tensor(counts_np.T.copy(), dtype=torch.float32, device=DEVICE)
    X = torch.as_tensor(X_np, dtype=torch.float32, device=DEVICE)
    max_disp = float(max(10, N_MAIN))
    _, _, _, mom, mu = stage_inputs(counts, X, max_disp)

    def run(fine_length=FINE_LENGTH):
        alpha, conv = dsp.alpha_mle_batch(counts, X, mu, mom, 1e-8, max_disp, fine_length=fine_length)
        return alpha, conv, nb.dnb_nll(counts, mu, alpha)

    run()
    torch.cuda.synchronize()
    walls = []
    launches = None
    for i in range(reps):
        if i == 0:
            kernels.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alpha, conv, d = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
    for name in FINE_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the fine-scan path")
    check(alpha.shape == (G_MAIN,) and d.shape == (G_MAIN,), "fine path: output shapes")
    check(bool(torch.isfinite(alpha).all()), "fine path: non-finite dispersions")
    conv_share = conv.double().mean().item()
    d_finite = torch.isfinite(d).double().mean().item()
    check(conv_share > 0.9 and d_finite > 0.99, f"fine path: converged {conv_share:.4f}, finite dnb {d_finite:.4f}")
    alpha0 = run(0)[0]
    agree = ((alpha - alpha0).abs() <= 1e-3 * alpha0).double().mean().item()
    # Reported, not held: the fine scan hands Newton another start, and
    # four steps from either may end at another point of a plateau or
    # another local minimum (the JAX package's algorithm, not the kernels,
    # which phases 2 and 4g hold).
    la_hat = torch.log(torch.clamp(mom, 1e-8, max_disp))
    pdv = torch.tensor(1.0, dtype=mu.dtype, device=mu.device)
    f1, f0 = (dsp._alpha_objective(torch.log(a), counts, X, mu, la_hat, pdv, True, False) for a in (alpha, alpha0))
    gap = (f1 - f0) / (1.0 + f0.abs())
    q = torch.tensor([0.5, 0.99, 1.0], dtype=gap.dtype, device=gap.device)
    f_gap = gap.quantile(q).tolist()
    best = min(walls)
    log(f"  wall (warm) {[round(w, 4) for w in walls]} s, best {best:.4f} s; launches in one run "
        f"{ {k: launches[k] for k in FINE_KERNELS} }; converged {conv_share:.5f}, finite dnb_nll {d_finite:.5f}, "
        f"alpha within 1e-3 of fine_length=0's on {agree:.5f}, objective minus fine_length=0's (over 1 + |f|; "
        f"50/99/100%) {f_gap}")
    return {"walls_s": walls, "best_s": best, "launches": launches, "converged": conv_share,
            "dnb_finite": d_finite, "agree_fine0": agree, "objective_gap_fine0": f_gap}


def fine_card_vs_cpu() -> None:
    """Phase 4g: float64 ``alpha_mle_batch(fine_length=8)`` and ``dnb_nll``
    on the card against the CPU plain path at 100 x 2000 (P = 2), and with
    the prior (the MAP fit's form). Tolerance: the dispersions at rtol 1e-6
    and the same flags, as the pipelines' phase 4, on 99.9% of lanes (a
    near tie of two fine points may hand Newton another start on a plateau);
    dnb_nll as dnb_check's f64 bound."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp
    from pydeseq2_tpu_torch.ops import nb
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_CPU_CMP, seed=1)
    max_disp = float(max(10, N_MAIN))
    counts = torch.as_tensor(counts_np.T.copy(), dtype=torch.float64)
    X = torch.as_tensor(X_np, dtype=torch.float64)
    _, _, _, mom, mu = stage_inputs(counts, X, max_disp)  # the CPU's operands, on both sides
    res = {}
    for dev in (DEVICE, "cpu"):
        out = []
        for kw in ({}, {"prior_reg": True, "prior_disp_var": 0.5}):
            alpha, conv = dsp.alpha_mle_batch(counts.to(dev), X.to(dev), mu.to(dev), mom.to(dev), 1e-8, max_disp,
                                              fine_length=FINE_LENGTH, **kw)
            out += [alpha.cpu(), conv.cpu()]
        res[dev] = out
    gpu, cpu = res[DEVICE], res["cpu"]
    for label, i in (("MLE", 0), ("MAP", 2)):
        close = torch.isclose(gpu[i], cpu[i], rtol=1e-6, atol=0.0).double().mean().item()
        flags = (gpu[i + 1] == cpu[i + 1]).double().mean().item()
        check(close >= 0.999 and flags >= 0.999, f"phase 4g {label}: alpha close on {close:.5f}, flags {flags:.5f}")
        log(f"  alpha_mle_batch(fine_length={FINE_LENGTH}) {label} f64: alpha within 1e-6 on {close:.5f}, "
            f"flags agree on {flags:.5f}")
    alpha = cpu[0]
    d_card = nb.dnb_nll(counts.to(DEVICE), mu.to(DEVICE), alpha.to(DEVICE)).cpu()
    err = ((d_card - nb.dnb_nll(counts, mu, alpha)).abs() / dnb_scale(counts, mu, alpha)).max().item()
    check(err <= 1e-13, f"phase 4g dnb_nll: error {err:.3g} of the summed magnitudes")
    log(f"  dnb_nll f64 card against CPU: error {err:.3g} of the summed magnitudes (tol 1e-13)")


def card_vs_cpu() -> None:
    """Phase 4: the f64 pipeline on the card against the CPU plain path.

    Three cases: the main path's design (P = 2); P = 3 with ``mu_init="irls"``
    and ``alt_hypothesis="greaterAbs"`` (closed-form 3 x 3 solves, the IRLS
    kernel twice); P = 5 (the unrolled-Cholesky solves)."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_CPU_CMP, seed=1)
    rng = np.random.default_rng(2)
    extra = rng.integers(0, 2, size=(N_MAIN, 3)).astype(float)
    base = {"max_disp": float(max(10, N_MAIN)), "beta_tol": 1e-8}
    cases = [
        ("P=2", X_np, base),
        ("P=3 mu_init=irls greaterAbs", np.column_stack([X_np, extra[:, 0]]),
         dict(base, mu_init="irls", alt_hypothesis="greaterAbs")),
        ("P=5", np.column_stack([X_np, extra]), base),
    ]
    for label, X, static in cases:
        contrast = np.zeros(X.shape[1])
        contrast[1] = 1.0
        args = (counts_np.T, X, contrast, 0.0)
        gpu = pt.outputs_to_numpy(pt.wald_pipeline(**pt.inputs_from_numpy(*args, device=DEVICE, **static)))
        cpu = pt.outputs_to_numpy(pt.wald_pipeline(**pt.inputs_from_numpy(*args, device="cpu", **static)))
        # Tolerance: rtol 1e-6 on the fitted quantities, as the CPU plain
        # path is held to the JAX f64 reference; identical NaN masks and flags.
        compare_outputs(label, gpu, cpu)


def summary_kwargs(counts_np, X_np, dtype, device, **static):
    """``summary_pipeline`` keyword arguments with the design's host inputs."""
    import pydeseq2_tpu_torch as pt

    host = pt.summary_host_inputs(X_np)
    static = {"cohort_ids": host["cohort_ids"], "use_for_max": host["use_for_max"],
              "max_disp": float(max(10, X_np.shape[0])), **static}
    contrast = np.zeros(X_np.shape[1])
    contrast[-1] = 1.0
    return pt.inputs_from_numpy(counts_np, X_np, contrast, 0.0, cooks_cutoff=host["cooks_cutoff"],
                                dtype=dtype, device=device, **static)


def capture(targets, run, key: str, kw: dict) -> dict:
    """Call ``run(**kw)`` once with the functions ``names`` of each
    ``(module, names)`` in ``targets`` recorded: {name: (args, kwargs,
    result)} for the first call of each, plus the run's output under
    ``key``."""
    seen: dict = {}
    originals = [(module, n, getattr(module, n)) for module, names in targets for n in names]

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            result = fn(*args, **kwargs)
            seen.setdefault(name, (args, kwargs, result))
            return result

        return recorded

    try:
        for module, n, fn in originals:
            setattr(module, n, wrap(n, fn))
        seen[key] = run(**kw)
    finally:
        for module, n, fn in originals:
            setattr(module, n, fn)
    torch.cuda.synchronize()
    return seen


def capture_summary_inputs(kw: dict) -> dict:
    """Run ``summary_pipeline`` once and keep the arguments that it hands to
    the summary kernels' wrappers, the rescue tiers, ``_irls_with_rescue``
    and ``device_padj``, and what each returned, plus the run's output under
    ``"summary"``."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused

    names = ("hat_wald", "cooks_outliers", "bh_sweep", "device_padj", "_irls_with_rescue",
             "newton_box_nbglm", "grid_fit_beta_batch")
    return capture([(fused, names)], pt.summary_pipeline, "summary", kw)


def capture_shrink_inputs(kw: dict) -> dict:
    """Run ``run_lfc_shrink_streamed`` once and keep what its first gene
    block hands to ``nbinom_glm_batch`` and, where a lane fails,
    ``grid_fit_shrink_beta_batch``, and the block's own operands
    (``_shrink_block``), plus the run's output under ``"shrink"``."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused_stream

    names = ("_shrink_block", "nbinom_glm_batch", "grid_fit_shrink_beta_batch")
    return capture([(fused_stream, names)], pt.run_lfc_shrink_streamed, "shrink", kw)


def bound_args(fn, args, kwargs) -> tuple:
    """A recorded call's arguments in ``fn``'s order, defaults filled in
    (the order of the ``_plain`` / ``_cuda`` versions behind it)."""
    b = inspect.signature(fn).bind(*args, **kwargs)
    b.apply_defaults()
    return tuple(b.arguments.values())


def with_outliers(counts: np.ndarray) -> np.ndarray:
    """(G, N) counts with two injected outliers (genes 0 and 3), which
    IRLS leaves to the rescue tiers and Cook's flags."""
    counts = counts.copy()
    counts[0, 0] = counts.max() * 10 + 100
    counts[3, 5] = counts.max() * 8 + 50
    return counts


def capture_draw(dtype, G: int, N: int, lfc_sd: float = 0.5, outliers: bool = False) -> dict:
    """:func:`capture_summary_inputs` on ``make_data(N, G, lfc_sd=lfc_sd)``
    (with :func:`with_outliers`) at the pipelines' beta_tol (1e-6 in
    float32, 1e-8 in float64); the keyword arguments under ``"kw"``."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G, lfc_sd=lfc_sd)
    counts = with_outliers(counts_np.T) if outliers else counts_np.T
    kw = summary_kwargs(counts, X_np, dtype, DEVICE, beta_tol=1e-6 if dtype == torch.float32 else 1e-8)
    seen = capture_summary_inputs(kw)
    seen["kw"] = kw
    return seen


def shrink_kwargs(summary_kw: dict, summary_out: dict, dtype) -> dict:
    """``run_lfc_shrink_streamed`` keyword arguments on a ``summary_pipeline``
    run's counts, dispersions, size factors, MLE LFCs and SEs, with the
    adaptive prior."""
    return dict(counts=summary_kw["counts"], design_matrix=summary_kw["design_matrix"], coeff_idx=1,
                dispersions=summary_out["dispersions"], size_factors=summary_out["size_factors"],
                mle_lfc=summary_out["lfc"][:, 1], mle_se=summary_out["se"], adapt=True, dtype=dtype,
                device=DEVICE)


def rel_err(a: torch.Tensor, b: torch.Tensor, floor: float) -> float:
    """max |a - b| / max(|b|, floor) over the entries where b is not NaN,
    after checking that a and b are NaN at the same places."""
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN masks differ")
    m = ~torch.isnan(b)
    if not bool(m.any()):
        return 0.0
    return ((a[m] - b[m]).abs() / torch.clamp(b[m].abs(), min=floor)).max().item()


def hat_wald_ops(P: int) -> int:
    """Operations per (gene, sample) of the hat_wald kernel: pass 1 (linear
    predictor, exp, both weights, both Gram triangles) and pass 2 (linear
    predictor, exp, weight, x^T M^-1 x, H)."""
    ntri = P * (P + 1) // 2
    return (2 * P + 9 + 5 * ntri) + (2 * P + 7 + 2 * P * P + 2 * P)


def cooks_ops(N: int, members, ntrims) -> int:
    """Operations per gene that the Cook's function needs, whatever way a
    kernel finds the trimmed means: per sample one divide (y / sf) and 21
    for the mean, the distance, the cutoff test, the argmax and the count
    above the argmax's count; per cohort member, the squared error (2) and
    two trimmed means, each ceil(log2 n) compares to place the member in
    the cohort's order (a comparison sort's share) and one add, or only the
    add when nothing is trimmed."""
    per = 0
    for n, k in zip(members, ntrims):
        place = math.ceil(math.log2(n)) if k > 0 and n > 1 else 0
        per += n * (2 + 2 * (place + 1))
    return per + 22 * N


def summary_kernel_checks(dtype, G, N, reps, timings, outliers=False):
    """Phase 2, summary kernels: hat_wald, cooks and bh against their plain
    versions on the inputs ``summary_pipeline`` hands them. Returns
    ({name: max_abs_err}, the filter row, the captured run) and fills
    ``timings`` (float32 only)."""
    from pydeseq2_tpu_torch.ops import stats as st
    from pydeseq2_tpu_torch.ops import wald as wd

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    seen = capture_draw(dtype, G, N, outliers=outliers)
    errs = {}

    # -- kernel 5: hat diagonals + Wald test ---------------------------------
    # Tolerance: both sum the Gram matrices over N samples in other orders
    # and the plain linear predictor is a GEMM: 1e-4 (f32) / 1e-10 (f64)
    # relative on H, mu, se and the statistic (H absolute below 1e-2), and
    # on log p scaled by 1 + stat^2 (d log p / d stat ~ stat).
    args, kwargs, _ = seen["hat_wald"]
    beta, disp, sf, X, contrast, lfc_null = args
    rtol = 1e-4 if f32 else 1e-10
    alts = [kwargs["alt_hypothesis"]] if f32 else list(wd.ALT_CODES)
    worst = {}
    for alt in alts:
        hw_args = (beta, disp, sf, X, contrast, lfc_null, kwargs["min_mu"], alt)
        got = wd._hat_wald_cuda(*hw_args)
        want = wd._hat_wald_plain(*hw_args)
        for key, a, b, floor in zip(("H", "mu", "p", "stat", "se"), got, want, (1e-2, 1e-300, 0.0, 1e-3, 1e-300)):
            if key == "p":
                # Where the plain p is below `tiny` (the f32 tail underflows)
                # the kernel's must be too (within a factor 1e3).
                tiny = 1e-30 if f32 else 1e-300
                check(torch.equal(torch.isnan(a), torch.isnan(b)), f"hat_wald {name} {alt}: p NaN masks differ")
                big = b >= tiny
                check(bool((a[~big & ~torch.isnan(b)] < 1e3 * tiny).all()), f"hat_wald {name} {alt}: p tail")
                scale = 1.0 + want[3][big].double().square()
                e = ((a[big].double().log() - b[big].double().log()).abs() / scale).max().item() if bool(big.any()) else 0.0
            else:
                e = rel_err(a.double(), b.double(), floor)
            worst[key] = max(worst.get(key, 0.0), e)
            check(e <= rtol, f"hat_wald {name} alt={alt} {key}: rel err {e:.3g} > {rtol}")
    errs["hat_wald"] = max((got[0] - want[0]).nan_to_num(0.0).abs().max().item(),
                           (got[4] - want[4]).nan_to_num(0.0).abs().max().item())
    log(f"  hat_wald {name}: alternatives {alts}, max rel err " +
        ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {rtol})")
    if f32:
        P = X.shape[1]
        hw_args = (beta, disp, sf, X, contrast, lfc_null, kwargs["min_mu"], kwargs["alt_hypothesis"])
        isz = beta.element_size()
        timings["hat_wald"] = {
            "ms": cuda_ms(lambda: wd._hat_wald_cuda(*hw_args), reps),
            "plain_ms": cuda_ms(lambda: wd._hat_wald_plain(*hw_args), reps),
            "library_ms": None,
            # reads beta, disp (G (P + 1)), sf, X; writes H and mu (2 G N), p, stat, se
            "bytes": isz * (G * (P + 1) + N * (P + 1) + 2 * G * N + 3 * G),
            "ops": hat_wald_ops(P) * G * N,
            "ops_per_s": F32_OPS_PER_S,
        }

    # -- kernel 10: Cook's distances, robust dispersion, outlier flags -------
    cargs = seen["cooks_outliers"][0]
    errs["cooks"] = cooks_check(name, cargs, reps if f32 else 0, timings)

    # -- kernel 9: the batched BH sweep of independent filtering -------------
    bargs, _, (adj_run, _) = seen["bh_sweep"]
    p, order, valid, base_mean, cutoffs, alpha = bargs
    for label, sweep_args in (
        ("50 rows", bargs),
        ("1 row", (p, order, valid, None, None, alpha)),
        ("50 rows, float32 operands", (p.float(), order, valid, base_mean.float(), cutoffs.float(), alpha)),
    ):
        adj_k, rej_k = st._bh_sweep_cuda(*sweep_args)
        adj_p, rej_p = st._bh_sweep_plain(*sweep_args)
        # Exact: the same order, products, quotients and minima.
        nan_k, nan_p = torch.isnan(adj_k), torch.isnan(adj_p)
        check(torch.equal(nan_k, nan_p), f"bh {name} {label}: NaN masks differ")
        check(torch.equal(adj_k.masked_fill(nan_k, 0.0), adj_p.masked_fill(nan_p, 0.0)),
              f"bh {name} {label}: adjusted p-values not bit-identical")
        check(torch.equal(rej_k, rej_p), f"bh {name} {label}: rejection counts differ")
    rows = cutoffs.shape[0]
    # The cutoff row the independent filter picked: the first row of the
    # run's sweep equal to the run's padj (rows that equal it are the same
    # adjustment). Adjusted values lie in [0, 1], so NaN is compared as 2.
    padj_run = seen["device_padj"][2].nan_to_num(2.0)
    same = [torch.equal(r.nan_to_num(2.0), padj_run) for r in adj_run]
    check(any(same), f"bh {name}: the run's padj is no row of its sweep")
    filter_row = same.index(True)
    log(f"  bh {name}: ({rows}, {p.shape[0]}), 1 row, and float32 operands bit-identical; "
        f"rejections per row {rej_k.tolist()[:3]}...{rej_k.tolist()[-3:]}; filter row j = {filter_row}")
    errs["bh"] = 0.0
    if f32:
        Gp = p.shape[0]
        timings["bh"] = {
            "ms": cuda_ms(lambda: st._bh_sweep_cuda(*bargs), reps),
            "plain_ms": cuda_ms(lambda: st._bh_sweep_plain(*bargs), reps),
            "library_ms": None,
            "sort_ms": cuda_ms(lambda: torch.argsort(p, stable=True), reps),
            # reads p, base_mean (f64), order (i32), valid (u8), the cutoffs;
            # writes adj (rows x G f64) and the counts
            "bytes": Gp * (8 + 8 + 4 + 1) + rows * 8 + rows * Gp * 8 + rows * 8,
            # per row and gene: mask (3 compares), rank count, product,
            # quotient, rank clamp, minimum, clip, compare with alpha
            "ops": 10 * rows * Gp,
            "ops_per_s": F64_OPS_PER_S,
        }
    return errs, filter_row, seen


def cooks_check(name, cargs, reps, timings):
    """The cooks kernel against its plain version on ``cargs``."""
    from pydeseq2_tpu_torch.ops import cooks as ck

    f32 = cargs[0].dtype == torch.float32
    # Tolerance: the trimmed sums run in other orders and feed
    # (v - m) / m^2, which cancels where v ~ m, so 1e-3 (f32) / 1e-9 (f64)
    # relative on the distances and the robust dispersion. Flags: identical
    # in f64; in f32 identical except on genes whose largest use_for_max
    # distance lies within that tolerance of the cutoff.
    rtol = 1e-3 if f32 else 1e-9
    c_k, o_k, d_k = ck._cooks_cuda(*cargs)
    c_p, o_p, d_p = ck._cooks_plain(*cargs)
    counts, G, N = cargs[0], cargs[0].shape[0], cargs[0].shape[1]
    e_c = rel_err(c_k.double(), c_p.double(), 1e-12)
    e_d = rel_err(d_k.double(), d_p.double(), 1e-12)
    check(e_c <= rtol and e_d <= rtol, f"cooks {name} N={N}: rel err cooks {e_c:.3g}, disp {e_d:.3g} > {rtol}")
    differ = o_k != o_p
    cohort_ids, use_for_max, cutoff = cargs[6], cargs[7], cargs[8]
    if bool(differ.any()):
        ufm = torch.tensor(use_for_max, device=counts.device)
        top = torch.where(ufm[None, :], c_p, torch.full_like(c_p, -math.inf)).amax(1)
        near = (top - cutoff).abs() <= rtol * cutoff.abs()
        check(f32 and bool((near | ~differ).all()), f"cooks {name} N={N}: outlier flags differ on "
                                                    f"{int(differ.sum())} genes")
    cohort, trims, _ = ck.cohort_layout(cohort_ids, use_for_max, N)
    log(f"  cooks {name} N={N} cohorts={len(trims)}: rel err cooks {e_c:.3g}, robust disp {e_d:.3g} "
        f"(tol {rtol}); outliers kernel {int(o_k.sum())} plain {int(o_p.sum())}, "
        f"flags differ on {int(differ.sum())}")
    if reps:
        members = [list(cohort).count(c) for c in range(len(trims))]
        ntrims = [math.floor(n * t) for n, t in zip(members, trims)]
        isz = counts.element_size()
        timings["cooks"] = {
            "ms": cuda_ms(lambda: ck._cooks_cuda(*cargs), reps),
            "plain_ms": cuda_ms(lambda: ck._cooks_plain(*cargs), reps),
            "library_ms": None,
            # reads counts, mu, H, writes the distances (4 G N); per gene
            # the flags and the dispersion
            "bytes": 4 * G * N * isz + G * (1 + 1 + isz) + N * (isz + 1),
            "ops": G * cooks_ops(N, members, ntrims),
            "ops_per_s": F32_OPS_PER_S,
        }
    return (c_k - c_p).nan_to_num(0.0).abs().max().item()


def cooks_wide_check() -> None:
    """Phase 2, Cook's at 1500 samples in one cohort (float64): the inputs
    of a ``summary_pipeline`` run whose design has no 3-replicate cohort
    information (``cohort_ids=None``), so the robust dispersion is one
    trimmed variance over all samples, past the JAX select switch."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_WIDE, G_WIDE, seed=5)
    kw = summary_kwargs(counts_np.T, X_np, torch.float64, DEVICE, beta_tol=1e-8)
    kw.update(cohort_ids=None, use_for_max=(True,) * N_WIDE)
    cargs = capture_summary_inputs(kw)["cooks_outliers"][0]
    check(cargs[6] is None and all(cargs[7]), "wide Cook's check: expected one cohort of all samples")
    cooks_check("f64", cargs, 0, {})


def summary_path(reps: int, filter_row: int):
    """Phase 3b: ``summary_pipeline`` through the public entry point at full
    width, float32. ``filter_row`` is the independent-filtering row that
    phase 2's run of the same inputs picked."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_MAIN)
    kw = summary_kwargs(counts_np.T, X_np, torch.float32, DEVICE, beta_tol=1e-6)
    out = pt.summary_pipeline(**kw)  # warm-up
    torch.cuda.synchronize()
    walls = []
    launches = None
    for i in range(reps):
        if i == 0:
            kernels.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pt.summary_pipeline(**kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
    for name in SUMMARY_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the summary path")
    res = pt.outputs_to_numpy(out)
    padj = res["padj"]
    check(padj.shape == (G_MAIN,) and padj.dtype == np.float64, "padj shape/dtype")
    check(res["cooks"].shape == (G_MAIN, N_MAIN), "cooks shape")
    fin = np.isfinite(padj)
    check(fin.mean() > 0.5, f"only {fin.mean():.4f} of padj are finite")
    check(np.all((padj[fin] >= 0) & (padj[fin] <= 1)), "padj outside [0, 1]")
    check(np.array_equal(np.isnan(res["p_values"]) & np.isfinite(padj), np.zeros(G_MAIN, bool)),
          "a gene without a p-value has a padj")
    best = min(walls)
    n_out = int(res["cooks_outlier"].sum())
    rescue_s, rescue_wall = rescue_share(pt.summary_pipeline, kw)
    log(f"  wall (warm) {[round(w, 4) for w in walls]} s, best {best:.4f} s, {G_MAIN / best:.1f} genes/s; "
        f"_irls_with_rescue {rescue_s * 1e3:.3f} ms of a {rescue_wall * 1e3:.3f} ms run (share "
        f"{rescue_s / rescue_wall:.4f})")
    log(f"  launches in one run {launches}")
    log(f"  cooks outliers {n_out}, finite padj {fin.mean():.5f}, padj < 0.05: {int((padj < 0.05).sum())}, "
        f"filter row j = {filter_row} (phase 2), rescue_overflow {int(res['rescue_overflow'])}")
    return {"walls_s": walls, "best_s": best, "genes_per_s": G_MAIN / best, "launches": launches,
            "cooks_outliers": n_out, "finite_padj": float(fin.mean()), "filter_row": filter_row,
            "rescue_share": rescue_s / rescue_wall}, kw, out


def compare_outputs(label: str, gpu: dict, cpu: dict, skip=None) -> dict:
    """Card against CPU, key by key: rtol 1e-6 on the float outputs,
    identical NaN masks, identical flags and counts. ``skip`` (G,) bools
    leaves genes out of the per-gene keys, except ``cooks_outlier`` and
    ``padj``, which must agree on every gene."""
    check(gpu.keys() == cpu.keys(), f"{label}: key sets differ")
    worst = {}
    for k in gpu:
        a, b = gpu[k], cpu[k]
        check(a.dtype == b.dtype and a.shape == b.shape, f"{label} {k}: dtype/shape")
        if skip is not None and a.ndim and a.shape[0] == skip.shape[0] and k not in ("cooks_outlier", "padj"):
            a, b = a[~skip], b[~skip]
        if a.dtype.kind == "f":
            check(np.array_equal(np.isnan(a), np.isnan(b)), f"{label} {k}: NaN masks differ")
            m = ~np.isnan(b)
            rel = float(np.max(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]), 1e-300), initial=0.0))
            worst[k] = rel
            check(np.allclose(a[m], b[m], rtol=1e-6, atol=1e-12),
                  f"{label} {k}: card and CPU differ beyond rtol 1e-6 (max rel {rel:.3g})")
        else:
            check(np.array_equal(a, b), f"{label} {k}: differs")
    log(f"  {label}: max rel card vs CPU " + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()))
    return worst


def account_rescue_exit(seen: dict, counts: np.ndarray, i: int, gpu: dict, cpu: dict, label: str) -> float:
    """Account for gene ``i``, whose rescue exit differs between the card
    and the CPU, from the card's own rescue inputs and outputs, by phase 2's
    rules for the rescue kernels: the card's Newton-box flag is the plain
    exit test at the card's box point (or that test's rounding straddles
    1e-5); the card's LFC agrees with the CPU plain tier of its branch (the
    Newton box where the flag holds or P > 2, else the grid), fed the exact
    operands the card's tiers got for that lane, within 1e-9 or with
    objectives tied to rounding (:func:`agree_or_tie`); and the gene is a
    Cook's outlier on both sides (its p-value is masked). Returns its LFC
    gap between card and CPU."""
    from pydeseq2_tpu_torch.ops import irls as irl

    check("newton_box_nbglm" in seen, f"{label}: gene {i} exits differ but the card ran no rescue")
    args, kwargs, (b_box, ok_box) = seen["newton_box_nbglm"]
    tc, sf, X, disp, binit, min_mu, max_beta, maxiter, sel = bound_args(irl.newton_box_nbglm, args, kwargs)
    row = torch.as_tensor(counts[i], dtype=tc.dtype, device=tc.device)
    lanes = torch.nonzero((tc == row[None, :]).all(1) & sel).flatten().tolist()
    check(len(lanes) == 1, f"{label}: gene {i} is not one selected lane of the card's rescue tile")
    k = lanes[0]

    def one(t):
        return t[k:k + 1].cpu()

    lane = (one(tc), sf.cpu(), X.cpu(), one(disp))
    flag = bool(ok_box[k])
    check(flag == bool(gpu["irls_converged"][i]), f"{label}: gene {i}: the card's box flag {flag} is not its output")
    sup, noise = box_exit(*lane, one(b_box), min_mu, max_beta)
    check(flag == bool(sup[0] < 1e-5) or bool((sup - 1e-5).abs()[0] <= noise[0]),
          f"{label}: gene {i}: the card's box flag {flag} is not the exit test at its point (|pg| {float(sup[0]):.3g})")
    card = torch.as_tensor(gpu["lfc"][i:i + 1], dtype=tc.dtype)
    if flag or X.shape[1] != 2:
        want = irl._newton_box_plain(*lane, one(binit), min_mu, max_beta, maxiter)[0]
        what, btol = f"{label} gene {i} (Newton box)", 1e-9
    else:
        grid = bound_args(irl.grid_fit_beta_batch, lane, {"min_mu": min_mu})[:-1]
        want = irl._grid_fit_beta_plain(*grid)
        what, btol = f"{label} gene {i} (grid)", 1e-6 * abs(grid[-1])
    unit = noise_unit(tc.shape[1], tc.dtype) * term_scale(lane[0])
    agree_or_tie(what, card, want, nb_objective64(*lane, card, min_mu), nb_objective64(*lane, want, min_mu), btol,
                 unit)
    check(bool(gpu["cooks_outlier"][i] and cpu["cooks_outlier"][i]), f"{label}: gene {i} is not a Cook's outlier "
                                                                      "on both sides")
    return float(np.abs(gpu["lfc"][i] - cpu["lfc"][i]).max())


def summary_card_vs_cpu():
    """Phase 4b: the f64 summary pipeline on the card against the CPU plain
    path, with two injected outliers, both filtering modes.

    Every gene is held at rtol 1e-6. The rescue tiers' exit tests
    (|projected gradient| < 1e-5, then the grid) may still decide
    differently on the two sides for a gene whose rescue inputs differ by
    rounding; such a gene (a flipped ``irls_converged``) is accounted for by
    :func:`account_rescue_exit` from the card's captured rescue inputs and
    only then left out of the per-gene keys. ``cooks_outlier`` and ``padj``
    agree on every gene. Returns the draw and the CPU result of the
    filtered run (phase 4c's inputs)."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_CPU_CMP, seed=1)
    counts = with_outliers(counts_np.T)
    routed = []
    cpu_filtered = None
    for indep in (True, False):
        label = f"summary independent_filter={indep}"
        seen = capture_summary_inputs(summary_kwargs(counts, X_np, torch.float64, DEVICE, beta_tol=1e-8,
                                                     independent_filter=indep))
        gpu = pt.outputs_to_numpy(seen["summary"])
        cpu = pt.outputs_to_numpy(pt.summary_pipeline(**summary_kwargs(counts, X_np, torch.float64, "cpu",
                                                                       beta_tol=1e-8, independent_filter=indep)))
        skip = gpu["irls_converged"] != cpu["irls_converged"]
        flipped = np.where(skip)[0].tolist()
        gaps = [account_rescue_exit(seen, counts, i, gpu, cpu, label) for i in flipped]
        compare_outputs(label, gpu, cpu, skip if flipped else None)
        n_out = int(gpu["cooks_outlier"].sum())
        check(n_out >= 1, "summary card vs CPU: the injected outliers were not flagged")
        log(f"    outliers {n_out}, padj < 0.05: {int(np.nansum(gpu['padj'] < 0.05))}; genes whose rescue exit "
            f"differs, accounted for from the card's rescue inputs: {flipped} (LFC gaps {gaps})")
        routed += flipped
        if indep:
            cpu_filtered = cpu
    log(f"  genes that took the rescue-exit route: {len(routed)}")
    return counts, X_np, cpu_filtered


def shrink_card_vs_cpu(counts: np.ndarray, X_np: np.ndarray, summary: dict) -> None:
    """Phase 4c: the f64 shrink path on the card against the CPU plain
    path, on phase 4b's draw (injected outliers) and its CPU summary
    result: ``lfc`` and ``se`` at rtol 1e-6 with identical NaN masks,
    identical ``converged`` and the same prior scale."""
    import pydeseq2_tpu_torch as pt

    res = {}
    for dev in (DEVICE, "cpu"):
        res[dev] = pt.run_lfc_shrink_streamed(counts, X_np, 1, summary["dispersions"], summary["size_factors"],
                                              mle_lfc=summary["lfc"][:, 1], mle_se=summary["se"],
                                              dtype=torch.float64, device=dev)
    gpu, cpu = res[DEVICE], res["cpu"]
    check(gpu["prior_scale"] == cpu["prior_scale"] and gpu["gene_block"] == cpu["gene_block"], "shrink: host values")
    check(np.array_equal(gpu["converged"], cpu["converged"]), "shrink card vs CPU: converged differs")
    worst = {}
    for k in ("lfc", "se"):
        a, b = gpu[k], cpu[k]
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"shrink {k}: NaN masks differ")
        m = ~np.isnan(b)
        worst[k] = float(np.max(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]), 1e-300), initial=0.0))
        check(np.allclose(a[m], b[m], rtol=1e-6, atol=1e-12), f"shrink {k}: card and CPU differ beyond rtol 1e-6 "
                                                              f"(max rel {worst[k]:.3g})")
    log(f"  shrink f64 ({counts.shape[0]}, {counts.shape[1]}): max rel card vs CPU lfc {worst['lfc']:.2g}, "
        f"se {worst['se']:.2g}; converged identical ({float(gpu['converged'].mean()):.5f}), "
        f"prior scale {gpu['prior_scale']:.6g}")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where NaN (a second launch on the same lanes
    must repeat the first)."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def term_scale(counts: torch.Tensor) -> torch.Tensor:
    """Per lane, a bound on the summed size of an NB objective's terms
    (y log mu and lgamma(y + 1) are ~ y log y at the optimum), in float64:
    1 + sum (y + 1)(1 + log(y + 1))."""
    y = counts.double()
    return 1.0 + ((y + 1.0) * (1.0 + torch.log1p(y))).sum(1)


def noise_unit(N: int, dtype) -> float:
    """The rounding noise of a sum of N terms in ``dtype`` relative to the
    summed size of its terms: sqrt(N) eps, a random walk of N roundings
    (a sequential sum and a tree sum of the same terms differ by about
    that)."""
    return math.sqrt(N) * torch.finfo(dtype).eps


def nb_objective64(counts, sf, X, disp, beta, min_mu=0.5):
    """The rescue tiers' objective in float64 at ``beta``: the NB NLL of
    max(sf e^{X beta}, min_mu) plus 0.5e-6 |beta|^2 (the box solver's
    lgamma-free objective differs from it by a constant per lane)."""
    from pydeseq2_tpu_torch.ops.nb import nb_nll

    c, s_, x, d, b = (t.double() for t in (counts, sf, X, disp, beta))
    mu = torch.clamp(s_[None, :] * torch.exp(b @ x.T), min=min_mu)
    return nb_nll(c, mu, d) + 0.5e-6 * (b**2).sum(1)


def agree_or_tie(what, b_k, b_p, f_k, f_p, btol, unit):
    """Kernel against plain, lane by lane: the coefficients agree within
    ``btol``, or the kernel's point is as good as the plain one to rounding
    (float64 objectives within TIE_UNITS x ``unit``, the lane's rounding
    unit): a search whose accept or argmin compares values at their
    rounding noise may stop elsewhere on a flat objective. Returns (the
    number of lanes that took the second route, their largest objective
    gap in units)."""
    nan_k, nan_p = torch.isnan(b_k).any(1), torch.isnan(b_p).any(1)
    check(torch.equal(nan_k, nan_p), f"{what}: NaN lanes differ")
    close = ((b_k - b_p).abs().amax(1) <= btol) | nan_p
    gap = (f_k - f_p).abs() / unit
    bad = ~close & ~(gap <= TIE_UNITS)
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} lanes differ beyond {btol} and their objectives by more "
                             f"than {TIE_UNITS} rounding units (worst {gap[bad].max().item():.3g})")
    far = ~close
    return int(far.sum()), (gap[far].max().item() if bool(far.any()) else 0.0)


def step_gaps(objective, b_p, b_k, h, unit):
    """Per lane, the smallest float64 objective gap, in rounding units,
    between the plain grid point and its eight neighbours one fine step
    ``h`` away, leaving out the kernel's own point: how far a grid point
    one step off would stand above the tie limit."""
    gaps = []
    f_p = objective(b_p)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx or dy:
                nb = b_p + torch.tensor([dx * h, dy * h], dtype=b_p.dtype, device=b_p.device)
                is_k = ((nb - b_k).abs().amax(1) <= 0.5 * h)
                g = (objective(nb) - f_p) / unit
                gaps.append(torch.where(is_k, torch.full_like(g, math.inf), g))
    return torch.stack(gaps, 1).amin(1)


def tie_report(what, b_k, b_p, objective, unit, btol, h, readings):
    """:func:`agree_or_tie` for a grid kernel, and the reading beside it:
    the largest tie gap and the one-fine-step gaps (on the tied lanes and
    the share of all lanes where one step off stands above the limit),
    kept in ``readings[what]``."""
    far, worst = agree_or_tie(what, b_k, b_p, objective(b_k), objective(b_p), btol, unit)
    ok = ~torch.isnan(b_p).any(1)
    steps = step_gaps(objective, b_p[ok], b_k[ok], h, unit[ok])
    tied = ((b_k - b_p).abs().amax(1) > btol)[ok]
    readings[what] = {"lanes": int(ok.sum()), "tied": far, "tie_max_units": worst,
                      "step_min_units_tied": steps[tied].min().item() if bool(tied.any()) else None,
                      "step_share_above_limit": (steps > TIE_UNITS).double().mean().item(),
                      "step_median_units": steps.median().item()}
    return far, readings[what]


def box_exit(counts, sf, X, disp, beta, min_mu=0.5, max_beta=30.0):
    """The box solver's exit test at ``beta`` (pydeseq2_tpu/ops/irls.py:
    366-370) in plain PyTorch: per lane the sup-norm of the projected
    gradient and its rounding scale, 16 eps of the summed size of its
    terms."""
    from pydeseq2_tpu_torch.ops import irls as irl

    g, mu = irl._ridged_grad(beta, counts, X, sf, disp, min_mu)
    at_lo = (beta <= -max_beta + 1e-12) & (g > 0)
    at_hi = (beta >= max_beta - 1e-12) & (g < 0)
    sup = torch.where(at_lo | at_hi, torch.zeros_like(g), g).abs().amax(1)
    inv_disp = (1.0 / disp)[:, None]
    t = (inv_disp + counts) * mu / (inv_disp + mu)
    size = ((t.abs() + counts) * X.abs().amax(1)[None, :]).sum(1)
    return sup, 16 * torch.finfo(counts.dtype).eps * size


def fine_step(grid_length=60, min_beta=-30.0, max_beta=30.0) -> float:
    """The fine grid's step of the rescue and shrink grids."""
    from pydeseq2_tpu_torch.ops.irls import grid_axes

    offs = grid_axes(min_beta, max_beta, grid_length, torch.float64, "cpu")[1]
    return float(offs[1] - offs[0])


def rescue_checks(seen, dtype, reps, timings, readings):
    """Phase 2, the IRLS rescue tiers (``newton_box``, ``grid_nb``) against
    their plain versions on the tile the summary run hands them: once with
    every lane selected, once as the pipeline calls them (where the box
    leaves no lane to the grid, the grid takes the box's tile and
    selection). Returns {name: max_abs_err} and fills ``timings`` (float32
    only)."""
    from pydeseq2_tpu_torch.ops import irls as irl

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    check("newton_box_nbglm" in seen, f"rescue {name}: the summary run sent no lane to the rescue tiers")
    *box, sel = bound_args(irl.newton_box_nbglm, *seen["newton_box_nbglm"][:2])
    counts, sf, X, disp, beta_init, min_mu, max_beta, _ = box
    if "grid_fit_beta_batch" in seen:
        *grid, sel_grid = bound_args(irl.grid_fit_beta_batch, *seen["grid_fit_beta_batch"][:2])
    else:
        *grid, sel_grid = bound_args(irl.grid_fit_beta_batch, (counts, sf, X, disp), {"min_mu": min_mu, "sel": sel})
    K, N = counts.shape
    P = X.shape[1]
    # Tolerance: coefficients within 1e-4 (f32) / 1e-9 (f64), or float64
    # objectives tied within TIE_UNITS rounding units: the box solver
    # accepts a step where its objective drops, at that rounding noise, and
    # the grid's argmin ties there.
    btol = 1e-4 if f32 else 1e-9
    unit = noise_unit(N, dtype) * term_scale(counts)
    bk, okk, _ = irl._newton_box_cuda(*box)
    bp, okp = irl._newton_box_plain(*box)
    far, worst = agree_or_tie(f"newton_box {name}", bk, bp, nb_objective64(counts, sf, X, disp, bk, min_mu),
                              nb_objective64(counts, sf, X, disp, bp, min_mu), btol, unit)
    readings[f"newton_box {name}"] = {"lanes": K, "tied": far, "tie_max_units": worst}
    flags = (okk == okp).double().mean().item()
    # The exit |projected gradient| < 1e-5 is a function of the point: near
    # the optimum of a lane with large counts the Hessian is large and the
    # backtracking stops where the objective's rounding hides the last
    # step, so two runs that stop at points tied to rounding may fall on
    # either side of 1e-5. Each kernel flag must equal the plain exit test
    # at the kernel's own point, except within the gradient's rounding of
    # the threshold.
    sup, noise = box_exit(counts, sf, X, disp, bk, min_mu, max_beta)
    exempt = (sup - 1e-5).abs() <= noise
    wrong = (okk != (sup < 1e-5)) & ~exempt
    check(not bool(wrong.any()), f"newton_box {name}: {int(wrong.sum())} exits differ from the plain test at the "
                                 "kernel's point")
    bs, oks, passes = irl._newton_box_cuda(*box, sel)
    check(bits_equal(bs[sel], bk[sel]) and torch.equal(oks[sel], okk[sel]),
          f"newton_box {name}: selected lanes differ from the all-lane launch")
    check(torch.equal(bs[~sel], beta_init[~sel]) and not bool(oks[~sel].any()) and int(passes[~sel].sum()) == 0,
          f"newton_box {name}: a lane not selected was worked on")
    log(f"  newton_box {name}: {K} lanes, {far} off by > {btol} with tied objectives (largest gap {worst:.3g} of "
        f"the limit {TIE_UNITS} rounding units); flags agree with the plain run on {flags:.4f}, with the plain test at "
        f"the kernel's point on all but {int((okk != (sup < 1e-5)).sum())} lanes within rounding of 1e-5; pipeline "
        f"selection {int(sel.sum())} lanes, {int(passes.sum())} passes, bit-identical to the all-lane launch")

    gk = irl._grid_fit_beta_cuda(*grid)
    gp = irl._grid_fit_beta_plain(*grid)
    gfar, r = tie_report(f"grid_nb {name}", gk, gp, lambda b: nb_objective64(counts, sf, X, disp, b, min_mu), unit,
                         1e-6 * 30.0, fine_step(*grid[-3:]), readings)
    gs = irl._grid_fit_beta_cuda(*grid, sel_grid)
    check(bits_equal(gs[sel_grid], gk[sel_grid]) and bool(torch.isnan(gs[~sel_grid]).all()),
          f"grid_nb {name}: the selected launch differs from the all-lane one")
    log(f"  grid_nb {name}: {K} lanes, {gfar} at another grid point with tied objectives ({r}); pipeline selection "
        f"{int(sel_grid.sum())} lanes, bit-identical to the all-lane launch")
    errs = {"newton_box": (bk - bp).nan_to_num(0.0).abs().max().item(),
            "grid_nb": (gk - gp).nan_to_num(0.0).abs().max().item()}
    if f32:
        isz = counts.element_size()
        n_sel, n_grid = int(sel.sum()), int(sel_grid.sum())
        ntri = P * (P + 1) // 2
        timings["newton_box"] = {
            "ms": cuda_ms(lambda: irl._newton_box_cuda(*box, sel), reps),
            "plain_ms": cuda_ms(lambda: irl._newton_box_plain(*box), 2),
            "all_lanes_ms": cuda_ms(lambda: irl._newton_box_cuda(*box), reps),
            "library_ms": None,
            # the selected lanes' rows, sf, log sf and X, their disp and
            # start; writes beta and the flag of the tile
            "bytes": isz * (n_sel * N + N * (P + 2) + n_sel * (P + 1) + K * P) + K,
            # per pass and sample: linear predictor, exp, clamp, the
            # objective's or the gradient's and Hessian's terms
            "ops": int(passes.sum()) * N * (2 * P + 12 + 2 * ntri),
        }
        timings["grid_nb"] = {
            "ms": cuda_ms(lambda: irl._grid_fit_beta_cuda(*grid, sel_grid), reps),
            "plain_ms": cuda_ms(lambda: irl._grid_fit_beta_plain(*grid), 2),
            "all_lanes_ms": cuda_ms(lambda: irl._grid_fit_beta_cuda(*grid), reps),
            "library_ms": None,
            "bytes": isz * (n_grid * N + N * (P + 1) + n_grid + 2 * 60 + 2 * K),
            # 2 x 60 x 60 points a lane; per sample the linear predictor,
            # exp, clamp, log(mu), log(mu + r) or log1p, and ~12 more
            "ops": n_grid * 2 * 60 * 60 * N * 20,
        }
    return errs


def ape_objective64(counts, X, size, offset, pns, ps, cnst, shrink_index, beta):
    """The scaled apeGLM objective in float64 at ``beta`` and, per lane,
    the summed size of its terms over cnst (1 + sum |terms|) / cnst."""
    from pydeseq2_tpu_torch.ops import shrink as sh

    c, x, s_, o, cn, b = (t.double() for t in (counts, X, size, offset, cnst, beta))
    xb = b @ x.T
    terms = c * xb - (c + s_[:, None]) * sh._logaddexp(xb + o[None, :], torch.log(s_)[:, None])
    f = sh.nbinom_fn_batch(b, x, c, s_, o, pns, ps, shrink_index) / cn
    return f, (1.0 + terms.abs().sum(1)) / cn


def grid_apeglm_check(what, grid, readings):
    """``grid_apeglm`` against its plain version on ``grid`` (the bound
    arguments of ``grid_fit_shrink_beta_batch`` but ``sel``), every lane
    selected: the same grid point, or objectives tied within TIE_UNITS
    rounding units. Returns (kernel result, plain result, lanes tied)."""
    from pydeseq2_tpu_torch.ops import shrink as sh

    ci, offset, X, si, pns, ps, cnst, shrink_index = grid[:8]
    gk = sh._grid_shrink_cuda(*grid)
    gp = sh._grid_shrink_plain(*grid)
    N = ci.shape[1]

    def objective(b):
        return ape_objective64(ci, X, si, offset, pns, ps, cnst, shrink_index, b)[0]

    unit = noise_unit(N, ci.dtype) * ape_objective64(ci, X, si, offset, pns, ps, cnst, shrink_index, gp)[1]
    far, _ = tie_report(what, gk, gp, objective, unit, 1e-6 * 30.0, fine_step(*grid[-3:]), readings)
    return gk, gp, far


def shrink_kernel_checks(seen, dtype, reps, timings, readings):
    """Phase 2, the apeGLM kernels on the operands the shrink path hands
    them (``seen`` from :func:`capture_shrink_inputs`): ``shrink`` on the
    first gene block's (all 60000 genes at the main width), and
    ``grid_apeglm`` on that block's failed-first tile, made by the path's
    own ``_grid_tile``, with every lane selected (so it launches where no
    lane fails), then as the pipeline selects. Returns {name: max_abs_err}
    and fills ``timings`` (float32, ``reps`` > 0)."""
    from pydeseq2_tpu_torch import fused_stream
    from pydeseq2_tpu_torch.ops import shrink as sh
    from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    fit = bound_args(sh.nbinom_glm_batch, *seen["nbinom_glm_batch"][:2])
    X, counts, size, offset, pns, ps, shrink_index, _ = fit
    G, N = counts.shape
    P = X.shape[1]
    bk, ihk, ck, trips, passes = sh._nbinom_glm_cuda(*fit)
    bp, ihp, cp = sh._nbinom_glm_plain(*fit)
    check(bits_equal(bk, seen["nbinom_glm_batch"][2][0]), f"shrink {name}: the launch differs from the path's")
    flags = (ck == cp).double().mean().item()
    both = ck & cp
    e_b = rel_err(bk[both].double(), bp[both].double(), 1.0)
    # The inverse Hessian against the plain float64 inverse at the kernel's
    # own point, per lane relative to its largest entry, within 64 eps of
    # the working dtype times the Hessian's condition number (an inverse
    # amplifies the rounding of H by it; near |beta_s| = prior scale the
    # prior's curvature vanishes and H is ill-conditioned there).
    H64 = sh._hess(bk.double(), X.double(), counts.double(), size.double(), offset.double(), pns, ps, shrink_index)
    ih64 = sym_inv(H64)
    cond = torch.linalg.cond(H64)
    e_lane = (ihk.double() - ih64).abs().flatten(1).amax(1) / ih64.abs().flatten(1).amax(1)
    tol_lane = 64 * torch.finfo(dtype).eps * cond
    bad_ih = both & ~(e_lane <= tol_lane)
    e_ih = (e_lane / tol_lane)[both].max().item() if bool(both.any()) else 0.0
    if f32:
        # The f32 accept and the |g| < 1e-6 flag sit at the rounding noise of
        # the objective and gradient: 99% of the flags, and on lanes that
        # converge on both sides coefficients within 1e-3 of (1 + |beta|).
        check(flags >= 0.99 and e_b <= 1e-3 and not bool(bad_ih.any()),
              f"shrink {name}: flags {flags:.4f}, beta {e_b:.3g}, ih {int(bad_ih.sum())} lanes beyond tolerance")
    else:
        # and the plain run's inverse within 1e-9 of its largest entry
        d_run = (ihk[both] - ihp[both]).abs().flatten(1).amax(1) / ihp[both].abs().flatten(1).amax(1)
        e_run = d_run.max().item() if bool(both.any()) else 0.0
        check(flags == 1.0 and e_b <= 1e-9 and e_run <= 1e-9 and not bool(bad_ih.any()),
              f"shrink {name}: flags {flags:.4f}, beta {e_b:.3g}, ih {e_run:.3g} (tol identical, 1e-9, 1e-9), "
              f"ih at the kernel's point: {int(bad_ih.sum())} lanes beyond tolerance")
    q = torch.tensor([0.5, 0.99, 1.0], dtype=torch.float64, device=trips.device)
    log(f"  shrink {name}: ({G}, {N}), prior scale {float(ps):.6g}, flags agree {flags:.5f}, converged "
        f"{ck.double().mean().item():.5f}; where both converge beta rel {e_b:.3g}, ih at the kernel's point {e_ih:.3g} "
        f"of its tolerance (64 eps cond, cond up to {cond[both].max().item() if bool(both.any()) else 0.0:.3g}); "
        f"Newton steps per gene (50/99/100%) {trips.double().quantile(q).tolist()}, passes {int(passes.sum())}")

    c, s, m, offset_b, X_b, prior_scale, pns_b, si_b = seen["_shrink_block"][0]
    conv = seen["nbinom_glm_batch"][2][2]
    _, ci, si, cnst, sel = fused_stream._grid_tile(c, s, m, conv, offset_b, X_b, prior_scale, pns_b, si_b)
    *grid, _ = bound_args(sh.grid_fit_shrink_beta_batch, (ci, offset_b, X_b, si, pns_b, prior_scale, cnst),
                          {"shrink_index": si_b})
    if "grid_fit_shrink_beta_batch" in seen:
        check(torch.equal(seen["grid_fit_shrink_beta_batch"][1]["sel"], sel), f"grid_apeglm {name}: the path's "
                                                                              "selection is not its tile's")
    K = ci.shape[0]
    gk, gp, gfar = grid_apeglm_check(f"grid_apeglm {name}", grid, readings)
    gs = sh._grid_shrink_cuda(*grid, sel)
    check(bits_equal(gs[sel], gk[sel]) and bool(torch.isnan(gs[~sel]).all()),
          f"grid_apeglm {name}: the selected launch differs from the all-lane one")
    log(f"  grid_apeglm {name}: {K} lanes (failed first), {gfar} at another grid point with tied objectives "
        f"({readings[f'grid_apeglm {name}']}); pipeline selection {int(sel.sum())} lanes, bit-identical to the "
        "all-lane launch")
    errs = {"shrink": (bk - bp)[both].abs().max().item() if bool(both.any()) else 0.0,
            "grid_apeglm": (gk - gp).nan_to_num(0.0).abs().max().item()}
    if f32 and reps:
        isz = counts.element_size()
        ntri = P * (P + 1) // 2
        timings["shrink"] = {
            "ms": cuda_ms(lambda: sh._nbinom_glm_cuda(*fit), reps),
            "plain_ms": cuda_ms(lambda: sh._nbinom_glm_plain(*fit), 1),
            "library_ms": None,
            # reads counts, size, offset, X; writes beta, the inverse
            # Hessian and the flag
            "bytes": isz * (G * N + G + N + N * P + G * P + G * P * P) + G,
            # per pass and sample: linear predictor, two exps or exp and
            # log1p (logaddexp), ~12 more, and the Hessian's Gram terms
            "ops": int(passes.sum()) * N * (2 * P + 14 + 2 * ntri),
            "steps_mean": trips.double().mean().item(),
        }
        timings["grid_apeglm"] = {
            # every lane of the failed-first tile
            "ms": cuda_ms(lambda: sh._grid_shrink_cuda(*grid), reps),
            "plain_ms": cuda_ms(lambda: sh._grid_shrink_plain(*grid), 2),
            "library_ms": None,
            "bytes": isz * (K * N + N * (P + 1) + 2 * K + 2 * 60 + 2 * K),
            # 2 x 60 x 60 points a lane; per sample the linear predictor,
            # logaddexp (exp, log1p) and ~8 more
            "ops": K * 2 * 60 * 60 * N * 16,
        }
    return errs


def grid_wide_checks(readings) -> None:
    """Phase 2, both grid kernels past one staged chunk of samples: 16
    lanes of ``make_data(N, 16)`` at N_GRID_WIDE samples (8000 in float32,
    4000 in float64), every lane selected, against their plain versions,
    on the port's own size factors and moment dispersions (the apeGLM tile
    made by the shrink path's ``_grid_tile`` at prior scale 0.5)."""
    from pydeseq2_tpu_torch import fused_stream
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.ops import shrink as sh
    from pydeseq2_tpu_torch.synthetic import make_data

    for dtype, N in N_GRID_WIDE.items():
        name = f"{'f32' if dtype == torch.float32 else 'f64'} N={N}"
        counts_np, X_np = make_data(N, 16, seed=3)
        counts = torch.tensor(counts_np.T, dtype=dtype, device=DEVICE)
        X = torch.tensor(X_np, dtype=dtype, device=DEVICE)
        sf, disp = stage_inputs(counts, X, float(N))[2:4]
        *grid, _ = bound_args(irl.grid_fit_beta_batch, (counts, sf, X, disp), {})
        gk = irl._grid_fit_beta_cuda(*grid)
        gp = irl._grid_fit_beta_plain(*grid)
        unit = noise_unit(N, dtype) * term_scale(counts)
        far, r = tie_report(f"grid_nb {name}", gk, gp, lambda b: nb_objective64(counts, sf, X, disp, b), unit,
                            1e-6 * 30.0, fine_step(*grid[-3:]), readings)
        log(f"  grid_nb {name}: 16 lanes, {far} at another grid point with tied objectives ({r})")
        G = counts.shape[0]
        lanes = torch.ones(G, dtype=torch.bool, device=counts.device)
        _, ci, si, cnst, _ = fused_stream._grid_tile(counts, 1.0 / disp, lanes, ~lanes, torch.log(sf), X, 0.5, 15.0, 1)
        *agrid, _ = bound_args(sh.grid_fit_shrink_beta_batch, (ci, torch.log(sf), X, si, 15.0, 0.5, cnst), {})
        _, _, far = grid_apeglm_check(f"grid_apeglm {name}", agrid, readings)
        log(f"  grid_apeglm {name}: 16 lanes, {far} at another grid point with tied objectives "
            f"({readings[f'grid_apeglm {name}']})")


def weak_shrink_path(reps: int, readings: dict):
    """Phase 3d, coverage of the grid rescue: the shrink path on a draw
    with weak effects (fold changes of SD ``WEAK_LFC_SD``), where the
    fitted prior is narrow and Newton fails on some lanes, so that the grid
    rescue runs: ``summary_pipeline`` at 100 x 60000 float32, then
    :func:`shrink_path` on its result, then both apeGLM kernels against
    their plain versions on the operands this run hands them (the
    pipeline's selection holds the failed lanes)."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_MAIN, lfc_sd=WEAK_LFC_SD)
    kw = summary_kwargs(counts_np.T, X_np, torch.float32, DEVICE, beta_tol=1e-6)
    out = pt.summary_pipeline(**kw)
    res = shrink_path(reps, kw, out, grid=True)
    shrink_kernel_checks(capture_shrink_inputs(shrink_kwargs(kw, out, torch.float32)), torch.float32, 0, {},
                         readings)
    return res


def rescue_share(run, kw) -> tuple[float, float]:
    """One more run with ``_irls_with_rescue`` timed (synchronised before
    and after): (its seconds, the run's wall)."""
    from pydeseq2_tpu_torch import fused

    orig = fused._irls_with_rescue
    spent = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    fused._irls_with_rescue = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fused._irls_with_rescue = orig
    return sum(spent), wall


def shrink_path(reps: int, summary_kw: dict, summary_out: dict, grid: bool = False):
    """Phase 3c: ``run_lfc_shrink_streamed`` through the public entry point
    at full width, float32, on a ``summary_pipeline`` run's counts,
    dispersions, size factors, MLE LFCs and SEs, with the adaptive prior.
    With ``grid``, lanes must fail Newton and ``grid_apeglm`` must launch."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels

    kw = shrink_kwargs(summary_kw, summary_out, torch.float32)
    res = pt.run_lfc_shrink_streamed(**kw)  # warm-up
    walls = []
    launches = None
    for i in range(reps):
        if i == 0:
            kernels.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.run_lfc_shrink_streamed(**kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
    check(launches["shrink"] > 0, "kernel shrink was not launched on the shrink path")
    if grid:
        check(launches["grid_apeglm"] > 0, "kernel grid_apeglm was not launched on the shrink path")
    G = G_MAIN
    lfc, se, conv = res["lfc"], res["se"], res["converged"]
    check(lfc.shape == (G, 2) and se.shape == (G,) and lfc.dtype == np.float32, "shrink output shapes/dtype")
    disp = summary_out["dispersions"].cpu().numpy()
    valid = np.isfinite(disp) & (disp > 0)
    check(np.array_equal(np.isnan(lfc[:, 1]), ~valid) and np.isfinite(se[valid]).all(),
          "shrunk LFCs are NaN exactly where the dispersion is not valid")
    mle = summary_out["lfc"][:, 1].cpu().numpy()
    shrunk = float(np.mean(np.abs(lfc[valid, 1]) <= np.abs(mle[valid]) + 1e-3))
    check(shrunk > 0.95, f"only {shrunk:.4f} of the shrunk LFCs are no larger than the MLE")
    B = res["gene_block"]
    K = min(B, max(256, B // 64))
    failed = ~conv & valid
    to_grid = sum(min(int(failed[b:b + B].sum()), K) for b in range(0, G, B))
    check(not grid or to_grid > 0, "no lane was sent to the grid")
    best = min(walls)
    log(f"  wall (warm) {[round(w, 4) for w in walls]} s, best {best:.4f} s, {G / best:.1f} genes/s; "
        f"prior scale {res['prior_scale']:.6g}, gene_block {B}")
    log(f"  converged {float(conv.mean()):.5f}, lanes sent to the grid {to_grid}, |shrunk| <= |MLE| on {shrunk:.5f}; "
        f"launches in one run: shrink {launches['shrink']}, grid_apeglm {launches['grid_apeglm']}")
    return {"walls_s": walls, "best_s": best, "genes_per_s": G / best, "launches": launches,
            "prior_scale": res["prior_scale"], "converged": float(conv.mean()), "to_grid": to_grid}


def plant_outliers(counts: np.ndarray) -> np.ndarray:
    """(G, N) counts with an outlier planted in every OUTLIER_EVERY-th gene
    (``synthetic.plant_outliers``)."""
    from pydeseq2_tpu_torch.synthetic import plant_outliers as plant

    return plant(counts, OUTLIER_EVERY)


def stream_kwargs(counts: np.ndarray, X_np: np.ndarray, dtype, device) -> dict:
    """``run_summary_streamed(refit_cooks=True)`` keyword arguments, the
    counts already on ``device`` (the device-resident input), at the
    pipelines' beta_tol (1e-6 in float32, 1e-8 in float64)."""
    contrast = np.zeros(X_np.shape[1])
    contrast[-1] = 1.0
    return dict(counts=torch.as_tensor(counts, dtype=dtype, device=device), design_matrix=X_np, contrast=contrast,
                dtype=dtype, refit_cooks=True, max_disp=float(max(10, X_np.shape[0])),
                beta_tol=1e-6 if dtype == torch.float32 else 1e-8, device=device)


def capture_stream_inputs(kw: dict) -> dict:
    """Run ``run_summary_streamed`` once and keep what it hands to the
    wrappers of the streamed path's new kernels (the first call of each:
    pass 1's first block for ``mom`` and ``cooks``, the refit tile's first
    block for ``impute``), plus the run's output under ``"stream"``."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused, fused_stream

    targets = [(fused, ("parametric_trend", "lowess_pick")),
               (fused_stream, ("mom_and_mu_coef", "cooks_outliers", "impute_outliers"))]
    return capture(targets, pt.run_summary_streamed, "stream", kw)


def scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max(|b|, 1) (relative, absolute below 1), after
    checking that a and b are NaN at the same places."""
    return rel_err(a.double(), b.double(), 1.0)


def count_trend_passes(run) -> tuple[int, int]:
    """(loss passes, gradient + Fisher passes) over the genes that the
    plain trend fit makes in ``run()`` (a call of a plain version): the
    work the kernel's bound counts."""
    from pydeseq2_tpu_torch.ops import trend as tr

    calls = {"trend_loss": 0, "trend_grad": 0}
    originals = {n: getattr(tr, n) for n in calls}

    def counted(name):
        def fn(*args, **kwargs):
            calls[name] += 1
            return originals[name](*args, **kwargs)

        return fn

    try:
        for n in calls:
            setattr(tr, n, counted(n))
        run()
    finally:
        for n, fn in originals.items():
            setattr(tr, n, fn)
    return calls["trend_loss"], calls["trend_grad"]


def mom_check(name: str, recorded) -> float:
    """``mom`` against its plain version on a recorded ``mom_and_mu_coef``
    call (args, kwargs, result), with and without mu: the max abs error."""
    from pydeseq2_tpu_torch.ops import linreg as lin

    f32 = recorded[0][0].dtype == torch.float32
    c, sf, X, pinv, min_mu, _, normed = bound_args(lin.mom_and_mu_coef, *recorded[:2])
    Gm, P = c.shape[0], X.shape[1]
    check(bits_equal(lin._mom_cuda(c, sf, X, pinv, min_mu, False, normed)[0], recorded[2][0]),
          f"mom {name}: the launch differs from the path's")
    rtol = 1e-5 if f32 else 1e-12
    worst = {}
    for want_mu in (False, True):
        got = lin._mom_cuda(c, sf, X, pinv, min_mu, want_mu, normed)
        want = lin._mom_plain(c, sf, X, pinv, min_mu, want_mu, normed)
        for key, a, b in zip(("rough", "moments", "coef", "mu"), got, want):
            if b is None:
                check(a is None, f"mom {name}: mu written without want_mu")
                continue
            if key == "coef":
                e = ((a - b).abs() / torch.clamp(b.abs().amax(1, keepdim=True), min=1.0)).max().item()
            else:
                e = scaled_err(a, b)
            worst[key] = max(worst.get(key, 0.0), e)
    check(all(v <= rtol for v in worst.values()), f"mom {name}: errors {worst} beyond {rtol}")
    log(f"  mom {name}{' normed counts' if normed else ''} ({Gm}, {c.shape[1]}): rel err (abs below 1) " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (tol {rtol})")
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def trend_check(name: str, recorded) -> tuple[float, int, int]:
    """``trend`` against its plain version on a recorded
    ``parametric_trend`` call: (max abs coefficient error, the plain fit's
    loss passes, its gradient + Fisher passes)."""
    from pydeseq2_tpu_torch.ops import trend as tr

    f32 = recorded[0][0].dtype == torch.float32
    bm, gm, nz, mean_disp, max_rounds = bound_args(tr.parametric_trend, *recorded[:2])
    run_out = recorded[2]
    got = tr._parametric_trend_cuda(bm, gm, nz, mean_disp, max_rounds)
    want = tr._parametric_trend_plain(bm, gm, nz, mean_disp, max_rounds)
    check(bits_equal(got[1], run_out[1]), f"trend {name}: the launch differs from the path's")
    e_c = rel_err(got[1].double(), want[1].double(), 1e-300)
    e_f = rel_err(got[0][nz].double(), want[0][nz].double(), 1e-300)
    rk, rp = int(got[3]), int(want[3])
    ctol = 1e-4 if f32 else 1e-10
    check(bool(got[2]) == bool(want[2]), f"trend {name}: failed flag {bool(got[2])}, plain {bool(want[2])}")
    check(e_c <= ctol and e_f <= ctol, f"trend {name}: coefficient rel err {e_c:.3g}, fitted {e_f:.3g} > {ctol}")
    check(abs(rk - rp) <= (1 if f32 else 0), f"trend {name}: {rk} rounds, plain {rp}")
    n_loss, n_grad = count_trend_passes(lambda: tr._parametric_trend_plain(bm, gm, nz, mean_disp, max_rounds))
    log(f"  trend {name} (G {bm.shape[0]}): coeffs {got[1].tolist()} (plain {want[1].tolist()}), rel err {e_c:.3g}, "
        f"fitted {e_f:.3g} (tol {ctol}); rounds {rk} "
        f"(plain {rp}), failed {bool(got[2])}; plain passes: {n_loss} loss, {n_grad} gradient + Fisher")
    return (got[1] - want[1]).abs().max().item(), n_loss, n_grad


def stream_kernel_checks(dtype, G, N, reps, timings):
    """Phase 2, the streamed refit path's kernels (``mom``, ``trend``,
    ``lowess``, ``impute`` and the refit outputs of ``cooks``) against their
    plain versions on the operands one ``run_summary_streamed(refit_cooks=
    True)`` run of ``make_data(N, G)`` with planted outliers hands them.
    Returns {name: max_abs_err} and fills ``timings`` (``reps`` > 0)."""
    from pydeseq2_tpu_torch.ops import cooks as ck
    from pydeseq2_tpu_torch.ops import linreg as lin
    from pydeseq2_tpu_torch.ops import refit as rf
    from pydeseq2_tpu_torch.ops import stats as st
    from pydeseq2_tpu_torch.ops import trend as tr
    from pydeseq2_tpu_torch.synthetic import make_data

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    counts_np, X_np = make_data(N, G)
    seen = capture_stream_inputs(stream_kwargs(plant_outliers(counts_np.T), X_np, dtype, DEVICE))
    for key in ("mom_and_mu_coef", "parametric_trend", "lowess_pick", "cooks_outliers", "impute_outliers"):
        check(key in seen, f"stream {name}: the run made no call of {key}")
    errs = {}
    isz = torch.finfo(dtype).bits // 8

    # -- mom: MoM dispersions, OLS coefficients, linear mu ---------------------
    # Tolerance 1e-5 (f32) / 1e-12 (f64), relative or absolute below 1: both
    # sum the row in other orders (warp tree, vectorised loops). A
    # coefficient is held relative to the gene's largest one: the condition
    # coefficient is a difference of group means and cancels to its
    # rounding at that scale.
    c, sf, X, pinv, min_mu, _, _ = bound_args(lin.mom_and_mu_coef, *seen["mom_and_mu_coef"][:2])
    Gm, P = c.shape[0], X.shape[1]
    errs["mom"] = mom_check(name, seen["mom_and_mu_coef"])
    if reps:
        normed = c / sf[None, :]
        pinv_t = pinv.T.contiguous()
        timings["mom"] = {
            "ms": cuda_ms(lambda: lin._mom_cuda(c, sf, X, pinv, min_mu, False), reps),
            "ms_with_mu": cuda_ms(lambda: lin._mom_cuda(c, sf, X, pinv, min_mu, True), reps),
            "plain_ms": cuda_ms(lambda: lin._mom_plain(c, sf, X, pinv, min_mu, False), reps),
            # the (G, N) @ (N, P) product of the OLS fit alone
            "library_ms": cuda_ms(lambda: torch.matmul(normed, pinv_t), reps),
            # reads counts, sf, X, pinv; writes rough, moments, coef (pass 1 of
            # the streamed path writes no mu)
            "bytes": isz * (Gm * N + N * (2 * P + 1) + Gm * (P + 2)),
            # per element: y / sf, P products and sums, the mean's add (pass 1);
            # y / sf, x.b (2P), max, the rough term (7), the squared deviation (3)
            "ops": Gm * N * (2 + 2 * P + 12 + 2 * P),
        }

    # -- trend: every exclusion round on the card -----------------------------
    # f64: coefficients and fitted values within 1e-10 relative, the same
    # rounds and failed flag. f32: within 1e-4, the same failed flag, rounds
    # within 1. Both versions sum each term in float64 and round the total,
    # so their accept and stall tests see the same float32 totals.
    bm, gm, nz, mean_disp, max_rounds = bound_args(tr.parametric_trend, *seen["parametric_trend"][:2])
    errs["trend"], n_loss, n_grad = trend_check(name, seen["parametric_trend"])
    if reps:
        Gt = bm.shape[0]
        timings["trend"] = {
            "ms": cuda_ms(lambda: tr._parametric_trend_cuda(bm, gm, nz, mean_disp, max_rounds), reps),
            "plain_ms": cuda_ms(lambda: tr._parametric_trend_plain(bm, gm, nz, mean_disp, max_rounds), 2),
            "library_ms": None,
            # reads base_mean, genewise, non_zero, mean_disp; writes fitted
            # and the coefficients, flag and round count
            "bytes": isz * (3 * Gt + 3) + Gt + 5,
            # per gene: the loss pass ~6 operations (clamp, divide, log, adds),
            # the gradient + Fisher pass ~22; passes counted on the plain run
            "ops": Gt * (6 * n_loss + 22 * n_grad),
        }

    # -- lowess: the independent-filtering fit and cutoff row -----------------
    # The same row j; the fit within 1e-6 (f32) / 1e-13 (f64), relative
    # (absolute below 1). Both versions sum over the points in index order.
    theta, num_rej, frac = bound_args(st.lowess_pick, *seen["lowess_pick"][:2])
    for label, rej in (("run", num_rej), ("all-zero counts", torch.zeros_like(num_rej))):
        yk, jk = st._lowess_pick_cuda(theta, rej, frac)
        yp, jp = st._lowess_pick_plain(theta, rej, frac)
        ytol = 1e-6 if f32 else 1e-13
        e_y = scaled_err(yk, yp)
        check(int(jk) == int(jp), f"lowess {name} {label}: row {int(jk)}, plain {int(jp)}")
        check(e_y <= ytol, f"lowess {name} {label}: fit rel err {e_y:.3g} > {ytol:.3g}")
        log(f"  lowess {name} {label}: row j = {int(jk)} (plain {int(jp)}), fit rel err {e_y:.3g} (tol {ytol:.3g})")
    check(int(seen["lowess_pick"][2][1]) == int(st._lowess_pick_plain(theta, num_rej, frac)[1]),
          f"lowess {name}: the path's row differs from the plain pick")
    check(int(st._lowess_pick_cuda(theta, torch.zeros_like(num_rej), frac)[1]) == 0,
          f"lowess {name}: all-zero counts must pick row 0")
    yk, _ = st._lowess_pick_cuda(theta, num_rej, frac)
    errs["lowess"] = (yk - st._lowess_pick_plain(theta, num_rej, frac)[0]).nan_to_num(0.0).abs().max().item()
    if reps:
        n = theta.shape[0]
        timings["lowess"] = {
            "ms": cuda_ms(lambda: st._lowess_pick_cuda(theta, num_rej, frac), reps),
            "plain_ms": cuda_ms(lambda: st._lowess_pick_plain(theta, num_rej, frac), reps),
            "library_ms": None,
            # reads theta and the counts (int64); writes the fit and the row
            "bytes": n * (isz + 8) + n * isz + 8,
            # 3 rounds x n^2 pairs x ~22 (weight 10, five weighted sums 12),
            # plus a sort of each point's n distances (n log2 n compares)
            "ops": 3 * n * n * 22 + n * n * math.ceil(math.log2(n)),
        }

    # -- cooks, refit mode: exceed bits, replaced, the refit flag -------------
    # Bit for bit, except cells whose plain distance lies within 1e-5 (f32)
    # / 1e-12 (f64) relative of the cutoff, and flags of genes holding one.
    b = bound_args(ck.cooks_outliers, *seen["cooks_outliers"][:2])
    cargs, repl = b[:9], b[9]
    check(repl is not None and b[10] is False, f"cooks {name}: the streamed pass is not in refit mode")
    got = ck._cooks_cuda(*cargs, repl, False)
    check(got[0] is None and all(bits_equal(x.double(), y.double()) for x, y in zip(got[1:], seen["cooks_outliers"][2][1:])),
          f"cooks {name} refit: the launch differs from the path's")
    want = ck._cooks_plain(*cargs, repl, True)
    dtol = 1e-5 if f32 else 1e-12
    cutoff = cargs[8]
    near = (want[0] - cutoff).abs() <= dtol * cutoff.abs()  # False on NaN distances
    Nc = cargs[0].shape[1]
    bits_k, bits_p = ck.unpack_bits(got[3], Nc), ck.unpack_bits(want[3], Nc)
    cell_differ = bits_k != bits_p
    check(not bool((cell_differ & ~near).any()), f"cooks {name} refit: {int((cell_differ & ~near).sum())} exceed bits "
                                                 "differ away from the cutoff")
    gene_near = near.any(1)
    for label, i in (("outlier", 1), ("replaced", 4), ("cooks_outlier_refit", 5)):
        differ = got[i] != want[i]
        check(not bool((differ & ~gene_near).any()), f"cooks {name} refit: {label} differs on "
                                                      f"{int((differ & ~gene_near).sum())} genes away from the cutoff")
    log(f"  cooks {name} refit mode ({cargs[0].shape[0]}, {Nc}): exceed bits differ on {int(cell_differ.sum())} cells "
        f"({int(near.sum())} within {dtol} of the cutoff); replaced {int(got[4].sum())} (plain {int(want[4].sum())}), "
        f"refit flag {int(got[5].sum())} (plain {int(want[5].sum())})")
    if reps:
        timings["cooks_refit_ms"] = cuda_ms(lambda: ck._cooks_cuda(*cargs, repl, False), reps)

    # -- impute: the refit tile ------------------------------------------------
    # floor() is discontinuous: the kernel sums the trimmed mean in another
    # order than sort-then-mean, so a product trim02 * sf within an ulp of an
    # integer may floor one count apart. A differing cell is accepted only
    # where the plain product lies within 4 ulps of an integer, and by 1.
    tile, packed, repl_i, sf_i, mask = bound_args(rf.impute_outliers, *seen["impute_outliers"][:2])
    ik, nk = rf._impute_cuda(tile, packed, repl_i, sf_i, mask)
    ip, nplain = rf._impute_plain(tile, packed, repl_i, sf_i, mask)
    check(bits_equal(ik, seen["impute_outliers"][2][0]), f"impute {name}: the launch differs from the path's")
    prod = st._trimmed_mean_plain(tile / sf_i[None, :], rf.TRIM, 1)[:, None] * sf_i[None, :]
    ulp = (torch.nextafter(prod.abs(), torch.full_like(prod, math.inf)) - prod.abs())
    near_int = (prod - torch.round(prod)).abs() <= 4 * ulp
    differ = ik != ip
    bad = differ & ~(near_int & ((ik - ip).abs() == 1))
    check(not bool(bad.any()), f"impute {name}: {int(bad.sum())} cells differ beyond the floor rule")
    naz_differ = nk != nplain
    check(not bool((naz_differ & ~differ.any(1)).any()), f"impute {name}: new_all_zero differs on rows with equal cells")
    swapped = int((ck.unpack_bits(packed, tile.shape[1]) & torch.as_tensor(repl_i, device=tile.device)[None, :]
                   & mask[:, None]).sum())
    log(f"  impute {name} ({tile.shape[0]}, {tile.shape[1]}), {int(mask.sum())} rows in the tile, {swapped} cells "
        f"imputed: {int(differ.sum())} cells floor one count apart (plain product within 4 ulps of an integer); "
        f"new_all_zero {int(nk.sum())} (plain {int(nplain.sum())})")
    errs["impute"] = (ik - ip).abs().max().item()
    if reps:
        K, Ni = tile.shape
        timings["impute"] = {
            "ms": cuda_ms(lambda: rf._impute_cuda(tile, packed, repl_i, sf_i, mask), reps),
            "plain_ms": cuda_ms(lambda: rf._impute_plain(tile, packed, repl_i, sf_i, mask), reps),
            "library_ms": None,
            # reads the tile, its words, sf, the replaceable mask and the tile
            # mask; writes the imputed tile and the flags
            "bytes": isz * (2 * K * Ni + Ni) + 4 * K * packed.shape[1] + Ni + 2 * K,
            # per cell: y / sf, its place in the row's order (log2 N compares)
            # and the trimmed sum's add, then unpack (2), test, product, floor,
            # select and the zero test
            "ops": K * Ni * (2 + math.ceil(math.log2(Ni)) + 7),
        }
    return errs, seen["stream"]


def stream_path(reps: int, G: int, N: int, label: str, zero_inflated: bool = False):
    """Phases 3e, 3f and 3i: ``run_summary_streamed(refit_cooks=True)``
    through the public entry point, float32, on ``make_data(N, G)`` with a
    planted outlier in every OUTLIER_EVERY-th gene, the counts already on
    the card: warm wall (best of ``reps``), genes/s, gene blocks, the refit
    tile K, the genes replaced and refitted, and the launches of one run
    (each of STREAM_KERNELS must be > 0). ``zero_inflated`` then sets one
    zero in every gene (``synthetic.zero_per_gene``; the planted outlier of
    a gene whose zero falls on it is lost): each run must warn and switch to
    the iterative size factors, whose kernels must launch, every size factor
    must be finite, and the iterative rounds are reported."""
    import warnings

    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused_stream, kernels
    from pydeseq2_tpu_torch.synthetic import make_data, zero_per_gene

    t0 = time.perf_counter()
    counts_np, X_np = make_data(N, G)
    counts = plant_outliers(counts_np.T)
    if zero_inflated:
        counts = zero_per_gene(counts)
    del counts_np
    kw = stream_kwargs(counts, X_np, torch.float32, DEVICE)
    gen_s = time.perf_counter() - t0
    n_iters = []
    iterative = fused_stream.iterative_size_factors

    def recorded(*args, **kwargs):
        out = iterative(*args, **kwargs)
        n_iters.append(out[1])
        return out

    fused_stream.iterative_size_factors = recorded
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = pt.run_summary_streamed(**kw)  # warm-up
            torch.cuda.synchronize()
            walls = []
            launches = None
            for i in range(reps):
                if i == 0:
                    kernels.STATS.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = pt.run_summary_streamed(**kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if i == 0:
                    launches = dict(kernels.STATS.launches)
    finally:
        fused_stream.iterative_size_factors = iterative
    switched = sum("Switching to iterative mode" in str(w.message) for w in caught)
    must = STREAM_KERNELS + (("sf_nll", "sf_newton") if zero_inflated else ())
    for name in must:
        check(launches[name] > 0, f"kernel {name} was not launched on the streamed refit path ({label})")
    if zero_inflated:
        check(switched == reps + 1 and len(n_iters) == reps + 1,
              f"{label}: {switched} iterative-mode warnings and {len(n_iters)} iterative fits in {reps + 1} runs")
        check(bool(np.isfinite(res["size_factors"]).all()), f"{label}: a size factor is not finite")
    else:
        check(switched == 0 and not n_iters, f"{label}: switched to iterative size factors")
    padj = res["padj"]
    check(padj.shape == (G,) and padj.dtype == np.float64 and res["lfc"].shape == (G, 2), f"{label}: output shapes")
    fin = np.isfinite(padj)
    check(fin.mean() > 0.5, f"{label}: only {fin.mean():.4f} of padj are finite")
    check(np.all((padj[fin] >= 0) & (padj[fin] <= 1)), f"{label}: padj outside [0, 1]")
    check(not np.any(np.isnan(res["p_values"]) & fin), f"{label}: a gene without a p-value has a padj")
    n_rep, n_refit = int(res["replaced"].sum()), int(res["refitted"].sum())
    planted = np.arange(0, G, OUTLIER_EVERY)
    planted_share = float(res["replaced"][planted].mean())
    check(n_refit > 0 and planted_share > 0.9, f"{label}: {n_refit} genes refitted, planted replaced {planted_share}")
    block = fused_stream._refit_block_size(N)
    K = math.ceil(n_rep / block) * block
    B = res["gene_block"]
    best = min(walls)
    log(f"  data {gen_s:.1f} s; wall (warm) {[round(w, 4) for w in walls]} s, best {best:.4f} s, {G / best:.1f} genes/s; "
        f"gene_block {B} ({-(-G // B)} blocks)")
    log(f"  replaced {n_rep} (planted genes {planted_share:.4f}), refitted {n_refit}, new all-zero "
        f"{int(res['new_all_zeroes'].sum())}, refit tile K {K} ({K // block} block of {block}); cooks outliers "
        f"{int(res['cooks_outlier'].sum())}, finite padj {fin.mean():.5f}, padj < 0.05: {int((padj < 0.05).sum())}, "
        f"rescue_overflow {int(res['rescue_overflow'])}")
    if zero_inflated:
        sf = res["size_factors"]
        log(f"  iterative size factors: rounds per run {n_iters}, size factors in [{sf.min():.4f}, {sf.max():.4f}]")
    log(f"  launches in one run {launches}")
    out = {"shape": [N, G], "walls_s": walls, "best_s": best, "genes_per_s": G / best, "gene_block": B,
           "refit_tile": K, "replaced": n_rep, "refitted": n_refit, "launches": launches,
           "finite_padj": float(fin.mean())}
    if zero_inflated:
        out["n_iters"] = n_iters[1]
    return out


def stream_card_vs_cpu() -> None:
    """Phase 4d: the float64 streamed refit on the card against the CPU
    plain path at 100 x 2000 with planted outliers: the same genes
    replaced, refitted and left all zero, the same Cook's outliers, and
    every float output (padj included) at rtol 1e-6 with identical NaN
    masks (:func:`compare_outputs`)."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_CPU_CMP, seed=1)
    counts = plant_outliers(counts_np.T)
    gpu = pt.run_summary_streamed(**stream_kwargs(counts, X_np, torch.float64, DEVICE))
    cpu = pt.run_summary_streamed(**stream_kwargs(counts, X_np, torch.float64, "cpu"))
    check(gpu.pop("gene_block") == cpu.pop("gene_block"), "stream card vs CPU: gene_block differs")
    for k in ("replaced", "refitted", "new_all_zeroes", "cooks_outlier"):
        check(np.array_equal(gpu[k], cpu[k]), f"stream card vs CPU: {k} differs")
    check(int(gpu["refitted"].sum()) > 0, "stream card vs CPU: no gene was refitted")
    compare_outputs("stream refit f64", gpu, cpu)
    log(f"    replaced {int(gpu['replaced'].sum())}, refitted {int(gpu['refitted'].sum())}, cooks outliers "
        f"{int(gpu['cooks_outlier'].sum())}, padj < 0.05: {int(np.nansum(gpu['padj'] < 0.05))}")


def sf_kernel_checks(dtype, G, N, reps, timings):
    """Phase 2, the iterative size factors' kernels: ``sf_nll`` and
    ``sf_newton`` against their plain versions on the operands that the
    first trimmed solve of one zero-inflated
    ``run_summary_streamed(refit_cooks=True)`` run of ``make_data(N, G)``
    hands them, then the whole solve (6 rounds of both) by each route.
    Returns {name: max_abs_err} and fills ``timings`` (``reps`` > 0)."""
    import warnings

    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.ops import sizefactors as sz
    from pydeseq2_tpu_torch.synthetic import make_data, zero_per_gene

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    counts_np, X_np = make_data(N, G)
    kw = stream_kwargs(zero_per_gene(plant_outliers(counts_np.T)), X_np, dtype, DEVICE)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the switch to iterative mode; phase 3i checks it
        seen = capture([(sz, ("trimmed_sf_newton",))], pt.run_summary_streamed, "stream", kw)
    check("trimmed_sf_newton" in seen, f"sizefactors {name}: the run made no trimmed solve")
    c, coef, disp, s0, quant, mask, min_mu, outer, inner, gb = bound_args(sz.trimmed_sf_newton,
                                                                         *seen["trimmed_sf_newton"][:2])
    sf0, inv_sf0 = torch.exp(s0), torch.exp(-s0)
    eps = torch.finfo(dtype).eps
    errs = {}

    # -- sf_nll: the per-gene NLL at the solve's start ---------------------------
    # Both compute each cell with the same expressions and the card's libm and
    # sum in float64: the rounded totals agree to a few ulps (tolerance 8 eps,
    # relative), +inf exactly off the mask.
    nk = sz._sf_nll_cuda(c, coef, sf0, inv_sf0, s0, disp, mask, min_mu)
    npl = sz._sf_nll_plain(c, coef, sf0, inv_sf0, s0, disp, mask, min_mu)
    check(torch.equal(torch.isinf(nk), ~mask) and torch.equal(torch.isinf(npl), ~mask),
          f"sf_nll {name}: +inf lanes are not the lanes off the mask")
    e_nll = ((nk[mask] - npl[mask]).abs() / npl[mask].abs().clamp(min=1.0)).max().item()
    same = (nk[mask] == npl[mask]).double().mean().item()
    check(e_nll <= 8 * eps, f"sf_nll {name}: rel err {e_nll:.3g} > {8 * eps:.3g}")
    errs["sf_nll"] = (nk[mask] - npl[mask]).abs().max().item()

    # The keep sets of the two NLLs: equal, but for a gene whose plain NLL
    # lies within 8 eps (relative) of the plain quantile (a rounding tie).
    def differ_off_ties(kk, kp, nll_p):
        q = sz.trim_quantile(nll_p, mask, quant)
        near = (nll_p - q).abs() <= 8 * eps * q.abs()
        return int((kk != kp).sum()), int(((kk != kp) & ~near).sum())

    kk, kp = sz.keep_mask(nk, mask, quant), sz.keep_mask(npl, mask, quant)
    n_diff, n_bad = differ_off_ties(kk, kp, npl)
    check(n_bad == 0, f"sf_nll {name}: keep sets differ on {n_bad} genes away from the quantile")
    log(f"  sf_nll {name} ({c.shape[0]}, {c.shape[1]}), {int(mask.sum())} genes on the mask: rel err {e_nll:.3g} "
        f"(tol {8 * eps:.3g}), bit-equal on {same:.5f}; keep {int(kp.sum())}, sets differ on {n_diff} (ties)")

    # -- sf_newton: one round's Newton steps from the plain keep set -------------
    # Identical terms summed in float64 and rounded: 1e-5 (f32) / 1e-12 (f64).
    sk = sz._sf_newton_cuda(c, coef, sf0, inv_sf0, s0, disp, kp, min_mu, inner)
    sp = sz._sf_newton_plain(c, coef, sf0, inv_sf0, s0, disp, kp, min_mu, inner)
    stol = 1e-5 if f32 else 1e-12
    e_s = (sk - sp).abs().max().item()
    check(e_s <= stol, f"sf_newton {name}: {inner} steps, log size factor err {e_s:.3g} > {stol}")
    errs["sf_newton"] = e_s

    # -- the whole solve by each route ---------------------------------------------
    def route(fns, rounds):
        return sz._trimmed_sf_newton(c, coef, disp, s0, mask, quant, min_mu, rounds, inner, gb, *fns)

    cuda_fns, plain_fns = (sz._sf_nll_cuda, sz._sf_newton_cuda), (sz._sf_nll_plain, sz._sf_newton_plain)
    rk, rp = route(cuda_fns, outer), route(plain_fns, outer)
    path_s, path_keep = seen["trimmed_sf_newton"][2]
    check(bits_equal(rk[0], path_s) and torch.equal(rk[1], path_keep), f"sizefactors {name}: the path's solve "
                                                                        "does not repeat")
    last_p = sz._sf_nll_plain(c, coef, sf0, inv_sf0, route(plain_fns, outer - 1)[0], disp, mask, min_mu)
    n_diff, n_bad = differ_off_ties(rk[1], rp[1], last_p)
    check(n_bad == 0, f"sizefactors {name}: final keep sets differ on {n_bad} genes away from the quantile")
    e_solve = (rk[0] - rp[0]).abs().max().item()
    check(e_solve <= stol, f"sizefactors {name}: solve err {e_solve:.3g} > {stol}")
    log(f"  sf_newton {name}: {inner} steps err {e_s:.3g} (tol {stol}); whole solve ({outer} rounds) err "
        f"{e_solve:.3g}, final keep {int(rk[1].sum())} (plain {int(rp[1].sum())}), sets differ on {n_diff} (ties)")
    if reps:
        isz = c.element_size()
        Gs, Ns = c.shape
        on = mask.sum().item()
        n_plain = (mask & (1.0 / disp < 8.0)).sum().item()
        timings["sf_nll"] = {
            "ms": cuda_ms(lambda: sz._sf_nll_cuda(c, coef, sf0, inv_sf0, s0, disp, mask, min_mu), reps),
            "plain_ms": cuda_ms(lambda: sz._sf_nll_plain(c, coef, sf0, inv_sf0, s0, disp, mask, min_mu), reps),
            "library_ms": None,
            # reads counts, coef, disp, sf0, inv_sf0, s and the mask; writes the NLL
            "bytes": isz * (Gs * Ns + 3 * Gs + 3 * Ns) + Gs,
            # per cell of a gene on the mask: mu 5 (two products, max, exp,
            # product), y log mu 3, lgamma(y + 1) 2, the float64 add 2, and
            # the plain form 14 (r < 8) or the Stirling-difference form 25
            "ops": Ns * (n_plain * (12 + 14) + (on - n_plain) * (12 + 25)),
        }
        n_keep = kp.sum().item()
        timings["sf_newton"] = {
            "ms": cuda_ms(lambda: sz._sf_newton_cuda(c, coef, sf0, inv_sf0, s0, disp, kp, min_mu, inner), reps),
            "plain_ms": cuda_ms(lambda: sz._sf_newton_plain(c, coef, sf0, inv_sf0, s0, disp, kp, min_mu, inner),
                                reps),
            "library_ms": None,
            # reads counts, coef, disp, the keep set, sf0, inv_sf0, s; writes s
            "bytes": isz * (Gs * Ns + 2 * Gs + 4 * Ns) + Gs,
            # per step and cell of a kept gene: 1 / disp, mu 5, w 3, g 4 and h
            # 6 (with their float64 converts and adds)
            "ops": inner * Ns * n_keep * 19,
            "steps": inner,
        }
    return errs


def vst_kernel_checks(dtype, G, N, reps, timings):
    """Phase 2, the blind VST: ``vst`` against its plain version on the
    operands one ``vst_pipeline`` run of ``make_data(N, G)`` hands it
    (parametric as run, with the ``used_mean`` flag forced each way, and the
    mean form), every 7th gene masked out; and ``mom``, ``disp_scan``,
    ``disp_newton`` and ``trend`` at P = 1 on that run's blind-design
    operands. Returns {name: max_abs_err} and fills ``timings``."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused
    from pydeseq2_tpu_torch.ops import dispersion as dsp
    from pydeseq2_tpu_torch.ops import vst as vs
    from pydeseq2_tpu_torch.synthetic import make_data

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    counts = torch.as_tensor(make_data(N, G)[0].T.copy(), dtype=dtype, device=DEVICE)
    seen = capture([(fused, ("vst_transform", "mom_and_mu_coef", "parametric_trend")),
                    (dsp, ("scan_coarse", "newton_polish"))],
                   pt.vst_pipeline, "vst", dict(counts=counts, max_disp=float(max(10, N)), device=DEVICE))
    for key in ("vst_transform", "mom_and_mu_coef", "parametric_trend", "scan_coarse", "newton_polish"):
        check(key in seen, f"vst {name}: the run made no call of {key}")
    check(seen["mom_and_mu_coef"][0][2].shape[1] == 1, f"vst {name}: the design is not intercept-only")
    mom_check(f"{name} P=1", seen["mom_and_mu_coef"])
    scan_check(f"{name} P=1", bound_args(dsp.scan_coarse, *seen["scan_coarse"][:2]))
    newton_check(f"{name} P=1", bound_args(dsp.newton_polish, *seen["newton_polish"][:2]))
    trend_check(f"{name} blind", seen["parametric_trend"])

    c, sf, coeffs, used_mean, mean_disp, gmask, trend_type = bound_args(vs.vst_transform, *seen["vst_transform"][:2])
    check(trend_type == "parametric", f"vst {name}: the run's trend is {trend_type}")
    check(bits_equal(vs._vst_cuda(c, sf, coeffs, used_mean, mean_disp, gmask, False), seen["vst_transform"][2]),
          f"vst {name}: the launch differs from the path's")
    # Tolerance: the same expressions with the card's libm (log, sqrt,
    # asinh) on each side, so a few ulps at most: 1e-6 (f32) / 1e-13 (f64),
    # relative (absolute below 1), and NaN on the same rows.
    vtol = 1e-6 if f32 else 1e-13
    masked = gmask & (torch.arange(c.shape[0], device=c.device) % 7 != 0)
    flag = {v: torch.tensor(v, device=c.device) for v in (False, True)}
    worst = {}
    errs_v = 0.0
    for label, fl, mean_only in (("parametric", flag[False], False), ("used_mean", flag[True], False),
                                 ("mean", None, True)):
        got = vs._vst_cuda(c, sf, coeffs, fl, mean_disp, masked, mean_only)
        want = vs._vst_plain(c, sf, coeffs, fl, mean_disp, masked, mean_only)
        check(bool(torch.isnan(got).all(1).eq(~masked).all()), f"vst {name} {label}: NaN rows are not the masked ones")
        worst[label] = scaled_err(got, want)
        errs_v = max(errs_v, (got - want).nan_to_num(0.0).abs().max().item())
    check(all(v <= vtol for v in worst.values()), f"vst {name}: errors {worst} beyond {vtol}")
    log(f"  vst {name} ({c.shape[0]}, {c.shape[1]}), every 7th gene masked: rel err (abs below 1) "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {vtol}); the run's used_mean "
        f"{bool(used_mean)}")
    if reps:
        isz = c.element_size()
        Gv, Nv = c.shape
        timings["vst"] = {
            "ms": cuda_ms(lambda: vs._vst_cuda(c, sf, coeffs, used_mean, mean_disp, gmask, False), reps),
            "plain_ms": cuda_ms(lambda: vs._vst_plain(c, sf, coeffs, used_mean, mean_disp, gmask, False), reps),
            "library_ms": None,
            # reads counts and sf once, the mask, coefficients, flag and mean
            # dispersion; writes the (G, N) result
            "bytes": isz * (2 * Gv * Nv + Nv + 3) + Gv + 1,
            # per cell: y / sf, then the closed form: 6 products and sums, sqrt,
            # 2 sums, the divide by 4 a0, log and the divide by log 2
            "ops": Gv * Nv * 13,
        }
    return {"vst": errs_v}


def vst_path(reps: int):
    """Phase 3g: ``vst_pipeline`` through its public entry point at 100 x
    60000 float32, the counts on the card: warm wall (best of ``reps``),
    genes/s and the launches of one run (each of VST_KERNELS must be > 0);
    the result must be finite, of shape (G, N), on the parametric trend."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.synthetic import make_data

    counts = torch.as_tensor(make_data(N_MAIN, G_MAIN)[0].T.copy(), dtype=torch.float32, device=DEVICE)
    kw = dict(counts=counts, max_disp=float(max(10, N_MAIN)), device=DEVICE)
    out = pt.vst_pipeline(**kw)  # warm-up
    torch.cuda.synchronize()
    walls = []
    launches = None
    for i in range(reps):
        if i == 0:
            kernels.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pt.vst_pipeline(**kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
    for name in VST_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the VST path")
    v = out["vst_counts"]
    check(v.shape == (G_MAIN, N_MAIN) and v.dtype == torch.float32, "vst_pipeline: output shape")
    check(bool(torch.isfinite(v).all()), "vst_pipeline: a VST value is not finite")
    check(not bool(out["trend_used_mean"]), "vst_pipeline: the parametric trend fell back to the mean")
    best = min(walls)
    log(f"  wall (warm) {[round(w, 4) for w in walls]} s, best {best:.4f} s, {G_MAIN / best:.1f} genes/s; VST in "
        f"[{float(v.min()):.3f}, {float(v.max()):.3f}], trend coeffs {out['trend_coeffs'].tolist()}")
    log(f"  launches in one run {launches}")
    return {"walls_s": walls, "best_s": best, "genes_per_s": G_MAIN / best, "launches": launches}


def vst_stream_path(reps: int, G: int, N: int):
    """Phase 3h: ``run_vst_streamed`` through its public entry point,
    float32, the counts on the card: warm wall (best of ``reps``), genes/s,
    the gene blocks and the launches of one run (each of VST_KERNELS must be
    > 0); the result must be finite and of shape (G, N)."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.synthetic import make_data

    counts = torch.as_tensor(make_data(N, G)[0].T.copy(), dtype=torch.float32, device=DEVICE)
    kw = dict(counts=counts, dtype=torch.float32, max_disp=float(max(10, N)), device=DEVICE)
    res = pt.run_vst_streamed(**kw)  # warm-up
    walls = []
    launches = None
    for i in range(reps):
        if i == 0:
            kernels.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.run_vst_streamed(**kw)
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
    for name in VST_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the streamed VST path")
    v = res["vst_counts"]
    check(v.shape == (G, N) and v.dtype == np.float32, "run_vst_streamed: output shape")
    check(bool(np.isfinite(v).all()), "run_vst_streamed: a VST value is not finite")
    B = res["gene_block"]
    best = min(walls)
    log(f"  wall (warm, to numpy on the host) {[round(w, 4) for w in walls]} s, best {best:.4f} s, "
        f"{G / best:.1f} genes/s; gene_block {B} ({-(-G // B)} blocks)")
    log(f"  launches in one run {launches}")
    return {"shape": [N, G], "walls_s": walls, "best_s": best, "genes_per_s": G / best, "gene_block": B,
            "launches": launches}


def sf_vst_card_vs_cpu() -> None:
    """Phase 4e: float64 on the card against the CPU plain path at 100 x
    2000: the iterative size factors of the zero-inflated draw, whole-G and
    over gene blocks of 512 (the same rounds, rtol 1e-6); the zero-inflated
    ``run_summary_streamed(refit_cooks=True)`` with planted outliers (the
    same flags, every float output at rtol 1e-6); ``vst_pipeline`` with both
    trend types and ``run_vst_streamed`` (rtol 1e-6, the same NaN masks)."""
    import warnings

    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.synthetic import make_data, zero_per_gene

    counts_np, X_np = make_data(N_MAIN, G_CPU_CMP, seed=1)
    counts = counts_np.T
    max_disp = float(max(10, N_MAIN))
    fits = {}
    for gb in (None, 512):
        for dev in (DEVICE, "cpu"):
            sf, n_it = pt.iterative_size_factors(zero_per_gene(counts), max_disp=max_disp, gene_block=gb, device=dev)
            fits[gb, dev] = (sf.cpu().numpy(), n_it)
        (a, ia), (b, ib) = fits[gb, DEVICE], fits[gb, "cpu"]
        check(ia == ib, f"iterative size factors gene_block={gb}: {ia} rounds on the card, {ib} on the CPU")
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        check(rel <= 1e-6, f"iterative size factors gene_block={gb}: card vs CPU rel {rel:.3g}")
        log(f"  iterative size factors f64 gene_block={gb}: {ia} rounds on both, max rel card vs CPU {rel:.2g}")
    rel = float(np.max(np.abs(fits[512, DEVICE][0] / fits[None, DEVICE][0] - 1.0)))
    check(fits[512, DEVICE][1] == fits[None, DEVICE][1] and rel <= 1e-12,
          f"iterative size factors: blocked vs whole-G on the card rel {rel:.3g}")

    zi = zero_per_gene(plant_outliers(counts))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the switch to iterative mode (phase 3i checks it)
        gpu = pt.run_summary_streamed(**stream_kwargs(zi, X_np, torch.float64, DEVICE))
        cpu = pt.run_summary_streamed(**stream_kwargs(zi, X_np, torch.float64, "cpu"))
    check(gpu.pop("gene_block") == cpu.pop("gene_block"), "zero-inflated stream card vs CPU: gene_block differs")
    for k in ("replaced", "refitted", "new_all_zeroes", "cooks_outlier"):
        check(np.array_equal(gpu[k], cpu[k]), f"zero-inflated stream card vs CPU: {k} differs")
    compare_outputs("zero-inflated stream refit f64", gpu, cpu)

    for trend_type in ("parametric", "mean"):
        gpu, cpu = (pt.outputs_to_numpy(pt.vst_pipeline(counts, trend_type=trend_type, max_disp=max_disp, device=dev))
                    for dev in (DEVICE, "cpu"))
        compare_outputs(f"vst_pipeline {trend_type} f64", gpu, cpu)
    gpu, cpu = (pt.run_vst_streamed(counts, dtype=torch.float64, max_disp=max_disp, device=dev)
                for dev in (DEVICE, "cpu"))
    check(gpu.pop("gene_block") == cpu.pop("gene_block"), "run_vst_streamed: gene_block differs")
    compare_outputs("run_vst_streamed f64", gpu, cpu)


# ------------------------------------------------------------- the class API
# The kernels the class API launches at 100 x 60000 (phase 3j): deseq2()
# (size-factor and MAD medians, MoM in its normed-count mode, the dispersion
# fits, the trend fit once per exclusion round, IRLS and the hat-only entry,
# the trimmed cell variances of Cook's), summary() (the Wald-only entry, the
# BH sweep, the lowess pick), lfc_shrink() and vst(). The rescue tiers
# launch only where a lane stays flagged after IRLS, grid_apeglm only where
# Newton fails: their counts are reported, not required.
CLASS_KERNELS = ("select", "mom", "disp_scan", "disp_newton", "trend_fit", "irls", "hat", "trimmed_var", "wald",
                 "bh", "lowess", "shrink", "vst")


def class_inputs(N: int, G: int, seed: int = 0):
    """``make_data(N, G)`` with an outlier planted in every OUTLIER_EVERY-th
    gene, as the class API takes it: ``(counts DataFrame (N, G) of ints,
    metadata with a condition column, design (N, 2), gene-major counts)``."""
    import pandas as pd

    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G, seed=seed)
    counts_gn = plant_outliers(counts_np.T)
    samples = [f"sample{i}" for i in range(N)]
    counts_df = pd.DataFrame(counts_gn.T.astype(np.int64), index=samples, columns=[f"gene{j}" for j in range(G)])
    metadata = pd.DataFrame({"condition": np.where(X_np[:, 1] > 0, "B", "A")}, index=samples)
    return counts_df, metadata, X_np, counts_gn


def class_deseq2(counts_df, metadata, dtype, device):
    """``DeseqDataSet(...)`` and ``deseq2()`` over ``TorchInference``, at the
    pipelines' beta_tol (1e-6 in float32, 1e-8 in float64), so that the
    class API and run_summary_streamed run the same stopping rule."""
    import pydeseq2_tpu_torch as pt

    dds = pt.DeseqDataSet(counts=counts_df, metadata=metadata, design="~condition", quiet=True,
                          beta_tol=1e-6 if dtype == torch.float32 else 1e-8,
                          inference=pt.TorchInference(dtype=dtype, device=device))
    dds.deseq2()
    return dds


def class_summary(dds):
    import pydeseq2_tpu_torch as pt

    ds = pt.DeseqStats(dds, contrast=["condition", "B", "A"], quiet=True)
    ds.summary()
    return ds


def capture_class_inputs(counts_df, metadata, dtype) -> dict:
    """Run deseq2() + summary() once and keep what the class API hands the
    new kernels' wrappers (the first call of each: the first exclusion
    round's trend fit, the main LFC fit's hat diagonals, the summary's Wald
    test, Cook's trimmed cell variances, the MoM fit in its normed-count
    mode), plus ``(dds, ds)`` under ``"class"``."""
    from pydeseq2_tpu_torch import torch_inference as ti
    from pydeseq2_tpu_torch.ops import stats as st

    def run():
        dds = class_deseq2(counts_df, metadata, dtype, DEVICE)
        return dds, class_summary(dds)

    targets = [(ti, ("gamma_glm_trend_fit", "hat_diagonals", "wald_test_batch", "mom_and_mu_coef")),
               (st, ("trimmed_cell_variance",))]
    return capture(targets, run, "class", {})


def trimmed_ops(members) -> int:
    """Operations per row that a trimmed variance needs, whatever way a
    kernel finds the order statistics: per cohort member the squared error
    (2) and two trimmed means, each ceil(log2 n) compares to place the
    member in the cohort's order (a comparison sort's share) and one add."""
    return sum(n * (2 + 2 * (math.ceil(math.log2(n)) + 1)) for n in members if n > 1)


def class_kernel_checks(dtype, G, N, reps, timings):
    """Phase 2, the class API's kernels: ``trend_fit``, ``trimmed_var``
    (cohorts of ~50; one column of the genewise dispersions, the mean
    trend's input), the ``hat`` and ``wald`` entries of hat_wald.cu and
    ``mom`` in its normed-count mode, each against its plain version on the
    operands one deseq2() + summary() run of ``make_data(N, G)`` with
    planted outliers hands it. Returns {name: max_abs_err} and fills
    ``timings`` (``reps`` > 0)."""
    from pydeseq2_tpu_torch.ops import irls as ir
    from pydeseq2_tpu_torch.ops import stats as st
    from pydeseq2_tpu_torch.ops import trend as tr
    from pydeseq2_tpu_torch.ops import wald as wd

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    counts_df, metadata, _, _ = class_inputs(N, G)
    seen = capture_class_inputs(counts_df, metadata, dtype)
    for key in ("gamma_glm_trend_fit", "hat_diagonals", "wald_test_batch", "mom_and_mu_coef",
                "trimmed_cell_variance"):
        check(key in seen, f"class {name}: the run made no call of {key}")
    dds, _ = seen["class"]
    errs = {}
    isz = torch.finfo(dtype).bits // 8

    # -- mom in its normed-count mode (fit_rough_dispersions) ----------------
    check(seen["mom_and_mu_coef"][1].get("normed") is True, f"class {name}: the MoM fit is not in normed mode")
    mom_check(f"{name} class API", seen["mom_and_mu_coef"])

    # -- trend_fit: the first exclusion round's fit ---------------------------
    # Coefficients and predictions within 1e-4 relative in f32, the same
    # converged flag: both sum every term in float64 in their own order and
    # round, as the trend kernel does (bit-equal in f32 on the class API's
    # inputs). In f64 the fit stops once a step gains less than 10 eps
    # (|f| + 1) of the loss, which it does anywhere within ~sqrt(10 eps)
    # ~ 5e-8 of the optimum, relative, so two sum orders stop up to that
    # far apart: 1e-7 there (4.75e-9 read on the H100). A fit that does not
    # converge (both flags False: the class API then falls back to the mean
    # trend) stops at its 60th iterate: 1e-6 there.
    cov, tar, valid = bound_args(tr.gamma_glm_trend_fit, *seen["gamma_glm_trend_fit"][:2])[:3]
    got = tr._trend_fit_cuda(cov, tar, valid, 60)
    want = tr._trend_fit_plain(cov, tar, valid, 60)
    check(bits_equal(got[0], seen["gamma_glm_trend_fit"][2][0]), f"trend_fit {name}: the launch differs from the path's")
    ctol = 1e-4 if f32 else (1e-7 if bool(want[2]) else 1e-6)
    e_c = rel_err(got[0].double(), want[0].double(), 1e-300)
    e_p = rel_err(got[1].double(), want[1].double(), 1e-300)
    check(bool(got[2]) == bool(want[2]), f"trend_fit {name}: converged {bool(got[2])}, plain {bool(want[2])}")
    check(e_c <= ctol and e_p <= ctol, f"trend_fit {name}: coefficient rel err {e_c:.3g}, predictions {e_p:.3g} > {ctol}")
    n_loss, n_grad = count_trend_passes(lambda: tr._trend_fit_plain(cov, tar, valid, 60))
    log(f"  trend_fit {name} (G {cov.shape[0]}, {int(valid.sum())} valid): coeffs {got[0].tolist()} (plain "
        f"{want[0].tolist()}), bit-equal {bits_equal(got[0], want[0])}, rel err {e_c:.3g}, predictions {e_p:.3g} "
        f"(tol {ctol}); converged {bool(got[2])}; plain passes: {n_loss} loss, {n_grad} gradient + Fisher")
    errs["trend_fit"] = (got[0] - want[0]).abs().max().item()
    if reps:
        Gt = cov.shape[0]
        timings["trend_fit"] = {
            "ms": cuda_ms(lambda: tr._trend_fit_cuda(cov, tar, valid, 60), reps),
            "plain_ms": cuda_ms(lambda: tr._trend_fit_plain(cov, tar, valid, 60), 2),
            "library_ms": None,
            # reads covariates, targets, the mask; writes predictions, the
            # coefficients and the flag
            "bytes": Gt * (3 * isz + 1) + 2 * isz + 1,
            # per valid gene: the loss pass ~6 operations, the gradient +
            # Fisher pass ~22; passes counted on the plain fit
            "ops": int(valid.sum()) * (6 * n_loss + 22 * n_grad),
        }

    # -- trimmed_var: Cook's cell variances, and a column of ~G --------------
    # Relative 1e-6 (f32) / 1e-12 (f64): both find the same kept multiset and
    # sum it in float64, rounding once; the plain sort path (n < 1024) and
    # the kernel's interior + boundary sum differ only by that sum's order,
    # so in float32 they agree to the bit but for rounding ties. The class
    # API hands the cell variances its float64 normalised counts whatever
    # the solvers' dtype; both are also run on a float32 copy here. The
    # column is the genewise dispersions over 10 min_disp (the mean trend's
    # input), in the solvers' dtype and in the other one.
    counts_nt, cells = bound_args(st.trimmed_cell_variance, *seen["trimmed_cell_variance"][:2])
    cohorts, bins = st._cohorts(cells)
    got = st._trimmed_cell_variance_cuda(counts_nt, cells)
    check(bits_equal(got, seen["trimmed_cell_variance"][2]), f"trimmed_var {name}: the launch differs from the path's")
    gd = dds.var["genewise_dispersions"].to_numpy()
    gd = gd[gd > 10 * dds.min_disp]
    for cdt in (torch.float64, torch.float32):
        x = counts_nt.to(cdt)
        got = st._trimmed_cell_variance_cuda(x, cells)
        want = st._trimmed_cell_variance_plain(x, cells)
        vtol = 1e-6 if cdt == torch.float32 else 1e-12
        e_v = rel_err(got.double(), want.double(), 1e-300)
        check(e_v <= vtol, f"trimmed_var {name} cells {cdt}: rel err {e_v:.3g} > {vtol}")
        column = torch.as_tensor(gd, dtype=cdt, device=DEVICE)
        got_c = st.trimmed_mean(column, 0.001)
        want_c = st._trimmed_mean_plain(column, 0.001, 0)
        e_m = rel_err(got_c.double().reshape(1), want_c.double().reshape(1), 1e-300)
        check(e_m <= vtol, f"trimmed_var {name} column {cdt}: rel err {e_m:.3g} > {vtol}")
        log(f"  trimmed_var {name} run, {cdt} operands: cell variances ({x.shape[1]} genes, cohorts of "
            f"{[len(c) for c in cohorts]}) rel err {e_v:.3g}, {int((got != want).sum())} not bit-equal; column of "
            f"{column.shape[0]} (trim 0.001, one block) {got_c.item()!r} (plain {want_c.item()!r}), rel err {e_m:.3g} "
            f"(tol {vtol})")
        if cdt == dtype:
            errs["trimmed_var"] = (got - want).abs().max().item()
    if reps:
        Gv, Nv = counts_nt.shape[1], counts_nt.shape[0]
        members = [len(c) for c in cohorts]
        column = torch.as_tensor(gd, dtype=dtype, device=DEVICE)
        vsz = counts_nt.element_size()  # the class API's float64 normalised counts
        timings["trimmed_var"] = {
            "ms": cuda_ms(lambda: st._trimmed_cell_variance_cuda(counts_nt, cells), reps),
            "plain_ms": cuda_ms(lambda: st._trimmed_cell_variance_plain(counts_nt, cells), reps),
            "library_ms": None,
            "column_ms": cuda_ms(lambda: st.trimmed_mean(column, 0.001), reps),
            # reads the (G, N) normalised counts once, writes one value a gene
            "bytes": vsz * (Gv * Nv + Gv),
            "ops": Gv * trimmed_ops(members),
            "ops_per_s": F64_OPS_PER_S if vsz == 8 else F32_OPS_PER_S,
        }

    # -- hat: the hat-only entry (fit_LFC) -------------------------------------
    # The hat_wald tolerances: 1e-4 (f32) / 1e-10 (f64) relative on H (absolute
    # below 1e-2) and mu.
    _, sf, X, disp, beta, min_mu = bound_args(ir.hat_diagonals, *seen["hat_diagonals"][:2])
    got = ir._hat_cuda(sf, X, disp, beta, min_mu)
    want = ir._hat_plain(sf, X, disp, beta, min_mu)
    check(bits_equal(got[0], seen["hat_diagonals"][2][0]), f"hat {name}: the launch differs from the path's")
    rtol = 1e-4 if f32 else 1e-10
    e_h = rel_err(got[0].double(), want[0].double(), 1e-2)
    e_mu = rel_err(got[1].double(), want[1].double(), 1e-300)
    check(e_h <= rtol and e_mu <= rtol, f"hat {name}: rel err H {e_h:.3g}, mu {e_mu:.3g} > {rtol}")
    log(f"  hat {name} ({beta.shape[0]}, {X.shape[0]}): rel err H {e_h:.3g}, mu {e_mu:.3g} (tol {rtol})")
    errs["hat"] = (got[0] - want[0]).abs().max().item()
    P = X.shape[1]
    ntri = P * (P + 1) // 2
    if reps:
        Gh, Nh = beta.shape[0], X.shape[0]
        timings["hat"] = {
            "ms": cuda_ms(lambda: ir._hat_cuda(sf, X, disp, beta, min_mu), reps),
            "plain_ms": cuda_ms(lambda: ir._hat_plain(sf, X, disp, beta, min_mu), reps),
            "library_ms": None,
            # reads beta, disp, sf, X; writes H and mu
            "bytes": isz * (Gh * (P + 1) + Nh * (P + 1) + 2 * Gh * Nh),
            # per (gene, sample): pass 1 linear predictor, exp, clamp, weight,
            # the thresholded Gram triangle; pass 2 the same predictor and
            # weight, x^T M^-1 x and H
            "ops": Gh * Nh * ((2 * P + 6 + 3 * ntri) + (2 * P + 7 + 2 * P * P + 2 * P)),
        }

    # -- wald: the Wald-only entry (summary), the caller's mu and ridge -------
    # The hat_wald tolerances on p (log p scaled by 1 + stat^2), stat and se;
    # every alternative in f64, and a prior-LFC ridge diag(1 / v^2).
    wargs = bound_args(wd.wald_test_batch, *seen["wald_test_batch"][:2])
    got = wd._wald_cuda(*wargs)
    check(bits_equal(got[0], seen["wald_test_batch"][2][0]), f"wald {name}: the launch differs from the path's")
    X_w, disp_w, lfc_w, mu_w, ridge_w, contrast_w, null_w, alt_w = wargs
    cases = [("run", ridge_w, null_w, alt_w)]
    if not f32:
        prior = torch.diag(1.0 / torch.tensor([3.0, 0.7], dtype=dtype, device=DEVICE) ** 2)
        cases += [(alt, prior, 0.3, alt) for alt in ("greaterAbs", "lessAbs", "greater", "less")]
    worst = {}
    for label, ridge, null, alt in cases:
        args = (X_w, disp_w, lfc_w, mu_w, ridge, contrast_w, null, alt)
        got, want = wd._wald_cuda(*args), wd._wald_plain(*args)
        tiny = 1e-30 if f32 else 1e-300
        p_k, p_p = got[0], want[0]
        check(torch.equal(torch.isnan(p_k), torch.isnan(p_p)), f"wald {name} {label}: p NaN masks differ")
        big = p_p >= tiny
        check(bool((p_k[~big & ~torch.isnan(p_p)] < 1e3 * tiny).all()), f"wald {name} {label}: p tail")
        scale = 1.0 + want[1][big].double().square()
        e_p = ((p_k[big].double().log() - p_p[big].double().log()).abs() / scale).max().item() if bool(big.any()) else 0.0
        e_s = rel_err(got[1].double(), want[1].double(), 1e-3)
        e_se = rel_err(got[2].double(), want[2].double(), 1e-300)
        for key, e in (("p", e_p), ("stat", e_s), ("se", e_se)):
            worst[key] = max(worst.get(key, 0.0), e)
            check(e <= rtol, f"wald {name} {label} {key}: rel err {e:.3g} > {rtol}")
    log(f"  wald {name}: cases {[c[0] for c in cases]}, max rel err " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (tol {rtol})")
    got, want = wd._wald_cuda(*wargs), wd._wald_plain(*wargs)
    errs["wald"] = (got[2] - want[2]).nan_to_num(0.0).abs().max().item()
    if reps:
        Gw, Nw = mu_w.shape
        timings["wald"] = {
            "ms": cuda_ms(lambda: wd._wald_cuda(*wargs), reps),
            "plain_ms": cuda_ms(lambda: wd._wald_plain(*wargs), reps),
            "library_ms": None,
            # reads mu (G N), lfc, disp, X, ridge, contrast; writes p, stat, se
            "bytes": isz * (Gw * Nw + Gw * (P + 1) + Nw * P + P * P + P + 3 * Gw),
            # per (gene, sample): the weight (3) and the Gram triangle (3 a term)
            "ops": Gw * Nw * (3 + 3 * ntri),
        }
    return errs


def profiled_d2h(fn) -> dict:
    """One torch.profiler trace of ``fn``: the device-to-host copies it
    makes (count and bytes; bytes None where the trace has copies without
    byte counts), the device's busy time in kernels and copies, and the
    host wall of the traced call (the profiler's own cost included)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = Path(__file__).resolve().parent / "build" / "class_api_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text()).get("traceEvents", []) if e.get("ph") == "X"]
    copies = [e for e in events if "DtoH" in str(e.get("name", "")) and "memcpy" in str(e.get("cat", "")).lower()]
    sizes = [e.get("args", {}).get("bytes") for e in copies]
    device = [e for e in events if str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset")]
    return {"d2h_bytes": int(sum(sizes)) if copies and None not in sizes else None, "d2h_copies": len(copies),
            "device_busy_ms": sum(float(e.get("dur", 0.0)) for e in device) / 1e3,
            "kernels": sum(str(e.get("cat", "")).lower() == "kernel" for e in device), "traced_wall_ms": wall * 1e3}


def class_stage_walls(counts_df, metadata, dtype) -> dict:
    """Host wall (synchronised) of each top-level stage that deseq2() calls,
    in ms, on one more run: where the class API's wall goes."""
    import pydeseq2_tpu_torch as pt

    stages = ("fit_size_factors", "fit_genewise_dispersions", "fit_dispersion_trend", "fit_dispersion_prior",
              "fit_MAP_dispersions", "fit_LFC", "calculate_cooks", "refit", "cooks_outlier")
    walls: dict = {}
    depth = [0]
    originals = {s: getattr(pt.DeseqDataSet, s) for s in stages}

    def timed(name, fn):
        def run(self, *args, **kwargs):
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                depth[0] -= 1
                if depth[0] == 0:
                    walls[name] = walls.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

        return run

    try:
        for s, fn in originals.items():
            setattr(pt.DeseqDataSet, s, timed(s, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_deseq2(counts_df, metadata, dtype, DEVICE)
        torch.cuda.synchronize()
        walls["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        for s, fn in originals.items():
            setattr(pt.DeseqDataSet, s, fn)
    return walls


def class_path(reps: int):
    """Phase 3j: the class API at 100 x 60000 float32 on the card through
    its public steps, an outlier planted in every OUTLIER_EVERY-th gene:
    ``DeseqDataSet(...).deseq2()``, ``DeseqStats(...).summary()``,
    ``lfc_shrink()`` and ``vst()``. Warm wall of each step (best of
    ``reps``), peak device memory, the device-to-host bytes of deseq2()
    (torch.profiler), the launches of one run (each of CLASS_KERNELS must be
    > 0), and ``results_df`` held against ``run_summary_streamed(
    refit_cooks=True)`` on the same counts on the card."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels

    counts_df, metadata, X_np, counts_gn = class_inputs(N_MAIN, G_MAIN)
    dtype = torch.float32
    steps = ("deseq2", "summary", "lfc_shrink", "vst")

    def run():
        t = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dds = class_deseq2(counts_df, metadata, dtype, DEVICE)
        torch.cuda.synchronize()
        t["deseq2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = class_summary(dds)
        t["summary"] = time.perf_counter() - t0
        results = ds.results_df.copy()
        t0 = time.perf_counter()
        ds.lfc_shrink("condition[T.B]")
        torch.cuda.synchronize()
        t["lfc_shrink"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dds.vst()
        torch.cuda.synchronize()
        t["vst"] = time.perf_counter() - t0
        return dds, ds, results, t

    run()  # warm-up
    walls = {s: [] for s in steps}
    launches = None
    peak = None
    for i in range(reps):
        if i == 0:
            kernels.STATS.reset()
            torch.cuda.reset_peak_memory_stats()
        dds, ds, results, t = run()
        if i == 0:
            launches = dict(kernels.STATS.launches)
            peak = torch.cuda.max_memory_allocated()
        for s in steps:
            walls[s].append(t[s])
    for k in CLASS_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the class API path")
    trace = profiled_d2h(lambda: class_deseq2(counts_df, metadata, dtype, DEVICE))
    stage_ms = class_stage_walls(counts_df, metadata, dtype)

    # -- outputs: finite, shaped, and the streamed refit's ---------------------
    G = G_MAIN
    padj = results["padj"].to_numpy()
    check(results.shape == (G, 6) and padj.dtype == np.float64, "phase 3j: results_df shape")
    fin = np.isfinite(padj)
    check(fin.mean() > 0.5 and np.all((padj[fin] >= 0) & (padj[fin] <= 1)), "phase 3j: padj")
    vst = dds.layers["vst_counts"]
    check(vst.shape == (N_MAIN, G) and bool(np.isfinite(vst).all()), "phase 3j: vst_counts")
    check(bool(np.isfinite(ds.results_df["log2FoldChange"].to_numpy()[fin]).all()), "phase 3j: shrunk LFCs")
    stream = pt.run_summary_streamed(**stream_kwargs(counts_gn, X_np, dtype, DEVICE))
    refit_c = dds.var["refitted"].to_numpy()
    refit_s = stream["refitted"]
    n_refit = int(refit_c.sum())
    check(n_refit > 0, "phase 3j: no gene was refitted")
    # Tie rule: a gene whose largest Cook's distance lies within 1e-4 relative
    # of the cutoff may be replaced by one path and not the other (the class
    # API forms the distances from float64 normalised counts, the streamed
    # path in float32).
    cooks = dds.layers["cooks"]
    cutoff = dds._cooks_cutoff()
    near = (np.abs(np.nan_to_num(cooks, nan=-1.0) - cutoff) <= 1e-4 * cutoff).any(axis=0)
    differ = refit_c != refit_s
    check(not bool((differ & ~near).any()), f"phase 3j: refitted sets differ on {int((differ & ~near).sum())} genes "
                                              "away from the cutoff")
    same = ~differ
    ln2 = math.log(2.0)
    lfc_c, lfc_s = results["log2FoldChange"].to_numpy(), stream["lfc"][:, 1] / ln2
    p_c, p_s = results["padj"].to_numpy(), stream["padj"]
    gaps = {}
    m = same & np.isfinite(lfc_c) & np.isfinite(lfc_s)
    gaps["lfc_abs"] = float(np.max(np.abs(lfc_c[m] - lfc_s[m])))
    m2 = same & np.isfinite(p_c) & np.isfinite(p_s)
    gaps["padj_rel_p99"] = float(np.quantile(np.abs(p_c[m2] - p_s[m2]) / np.maximum(p_s[m2], 1e-12), 0.99))
    gaps["padj_rel_max"] = float(np.max(np.abs(p_c[m2] - p_s[m2]) / np.maximum(p_s[m2], 1e-12)))
    gaps["call_agreement"] = float(np.mean((p_c[m2] < 0.05) == (p_s[m2] < 0.05)))
    gaps["nan_mask_agreement"] = float(np.mean(np.isnan(p_c) == np.isnan(p_s)))
    log(f"  class API vs run_summary_streamed (f32, same counts): refitted {n_refit} (streamed {int(refit_s.sum())}), "
        f"{int(differ.sum())} differ ({int(near.sum())} genes with a distance within 1e-4 of the cutoff); gaps {gaps}")
    check(gaps["lfc_abs"] <= CLASS_VS_STREAM["lfc_abs"] and gaps["padj_rel_p99"] <= CLASS_VS_STREAM["padj_rel_p99"]
          and gaps["call_agreement"] >= CLASS_VS_STREAM["call_agreement"]
          and gaps["nan_mask_agreement"] >= CLASS_VS_STREAM["nan_mask_agreement"],
          f"phase 3j: class API vs streamed gaps {gaps} beyond {CLASS_VS_STREAM}")

    best = {s: min(walls[s]) for s in steps}
    log(f"  warm walls (best of {reps}) " + ", ".join(f"{s} {best[s]:.4f} s" for s in steps)
        + f"; all runs {walls}")
    d2h = trace["d2h_bytes"]
    log(f"  peak device memory {peak / 2**30:.3f} GiB; deseq2() device-to-host "
        + (f"{d2h} bytes" if d2h is not None else "bytes not measured") + f" in {trace['d2h_copies']} copies; "
        f"traced deseq2(): {trace['traced_wall_ms']:.3f} ms wall, device busy {trace['device_busy_ms']:.3f} ms "
        f"({trace['kernels']} kernels)")
    log(f"  deseq2() stages, ms (synchronised, one run): {stage_ms}")
    log(f"  launches in one run {launches}")
    return {"walls_s": walls, "best_s": best, "peak_bytes": peak, "trace_deseq2": trace, "stage_ms": stage_ms,
            "launches": launches, "refitted": n_refit, "gaps_vs_stream": gaps}


def class_card_vs_cpu() -> None:
    """Phase 4f: the float64 class API on the card against the CPU plain
    path at 100 x 2000 with planted outliers: deseq2(), summary(),
    lfc_shrink() and vst(); the same replaced, refitted and Cook's-outlier
    genes and convergence flags, every float column of ``results_df`` (and
    the shrunk one), the dispersions and ``vst_counts`` at rtol 1e-6 with
    identical NaN masks."""
    counts_df, metadata, _, _ = class_inputs(N_MAIN, G_CPU_CMP, seed=1)
    out = {}
    for dev in (DEVICE, "cpu"):
        dds = class_deseq2(counts_df, metadata, torch.float64, dev)
        ds = class_summary(dds)
        res = ds.results_df.copy()
        ds.lfc_shrink("condition[T.B]")
        dds.vst()
        out[dev] = (dds, res, ds.results_df, dds.layers["vst_counts"])
    (dg, rg, sg, vg), (dc, rc, sc, vc) = out[DEVICE], out["cpu"]
    for col in ("replaced", "refitted", "_pvalue_cooks_outlier", "_genewise_converged", "_MAP_converged",
                "_LFC_converged", "_outlier_genes"):
        check(np.array_equal(dg.var[col].to_numpy(), dc.var[col].to_numpy()), f"class card vs CPU: {col} differs")
    check(int(dg.var["refitted"].sum()) > 0, "class card vs CPU: no gene was refitted")
    arrays = {f"results {c}": (rg[c].to_numpy(), rc[c].to_numpy()) for c in rg.columns}
    arrays.update({f"shrunk {c}": (sg[c].to_numpy(), sc[c].to_numpy()) for c in ("log2FoldChange", "lfcSE")})
    arrays.update({c: (dg.var[c].to_numpy(), dc.var[c].to_numpy()) for c in ("genewise_dispersions", "dispersions")})
    arrays["vst_counts"] = (vg, vc)
    compare_outputs("class API f64", *({k: np.asarray(v[side], dtype=np.float64) for k, v in arrays.items()}
                                       for side in (0, 1)))
    log(f"    refitted {int(dg.var['refitted'].sum())}, cooks outliers {int(dg.var['_pvalue_cooks_outlier'].sum())}, "
        f"padj < 0.05: {int(np.nansum(rg['padj'] < 0.05))}")



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from pydeseq2_tpu_torch import kernels

    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    took = kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source {took}")

    log("phase 2: kernels against their plain versions")
    psi_check()
    timings: dict = {}
    readings: dict = {}  # objective gaps of the lanes where a kernel and its plain version tie
    errs32 = kernel_checks(torch.float32, G_MAIN, N_MAIN, reps=20, timings=timings)
    kernel_checks(torch.float64, G_F64, N_MAIN, reps=5, timings={})
    wide_dispersion_checks(5, timings)
    errs_sum, filter_row, seen32 = summary_kernel_checks(torch.float32, G_MAIN, N_MAIN, reps=20, timings=timings)
    errs32.update(errs_sum)
    errs32.update(rescue_checks(seen32, torch.float32, 20, timings, readings))
    seen = capture_shrink_inputs(shrink_kwargs(seen32["kw"], seen32["summary"], torch.float32))
    errs32.update(shrink_kernel_checks(seen, torch.float32, 5, timings, readings))
    del seen32, seen
    # float64 on a draw with two injected outliers, which IRLS leaves to
    # the rescue tiers; the shrink kernels also on the weak-effect draw
    seen64 = summary_kernel_checks(torch.float64, G_F64, N_MAIN, reps=0, timings={}, outliers=True)[2]
    rescue_checks(seen64, torch.float64, 0, {}, readings)
    for draw in (seen64, capture_draw(torch.float64, G_F64, N_MAIN, WEAK_LFC_SD)):
        seen = capture_shrink_inputs(shrink_kwargs(draw["kw"], draw["summary"], torch.float64))
        shrink_kernel_checks(seen, torch.float64, 0, {}, readings)
    del seen64, draw, seen
    grid_wide_checks(readings)
    cooks_wide_check()
    errs32.update(stream_kernel_checks(torch.float32, G_MAIN, N_MAIN, 20, timings)[0])
    stream_kernel_checks(torch.float64, G_F64, N_MAIN, 0, {})
    errs32.update(sf_kernel_checks(torch.float32, G_MAIN, N_MAIN, 20, timings))
    sf_kernel_checks(torch.float64, G_F64, N_MAIN, 0, {})
    errs32.update(vst_kernel_checks(torch.float32, G_MAIN, N_MAIN, 20, timings))
    vst_kernel_checks(torch.float64, G_F64, N_MAIN, 0, {})
    errs32.update(class_kernel_checks(torch.float32, G_MAIN, N_MAIN, 20, timings))
    class_kernel_checks(torch.float64, G_F64, N_MAIN, 0, {})

    log("phase 3: wald_pipeline, 100 x 60000 float32")
    main = main_path(reps=3)

    log("phase 3b: summary_pipeline (counts -> padj), 100 x 60000 float32")
    summary, summary_kw, summary_out = summary_path(reps=3, filter_row=filter_row)

    log("phase 3c: run_lfc_shrink_streamed (apeGLM), 100 x 60000 float32, on phase 3b's results")
    shrink = shrink_path(reps=3, summary_kw=summary_kw, summary_out=summary_out)
    del summary_kw, summary_out
    log(f"phase 3d: summary_pipeline then run_lfc_shrink_streamed on a weak-effect draw (lfc SD {WEAK_LFC_SD}), "
        "100 x 60000 float32")
    weak = weak_shrink_path(3, readings)

    log(f"phase 3e: run_summary_streamed(refit_cooks=True), {N_MAIN} x {G_MAIN} float32, an outlier planted in "
        f"every {OUTLIER_EVERY}th gene")
    stream = stream_path(3, G_MAIN, N_MAIN, "phase 3e")
    log(f"phase 3f: the same at {N_STREAM_WIDE} x {G_MAIN} float32 (auto gene_block: 2 blocks)")
    stream_wide = stream_path(3, G_MAIN, N_STREAM_WIDE, "phase 3f")
    check(stream_wide["gene_block"] == G_MAIN // 2, f"phase 3f: gene_block {stream_wide['gene_block']}, expected "
                                                    f"{G_MAIN // 2}")

    log(f"phase 3g: vst_pipeline (blind VST), {N_MAIN} x {G_MAIN} float32")
    vst = vst_path(3)
    log(f"phase 3h: run_vst_streamed, {N_STREAM_WIDE} x {G_MAIN} float32 (auto gene_block: 2 blocks)")
    vst_wide = vst_stream_path(3, G_MAIN, N_STREAM_WIDE)
    check(vst_wide["gene_block"] == G_MAIN // 2, f"phase 3h: gene_block {vst_wide['gene_block']}, expected "
                                                 f"{G_MAIN // 2}")
    log(f"phase 3i: run_summary_streamed(refit_cooks=True) on a zero-inflated draw (a zero in every gene), "
        f"{N_MAIN} x {G_MAIN} float32, an outlier planted in every {OUTLIER_EVERY}th gene")
    stream_zi = stream_path(3, G_MAIN, N_MAIN, "phase 3i", zero_inflated=True)
    log(f"phase 3j: the class API (DeseqDataSet.deseq2, DeseqStats.summary, lfc_shrink, vst), {N_MAIN} x {G_MAIN} "
        f"float32, an outlier planted in every {OUTLIER_EVERY}th gene")
    klass = class_path(3)
    log(f"phase 3k: alpha_mle_batch(fine_length={FINE_LENGTH}) then dnb_nll, {N_MAIN} x {G_MAIN} float32")
    fine = fine_path(3)

    log("phase 4: float64 pipeline, card against CPU, 100 x 2000, P = 2, 3, 5")
    card_vs_cpu()
    log("phase 4b: float64 summary pipeline with injected outliers, card against CPU, 100 x 2000")
    counts4, X4, summary4 = summary_card_vs_cpu()
    log("phase 4c: float64 apeGLM shrinkage on phase 4b's draw, card against CPU")
    shrink_card_vs_cpu(counts4, X4, summary4)
    log("phase 4d: float64 run_summary_streamed(refit_cooks=True) with planted outliers, card against CPU, "
        "100 x 2000")
    stream_card_vs_cpu()
    log("phase 4e: float64 iterative size factors, zero-inflated run_summary_streamed, vst_pipeline and "
        "run_vst_streamed, card against CPU, 100 x 2000")
    sf_vst_card_vs_cpu()
    log("phase 4f: float64 class API (deseq2, summary, lfc_shrink, vst) with planted outliers, card against CPU, "
        "100 x 2000")
    class_card_vs_cpu()
    log(f"phase 4g: float64 alpha_mle_batch(fine_length={FINE_LENGTH}) and dnb_nll, card against CPU, 100 x 2000")
    fine_card_vs_cpu()

    # name -> (source, TPU program it replaces, the run whose launches count)
    replaces = {
        "order_stats_select": ("pydeseq2_tpu_torch/csrc/select.cu", "pydeseq2_tpu/ops/select.py:65", "select"),
        "disp_scan": ("pydeseq2_tpu_torch/csrc/disp_scan.cu", "pydeseq2_tpu/ops/dispersion.py:196", "disp_scan"),
        "disp_newton": ("pydeseq2_tpu_torch/csrc/disp_newton.cu", "pydeseq2_tpu/ops/dispersion.py:361", "disp_newton"),
        "disp_scan_fine": ("pydeseq2_tpu_torch/csrc/disp_scan.cu", "pydeseq2_tpu/ops/dispersion.py:170",
                           "disp_scan_fine"),
        "dnb_nll": ("pydeseq2_tpu_torch/csrc/dnb_nll.cu", "pydeseq2_tpu/ops/nb.py:381", "dnb_nll"),
        "irls": ("pydeseq2_tpu_torch/csrc/irls.cu", "pydeseq2_tpu/ops/irls.py:45", "irls"),
        "newton_box": ("pydeseq2_tpu_torch/csrc/newton_box.cu", "pydeseq2_tpu/ops/irls.py:272", "newton_box"),
        "grid_nb": ("pydeseq2_tpu_torch/csrc/grid.cu", "pydeseq2_tpu/ops/irls.py:375", "grid_nb"),
        "hat_wald": ("pydeseq2_tpu_torch/csrc/hat_wald.cu",
                     "pydeseq2_tpu/ops/irls.py:444 + pydeseq2_tpu/ops/wald.py:28", "hat_wald"),
        "cooks": ("pydeseq2_tpu_torch/csrc/cooks.cu",
                  "pydeseq2_tpu/ops/stats.py:108 + pydeseq2_tpu/fused.py:702", "cooks"),
        "bh": ("pydeseq2_tpu_torch/csrc/bh.cu", "pydeseq2_tpu/ops/stats.py:145", "bh"),
        "shrink": ("pydeseq2_tpu_torch/csrc/shrink.cu", "pydeseq2_tpu/ops/shrink.py:101", "shrink"),
        "grid_apeglm": ("pydeseq2_tpu_torch/csrc/grid.cu", "pydeseq2_tpu/ops/shrink.py:258", "grid_apeglm"),
        "mom": ("pydeseq2_tpu_torch/csrc/mom.cu", "pydeseq2_tpu/ops/linreg.py:23,52,76", "mom"),
        "trend": ("pydeseq2_tpu_torch/csrc/trend.cu", "pydeseq2_tpu/ops/trend.py:22 + pydeseq2_tpu/fused.py:212",
                  "trend"),
        "lowess": ("pydeseq2_tpu_torch/csrc/lowess.cu", "pydeseq2_tpu/ops/stats.py:218 + pydeseq2_tpu/fused.py:763",
                   "lowess"),
        "impute": ("pydeseq2_tpu_torch/csrc/impute.cu", "pydeseq2_tpu/fused_stream.py:561", "impute"),
        "sf_nll": ("pydeseq2_tpu_torch/csrc/sizefactors.cu", "pydeseq2_tpu/ops/sizefactors.py:34", "sf_nll"),
        "sf_newton": ("pydeseq2_tpu_torch/csrc/sizefactors.cu", "pydeseq2_tpu/ops/sizefactors.py:34", "sf_newton"),
        "vst": ("pydeseq2_tpu_torch/csrc/vst.cu", "pydeseq2_tpu/fused.py:886 + pydeseq2_tpu/fused_stream.py:1249",
                "vst"),
        "trend_fit": ("pydeseq2_tpu_torch/csrc/trend.cu", "pydeseq2_tpu/ops/trend.py:22", "trend_fit"),
        "trimmed_var": ("pydeseq2_tpu_torch/csrc/trimmed.cu",
                        "pydeseq2_tpu/ops/select.py:166 + pydeseq2_tpu/ops/stats.py:28,88,108", "trimmed_var"),
        "hat": ("pydeseq2_tpu_torch/csrc/hat_wald.cu", "pydeseq2_tpu/ops/irls.py:444", "hat"),
        "wald": ("pydeseq2_tpu_torch/csrc/hat_wald.cu", "pydeseq2_tpu/ops/wald.py:28", "wald"),
    }
    # Launches: the summary path for its kernels, the shrink paths for
    # theirs, the streamed refit path (phase 3e) for mom, trend, lowess and
    # impute, the zero-inflated one (3i) for the size-factor kernels, the
    # blind VST (3g) for vst, the class API (3j) for its four, the fine-scan
    # path (3k) for disp_scan_fine and dnb_nll.
    launches = {**summary["launches"], "shrink": shrink["launches"]["shrink"],
                "grid_apeglm": weak["launches"]["grid_apeglm"],
                **{k: stream["launches"][k] for k in ("mom", "trend", "lowess", "impute")},
                "sf_nll": stream_zi["launches"]["sf_nll"], "sf_newton": stream_zi["launches"]["sf_newton"],
                "vst": vst["launches"]["vst"],
                **{k: klass["launches"][k] for k in ("trend_fit", "trimmed_var", "hat", "wald")},
                **{k: fine["launches"][k] for k in ("disp_scan_fine", "dnb_nll")}}
    timings["cooks"]["refit_ms"] = timings.pop("cooks_refit_ms")
    rows = []
    for name, (source, repl, key) in replaces.items():
        t = timings[name]
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["ops"] / t.get("ops_per_s", F32_OPS_PER_S) * 1e3
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": repl,
            "launches": launches[key], "max_abs_err": errs32[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t["library_ms"],
        }
        for extra in ("sort_ms", "all_lanes_ms", "refit_ms", "ms_with_mu", "steps", "column_ms", "wide_ms",
                      "wide_plain_ms"):
            if extra in t:
                # the sort before the BH sweep; a rescue kernel over every lane
                # of its tile; cooks in the streamed refit mode; mom writing mu;
                # the Newton steps of one sf_newton launch; trimmed_var over the
                # mean trend's one column; the atlas block's times of disp_scan
                # and disp_newton
                row[extra] = t[extra]
        rows.append(row)
    log("wald path: " + json.dumps(main))
    log("summary path: " + json.dumps(summary))
    log("shrink path: " + json.dumps(shrink))
    log("shrink path, weak effects: " + json.dumps(weak))
    log("streamed refit path: " + json.dumps(stream))
    log("streamed refit path, wide: " + json.dumps(stream_wide))
    log("blind VST path: " + json.dumps(vst))
    log("streamed VST path, wide: " + json.dumps(vst_wide))
    log("streamed refit path, zero-inflated: " + json.dumps(stream_zi))
    log("class API path: " + json.dumps(klass))
    log("fine-scan path: " + json.dumps(fine))
    log("ties of the rescue and grid kernels with their plain versions: " + json.dumps(readings))
    print(json.dumps({"kernels": rows}), flush=True)
    name = torch.cuda.get_device_name(0)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
