"""Smoke run of pydeseq2_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the twenty-nine hand-written kernels from ``pydeseq2_tpu_torch/csrc``
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
   around the coarse argmin) with its gene grouping ``disp_scan_group``
   (the same buckets as the plain version, a permutation, the scan's bits
   the same in any gene order) and ``dnb_nll`` (at the genewise
   dispersions) on the main draw's operands (same two scales); ``disp_scan``,
   ``disp_newton`` and ``disp_scan_fine`` at the atlas iterative fit's shape
   (5000 genes x 10000 samples, P = 1, float32, the rows over segments),
   checked and timed; ``disp_newton`` where its plan splits each gene's
   row over several warps (``newton_split_check``: 512 x 17382 float32, P =
   2), held to the plain version by the same tolerances, with its gap from
   the unsplit launch; the fine scan on its gene lists
   (``fine_list_checks``: P = 2 and 5, both types, the coarse scan's
   centres, one centre, every tile straddling r = 8, la_init centres and
   genes with no finite point); ``vst`` in every plan (``vst_plan_checks``:
   16-byte and scalar rows, N = 101, a pointer 4 bytes off, one and
   several column tiles, the atlas block, each form twice and bit for bit,
   masked rows); ``dnb_nll`` in every plan (``dnb_plan_checks``: 4, 8
   and 32 lanes and a block a row at row lengths on both sides of each of
   ``_dnb_plan``'s thresholds, row counts that fill no last warp, both
   types, alpha a row vector, one value on the card and a float by value,
   each launched twice and bit for bit, within ``dnb_check``'s bounds of
   the plain version); the cluster kernels in every
   mode (``cluster_kernel_checks``): ``sf_newton`` with its counts in shared
   memory at 100 x 60000 float32 and float64 and streamed at 200000 genes
   float64, at N = 3 and G = 5 (one block, and a cluster of 16 with empty
   blocks), ``trend_fit`` and ``trend`` at 300, 60000 and 200000 lanes in
   both types, their lanes in shared memory and streamed, each launched
   twice and equal to itself bit for bit; the trimmed moments' launch plans
   (``trim_plan_checks``): ``cooks`` (summary and refit mode) and
   ``trimmed_var`` (cohorts and a column) at the atlas cohort shape (300
   genes x 10000 samples, two cohorts of 5000), on tie-heavy counts (unit
   size factors, Poisson means 0.1-3), with cohorts of 1, 2 and 3 members,
   at cohort and column sizes on each side of the plan's thresholds (rank
   count or radix select, a warp or a block a row, shared memory or the
   streamed workspace), each launched twice and equal to itself bit for bit;
   ``grid_apeglm`` on three designs (intercept and indicator, intercept and
   a continuous covariate, a zero in the first column) at 1, 16 and 937
   lanes in both types, every other lane selected bit for bit as every lane
   (``grid_design_checks``); ``sf_nll`` at every lane count on Poisson and
   zero-heavy counts at 3, 100 and 10000 samples in both types, and
   ``grid_apeglm`` at every cluster size, each launched twice and equal to
   itself bit for bit (``nll_grid_plan_checks``); ``grid_nb`` in each plan
   its wrapper picks from the selected count (1, 16 and 937 of a 937-lane
   tile, and 16 at every cluster size; both types, indicator and
   continuous designs), each launched twice (``grid_nb_plan_checks``);
   ``shrink`` launched twice and in rounds of one candidate (the same
   iterate, bit for bit); ``select`` in every plan (``select_plan_checks``:
   the size-factor tile 100 x 60000 in both types and 1000 x 60000
   float32, one column of 60000 and of 60001 at each cluster size K = 1-16
   staged and streamed, columns on each side of the staged/streamed
   threshold, a column with no valid value, one of 777), each launched
   twice and both launches bit for bit the sorted element; ``select_hist``
   and ``select_pick`` (``select_hist_checks``: every radix pass of the
   gene mesh's median in every path, a warp a column over staged chunks
   and the sparse passes' keys tested where they were loaded, by 16-byte
   and by scalar loads, a last group of fewer than 16 columns, a
   column view read in place, blocks whose rows do not divide L, on the
   size-factor tile 100 x 60000, a four-rank shard of
   it, 8000 samples, 101 samples and single columns, both types, each
   launched twice and bit for bit its plain version; every pick launch
   bit for bit ``radix_pick``, twice; the one-rank radix median bit for
   bit the ``select`` kernel's); ``irls`` with
   the deviance constant it computes itself at P = 2, 3, 5 at 12, 100,
   1000 and 10000 samples in both types, phase 1 and the phase-2 tile it
   leaves (``irls_plan_checks``), each launched twice, held to the stated
   rule (99.9% of lanes within 1e-4 / 1e-7 of the plain loop, flags on
   99.9%, the slowest lanes one trip apart) or, in float32 at P > 2 and on
   float32 phase-2 tiles, where the plain loop does not meet that rule
   against itself with its samples in other orders, to its worst
   agreement (a lane beyond the tolerance agreeing where its float64
   objective ties); ``mom`` in every lane-group plan at 12, 100, 1000 and
   10000 samples (``mom_plan_checks``: 4, 8 and 32 lanes in registers, 32
   lanes and a block with the row staged and with part of it divided
   again; P = 2, and the picked, one staged and one streamed plan at P =
   1, 5 and on normalised counts; both types), each launched twice and bit
   for bit, with and without mu, within ``mom_check``'s tolerances (or the
   plain version's own disagreement with its samples reversed, where that
   is larger); ``bh_count`` and ``bh_adjust`` (``bh_plan_checks``) on 1,
   33 and 60000 genes with tied and NaN p-values under sorted, shuffled and
   non-finite cutoffs (three rows masking every gene), every row picked by
   a tensor on the card, each launched twice and bit for bit against the
   plain sweep, the row on clusters of 1-16 blocks, 300 rows of counts;
   ``hat_wald``, ``hat`` and ``wald`` in every lane-group plan
   (``hat_wald_plan_checks``: 4, 8, 32 lanes and a block, each staging what
   its share of shared memory holds, and 32 lanes and a block staging a
   third of the row, the rest formed again in pass 2) at 12,
   100, 1000 and 10000 samples and on both sides of each plan threshold,
   P = 2, and the picked, one staged and one streamed plan at P = 5, both
   types (every alternative in float64), each launched twice and bit for
   bit, within the ``hat_wald`` tolerances of the plain version, the test
   alone and the ``hat`` and ``wald`` entries bit for bit the fused call's;
   ``lowess`` at 2, 50 and 64 points with tied distances and an all-zero
   row (``lowess_checks``), twice and bit for bit, the plain pick's row;
   ``impute`` in every trimmed-moment plan (``impute_plan_checks``: a warp
   a row by rank count and by radix select, a block a row with the keys in
   shared memory and over the workspace) at 3, 12, 96, 97, 100, 1000 and
   10000 samples and a float64 row past 227 KB, on Poisson, tie-heavy and
   zero-heavy rows and rows left all zero, both types, each launched twice
   and bit for bit, held to the plain version by the floor rule;
   ``newton_box`` (``newton_box_plan_checks``) with 1, 2, 16 and all of a
   937-lane tile selected at 12, 100 and 1000 samples and of a 16-lane tile
   past the stage (8000 samples float32, 4000 float64), P = 2, 3, 5, both
   types, each launched twice and bit for bit, the selected lanes bit for
   bit the all-lane launch's, held to the plain version by the tie rule and
   the exit test at the kernel's point;
   ``sf_nll`` also on a
   zero-heavy copy of the trimmed solve's counts, and its lgamma table
   (lgamma(1) = 0 on the card);
3. runs ``wald_pipeline`` at 100 x 60000 float32 on the card through its
   public entry point: warm wall time, genes/s, IRLS trip counts, rescue
   overflow, share of finite p-values, the share of ``_irls_with_rescue``
   in one more run, and the launch count of each of its kernels in one run
   (each must be > 0);
3b. runs ``summary_pipeline`` (counts -> padj) the same way: warm wall,
   genes/s, Cook's outliers, share of finite padj, the independent-filtering
   row picked, and the launch count of its ten kernels in one run;
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
   launches of its twelve kernels in one run (each must be > 0);
3f. the same at 1000 x 60000, where the automatic gene block streams two
   blocks of 30000 genes;
3g. runs ``vst_pipeline`` (the blind VST) at 100 x 60000 float32 the same
   way: warm wall, genes/s and the launches of its six kernels in one run;
3h. runs ``run_vst_streamed`` at 1000 x 60000 float32 (two gene blocks);
3i. runs phase 3e on a zero-inflated draw (a zero in every gene): each run
   must warn and switch to the iterative size factors, whose two kernels
   must launch beside the twelve; the rounds of the iterative fit;
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
3l. runs the one-call entry point ``run_deseq2`` at 100 x 60000 float32
   from pandas DataFrames, on phase 3e's draw (the default refit route) and
   on phase 3b's (``refit_cooks=False``), each beside the direct pipeline
   call it makes on the same counts: warm walls of both, the launches of
   one call (> 0 for each kernel of the route, and equal to the direct
   call's kernel by kernel), every column within rtol 1e-6 of the direct
   call's, and one call under cProfile (where the host time goes);
3m. runs ``run_deseq2(mesh=)`` on a gene mesh at 100 x 60000 float32 on
   both routes (3l's draws): one rank over NCCL (``init_distributed``,
   ``make_gene_mesh``), every column and the refitted genes bit for bit
   the ``mesh=None`` call's, the launches of one call those of
   ``mesh=None`` but for the size-factor median's ``select``, which
   becomes 4 ``select_hist`` passes and their ``select_pick`` launches;
   warm walls of both, one profiled call's
   collectives; then two ranks on the one card over gloo (two processes of
   this script, ``--mesh-rank``), every column within rtol 1e-6 of
   ``mesh=None`` and bit for bit but for the genes it names;
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
4h. runs float64 ``run_deseq2`` on the card and on the CPU at 100 x 2000
   (both routes, poscounts, control genes, the zero-inflated switch): every
   column at rtol 1e-6, the same refitted genes and Cook's outliers; then
   saves a dataset fitted on the card through its genewise dispersions
   (``pydeseq2_tpu_torch.io``), loads it with a card inference and resumes
   the stages left (equal to the uninterrupted card run at rtol 1e-12), and
   loads and resumes the same file on the CPU (rtol 1e-6);
5. prints one JSON line with the kernels' numbers, the card line, and last
   the result line ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result
line. It exits non-zero at once where no CUDA card is visible.
"""

from __future__ import annotations

import inspect
import json
import math
import os
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
# Instruction rate: 4 schedulers an SM, one warp instruction (32 lanes)
# each a clock, 132 SMs at 1.98 GHz; an IEEE float32 division takes ~16
# instructions on its fast path (reciprocal estimate, refinement and checks:
# an estimate from the instruction sequence, not a count of the compiled
# code). sf_newton's phase-2 log line states the divisions' time at that rate.
INSTR_PER_S = 132 * 4 * 32 * 1.98e9
DIV_INSTR = 16
# SASS instructions of one apeGLM term in grid_apeglm (the shortest path
# through a trip of its one-term float32 loops) and of one NLL cell in
# sf_nll (the shortest and the longest path through its cell loop), read
# by `kernel_bench --detail` (sass_loops) on this build. Their phase-2 log
# lines state an instruction time from them: an estimate, not a bound (the
# loops unrolled by 4 share part of a term's instructions), and not in the
# kernels line.
APEGLM_TERM_INSTR = 75
SF_NLL_CELL_INSTR = (24, 538)
# The same for one NB term of grid_nb (the shortest trip of its float32
# term loops, 267 instructions, over the 4 terms a trip of a loop unrolled
# by 4: the 937-lane tile's 343 M terms take 1.55 ms on an H100, which at
# the issue rate leaves a term ~151 instructions at most) and one apeGLM
# term of shrink's objective pass (the shortest trip of its one-sample
# float32 loop).
NB_TERM_INSTR = 67
SHRINK_TERM_INSTR = 59

DEVICE = "cuda"
G_MAIN, N_MAIN = 60_000, 100
G_F64 = 4_000
G_CPU_CMP = 2_000
N_HIST_WIDE, G_HIST_WIDE = 8_000, 6_000  # select_hist past 16 x 256 columns a launch row
# Phase 3m: the ranks of the two-rank mesh on the one card (gloo, CUDA
# tensors), and the seconds they may take together.
MESH_RANKS_2 = 2
MESH_RANK_TIMEOUT_S = 420
N_WIDE, G_WIDE = 1_500, 3_000  # Cook's past the JAX select switch (n >= 1024)
# The atlas iterative fit's dispersion shape (PERF.md section 4): one block
# of 5000 genes of 10000 samples, intercept-only design, float32.
N_ATLAS, G_ATLAS_BLOCK = 10_000, 5_000
# The fine scan's points in phases 2 and 3k (alpha_mle_batch(fine_length=8),
# the JAX package's documented fine setting).
FINE_LENGTH = 8
# The kernels wald_pipeline launches; summary_pipeline adds cooks, the BH
# counts and row (bh_count, bh_adjust) and lowess. Both launch the rescue tiers' kernels (newton_box, grid_nb) only
# where a lane stays flagged after IRLS, as at 100 x 60000 (1-2 lanes).
WALD_KERNELS = ("select", "disp_scan", "disp_newton", "irls", "hat_wald", "newton_box", "grid_nb", "mom", "trend")
SUMMARY_KERNELS = WALD_KERNELS + ("cooks", "bh_count", "bh_adjust", "lowess")
# The kernels run_summary_streamed(refit_cooks=True) must launch (phases 3e,
# 3f): the rescue tiers again only where a lane stays flagged.
STREAM_KERNELS = ("select", "disp_scan", "disp_newton", "irls", "hat_wald", "cooks", "bh_count", "bh_adjust", "mom",
                  "trend", "lowess", "impute")
# The cluster kernels' own shapes (phase 2, cluster_kernel_checks): the
# streamed mode of sf_newton at a transcript-level gene list (~200000 rows,
# float64, whose slab does not fit a block's shared memory); trend_fit and
# trend at a few hundred lanes (one block), the main width and that list.
SF_STREAMED_G = 200_000
TREND_LANES = (300, G_MAIN, SF_STREAMED_G)
# The trimmed moments' own shapes (phase 2, trim_plan_checks): Cook's at the
# atlas block's cohort shape (two cohorts of 5000) on TRIM_ATLAS_G genes;
# the mean trend's column of ~G dispersions.
TRIM_ATLAS_G = 300
TRIM_COLUMN = 59_038
N_STREAM_WIDE = 1_000  # phases 3f, 3h: auto gene_block splits 60000 genes into 2 blocks of 30000
# The kernels the blind VST launches (phases 3g, 3h): the size-factor
# medians, MoM, the genewise fit and the trend at P = 1, and the transform.
VST_KERNELS = ("select", "mom", "disp_scan", "disp_newton", "trend", "vst")
# The kernels of phase 3k: alpha_mle_batch(fine_length=8), then dnb_nll at
# its dispersions.
FINE_KERNELS = ("disp_scan", "disp_scan_group", "disp_scan_fine", "disp_newton", "dnb_nll")
# The fine scan's gene lists (phase 2, fine_list_checks), float32 at the
# main width and float64 at G_F64, P = 2 and 5: the draw as its coarse scan
# leaves it, every gene at one centre, every tile straddling r = 8
# (kernel_bench.fine_lists), and la_init centres in every LA_INIT_EVERY-th
# gene, with no finite point (mu NaN) in every NAN_EVERY-th.
FINE_LIST_SHAPES = ((torch.float32, G_MAIN, 2), (torch.float32, G_MAIN, 5), (torch.float64, G_F64, 2),
                    (torch.float64, G_F64, 5))
FINE_LISTS = ("coarse", "one", "straddle", "la_init")
LA_INIT_EVERY, NAN_EVERY = 50, 97
# vst's plan checks (vst_plan_checks): row lengths on each side of the
# plan's edges in each type (16-byte vectors or scalar; one column tile of
# 4096 bytes or several; one vector a row), each at an odd gene count of
# ~3 M cells (a partial row tile); a row length that takes vectors on a
# pointer 4 bytes off (scalar); and the atlas block.
VST_PLAN_N = {torch.float32: (1, 4, 100, 101, 1024, 1025, 2048), torch.float64: (1, 2, 100, 101, 512, 513, 1024)}
VST_PLAN_CELLS = 3_000_000
# dnb_plan_checks: row lengths on both sides of each _dnb_plan threshold
# (48, 256, 4096 samples), the main width and the atlas', at ~DNB_PLAN_CELLS
# cells (an odd row count); every plan at each.
DNB_PLAN_N = (1, 12, 48, 49, 100, 256, 257, 1_000, 4_095, 4_096, 10_000)
DNB_PLAN_CELLS = 2_000_000
# Planted Cook's outliers of the streamed refit runs: one cell at 20x its
# row's maximum in every OUTLIER_EVERY-th gene.
OUTLIER_EVERY = 100
# Coverage only, not a cited study: a draw with weak effects (fold changes
# of SD 0.1), whose narrow fitted prior makes Newton fail on some lanes, so
# that the shrink path's grid rescue runs (phases 2 and 3d; PERF.md section
# 4 gives the share). The kernel table times grid_apeglm on the main draw's
# failed-first tile with every lane selected.
WEAK_LFC_SD = 0.1
# Samples past one staged chunk of the grid kernels (csrc/grid.cu: grid_nb
# 512, grid_apeglm up to 1024).
N_GRID_WIDE = {torch.float32: 8_000, torch.float64: 4_000}
# grid_apeglm's designs and lane counts (phase 2, grid_design_checks): the
# intercept and condition of make_data, an intercept and a continuous
# covariate (no sample skips a term), the two conditions' own indicators (a
# zero in the first column); one lane, 16, and the weak-effect tile's 937.
GRID_DESIGNS = ("indicator", "continuous", "zero-first")
GRID_LANES = (1, 16, 937)
# grid_nb's plan checks: a tile of NB_TILE lanes at the main width, of which
# 1, 16 or all are selected, and every cluster size at 16 selected lanes
NB_TILE = 937
# The plans' own shapes (phase 2, nll_grid_plan_checks): sf_nll at each lane
# count on Poisson and zero-heavy draws at 100 samples, past the staged
# chunk (10000 samples: 4096 a chunk in float32, 2048 in float64), and at
# N = 3; grid_apeglm at each cluster size.
NLL_PLAN_G = 4_000
# impute's plan checks: rows of each length, the longest a float64 row
# past one block's 227 KB of shared memory (the workspace plan); tiles of
# IMPUTE_PLAN_K rows, fewer past 1000 samples.
IMPUTE_PLAN_N = (3, 12, 96, 97, 100, 1_000, 10_000)
IMPUTE_WS_N = 30_000
IMPUTE_PLAN_K = 4_096
# newton_box's plan checks: a NB_TILE-lane tile at BOX_PLAN_N samples and a
# 16-lane tile at N_GRID_WIDE, past the kernel's stage; P = 2, 3, 5.
BOX_PLAN_N = (12, 100, 1_000)
BOX_PLAN_P = (2, 3, 5)
# The float32 case (samples, P) whose plain search ties with itself beyond
# TIE_UNITS, and the draws of it that newton_box_plan_checks holds the
# kernel to, each with its own limit.
BOX_TIE_CASE = (12, 3)
BOX_TIE_SEEDS = 8
# The parent design's passes on the phase-2 rescue tiles (one warp a lane,
# one objective pass a backtracking candidate; PERF.md section 6), logged
# beside the passes of this build.
BOX_PARENT_PASSES = {"f32": 28, "f64": 73}
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


def box_selection(passes: list) -> list:
    """Per ``newton_box`` launch of a counted run (``kernels.STATS.box_passes``
    taken just after it): [selected lanes, lanes of the tile, the slowest
    lane's serial passes]."""
    return [[int((p > 0).sum()), p.numel(), int(p.max()) if p.numel() else 0] for p in passes]


def stage_inputs(counts, X, max_disp):
    """The tensors the pipeline hands to each kernel (size factors, MoM,
    linear mu), computed with the port's own stage functions."""
    from pydeseq2_tpu_torch.fused_stream import _streamed_size_factors
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
    sf = _streamed_size_factors(counts, mask, logmeans)
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


def fine_group_check(label: str, center, lo_f: float, hi_f: float, hw_f: float) -> list:
    """``disp_scan_group`` against its plain version on the centres
    ``center``, launched twice: the same genes in each bucket, and an order
    that is a permutation of the genes whose keys run in bucket order (the
    plain order's keys). Returns the bucket counts."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    n_grid = dsp._fine_buckets(lo_f, hi_f, hw_f)
    keys = dsp._fine_keys_plain(center, lo_f, hw_f, n_grid)
    order_p, count_p = dsp._fine_order_plain(center, lo_f, hw_f, n_grid)
    every = torch.arange(center.numel(), dtype=torch.int32, device=center.device)
    for _ in range(2):
        order, count = dsp._fine_order_cuda(center, lo_f, hw_f, n_grid)
        check(torch.equal(count, count_p), f"disp_scan_group {label}: bucket counts {count.tolist()}, plain "
                                           f"{count_p.tolist()}")
        check(torch.equal(torch.sort(order).values, every), f"disp_scan_group {label}: not a permutation")
        check(torch.equal(keys[order.long()], keys[order_p.long()]), f"disp_scan_group {label}: keys out of order")
    return count_p.tolist()


def fine_order_check(label: str, fine_args) -> None:
    """The fine scan's bits do not depend on its gene order: the grouped
    call (``scan_grid``) against launches in index order and in a seeded
    random order, bit for bit."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    counts, mu, X, center, hw, length, lo_f, hi_f, cr_reg, prior_reg, la_hat, pdv = fine_args
    got = dsp.scan_grid(*fine_args)
    G = center.numel()
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    for name, order in (("index", torch.arange(G, device=DEVICE)), ("random", torch.randperm(G, generator=gen,
                                                                                             device=DEVICE))):
        grid_args = (center, hw, 2.0 * hw / (length - 1), lo_f, hi_f, length, order.to(torch.int32))
        other = dsp._scan_launch("disp_scan_fine", counts, mu, X, grid_args, length, cr_reg, prior_reg, la_hat, pdv,
                                 None)
        check(bits_equal(other, got), f"disp_scan_fine {label}: the genes in {name} order give other bits")


def dnb_scale(counts, mu, alpha):
    """alpha^-2 sum_n (|psi(r)| + |psi(y + r)| + |log1p(mu a)| + |(y - mu)/(mu + r)|),
    r = 1/alpha: the size of the terms dnb_nll sums."""
    from pydeseq2_tpu_torch.ops import nb

    r = 1.0 / alpha[:, None]
    return (nb._psi_fast(r).abs() + nb._psi_fast(counts + r).abs() + torch.log1p(mu * alpha[:, None]).abs()
            + ((counts - mu) / (mu + r)).abs()).sum(-1) / alpha**2


def dnb_check(name: str, counts, mu, alpha, lanes: int | None = None, want=None) -> tuple[float, float]:
    """``dnb_nll`` (in the plan of ``lanes``, else its own) against its
    plain version (``want`` where given): (max abs error, max error
    relative to the summed magnitudes); a second launch must give the same
    bits. Both evaluate the same terms with the same psi; alpha^-2
    amplifies psi(1/a) - psi(y + 1/a), which cancels as alpha -> 0, so the
    gap is held against alpha^-2 sum(|psi(r)| + |psi(y + r)| + |log1p(mu
    a)| + |(y - mu)/(mu + r)|): 1e-5 (f32) / 1e-13 (f64), a few rounding
    units of that sum in float32 (~80 eps) and float64 (~450 eps) for terms
    summed in another order."""
    from pydeseq2_tpu_torch.ops import nb

    f32 = mu.dtype == torch.float32
    got = nb.dnb_nll(counts, mu, alpha) if lanes is None else nb._dnb_nll_cuda(counts, mu, alpha, lanes)
    again = nb.dnb_nll(counts, mu, alpha) if lanes is None else nb._dnb_nll_cuda(counts, mu, alpha, lanes)
    check(bits_equal(got, again), f"dnb_nll {name}: a second launch differs from the first")
    if want is None:
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


def dnb_draw(G: int, N: int, dtype, seed: int):
    """(counts, mu, alpha) on the card: G rows of N negative-binomial counts
    around lognormal means, dispersions lognormal in [1e-3, 5]."""
    rng = np.random.default_rng(seed)
    alpha = np.clip(rng.lognormal(-2.0, 1.0, G), 1e-3, 5.0)
    mu = rng.lognormal(2.0, 1.0, (G, 1)) * rng.lognormal(0.0, 0.3, (G, N))
    counts = rng.negative_binomial(1.0 / alpha[:, None], 1.0 / (1.0 + alpha[:, None] * mu))
    return tuple(torch.as_tensor(a, dtype=dtype, device=DEVICE) for a in (counts, mu, alpha))


def dnb_plan_checks() -> dict:
    """``dnb_nll`` in every plan (4, 8 and 32 lanes and a block a row) at
    each row length of DNB_PLAN_N, on ~DNB_PLAN_CELLS cells of
    ``dnb_draw`` (an odd row count: the last warp or block of rows is not
    full), in both types: each launched twice and bit for bit, held to the
    plain version by ``dnb_check``. At the main width, in the picked plan,
    alpha as one value on the card and as a float by value give the bits
    of a row vector of that value. Returns {label: plan}."""
    from pydeseq2_tpu_torch.ops import nb

    plans = {}
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        for N in DNB_PLAN_N:
            G = max(1, DNB_PLAN_CELLS // N) | 1
            counts, mu, alpha = dnb_draw(G, N, dtype, seed=N)
            want = nb._dnb_nll_plain(counts, mu, alpha)
            auto = nb._dnb_plan(N, mu.element_size())
            for lanes in (4, 8, 32, nb._DNB_BLOCK):
                label = f"{name} {G} x {N}, {lanes} lanes" + (" (picked)" if lanes == auto else "")
                dnb_check(label, counts, mu, alpha, lanes, want)
                plans[f"dnb_nll {label}"] = {"lanes": lanes}
            if N == N_MAIN:
                value = float(alpha[G // 2])
                row = nb._dnb_nll_cuda(counts, mu, torch.full_like(alpha, value))
                for form, a in (("one value on the card", alpha[G // 2].clone()), ("a float by value", value)):
                    check(bits_equal(nb._dnb_nll_cuda(counts, mu, a), row),
                          f"dnb_nll {name} {G} x {N}: alpha as {form} differs from a row vector of it")
                log(f"  dnb_nll {name} {G} x {N}: alpha as one value on the card and as a float by value, bit for "
                    "bit a row vector of it")
            del counts, mu, alpha, want
    return plans


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
    again = sel.order_stats_select(log_ratios, ks, axis=0)
    want = sel.order_stats_select_plain(log_ratios, ks, axis=0)
    # Exact: the kernel must return the very element a sort puts at each rank.
    for a, b, c in zip(got, want, again):
        check(torch.equal(sel._monotone_key(a), sel._monotone_key(b)), f"select {name}: not bit-identical")
        check(torch.equal(sel._monotone_key(a), sel._monotone_key(c)), f"select {name}: a second launch differs")
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
            # the key map (3) and, in the first two passes (the later ones
            # visit the compacted candidates only), the prefix test, digit
            # and count of the ranks' one histogram (6) per element
            "ops": (3 + 2 * 6) * G * N,
            # one column of G (the prior's median and MAD, the keep quantile)
            "column_ms": cuda_ms(lambda: sel.order_stats_select(col[:, None], ks1), reps),
            "column_sort_ms": cuda_ms(lambda: torch.sort(col), reps),
            "plan": sel._select_device_plan(N, G, dtype, dev)._asdict(),
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
    # its gene grouping (a launch of scan_grid), and the scan's bits in any gene order
    buckets = fine_group_check(name, la1_k, lo_f, hi_f, step1_f)
    fine_order_check(name, fine_args)
    errs["disp_scan_group"] = 0.0
    log(f"  disp_scan_group {name}: bucket counts {buckets} (the last: any other centre); the scan's bits the "
        "same in index and random gene order")
    if f32:
        n_grid = dsp._fine_buckets(lo_f, hi_f, step1_f)
        timings["disp_scan_group"] = {
            "ms": cuda_ms(lambda: dsp._fine_order_cuda(la1_k, lo_f, step1_f, n_grid), reps),
            "plain_ms": cuda_ms(lambda: dsp._fine_order_plain(la1_k, lo_f, step1_f, n_grid), reps),
            "library_ms": None,
            # the centres read, the order and bucket counts written; per gene
            # the key (a subtraction, a division, a rounding, two compares, the
            # grid point's product and sum, its compare) and two claims
            "bytes": G * isz + 4 * G + 4 * (n_grid + 1), "ops": 10 * G,
        }

    # -- dnb_nll at the genewise fit's dispersions
    alpha = torch.exp(outk[0])
    errs["dnb_nll"], _ = dnb_check(name, counts, mu, alpha)
    if f32:
        nbytes, ops, sfu = dnb_cost(G, N, isz)
        timings["dnb_nll"] = {
            "ms": cuda_ms(lambda: nb.dnb_nll(counts, mu, alpha), reps),
            "plain_ms": cuda_ms(lambda: nb._dnb_nll_plain(counts, mu, alpha), reps),
            "library_ms": None, "bytes": nbytes, "ops": ops, "plan": {"lanes": nb._dnb_plan(N, isz)},
        }
        log_sfu("dnb_nll", sfu)

    # -- kernel 4: IRLS (phase 1 of the LFC fit: every lane, 8 trips) ------
    # The kernel computes its deviance constant itself; the plain loop gets
    # PyTorch's (irls_against_plain, the stated rule).
    disp = torch.clamp(torch.exp(outk[0]), 1e-8, max_disp)
    ops = {"counts": counts, "sf": sf, "X": X, "disp": disp, "beta_init": irl.irls_beta_init(counts, sf, X)}
    results = {}
    for maxiter in (8, 250):
        bk, _, trips, plan = irls_against_plain(f"{name} {G} x {N} maxiter={maxiter}", ops, maxiter)
        results[maxiter] = (bk, trips)
    errs["irls"] = (results[8][0] - irls_plain_of(ops, 8)[0]).abs().max().item()
    if f32:
        trips = results[8][1].double()
        ntri = P * (P + 1) // 2
        per_pass = 2 * P + 26 + 2 * ntri + 2 * P
        beta_tol, step_tol = 1e-6, 1e-5
        log_sf = torch.log(sf)
        kargs = (counts, sf, X, disp, ops["beta_init"], log_sf, 0.5, beta_tol, 30.0, 8, step_tol, 2)
        timings["irls"] = {
            "ms": cuda_ms(lambda: irl._irls_cuda(*kargs), reps),
            "plain_ms": cuda_ms(lambda: irls_plain_of(ops, 8), max(1, reps // 5)),
            "library_ms": None,
            "bytes": counts.numel() * counts.element_size() + 6 * G * counts.element_size(),
            # the deviance constant (~60 ops an element), (trips + 1) IRLS
            # passes per gene at per_pass ops per element, plus 3 polish
            # passes of ~(25 + 2 ntri) ops
            "ops": int(N * (60 * G + (trips + 1).sum().item() * per_pass + 3 * G * (25 + 2 * ntri))),
            "trips_mean": trips.mean().item(),
            "plan": plan._asdict(),
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
    # the fine scan on the atlas block: rows split over segments
    fine_args = (counts, mu, X, la1, step1_f, FINE_LENGTH, lo_f, hi_f, True, False, la_hat, pdv)
    S = dsp._scan_segments(G, N, torch.cuda.get_device_properties(0).multi_processor_count)
    fine_check(f"f32 atlas block {G} x {N} P=1, {S} segments", fine_args)
    fine_group_check("f32 atlas block", la1, lo_f, hi_f, step1_f)
    fine_order_check("f32 atlas block", fine_args)
    t = timings["disp_scan_fine"]
    t["wide_ms"] = cuda_ms(lambda: dsp.scan_grid(*fine_args), reps)
    t["wide_plain_ms"] = cuda_ms(lambda: dsp.scan_grid_plain(*fine_args), 1)
    log(f"  disp_scan_fine atlas block: {t['wide_ms']:.4f} ms with its grouping (plain {t['wide_plain_ms']:.4f})")
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


# A short gene list at an atlas's width, where disp_newton's plan splits a
# gene's row over several warps (ops/dispersion.py:_newton_plan).
G_SPLIT, N_SPLIT = 512, 17_382


def newton_split_check() -> dict:
    """``disp_newton`` where its plan splits each gene's row over several
    warps: G_SPLIT x N_SPLIT float32 at P = 2, four Newton steps from the
    kernel scan's argmin, held to the plain version by ``newton_check``'s
    tolerances; beside it the largest log-alpha gap from the unsplit launch
    (one warp a gene, ``plan=1``) and the genes whose log-alpha differs from
    it in any bit. The plan must split, and ``STATS.newton_split`` count the
    launch."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import dispersion as dsp
    from pydeseq2_tpu_torch.synthetic import make_data

    G, N, P = G_SPLIT, N_SPLIT, 2
    dtype = torch.float32
    dev = torch.device(DEVICE)
    counts_np, X_np = make_data(N, G)
    counts = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=dev)
    X = torch.as_tensor(X_np[:, :P], dtype=dtype, device=dev)
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
    la1, _ = dsp.scan_coarse(*scan_args)
    newton_args = (counts, mu, X, la1, lo_f, hi_f, step1_f, step1_f / 3.5, 4, True, False, la_hat, pdv)
    wg = dsp._newton_device_plan(G, N, P, dtype, dev)
    check(wg > 1, f"disp_newton {G} x {N}: the plan keeps one warp a gene")
    before = kernels.STATS.newton_split
    name = f"f32 split {G} x {N} P=2, {wg} warps a gene"
    _, outk, _ = newton_check(name, newton_args)
    check(kernels.STATS.newton_split == before + 1, f"disp_newton {name}: STATS.newton_split not counted")
    unsplit = dsp._newton_polish_cuda(*newton_args, plan=1)
    torch.cuda.synchronize()
    gap = (outk[0] - unsplit[0]).abs().max().item()
    differ = int((outk[0] != unsplit[0]).sum().item())
    log(f"  disp_newton {name}: largest la gap from one warp a gene {gap:.3g}, {differ} of {G} genes not bit "
        "for bit")
    return {"newton_split": {"warps": wg, "la_gap_unsplit": gap, "genes_not_bit_equal_unsplit": differ}}


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
    from pydeseq2_tpu_torch import kernels, tracing
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
        with tracing.enabled(i == 0):  # the counted run records trips and box passes
            out = pt.wald_pipeline(**kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
            trips = [int(t) for t in kernels.STATS.irls_trips]
            box = box_selection(kernels.STATS.box_passes)
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
    log(f"  launches in one run {launches}; IRLS slowest-lane trips per launch {trips}; newton_box per launch "
        f"[selected, tile lanes, slowest lane's passes] {box}")
    log(f"  rescue_overflow {int(res['rescue_overflow'])}, finite p-values {finite:.5f}, "
        f"irls_converged {float(res['irls_converged'].mean()):.5f}, "
        f"trend_used_mean {bool(res['trend_used_mean'])}")
    return {"walls_s": walls, "best_s": best, "genes_per_s": G_MAIN / best, "launches": launches,
            "irls_trips": trips, "box_selection": box, "rescue_overflow": int(res["rescue_overflow"]), "finite_p": finite,
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
    from pydeseq2_tpu_torch import fused, fused_stream

    return capture([(fused_stream, ("hat_wald", "cooks_outliers", "_irls_with_rescue")),
                    (fused, ("bh_rejections", "bh_adjust_row", "device_padj", "newton_box_nbglm",
                             "grid_fit_beta_batch"))], pt.summary_pipeline, "summary", kw)


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
    """Operations per (gene, sample) that the fused hat diagonals and Wald
    test need: pass 1 (linear predictor, exp, the product by sf, the clamp,
    one weight, both Gram triangles) and pass 2 (x^T M^-1 x, H); a sample
    whose mu is clamped needs a second weight (3 more, counted by the
    caller)."""
    ntri = P * (P + 1) // 2
    return (2 * P + 6 + 5 * ntri) + (2 * P * P + 2 * P + 1)


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


def bh_check(name: str, seen: dict, reps: int, timings: dict) -> int:
    """``bh_count`` and ``bh_adjust`` against their plain versions on the
    operands one ``summary_pipeline`` run hands ``bh_rejections`` and
    ``bh_adjust_row`` (and as the whole sweep, with one row and in float32
    operands), each launched twice, bit for bit; the run's padj against the
    plain sweep's row at the run's pick. Fills ``timings`` (``reps`` > 0)
    and returns the picked row."""
    from pydeseq2_tpu_torch.ops import stats as st

    # Exact: the same order, products, quotients and minima as the plain
    # versions, and the count as the rank of a row's last rejection.
    rej_run = seen["bh_rejections"][2]
    p, order, valid, base_mean, cutoffs, alpha = bound_args(st.bh_rejections, *seen["bh_rejections"][:2])
    rargs = bound_args(st.bh_adjust_row, *seen["bh_adjust_row"][:2])
    j_run = rargs[-1]
    for label, sweep_args in (
        ("50 rows", (p, order, valid, base_mean, cutoffs, alpha)),
        ("1 row", (p, order, valid, None, None, alpha)),
        ("50 rows, float32 operands", (p.float(), order, valid, base_mean.float(), cutoffs.float(), alpha)),
    ):
        adj_p, rej_p = st._bh_sweep_plain(*sweep_args)
        for rep in range(2):
            rej_k = st._bh_count_cuda(*sweep_args)
            check(torch.equal(rej_k, rej_p), f"bh {name} {label}: rejection counts differ from (adj < alpha).sum(1)"
                                             f" (launch {rep + 1})")
            adj_k = st._bh_adjust_cuda(*sweep_args[:5], None)
            check(bits_equal(adj_k, adj_p),
                  f"bh {name} {label}: adjusted p-values not bit-identical (launch {rep + 1})")
        check(torch.equal(st._bh_sweep_cuda(*sweep_args)[1], rej_p), f"bh {name} {label}: bh_sweep's counts differ")
    adj_p, rej_p = st._bh_sweep_plain(p, order, valid, base_mean, cutoffs, alpha)
    check(torch.equal(rej_run, rej_p), f"bh {name}: the run's counts differ from the plain sweep's")
    rows = cutoffs.shape[0]
    # The run's padj is the plain sweep's row at the run's pick.
    filter_row = int(j_run)
    check(bits_equal(seen["device_padj"][2], adj_p[filter_row]),
          f"bh {name}: the run's padj is not the plain sweep's row j = {filter_row}")
    log(f"  bh {name}: ({rows}, {p.shape[0]}), 1 row, and float32 operands: counts and rows bit-identical, each "
        f"launched twice; rejections per row {rej_p.tolist()[:3]}...{rej_p.tolist()[-3:]}; filter row j = "
        f"{filter_row}, the run's padj the plain row")
    if reps:
        Gp = p.shape[0]
        bargs = (p, order, valid, base_mean, cutoffs, alpha)
        timings["bh_count"] = {
            "ms": cuda_ms(lambda: st._bh_count_cuda(*bargs), reps),
            "plain_ms": cuda_ms(lambda: st._bh_count_plain(*bargs), reps),
            "library_ms": None,
            "sort_ms": cuda_ms(lambda: torch.argsort(p, stable=True), reps),
            # reads p, order, valid and base_mean once, the cutoffs; writes
            # the counts
            "bytes": Gp * sum(x.element_size() for x in (p, order, valid, base_mean)) + rows * (8 + 8),
            # per row and masked gene (the rows' masks are nested): the
            # rank, the product, the comparison with alpha rank (a fused
            # multiply-add) and the running maximum
            "ops": 5 * int(_bh_pairs(valid, base_mean, cutoffs, p)),
            "ops_per_s": F64_OPS_PER_S,
        }
        timings["bh_adjust"] = {
            "ms": cuda_ms(lambda: st._bh_adjust_cuda(*rargs), reps),
            "plain_ms": cuda_ms(lambda: st._bh_adjust_plain(*rargs), reps),
            "library_ms": None,
            "all_rows_ms": cuda_ms(lambda: st._bh_adjust_cuda(*bargs[:5], None), reps),
            # gathers p, valid, base_mean and reads order once; writes one row
            "bytes": Gp * sum(x.element_size() for x in (p, order, valid, base_mean)) + 8 + Gp * 8,
            # per gene: the mask (3 compares), rank, product, quotient,
            # minimum, clip
            "ops": 8 * Gp,
            "ops_per_s": F64_OPS_PER_S,
        }
    return filter_row


def _bh_pairs(valid, base_mean, cutoffs, p) -> torch.Tensor:
    """The (row, gene) pairs inside the masks of a BH sweep: the work the
    counts' bound counts."""
    mask = valid & ~torch.isnan(p)
    return ((base_mean[None, :] >= cutoffs[:, None]) & mask[None, :]).sum()


def summary_kernel_checks(dtype, G, N, reps, timings, outliers=False):
    """Phase 2, summary kernels: hat_wald, cooks, bh_count and bh_adjust against their plain
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
        alone = wd._hat_wald_cuda(*hw_args, want_hat=False)
        check(all(bits_equal(a, b) for a, b in zip(alone[2:], got[2:])),
              f"hat_wald {name} {alt}: the test alone differs from the fused call's")
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
            "ops": hat_wald_ops(P) * G * N + 3 * int((want[1] < kwargs["min_mu"]).sum()),
            "ops_per_s": F32_OPS_PER_S,
            "plan": wd._hat_wald_plan(N, P, isz)._asdict(),
            "test_only_ms": cuda_ms(lambda: wd._hat_wald_cuda(*hw_args, want_hat=False), reps),
        }

    # -- kernel 10: Cook's distances, robust dispersion, outlier flags -------
    cargs = seen["cooks_outliers"][0]
    errs["cooks"] = cooks_check(name, cargs, reps if f32 else 0, timings)

    # -- kernel 9: BH, the counts of the 50 cutoff rows and the picked row ----
    filter_row = bh_check(name, seen, reps if f32 else 0, timings)
    errs["bh_count"] = errs["bh_adjust"] = 0.0
    return errs, filter_row, seen


def cooks_check(name, cargs, reps, timings):
    """The cooks kernel against its plain version on ``cargs``."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import cooks as ck
    from pydeseq2_tpu_torch.ops import stats as st

    f32 = cargs[0].dtype == torch.float32
    # Tolerance: both sum each trimmed mean's kept values in float64 and
    # round once, but the mean m of y / sf is summed in other orders and
    # feeds (v - m) / m^2, which cancels where v ~ m, so 1e-3 (f32) / 1e-9 (f64)
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
        normed = counts / cargs[1][None, :]
        cohort_rows = [normed[:, torch.tensor([i for i, c in enumerate(cohort) if c == lvl], device=counts.device)]
                       .contiguous() for lvl in range(len(trims))]
        timings["cooks"] = {
            "ms": cuda_ms(lambda: ck._cooks_cuda(*cargs), reps),
            "plain_ms": cuda_ms(lambda: ck._cooks_plain(*cargs), reps),
            "library_ms": None,
            # the yardstick: torch.sort of the cohort rows, the sort alone
            "sort_ms": cuda_ms(lambda: [torch.sort(r, dim=1) for r in cohort_rows], reps),
            "plan": st._trim_plan(isz, members, G, True, kernels.sm_count(counts.device))._asdict(),
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
    from pydeseq2_tpu_torch import kernels, tracing
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
        with tracing.enabled(i == 0):  # the counted run records the box passes
            out = pt.summary_pipeline(**kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
            box = box_selection(kernels.STATS.box_passes)
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
    log(f"  launches in one run {launches}; newton_box per launch [selected, tile lanes, slowest lane's passes] "
        f"{box}")
    log(f"  cooks outliers {n_out}, finite padj {fin.mean():.5f}, padj < 0.05: {int((padj < 0.05).sum())}, "
        f"filter row j = {filter_row} (phase 2), rescue_overflow {int(res['rescue_overflow'])}")
    return {"walls_s": walls, "best_s": best, "genes_per_s": G_MAIN / best, "launches": launches,
            "box_selection": box, "cooks_outliers": n_out, "finite_padj": float(fin.mean()), "filter_row": filter_row,
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
        grid = bound_args(irl.grid_fit_beta_batch, lane, {"min_mu": min_mu})[:-2]
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


def agree_or_tie(what, b_k, b_p, f_k, f_p, btol, unit, limit=TIE_UNITS):
    """Kernel against plain, lane by lane: the coefficients agree within
    ``btol``, or the kernel's point is as good as the plain one to rounding
    (float64 objectives within ``limit`` x ``unit``, the lane's rounding
    unit; TIE_UNITS unless the caller measured the plain version's own
    noise): a search whose accept or argmin compares values at their
    rounding noise may stop elsewhere on a flat objective. Returns (the
    number of lanes that took the second route, their largest objective
    gap in units)."""
    nan_k, nan_p = torch.isnan(b_k).any(1), torch.isnan(b_p).any(1)
    check(torch.equal(nan_k, nan_p), f"{what}: NaN lanes differ")
    close = ((b_k - b_p).abs().amax(1) <= btol) | nan_p
    gap = (f_k - f_p).abs() / unit
    bad = ~close & ~(gap <= limit)
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} lanes differ beyond {btol} and their objectives by more "
                             f"than {limit:.3g} rounding units (worst {gap[bad].max().item():.3g})")
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
    from pydeseq2_tpu_torch.ops import shrink as sh

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    check("newton_box_nbglm" in seen, f"rescue {name}: the summary run sent no lane to the rescue tiers")
    *box, sel = bound_args(irl.newton_box_nbglm, *seen["newton_box_nbglm"][:2])
    counts, sf, X, disp, beta_init, min_mu, max_beta, _ = box
    if "grid_fit_beta_batch" in seen:
        *grid, sel_grid, n_grid = bound_args(irl.grid_fit_beta_batch, *seen["grid_fit_beta_batch"][:2])
        check(n_grid is not None and n_grid >= int(sel_grid.sum()), f"rescue {name}: the path's grid launch "
                                                                      f"counts {n_grid} selected lanes")
    else:
        *grid, sel_grid, n_grid = bound_args(irl.grid_fit_beta_batch, (counts, sf, X, disp),
                                             {"min_mu": min_mu, "sel": sel, "n_sel": int(sel.sum())})
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
        f"selection {int(sel.sum())} lanes, {int(passes.sum())} passes (the parent design's "
        f"{BOX_PARENT_PASSES[name]}), bit-identical to the all-lane launch")

    gk = irl._grid_fit_beta_cuda(*grid)
    gp = irl._grid_fit_beta_plain(*grid)
    gfar, r = tie_report(f"grid_nb {name}", gk, gp, lambda b: nb_objective64(counts, sf, X, disp, b, min_mu), unit,
                         1e-6 * 30.0, fine_step(*grid[-3:]), readings)
    gs = irl._grid_fit_beta_cuda(*grid, sel_grid, n_grid)
    check(bits_equal(gs[sel_grid], gk[sel_grid]) and bool(torch.isnan(gs[~sel_grid]).all()),
          f"grid_nb {name}: the selected launch differs from the all-lane one")
    check(bits_equal(gs, irl._grid_fit_beta_cuda(*grid, sel_grid, n_grid)), f"grid_nb {name}: a second selected "
                                                                            "launch differs from the first")
    log(f"  grid_nb {name}: {K} lanes, {gfar} at another grid point with tied objectives ({r}); pipeline selection "
        f"{int(sel_grid.sum())} lanes, bit-identical to the all-lane launch")
    errs = {"newton_box": (bk - bp).nan_to_num(0.0).abs().max().item(),
            "grid_nb": (gk - gp).nan_to_num(0.0).abs().max().item()}
    if f32:
        isz = counts.element_size()
        n_sel, n_grid = int(sel.sum()), int(sel_grid.sum())
        ntri = P * (P + 1) // 2
        terms = grid_terms(X, n_grid)
        timings["newton_box"] = {
            "ms": cuda_ms(lambda: irl._newton_box_cuda(*box, sel), reps),
            "plain_ms": cuda_ms(lambda: irl._newton_box_plain(*box), 2),
            "all_lanes_ms": cuda_ms(lambda: irl._newton_box_cuda(*box), reps),
            "library_ms": None,
            # the selected lanes' rows, sf, log sf and X, their disp and
            # start; writes beta and the flag of the tile
            "bytes": isz * (n_sel * N + N * (P + 2) + n_sel * (P + 1) + K * P) + K,
            # per serial pass and sample (a pass is at least one row
            # evaluation that the sequential search needs, so this counts no
            # more than the run's data needs): linear predictor, exp, clamp,
            # the objective's or the gradient's and Hessian's terms
            "ops": int(passes.sum()) * N * (2 * P + 12 + 2 * ntri),
            "passes": int(passes.sum()),
            "plan": irl._box_plan(N, P, isz)._asdict(),
        }
        timings["grid_nb"] = {
            "ms": cuda_ms(lambda: irl._grid_fit_beta_cuda(*grid, sel_grid, n_grid), reps),
            "plain_ms": cuda_ms(lambda: irl._grid_fit_beta_plain(*grid), 2),
            "all_lanes_ms": cuda_ms(lambda: irl._grid_fit_beta_cuda(*grid), reps),
            "library_ms": None,
            "bytes": isz * (n_grid * N + N * (P + 1) + n_grid + 2 * 60 + 2 * K),
            # the terms the design needs (grid_terms); per term the linear
            # predictor, exp, clamp, log(mu), log(mu + r) or log1p, and ~12 more
            "ops": terms * 20,
            "terms": terms,
            "plan": sh._grid_device_plan(n_grid, N, 60, counts.dtype, counts.device, kernel="grid_nb")._asdict(),
        }
        log(f"  grid_nb f32: {n_grid} selected lanes, {terms} terms, plan {timings['grid_nb']['plan']}; bound "
            f"{terms * 20 / F32_OPS_PER_S * 1e3:.6f} ms (operations), instruction estimate "
            f"{terms * NB_TERM_INSTR / INSTR_PER_S * 1e3:.6f} ms ({NB_TERM_INSTR} a term) on all SMs")
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


def grid_apeglm_check(what, grid, readings, plan=None, gp=None):
    """``grid_apeglm`` against its plain version on ``grid`` (the bound
    arguments of ``grid_fit_shrink_beta_batch`` but ``sel``), every lane
    selected, in ``plan`` (default: the wrapper's): the same grid point, or
    objectives tied within TIE_UNITS rounding units. ``gp``: the plain
    result where it is already known. Returns (kernel result, plain result,
    lanes tied)."""
    from pydeseq2_tpu_torch.ops import shrink as sh

    ci, offset, X, si, pns, ps, cnst, shrink_index = grid[:8]
    gk = sh._grid_shrink_cuda(*grid, plan=plan)
    if gp is None:
        gp = sh._grid_shrink_plain(*grid)
    N = ci.shape[1]

    def objective(b):
        return ape_objective64(ci, X, si, offset, pns, ps, cnst, shrink_index, b)[0]

    unit = noise_unit(N, ci.dtype) * ape_objective64(ci, X, si, offset, pns, ps, cnst, shrink_index, gp)[1]
    far, _ = tie_report(what, gk, gp, objective, unit, 1e-6 * 30.0, fine_step(*grid[-3:]), readings)
    return gk, gp, far


def grid_terms(X: torch.Tensor, lanes: int, L: int = 60) -> int:
    """The apeGLM terms ``grid_apeglm`` evaluates on ``lanes`` selected
    lanes of design ``X`` (csrc/grid.cu): per pass, each sample whose
    design row has no zero at every one of the L x L points, one with x1 =
    0 once a row, one with x0 = 0 (and x1 != 0) once a column."""
    a = int((X[:, 1] == 0).sum())
    b = int(((X[:, 0] == 0) & (X[:, 1] != 0)).sum())
    c = X.shape[0] - a - b
    return lanes * 2 * (L * L * c + L * a + L * b)


def grid_design_checks(readings) -> dict:
    """Phase 2, ``grid_apeglm`` on each of GRID_DESIGNS at each of
    GRID_LANES lanes (``kernel_bench.grid_operands``; 1 and 16 lanes at
    N_GRID_WIDE samples, past one staged chunk, 937 at the main width) in
    float32 and float64: against its plain version by
    :func:`grid_apeglm_check` (the same point or tied within TIE_UNITS),
    then on every other lane (the first always), bit for bit the all-lane
    launch's there and NaN elsewhere. Returns {label: plan}."""
    from pydeseq2_tpu_torch import kernel_bench
    from pydeseq2_tpu_torch.ops import shrink as sh

    plans = {}
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        for design in GRID_DESIGNS:
            for lanes in GRID_LANES:
                N = N_MAIN if lanes > 16 else N_GRID_WIDE[dtype]
                grid = kernel_bench.grid_operands(lanes, N, dtype, design)
                what = f"grid_apeglm {name} {design} {lanes} x {N}"
                plans[what] = sh._grid_device_plan(lanes, N, 60, dtype, DEVICE)._asdict()
                gk, _, far = grid_apeglm_check(what, grid, readings)
                sel = torch.arange(lanes, device=gk.device) % 2 == 0
                gs = sh._grid_shrink_cuda(*grid, sel)
                check(bits_equal(gs[sel], gk[sel]) and bool(torch.isnan(gs[~sel]).all()),
                      f"{what}: the launch on every other lane differs from the all-lane one")
                log(f"  {what}: plan {plans[what]}, {far} lanes at another grid point with tied objectives "
                    f"({readings[what]}); every other lane bit-identical")
    return plans


def nll_grid_plan_checks(readings) -> dict:
    """Phase 2, the plans of ``sf_nll`` (``_nll_plan``) and ``grid_apeglm``
    (``_grid_plan``), each launched twice (the second launch equal to the
    first bit for bit) and held to its plain version: ``sf_nll`` at every
    lane count 4-32, on NLL_PLAN_G genes of
    ``kernel_bench.sf_operands`` and of its zero-heavy copy, at 100 and
    10000 samples (past the staged chunk) and at N = 3 in both types, within
    8 eps (float32) or 8 sqrt(N) eps (float64) of the plain NLL, relative,
    +inf off the mask; ``grid_apeglm`` at every cluster size 1-16 on 16
    lanes at N_GRID_WIDE samples and on 937 lanes at the main width, the
    continuous design, in float32, the same point or tied within TIE_UNITS.
    Returns {label: plan}."""
    from pydeseq2_tpu_torch import kernel_bench
    from pydeseq2_tpu_torch.ops import shrink as sh
    from pydeseq2_tpu_torch.ops import sizefactors as sz

    plans = {}
    for dtype in (torch.float32, torch.float64):
        for N in (N_MAIN, N_ATLAS, 3):
            # float32 cells summed in float64 round to the same total in any
            # order but at rounding ties: 8 eps. float64 cells summed in
            # another order: the noise of N float64 additions, 8 sqrt(N) eps
            # of the total (a sum of -log probabilities, as large as its terms).
            tol = 8 * torch.finfo(dtype).eps * (1.0 if dtype == torch.float32 else math.sqrt(N))
            ops = kernel_bench.sf_operands(NLL_PLAN_G, N, dtype)
            mask = ops[6]
            for draw in ("Poisson", "zero-heavy"):
                if draw == "zero-heavy":
                    ops = (kernel_bench.zero_heavy(ops[0]), *ops[1:])
                args = (*ops, 0.5)
                want = sz._sf_nll_plain(*args)
                auto = sz._nll_plan(N, ops[0].element_size())
                for lanes in (4, 8, 16, 32):
                    plan = auto._replace(lanes=lanes)
                    name = "f32" if dtype == torch.float32 else "f64"
                    label = f"sf_nll {name} {NLL_PLAN_G} x {N} {draw}, {lanes} lanes"
                    plans[label] = plan._asdict()
                    got = sz._sf_nll_cuda(*args, plan=plan)
                    check(bits_equal(got, sz._sf_nll_cuda(*args, plan=plan)),
                          f"{label}: a second launch differs from the first")
                    check(torch.equal(torch.isinf(got), ~mask), f"{label}: +inf lanes are not the lanes off the mask")
                    e = ((got[mask] - want[mask]).abs() / want[mask].abs().clamp(min=1.0)).max().item()
                    check(e <= tol, f"{label}: rel err {e:.3g} > {tol:.3g}")
                    log(f"  {label}: rel err {e:.3g} (tol {tol:.3g}), bit-equal on "
                        f"{(got[mask] == want[mask]).double().mean().item():.5f}, repeat bit-equal")
            del ops, args, want
    for lanes, N in ((16, N_GRID_WIDE[torch.float32]), (937, N_MAIN)):
        grid = kernel_bench.grid_operands(lanes, N, torch.float32, "continuous")
        gp = sh._grid_shrink_plain(*grid)
        auto = sh._grid_plan(lanes, N, 60, 4)
        for K in (1, 2, 4, 8, 16):
            plan = auto._replace(K=K)
            label = f"grid_apeglm f32 continuous {lanes} x {N}, K {K}"
            plans[label] = plan._asdict()
            gk, _, far = grid_apeglm_check(label, grid, readings, plan, gp)
            check(bits_equal(gk, sh._grid_shrink_cuda(*grid, plan=plan)),
                  f"{label}: a second launch differs from the first")
            log(f"  {label}: {far} lanes at another grid point with tied objectives, repeat bit-equal")
    return plans


def grid_nb_plan_checks(readings) -> dict:
    """Phase 2, the plans ``grid_nb``'s wrapper picks from the selected
    count: on a tile of NB_TILE lanes at the main width
    (``kernel_bench.grid_operands``' counts, size factors and design,
    dispersions 1 / size) in float32 and float64, indicator and continuous
    designs, with the first lane, every 59th lane (16) or every lane
    selected, and with 16 selected at every cluster size: each launched
    twice, bit for bit the same, NaN off the selection, the selected lanes
    at the plain version's grid point or tied within TIE_UNITS rounding
    units, and bit for bit the all-lane launch's. Returns {label: plan}."""
    from pydeseq2_tpu_torch import kernel_bench
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.ops import shrink as sh

    plans = {}
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        for design in ("indicator", "continuous"):
            counts, offset, X, size = kernel_bench.grid_operands(NB_TILE, N_MAIN, dtype, design)[:4]
            sf, disp = torch.exp(offset), 1.0 / size
            grid = (counts, sf, X, disp, 0.5, 60, -30.0, 30.0)
            gp = irl._grid_fit_beta_plain(*grid)
            every = irl._grid_fit_beta_cuda(*grid)
            unit = noise_unit(N_MAIN, dtype) * term_scale(counts)
            idx = torch.arange(NB_TILE, device=counts.device)
            cases = [(n, idx == 0 if n == 1 else (idx % 59 == 0 if n == 16 else idx >= 0), None)
                     for n in (1, 16, NB_TILE)]
            cases += [(16, idx % 59 == 0, K) for K in (1, 2, 4, 8, 16)]
            for n, sel, K in cases:
                plan = sh._grid_device_plan(n, N_MAIN, 60, dtype, DEVICE, kernel="grid_nb")
                if K is not None:
                    plan = plan._replace(K=K)
                what = f"grid_nb {name} {design} {n} of {NB_TILE} x {N_MAIN}" + (f", K {K}" if K else "")
                plans[what] = plan._asdict()
                gk = irl._grid_fit_beta_cuda(*grid, sel, n, plan)
                check(bits_equal(gk, irl._grid_fit_beta_cuda(*grid, sel, n, plan)),
                      f"{what}: a second launch differs from the first")
                check(bool(torch.isnan(gk[~sel]).all()), f"{what}: a lane not selected is not NaN")
                check(bits_equal(gk[sel], every[sel]), f"{what}: the selected lanes differ from the all-lane launch")
                far, r = tie_report(what, gk[sel], gp[sel], lambda b: nb_objective64(
                    counts[sel], sf, X, disp[sel], b), unit[sel], 1e-6 * 30.0, fine_step(), readings)
                log(f"  {what}: plan {plans[what]}, {far} lanes at another grid point with tied objectives ({r}); "
                    "repeat bit-equal, NaN off the selection, bit-equal to the all-lane launch")
    return plans


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
    bk, ihk, ck, trips, passes, evals, rounds = sh._nbinom_glm_cuda(*fit)
    bp, ihp, cp = sh._nbinom_glm_plain(*fit)
    check(bits_equal(bk, seen["nbinom_glm_batch"][2][0]), f"shrink {name}: the launch differs from the path's")
    again = sh._nbinom_glm_cuda(*fit)
    first = (bk, ihk, ck, trips, passes, evals, rounds)
    check(all(bits_equal(a.double(), b.double()) for a, b in zip(first, again)),
          f"shrink {name}: a second launch differs from the first")
    # One candidate a round is the serial schedule, whose evaluations are the
    # passes the JAX order needs (the work the bound counts): every round
    # size stops at the same iterate, bit for bit, and counts those passes.
    serial = sh._nbinom_glm_cuda(*fit, cands=1)
    check(all(bits_equal(a.double(), b.double()) for a, b in zip((bk, ihk, ck, trips, passes), serial[:5]))
          and torch.equal(serial[5], passes), f"shrink {name}: rounds of {sh._shrink_round(dtype, P)} candidates stop "
                                              "elsewhere than rounds of one")
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
        f"Newton steps per gene (50/99/100%) {trips.double().quantile(q).tolist()}, passes {int(passes.sum())} "
        f"(as the JAX order needs them), {int(evals.sum())} evaluations in {int(rounds.sum())} reads of the row "
        f"(rounds of {sh._shrink_round(dtype, P)}); relaunch and rounds of one bit-identical")

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
            # per pass the JAX order needs and sample: linear predictor,
            # two exps or exp and log1p (logaddexp), ~12 more, and the
            # Hessian's Gram terms
            "ops": int(passes.sum()) * N * (2 * P + 14 + 2 * ntri),
            "steps_mean": trips.double().mean().item(),
            "passes": int(passes.sum()),
        }
        # the instruction time of SHRINK_TERM_INSTR an objective term, an
        # estimate logged beside the bound
        log(f"  shrink f32: {int(passes.sum())} passes the JAX order needs, {int(evals.sum())} evaluations; bound "
            f"{timings['shrink']['ops'] / F32_OPS_PER_S * 1e3:.4f} ms (operations), instruction estimate "
            f"{int(passes.sum()) * N * SHRINK_TERM_INSTR / INSTR_PER_S * 1e3:.4f} ms ({SHRINK_TERM_INSTR} a term)")
        terms = grid_terms(X_b, K)
        timings["grid_apeglm"] = {
            # every lane of the failed-first tile
            "ms": cuda_ms(lambda: sh._grid_shrink_cuda(*grid), reps),
            "plain_ms": cuda_ms(lambda: sh._grid_shrink_plain(*grid), 2),
            "library_ms": None,
            "bytes": isz * (K * N + N * (P + 1) + 2 * K + 2 * 60 + 2 * K),
            # the terms the design needs (grid_terms); per term the linear
            # predictor, logaddexp (exp, log1p) and ~8 more
            "ops": terms * 16,
            "terms": terms,
            "plan": sh._grid_device_plan(K, N, 60, counts.dtype, counts.device)._asdict(),
        }
        # the instruction time of APEGLM_TERM_INSTR a term, an estimate
        # logged beside the bound
        log(f"  grid_apeglm f32: {terms} terms, plan {timings['grid_apeglm']['plan']}; bound "
            f"{terms * 16 / F32_OPS_PER_S * 1e3:.4f} ms (operations), instruction estimate "
            f"{terms * APEGLM_TERM_INSTR / INSTR_PER_S * 1e3:.4f} ms ({APEGLM_TERM_INSTR} a term)")
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
        *grid, _, _ = bound_args(irl.grid_fit_beta_batch, (counts, sf, X, disp), {})
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
    from pydeseq2_tpu_torch import fused_stream

    orig = fused_stream._irls_with_rescue
    spent = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    fused_stream._irls_with_rescue = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fused_stream._irls_with_rescue = orig
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
    from pydeseq2_tpu_torch.kernel_bench import count_passes
    from pydeseq2_tpu_torch.ops import trend as tr

    return count_passes(tr, run)


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


def refit_agree(label: str, got, want, cutoff, f32: bool) -> None:
    """The refit outputs of ``cooks`` (``got``) against its plain version
    (``want``, distances written): bit for bit, except cells whose plain
    distance lies within 1e-5 (f32) / 1e-12 (f64) relative of the cutoff,
    and flags of genes holding one."""
    from pydeseq2_tpu_torch.ops import cooks as ck

    dtol = 1e-5 if f32 else 1e-12
    near = (want[0] - cutoff).abs() <= dtol * cutoff.abs()  # False on NaN distances
    G, N = want[0].shape
    bits_k, bits_p = ck.unpack_bits(got[3], N), ck.unpack_bits(want[3], N)
    cell_differ = bits_k != bits_p
    check(not bool((cell_differ & ~near).any()), f"{label}: {int((cell_differ & ~near).sum())} exceed bits "
                                                 "differ away from the cutoff")
    gene_near = near.any(1)
    for what, i in (("outlier", 1), ("replaced", 4), ("cooks_outlier_refit", 5)):
        differ = got[i] != want[i]
        check(not bool((differ & ~gene_near).any()), f"{label}: {what} differs on "
                                                      f"{int((differ & ~gene_near).sum())} genes away from the cutoff")
    log(f"  {label} ({G}, {N}): exceed bits differ on {int(cell_differ.sum())} cells "
        f"({int(near.sum())} within {dtol} of the cutoff); replaced {int(got[4].sum())} (plain {int(want[4].sum())}), "
        f"refit flag {int(got[5].sum())} (plain {int(want[5].sum())})")


def impute_agree(what: str, tile, sf, got, want) -> int:
    """``impute``'s floor rule (``kernel_bench.impute_floor_diffs``):
    floor() is discontinuous and the kernel sums the trimmed mean in
    another order than sort-then-mean, so a product trim02 * sf within an
    ulp of an integer may floor one count apart. A differing cell is
    accepted only where the plain product lies within 4 ulps of an
    integer, and by 1; new_all_zero may differ only on rows with such a
    cell. Returns the cells that differ."""
    from pydeseq2_tpu_torch import kernel_bench

    differ, beyond = kernel_bench.impute_floor_diffs(tile, sf, got, want)
    check(beyond == 0, f"{what}: {beyond} cells or flags differ beyond the floor rule")
    return differ


def stream_kernel_checks(dtype, G, N, reps, timings):
    """Phase 2, the streamed refit path's kernels (``mom``, ``trend``,
    ``lowess``, ``impute`` and the refit outputs of ``cooks``) against their
    plain versions on the operands one ``run_summary_streamed(refit_cooks=
    True)`` run of ``make_data(N, G)`` with planted outliers hands them.
    Returns {name: max_abs_err} and fills ``timings`` (``reps`` > 0)."""
    from pydeseq2_tpu_torch import kernels
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
            "passes": n_loss + n_grad,
            "plan": tr._trend_plan(Gt, isz)._asdict(),
        }
        timings["trend"]["ms_per_pass"] = timings["trend"]["ms"] / (n_loss + n_grad)

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
            # the n^2 tricube weights once (~10 each), 3 rounds x n^2 pairs x
            # 12 (five weighted sums), plus a sort of each point's n
            # distances (n log2 n compares)
            "ops": n * n * 10 + 3 * n * n * 12 + n * n * math.ceil(math.log2(n)),
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
    refit_agree(f"cooks {name} refit", got, want, cargs[8], f32)
    if reps:
        timings["cooks_refit_ms"] = cuda_ms(lambda: ck._cooks_cuda(*cargs, repl, False), reps)

    # -- impute: the refit tile, held to the plain version by the floor rule --
    tile, packed, repl_i, sf_i, mask = bound_args(rf.impute_outliers, *seen["impute_outliers"][:2])
    ik, nk = rf._impute_cuda(tile, packed, repl_i, sf_i, mask)
    ip, nplain = rf._impute_plain(tile, packed, repl_i, sf_i, mask)
    check(bits_equal(ik, seen["impute_outliers"][2][0]), f"impute {name}: the launch differs from the path's")
    differ = impute_agree(f"impute {name}", tile, sf_i, (ik, nk), (ip, nplain))
    swapped = int((ck.unpack_bits(packed, tile.shape[1]) & torch.as_tensor(repl_i, device=tile.device)[None, :]
                   & mask[:, None]).sum())
    log(f"  impute {name} ({tile.shape[0]}, {tile.shape[1]}), {int(mask.sum())} rows in the tile, {swapped} cells "
        f"imputed: {differ} cells floor one count apart (plain product within 4 ulps of an integer); "
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
            "plan": st._trim_plan(isz, [Ni], K, True, kernels.sm_count(tile.device))._asdict(),
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
    from pydeseq2_tpu_torch import fused_stream, kernels, tracing
    from pydeseq2_tpu_torch.ops import sizefactors as sz
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
                    # sf_nll's lgamma table is made once a process: the
                    # counted run makes it as a process's first run does
                    sz._lgamma_tables.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with tracing.enabled(i == 0):  # the counted run records the box passes
                    res = pt.run_summary_streamed(**kw)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if i == 0:
                    launches = dict(kernels.STATS.launches)
                    box = box_selection(kernels.STATS.box_passes)
    finally:
        fused_stream.iterative_size_factors = iterative
    switched = sum("Switching to iterative mode" in str(w.message) for w in caught)
    must = STREAM_KERNELS + (("sf_nll", "sf_newton", "lgamma_table") if zero_inflated else ())
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
    log(f"  launches in one run {launches}; newton_box per launch [selected, tile lanes, slowest lane's passes] "
        f"{box}")
    out = {"shape": [N, G], "walls_s": walls, "best_s": best, "genes_per_s": G / best, "gene_block": B,
           "refit_tile": K, "replaced": n_rep, "refitted": n_refit, "launches": launches, "box_selection": box,
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
    from pydeseq2_tpu_torch import kernel_bench
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
    # The same on a zero-heavy copy of the counts (kernel_bench.zero_heavy:
    # ~60% zero cells, counts past the lgamma table, a non-integer row),
    # where the zero cells take their short form.
    cz = kernel_bench.zero_heavy(c)
    zk = sz._sf_nll_cuda(cz, coef, sf0, inv_sf0, s0, disp, mask, min_mu)
    zp = sz._sf_nll_plain(cz, coef, sf0, inv_sf0, s0, disp, mask, min_mu)
    check(torch.equal(torch.isinf(zk), ~mask), f"sf_nll {name} zero-heavy: +inf lanes are not the lanes off the mask")
    e_z = ((zk[mask] - zp[mask]).abs() / zp[mask].abs().clamp(min=1.0)).max().item()
    check(e_z <= 8 * eps, f"sf_nll {name} zero-heavy: rel err {e_z:.3g} > {8 * eps:.3g}")
    n_diff, n_bad = differ_off_ties(sz.keep_mask(zk, mask, quant), sz.keep_mask(zp, mask, quant), zp)
    check(n_bad == 0, f"sf_nll {name} zero-heavy: keep sets differ on {n_bad} genes away from the quantile")
    # The table (the lgamma_table kernel) against its plain version,
    # torch.lgamma on the card, within 8 eps relative (|value| at least 1);
    # the zero cells' short form rests on lgamma(1) = 0 there (the kernel
    # also tests it, and log1p(0) = 0, before using it).
    table = sz._lgamma_table(dtype, c.device)
    check(table[0].item() == 0.0, f"sf_nll {name}: lgamma(1) is {table[0].item()!r} on the card")
    ref = sz._lgamma_table_plain(dtype, c.device)
    e_tab = ((table - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    check(e_tab <= 8 * eps, f"lgamma_table {name}: rel err {e_tab:.3g} > {8 * eps:.3g}")
    errs["lgamma_table"] = (table - ref).abs().max().item()
    log(f"  sf_nll {name} zero-heavy ({(cz == 0).double().mean().item():.3f} of the cells zero): rel err {e_z:.3g} "
        f"(tol {8 * eps:.3g}), bit-equal on {(zk[mask] == zp[mask]).double().mean().item():.5f}; keep sets differ "
        f"on {n_diff} (ties); lgamma table ({table.numel()}) rel err {e_tab:.3g}, bit-equal to torch.lgamma on "
        f"{(table == ref).double().mean().item():.5f}")

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
        on_rows = mask[:, None].expand(Gs, Ns)
        plain_rows = (mask & (1.0 / disp < 8.0))[:, None].expand(Gs, Ns)
        zeros = c == 0
        stirling_rows = on_rows & ~plain_rows
        cells = {k: int(v.sum()) for k, v in (("plain", plain_rows & ~zeros), ("stirling", stirling_rows & ~zeros),
                                                ("plain zero", plain_rows & zeros), ("stirling zero", stirling_rows & zeros))}
        timings["sf_nll"] = {
            "ms": cuda_ms(lambda: sz._sf_nll_cuda(c, coef, sf0, inv_sf0, s0, disp, mask, min_mu), reps),
            "plain_ms": cuda_ms(lambda: sz._sf_nll_plain(c, coef, sf0, inv_sf0, s0, disp, mask, min_mu), reps),
            "library_ms": None,
            # reads counts, coef, disp, sf0, inv_sf0, s and the mask; writes the NLL
            "bytes": isz * (Gs * Ns + 3 * Gs + 3 * Ns) + Gs,
            # per cell of a gene on the mask: mu 4 (two products, max,
            # product; exp(s) is staged) and the float64 add 2; a zero count
            # its short form, 4 (r < 8) or 3; any other y log mu 3 and the
            # plain form 14, lgamma(y + r) among them, or the
            # Stirling-difference form 25 (lgamma(y + 1) read from the table)
            "ops": (6 * sum(cells.values()) + 17 * cells["plain"] + 28 * cells["stirling"] + 4 * cells["plain zero"]
                    + 3 * cells["stirling zero"]),
            "cells": cells,
            "plan": sz._nll_plan(Ns, isz)._asdict(),
        }
        # the instruction time of SF_NLL_CELL_INSTR a cell, the shortest and
        # the longest path, an estimate logged beside the bound
        n_cells = sum(cells.values())
        lo, hi = (n_cells * k / INSTR_PER_S * 1e3 for k in SF_NLL_CELL_INSTR)
        log(f"  sf_nll {name}: {cells} cells, plan {timings['sf_nll']['plan']}; instruction estimate {lo:.4f} ms "
            f"to {hi:.4f} ms ({SF_NLL_CELL_INSTR[0]} to {SF_NLL_CELL_INSTR[1]} a cell)")
        n_tab = sz.LGAMMA_TABLE_LEN
        ar = torch.arange(1, n_tab + 1, dtype=dtype, device=c.device)

        def made():
            sz._lgamma_tables.clear()
            return sz._lgamma_table(dtype, c.device)

        timings["lgamma_table"] = {
            "ms": cuda_ms(made, reps),
            "plain_ms": cuda_ms(lambda: sz._lgamma_table_plain(dtype, c.device), reps),
            "library_ms": cuda_ms(lambda: torch.lgamma(ar), reps),
            # writes the table; per value the library lgamma (~40 operations)
            "bytes": isz * n_tab,
            "ops": 40 * n_tab,
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
            "plan": sz._sf_plan(Gs, Ns, isz, torch.cuda.get_device_properties(0).multi_processor_count)._asdict(),
        }
        # the instruction time of the two IEEE divisions a cell and step, an
        # estimate (DIV_INSTR each), logged beside the bound
        div_ms = inner * Ns * n_keep * 2 * DIV_INSTR / INSTR_PER_S * 1e3
        log(f"  sf_newton {name}: plan {timings['sf_newton']['plan']}, {timings['sf_newton']['ms']:.4f} ms; bytes "
            f"bound {timings['sf_newton']['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (one read a round), division "
            f"instruction estimate {div_ms:.4f} ms")
    return errs


def cluster_kernel_checks() -> dict:
    """Phase 2, the cluster kernels in every mode they have, against their
    plain versions on the seeded operands of ``kernel_bench`` (one
    trimmed-solve round on Poisson counts; trend lanes), each launched twice (the second
    launch equal to the first bit for bit): ``sf_newton`` in its
    shared-memory mode at the main width in float32 and float64, in its
    streamed mode at SF_STREAMED_G genes in float64 (and forced at the main
    width), at the edge shapes (N = 3; G = 5 on one block and on a cluster
    of 16 whose blocks but one hold no gene; no kept gene); ``trend_fit``
    and ``trend`` at TREND_LANES lanes in float32 and float64, with the lanes
    in shared memory (their plan's mode at every such width) and streamed.
    Returns {label: plan} of the plans run."""
    from pydeseq2_tpu_torch import kernel_bench
    from pydeseq2_tpu_torch.ops import sizefactors as sz
    from pydeseq2_tpu_torch.ops import trend as tr

    plans = {}
    # -- sf_newton: one round's steps. Identical terms summed in float64 and
    # rounded: 1e-5 (f32) / 1e-12 (f64), the tolerance of sf_kernel_checks.
    cases = [
        (G_MAIN, N_MAIN, torch.float32, None, "main width"),
        (G_MAIN, N_MAIN, torch.float64, None, "main width"),
        (SF_STREAMED_G, N_MAIN, torch.float64, None, "transcript-level width"),
        (G_MAIN, N_MAIN, torch.float32, "streamed", "main width, streamed forced"),
        (G_MAIN, 3, torch.float32, None, "N = 3"),
        (5, N_MAIN, torch.float64, None, "G = 5"),
        (5, N_MAIN, torch.float64, "cluster16", "G = 5 on a cluster of 16"),
        (5, N_MAIN, torch.float32, "none kept", "G = 5, no kept gene"),
    ]
    for G, N, dtype, force, what in cases:
        c, coef, sf0, inv_sf0, s0, disp, keep = kernel_bench.sf_operands(G, N, dtype)
        plan = sz._sf_plan(G, N, c.element_size(), torch.cuda.get_device_properties(0).multi_processor_count)
        if force == "streamed":
            plan = plan._replace(shared=False)
        elif force == "cluster16":
            plan = plan._replace(K=16)
        elif force == "none kept":
            keep = torch.zeros_like(keep)
        if (G, dtype) == (G_MAIN, torch.float32) or (G, dtype) == (G_MAIN, torch.float64):
            check(plan.shared or force == "streamed", f"sf_newton {what}: plan {plan} is not in shared memory")
        if G == SF_STREAMED_G:
            check(not plan.shared, f"sf_newton {what}: plan {plan} is not streamed")
        label = f"sf_newton {'f32' if dtype == torch.float32 else 'f64'} {G} x {N} {what}"
        plans[label] = plan._asdict()
        sk = sz._sf_newton_cuda(c, coef, sf0, inv_sf0, s0, disp, keep, 0.5, 8, plan=plan)
        sk2 = sz._sf_newton_cuda(c, coef, sf0, inv_sf0, s0, disp, keep, 0.5, 8, plan=plan)
        sp = sz._sf_newton_plain(c, coef, sf0, inv_sf0, s0, disp, keep, 0.5, 8)
        stol = 1e-5 if dtype == torch.float32 else 1e-12
        e_s = (sk - sp).abs().max().item()
        check(bits_equal(sk, sk2), f"{label}: a second launch differs from the first")
        check(e_s <= stol, f"{label}: log size factor err {e_s:.3g} > {stol}")
        if force == "none kept":
            check(bits_equal(sk, s0), f"{label}: s moved without a kept gene")
        log(f"  {label}: plan {plan}, 8 steps err {e_s:.3g} (tol {stol}), repeat bit-equal")
        del c, coef, disp, keep, sk, sk2, sp
    # -- trend_fit and trend on seeded lanes: the tolerances of
    # class_kernel_checks' trend_fit (1e-4 f32; f64 1e-7 where the fit
    # converges, 1e-6 where it stops at its 60th iterate), the same
    # converged / failed flags, rounds within 1 in f32 and equal in f64.
    for G in TREND_LANES:
        for dtype in (torch.float32, torch.float64):
            f32 = dtype == torch.float32
            cov, tar, valid, bm = kernel_bench.trend_lanes(G, dtype)
            auto = tr._trend_plan(G, cov.element_size())
            check(auto.shared, f"trend_fit {G} lanes: plan {auto} does not keep the lanes in shared memory")
            want = tr._trend_fit_plain(cov, tar, valid, 60)
            ctol = 1e-4 if f32 else (1e-7 if bool(want[2]) else 1e-6)
            nz = valid
            mean_disp = tar[valid].mean()
            want_t = tr._parametric_trend_plain(bm, tar, nz, mean_disp, 20)
            for plan in (auto, auto._replace(shared=False)):
                tag = f"{'f32' if f32 else 'f64'} {G} lanes, K {plan.K} {'shared' if plan.shared else 'streamed'}"
                label = f"trend_fit {tag}"
                plans[label] = plan._asdict()
                got = tr._trend_fit_cuda(cov, tar, valid, 60, plan=plan)
                again = tr._trend_fit_cuda(cov, tar, valid, 60, plan=plan)
                check(bits_equal(got[0], again[0]) and bits_equal(got[1], again[1]),
                      f"{label}: a second launch differs from the first")
                e_c = rel_err(got[0].double(), want[0].double(), 1e-300)
                e_p = rel_err(got[1].double(), want[1].double(), 1e-300)
                check(bool(got[2]) == bool(want[2]), f"{label}: converged {bool(got[2])}, plain {bool(want[2])}")
                check(e_c <= ctol and e_p <= ctol, f"{label}: coefficient rel err {e_c:.3g}, predictions {e_p:.3g} "
                                                   f"> {ctol}")
                gt = tr._parametric_trend_cuda(bm, tar, nz, mean_disp, 20, plan=plan)
                gt2 = tr._parametric_trend_cuda(bm, tar, nz, mean_disp, 20, plan=plan)
                check(bits_equal(gt[0], gt2[0]) and bits_equal(gt[1], gt2[1]),
                      f"trend {tag}: a second launch differs from the first")
                e_t = rel_err(gt[1].double(), want_t[1].double(), 1e-300)
                rk, rp = int(gt[3]), int(want_t[3])
                check(bool(gt[2]) == bool(want_t[2]), f"trend {tag}: failed {bool(gt[2])}, plain "
                                                       f"{bool(want_t[2])}")
                check(e_t <= ctol, f"trend {tag}: coefficient rel err {e_t:.3g} > {ctol}")
                check(abs(rk - rp) <= (1 if f32 else 0), f"trend {tag}: {rk} rounds, plain {rp}")
                log(f"  {label}: coefficient rel err {e_c:.3g}, predictions {e_p:.3g} (tol {ctol}), converged "
                    f"{bool(got[2])}; trend: rel err {e_t:.3g}, rounds {rk} (plain {rp}); repeats bit-equal")
    return plans


def cooks_case(G: int, N: int, sizes, dtype, seed: int, ties: bool = False):
    """The ``cooks`` wrapper's summary-mode arguments for G genes of N
    samples in shuffled cohorts of ``sizes`` members (None: one trimmed
    variance over all samples), from a numpy seed: Poisson counts at
    lognormal gene means times size factors around 1 (``ties``: means
    0.1-3 and unit size factors, so zeros and equal counts fill both
    boundaries), an outlier at 20x the row maximum in every 50th gene, H
    uniform below 4 / N, a cutoff of 4.8, every sample in use_for_max."""
    rng = np.random.default_rng(seed)
    if ties:
        base, sf = rng.uniform(0.1, 3.0, G), np.ones(N)
    else:
        base, sf = rng.lognormal(3.0, 1.5, G), np.exp(rng.normal(0.0, 0.3, N))
    mu = base[:, None] * sf[None, :]
    counts = rng.poisson(mu).astype(np.float64)
    counts[::50, 0] = counts[::50].max(1) * 20 + 10
    H = rng.uniform(0.0, 4.0 / N, (G, N))
    cohort_ids = None
    if sizes is not None:
        ids = np.repeat(np.arange(len(sizes)), sizes)
        rng.shuffle(ids)
        cohort_ids = tuple(int(c) for c in ids)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=DEVICE)

    return (t(counts), t(sf), t(mu), t(H), torch.as_tensor((counts > 0).any(1), device=DEVICE), 2, cohort_ids,
            (True,) * N, t(4.8))


def select_case(kind: str, C: int, L: int, dtype, seed: int):
    """``(x, ranks)`` of a ``select`` check on the card: ``tile`` the
    log-ratios of (L, C) Poisson counts with rows holding a zero at +inf and
    the middle ranks (axis 0); ``column`` an (L, 1) column of normal values,
    ~10% at +inf, its middle ranks; ``empty`` an (L, 1) column of +inf (no
    valid value: ranks 0)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if kind == "tile":
        base = torch.exp(3.0 + 1.5 * torch.randn(L, generator=g, device=DEVICE, dtype=torch.float64))
        counts = torch.poisson(base[:, None].expand(L, C).contiguous(), generator=g).to(dtype)
        logc = torch.log(counts)
        lm = logc.mean(1)
        ok = torch.isfinite(lm)
        x = torch.where(ok[:, None], logc - lm[:, None], torch.full_like(logc, math.inf))
        n = ok.sum()
    elif kind == "column":
        vals = torch.randn(L, generator=g, device=DEVICE, dtype=torch.float64)
        off = torch.rand(L, generator=g, device=DEVICE) < 0.1
        x = torch.where(off, math.inf, vals).to(dtype)[:, None]
        n = (~off).sum()
    else:
        x = torch.full((L, 1), math.inf, dtype=dtype, device=DEVICE)
        n = torch.zeros((), dtype=torch.int64, device=DEVICE)
    return x, (torch.clamp((n - 1) // 2, min=0), n // 2)


def select_plan_checks() -> dict:
    """Phase 2, ``select`` in every plan (``ops/select.py:_select_plan``),
    each launched twice: both launches bit for bit the sorted keys' element
    at each rank (``order_stats_select_plain``). Many columns: the
    size-factor tile 100 x 60000 (groups of 8 f32 / 4 f64 columns, K = 16)
    in both types, and 1000 x 60000 f32; one column of 60000 and of 60001
    (not a multiple of K) at each cluster size K = 1-16, staged where it
    fits and streamed, in both types; one column at the staged/streamed
    threshold of 16 blocks and one past it (f32, f64); a column with no
    valid value; a column of 777 (one block). Returns {label: plan}."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import select as sel

    plans = {}

    def one(label, x, ranks, plan):
        got = sel._order_stats_select_cuda(x, ranks, 0, plan=plan)
        again = sel._order_stats_select_cuda(x, ranks, 0, plan=plan)
        want = sel.order_stats_select_plain(x, ranks, 0)
        for a, b, c in zip(got, again, want):
            check(torch.equal(sel._monotone_key(a), sel._monotone_key(c)), f"select {label}: not the sorted element")
            check(torch.equal(sel._monotone_key(a), sel._monotone_key(b)), f"select {label}: a second launch differs")
        plans[label] = plan._asdict()

    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        isz = torch.finfo(dtype).bits // 8
        cases = [("tile", 100, 60_000), ("column", 1, 60_000), ("column", 1, 60_001), ("empty", 1, 5_000),
                 ("column", 1, 777)]
        if dtype == torch.float32:
            cases.append(("tile", 1_000, 60_000))
        edge = plan_edge(lambda L: sel._select_plan(1, L, isz).staged, 1, 1 << 22)
        cases += [("column", 1, edge), ("column", 1, edge + 1)]
        for i, (kind, C, L) in enumerate(cases):
            x, ranks = select_case(kind, C, L, dtype, 10 + i)
            plan = sel._select_device_plan(C, L, dtype, x.device)
            one(f"{name} {kind} {C} x {L}", x, ranks, plan)
            if kind == "column" and L in (60_000, 60_001):
                for K in (1, 2, 4, 8, 16):
                    for staged in (True, False):
                        p = plan._replace(K=K, staged=staged)
                        if sel._select_smem_bytes(1, -(-L // K), isz, staged) <= kernels.SMEM_BLOCK_MAX:
                            one(f"{name} column {L} K={K} {'shared' if staged else 'streamed'}", x, ranks, p)
            log(f"  select {name} {kind} {C} x {L}: plan {plan}, both launches the sorted elements"
                + (f" (staged/streamed edge {edge})" if L in (edge, edge + 1) else ""))
            del x
    return plans


def select_hist_checks(timings: dict) -> dict:
    """Phase 2, ``select_hist`` and ``select_pick`` (the radix passes of the
    gene mesh's sharded size-factor median and their digit picks) in every
    path of ``csrc/select.cu``: the size-factor tile 100 x 60000 (a warp a
    column over staged chunks in passes 0-1, each thread on the keys it
    loaded in the sparse later passes; 16-byte loads in the six full
    16-column groups, the last group of 4 columns by scalar loads) and one
    four-rank shard of it (15000 genes) in both types, blocks of 777 rows
    (L no multiple of it, nor of a chunk) on the tile,
    8000 samples x 6000 genes in both types, 101 samples (rows of 101
    values: scalar staging everywhere), the tile's transpose reduced over
    axis 1 (a column view, read in place) in both types, one column of
    60000 and one of 777 with nothing valid. Every pass with the digits the
    passes before resolved, each launched twice, bit for bit
    ``select_hist_plain``; on each case's first plan the pick launch of
    every pass bit for bit ``radix_pick`` (digits and ranks), twice, and
    the last pass's median bit for bit ``masked_median_select``; then
    ``sharded_masked_median`` on one rank under each plan, bit for bit
    ``masked_median_select``. Times at 100 x
    60000 float32: each pass, the pick, the plain versions, ``torch.bincount``
    of pass 0's masked bins, the whole one-rank median (device and host
    clock). Returns {"select_hist": max_abs_err, "select_pick": ...}."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.kernel_bench import wall_ms
    from pydeseq2_tpu_torch.ops import select as sel

    def same_bits(a, b):
        return torch.equal(sel._monotone_key(a), sel._monotone_key(b))

    err = pick_err = 0
    cases = []
    for dtype in (torch.float32, torch.float64):
        cases += [("tile", N_MAIN, G_MAIN, dtype, "tile"), ("shard", N_MAIN, G_MAIN // 4, dtype, "tile"),
                  ("wide", N_HIST_WIDE, G_HIST_WIDE, dtype, "tile"), ("column view", N_MAIN, G_MAIN, dtype, "view")]
    cases += [("unaligned rows", N_MAIN + 1, G_MAIN, torch.float32, "tile"),
              ("one column", 1, G_MAIN, torch.float32, "column"), ("nothing valid", 1, 777, torch.float32, "empty")]
    for label, C, L, dtype, kind in cases:
        name = "f32" if dtype == torch.float32 else "f64"
        npass = sel._passes(dtype)
        x, _ = select_case("tile" if kind == "view" else kind, C, L, dtype, 50)
        axis = 0
        if kind == "view":
            x, axis = x.T.contiguous(), 1  # (C, L): a column's values adjacent, read in place
        n = torch.isfinite(x).sum(axis)  # (C,) valid counts
        cols = sel._columns(x, axis)
        plan = sel._hist_device_plan(cols)
        plans = [("", plan)]
        if label == "tile":
            plans.append((" rows 777", plan._replace(rows=777)))
        want_med = sel.masked_median_select(x, n, axis=axis)
        for tag, pl in plans:
            digits = torch.zeros((C, 2, npass), dtype=torch.uint8, device=x.device)
            rank = sel._mid_ranks(n)
            r_cur, at_pass = torch.zeros((C, 2), dtype=torch.int32, device=x.device), []
            for p in range(npass):
                what = f"select_hist {label} {name} {C} x {L}{tag} pass {p}"
                got = sel._select_hist_cuda(x, digits, p, axis, pl)
                again = sel._select_hist_cuda(x, digits, p, axis, pl)
                want = sel.select_hist_plain(x, digits, p, axis)
                check(torch.equal(got, want), f"{what}: differs from the plain counts")
                check(torch.equal(got, again), f"{what}: a second launch differs")
                check(int(got[0, 0].sum()) > 0, f"{what}: no key matched")
                err = max(err, int((got - want).abs().max()))
                at_pass.append(digits.clone())
                if tag == "":
                    outs = []
                    for _ in range(2):
                        d_k, r_out = digits.clone(), r_cur.clone()
                        med = torch.empty(C, dtype=dtype, device=x.device) if p == npass - 1 else None
                        sel._select_pick_cuda(got, n, r_out, d_k, p, med)
                        outs.append((d_k, r_out, med))
                rank = sel.radix_pick(got, rank, digits, p)
                if tag == "":
                    for d_k, r_out, med in outs:
                        check(torch.equal(d_k, digits) and torch.equal(r_out.to(torch.int64), rank),
                              f"select_pick {label} {name} {C} x {L} pass {p}: not radix_pick's digits and ranks")
                        pick_err = max(pick_err, int((r_out.to(torch.int64) - rank).abs().max()))
                        if med is not None:
                            check(same_bits(med, want_med.reshape(-1)),
                                  f"select_pick {label} {name} {C} x {L}: the last pick's median is not the select "
                                  "kernel's")
                    r_cur = outs[0][1]
            v = sel._decode(digits, dtype)
            med = torch.where(n > 0, (v[:, 0] + v[:, 1]) / 2.0, torch.full_like(v[:, 0], math.nan))
            check(same_bits(med, want_med.reshape(-1)),
                  f"select_hist {label} {name} {C} x {L}{tag}: the radix median is not the select kernel's")
            if label == "tile" and dtype == torch.float32 and tag == "":
                hist_at_pass, hist_plan = at_pass, pl
        for tag, pl in plans:
            med = sel.sharded_masked_median(x, n, axis=axis, plan=pl)
            check(same_bits(med, want_med), f"select_hist {label} {name} {C} x {L}{tag}: the one-rank median is "
                  "not the select kernel's")
        log(f"  select_hist {label} {name} {C} x {L}: plan {plan._asdict()}, {len(plans)} plan(s) x {npass} passes "
            "bit for bit the plain counts, twice; the picks radix_pick's, twice; the one-rank median bit for bit the "
            "select kernel's")
        if label == "tile" and dtype == torch.float32:
            keys = sel._unsigned_key(x).T  # (C, L)
            bins = (torch.arange(C * 2, device=x.device).reshape(C, 2, 1) * 256 + (keys >> 24)[:, None, :])
            bins = bins.expand(C, 2, L).reshape(-1)
            per_pass = [cuda_ms(lambda p=p: sel._select_hist_cuda(x, hist_at_pass[p], p, 0, hist_plan), 20)
                        for p in range(npass)]
            hist0 = sel.select_hist_plain(x, hist_at_pass[0], 0)
            r_out = torch.zeros((C, 2), dtype=torch.int32, device=x.device)
            d_k = torch.zeros((C, 2, npass), dtype=torch.uint8, device=x.device)
            kernels.STATS.reset()
            sel.sharded_masked_median(x, n)
            median_launches = {k: v for k, v in kernels.STATS.launches.items() if v}
            timings["select_hist"] = {
                "ms": per_pass[0],
                "ms_per_pass": per_pass,
                "passes": npass,
                "plain_ms": cuda_ms(lambda: sel.select_hist_plain(x, hist_at_pass[0], 0), 20),
                # one torch.bincount of pass 0's bins (every key matches at pass 0)
                "library_ms": cuda_ms(lambda: torch.bincount(bins, minlength=C * 2 * 256), 20),
                # one pass: each key read once, the counts written once, the digits read
                "bytes": x.numel() * x.element_size() + C * 2 * 256 * 4 + C * 2 * npass,
                # ~12 warp instructions a key (load, key map, prefix tests,
                # digit, match and count: an estimate from the source) at
                # the instruction issue rate
                "ops": 12 * C * L,
                "ops_per_s": INSTR_PER_S,
                "plan": hist_plan._asdict(),
                # the whole one-rank median: passes, picks and the zeroed buffer
                "median_ms": cuda_ms(lambda: sel.sharded_masked_median(x, n), 20),
                "median_wall_ms": wall_ms(lambda: sel.sharded_masked_median(x, n), 20),
                "median_launches": median_launches,
            }
            timings["select_pick"] = {
                "ms": cuda_ms(lambda: sel._select_pick_cuda(hist0, n, r_out, d_k, 0), 20),
                "plain_ms": cuda_ms(lambda: sel.select_pick_plain(hist0, n, r_out, d_k, 0), 20),
                "library_ms": None,
                # the totals read once; the counts, ranks and digits of the pass
                "bytes": C * 2 * 256 * 4 + C * 8 + C * 2 * (4 + 1),
                # one add a bin of the running count of each (column, rank)
                "ops": C * 2 * 256,
                "ops_per_s": INSTR_PER_S,
            }
            log(f"  select_hist f32 {C} x {L}: {[round(t, 4) for t in per_pass]} ms a pass, plain "
                f"{timings['select_hist']['plain_ms']:.4f} ms, torch.bincount {timings['select_hist']['library_ms']:.4f}"
                f" ms; select_pick {timings['select_pick']['ms']:.4f} ms (plain {timings['select_pick']['plain_ms']:.4f}"
                f"); the one-rank median {timings['select_hist']['median_ms']:.4f} ms by events, "
                f"{timings['select_hist']['median_wall_ms']:.4f} ms by the host clock, launches {median_launches}")
        del x
    return {"select_hist": float(err), "select_pick": float(pick_err)}


def irls_case(G: int, N: int, P: int, dtype, seed: int) -> dict:
    """Phase 1 operands of ``irls`` at (G, N, P): ``make_data`` counts and
    design (P > 2 adds indicator columns of a seeded batch), median-of-ratios
    size factors, seeded dispersions around 0.14, ``irls_beta_init``."""
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G, seed=seed)
    if P > 2:
        batch = np.random.default_rng(seed + 1).integers(0, P - 1, N)
        X_np = np.column_stack([X_np] + [(batch == b).astype(float) for b in range(1, P - 1)])
    counts = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=DEVICE)
    X = torch.as_tensor(X_np, dtype=dtype, device=DEVICE)
    logc = torch.log(counts)
    ok = torch.isfinite(logc.mean(1))
    sf = torch.exp(torch.median(logc[ok] - logc[ok].mean(1, keepdim=True), dim=0).values)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    disp = torch.clamp(torch.exp(-2.0 + torch.randn(G, generator=g, device=DEVICE, dtype=torch.float64)),
                       1e-4, 10.0).to(dtype)
    return {"counts": counts, "sf": sf, "X": X, "disp": disp, "beta_init": irl.irls_beta_init(counts, sf, X)}


def irls_plain_of(ops: dict, maxiter: int):
    """The plain loop on ``ops`` (``irls_case``'s keys) with PyTorch's
    deviance constant and the pipelines' tolerances for the type:
    ``(beta, needs_fb, n_iter)``."""
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.ops.nb import nb_nll

    counts, sf, X, disp, beta_init = (ops[k] for k in ("counts", "sf", "X", "disp", "beta_init"))
    f32 = counts.dtype == torch.float32
    beta_tol, step_tol = (1e-6, 1e-5) if f32 else (1e-8, 0.0)
    log_sf = torch.log(sf)[None, :]
    log_min_mu = torch.log(torch.tensor(0.5, dtype=counts.dtype, device=counts.device))
    mu0, log_mu0, _ = irl._mu_from_xb(beta_init, X, sf, log_sf, 0.5, log_min_mu)
    r = 1.0 / disp[:, None]
    nll_const = nb_nll(counts, mu0, disp) - irl._mu_part(counts, counts + r, r, mu0, log_mu0)
    return irl._irls_plain(counts, sf, X, disp, beta_init, nll_const, log_sf, 0.5, log_min_mu, beta_tol, 30.0,
                           maxiter, step_tol, 2)


def reordered_samples(ops: dict, seed: int | None) -> dict:
    """``ops`` with the samples reversed (``seed`` None) or in a seeded
    random order: the same fit, its float32 sums taken in another order."""
    N = ops["counts"].shape[1]
    dev = ops["counts"].device
    perm = (torch.arange(N - 1, -1, -1, device=dev) if seed is None
            else torch.as_tensor(np.random.default_rng(seed).permutation(N), device=dev))
    return {**ops, "counts": ops["counts"][:, perm].contiguous(), "sf": ops["sf"][perm].contiguous(),
            "X": ops["X"][perm].contiguous()}


# The sample orders irls_against_plain runs the plain loop in to read its
# own noise: reversed, and two seeded permutations.
IRLS_NOISE_ORDERS = (None, 1, 2)


def irls_mismatches(a, b, btol: float) -> tuple[torch.Tensor, int, int]:
    """(lanes whose coefficients differ beyond btol, the count of unequal
    flags, the slowest lanes' trip gap) of two IRLS results (beta,
    needs_fb, trips or n_iter)."""
    far = (a[0] - b[0]).abs().amax(1) > btol
    return far, int((a[1] != b[1]).sum()), abs(int(a[2].max()) - int(b[2].max()))


def irls_against_plain(label: str, ops: dict, maxiter: int, plan=None, own_noise: bool = False):
    """``irls`` with its own deviance constant against the plain loop with
    PyTorch's, a second launch bit for bit the first. The stated rule: at
    most 0.1% of lanes beyond 1e-4 (f32) / 1e-7 (f64) of the plain loop's
    coefficients, at most 0.1% with other flags, the slowest lanes' trips
    at most one apart. ``own_noise`` (:func:`irls_plan_checks`' float32
    checks at P > 2 and on phase-2 tiles only, where the plain loop misses
    that rule against itself: its stop compares deviances that round to
    1/16 at ~1e6, so a sum taken in another order moves a lane's stop)
    also runs the plain loop on its samples in other
    orders (IRLS_NOISE_ORDERS) and lets the kernel miss the rule as far:
    its counts by the plain loop's worst count plus three standard
    deviations of it (sqrt of the count), its trip gap by the plain loop's
    worst gap; and a lane beyond the coefficient tolerance whose float64
    objective ties with the plain point's (within TIE_UNITS rounding units,
    as ``agree_or_tie`` holds the rescue tiers) counts as agreeing. Returns
    (beta, needs_fb, trips, plan) of the kernel."""
    from pydeseq2_tpu_torch.ops import irls as irl

    counts, sf, X, disp, beta_init = (ops[k] for k in ("counts", "sf", "X", "disp", "beta_init"))
    f32 = counts.dtype == torch.float32
    beta_tol, step_tol, btol = (1e-6, 1e-5, 1e-4) if f32 else (1e-8, 0.0, 1e-7)
    G, N = counts.shape
    if plan is None:
        plan = irl._irls_device_plan(G, N, X.shape[1], counts.dtype, counts.device)
    log_sf = torch.log(sf)
    args = (counts, sf, X, disp, beta_init, log_sf, 0.5, beta_tol, 30.0, maxiter, step_tol, 2)
    bk, fbk, trips = irl._irls_cuda(*args, plan=plan)
    bk2, fbk2, trips2 = irl._irls_cuda(*args, plan=plan)
    check(bits_equal(bk, bk2) and torch.equal(fbk, fbk2) and torch.equal(trips, trips2),
          f"irls {label}: a second launch differs from the first")
    plain = irls_plain_of(ops, maxiter)
    far, n_flags, gap = irls_mismatches((bk, fbk, trips), plain, btol)
    ties = 0
    if own_noise and bool(far.any()):
        f_k = nb_objective64(counts[far], sf, X, disp[far], bk[far])
        f_p = nb_objective64(counts[far], sf, X, disp[far], plain[0][far])
        unit = noise_unit(N, counts.dtype) * term_scale(counts[far])
        ties = int(((f_k - f_p).abs() / unit <= TIE_UNITS).sum())
    n_far = int(far.sum()) - ties
    allow = [G // 1000, G // 1000, 1]
    noise = ""
    if own_noise:
        own = [irls_mismatches(irls_plain_of(reordered_samples(ops, seed), maxiter), plain, btol)
               for seed in IRLS_NOISE_ORDERS]
        worst = (max(int(o[0].sum()) for o in own), max(o[1] for o in own), max(o[2] for o in own))
        allow = [max(allow[0], worst[0] + math.ceil(3 * math.sqrt(worst[0]))),
                 max(allow[1], worst[1] + math.ceil(3 * math.sqrt(worst[1]))), max(allow[2], worst[2])]
        noise = (f"; the plain loop against itself in {len(own)} other sample orders: lanes beyond "
                 f"{[int(o[0].sum()) for o in own]}, flags {[o[1] for o in own]}, slowest lanes "
                 f"{[o[2] for o in own]} trips apart")
    check(n_far <= allow[0], f"irls {label}: {n_far} lanes beyond {btol}" + (" and not a tie" if own_noise else "")
          + f" (allowed {allow[0]})")
    check(n_flags <= allow[1], f"irls {label}: {n_flags} lanes' flags differ (allowed {allow[1]})")
    check(gap <= allow[2], f"irls {label}: slowest lane {int(trips.max())} trips, plain loop {int(plain[2])}")
    log(f"  irls {label}: plan {plan}, {G} lanes: {int(far.sum())} beyond {btol}"
        + (f" ({ties} objective ties)" if own_noise else "") + f", {n_flags} flags differ, slowest lane {int(trips.max())} trips (plain loop {int(plain[2])}); second "
        "launch bit-equal" + noise)
    return bk, fbk, trips, plan


def phase2_tile(ops: dict, needs_fb: torch.Tensor, beta: torch.Tensor) -> dict:
    """The compacted tile ``_irls_with_rescue`` hands phase 2: K = max(512,
    G/64) lanes, the unfinished first (stable), continuing from phase 1's
    iterate."""
    G = ops["counts"].shape[0]
    K = min(G, max(512, G // 64))
    idx = torch.argsort((~needs_fb).to(torch.int8), stable=True)[:K]
    return {"counts": ops["counts"][idx].contiguous(), "sf": ops["sf"], "X": ops["X"],
            "disp": ops["disp"][idx].contiguous(), "beta_init": beta[idx].contiguous()}


# irls' plan checks: (samples, genes in float32, genes in float64); the
# float32 shapes run every group size: 4 lanes a gene at 12 samples (8 at
# P = 5), 8 at 100, 32 at 1000 and on the phase-2 tiles, a block a gene at
# 10000 samples.
IRLS_PLAN_SHAPES = ((12, 60_000, 20_000), (100, 60_000, 20_000), (1_000, 6_000, 2_000), (10_000, 600, 300))


def irls_plan_checks() -> dict:
    """Phase 2, ``irls`` with the deviance constant it computes itself, at
    P = 2, 3, 5 on IRLS_PLAN_SHAPES in float32 and float64: phase 1
    (maxiter = 8) and the phase-2 tile it leaves (maxiter = 242), each
    launched twice and held to the plain loop by
    :func:`irls_against_plain`: by the stated rule, but in float32 at P > 2
    and on the float32 phase-2 tiles, where the plain loop misses that rule
    against itself in other sample orders (flags at P > 2; the slowest
    lane of a tile's long loops, up to 2 trips), by the plain loop's
    agreement with itself where that is lower. Returns {label: plan}."""
    plans = {}
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        f32 = dtype == torch.float32
        for N, g32, g64 in IRLS_PLAN_SHAPES:
            G = g32 if f32 else g64
            for P in (2, 3, 5):
                ops = irls_case(G, N, P, dtype, seed=P)
                label = f"{name} {N} x {G} P={P}"
                bk, fbk, _, plan = irls_against_plain(f"{label} phase 1", ops, 8, own_noise=f32 and P > 2)
                plans[f"{label} phase 1"] = plan._asdict()
                tile = phase2_tile(ops, fbk, bk)
                K = tile["counts"].shape[0]
                plans[f"{label} phase 2 ({K} lanes)"] = irls_against_plain(
                    f"{label} phase 2 tile of {K} lanes", tile, 242, own_noise=f32)[3]._asdict()
                del ops, tile, bk, fbk
                torch.cuda.empty_cache()
    return plans


# mom's plan checks: (samples, genes in float32, genes in float64), every
# lane-group plan the row takes, on each side of the staged/streamed edge.
MOM_PLAN_SHAPES = ((12, 20_000, 4_000), (100, G_MAIN, 4_000), (1_000, 6_000, 2_000), (10_000, 600, 300))


def mom_case(G: int, N: int, P: int, dtype, normed: bool):
    """(counts, sf, X, pinv) of one ``mom`` call on ``make_data(N, G)``: the
    draw's design (P = 1 its intercept, P = 5 with indicators of a seeded
    4-level batch), median-of-ratios size factors, the counts divided by
    them where ``normed``."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G)
    X_np = X_np[:, :P]
    if P > 2:
        batch = np.random.default_rng(1).integers(0, P - 1, N)
        X_np = np.column_stack([X_np] + [(batch == b).astype(float) for b in range(1, P - 1)])
    c = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=DEVICE)
    X = torch.as_tensor(X_np, dtype=dtype, device=DEVICE)
    logc = torch.log(c)
    ok = torch.isfinite(logc.mean(1))
    sf = torch.exp(torch.median(logc[ok] - logc[ok].mean(1, keepdim=True), dim=0).values)
    return (c / sf if normed else c), sf, X, torch.linalg.pinv(X)


def mom_plan_list(lin, N: int, itemsize: int) -> list:
    """The plan the wrapper picks for N samples, every register plan that
    holds the row, and 32 lanes and a block with the row staged as the
    picker stages it and with part of it streamed (divided again in the
    second pass)."""
    plans = [lin._mom_plan(N, itemsize)]
    for lanes in (4, 8, 32):
        if N <= lin._MOM_REG_ITEMS * lanes:
            plans.append(lin.MomPlan(lanes, 0))
    for lanes, budget in ((32, lin._MOM_GROUP_STAGE), (lin._MOM_BLOCK, lin._MOM_BLOCK_STAGE)):
        plans += [lin.MomPlan(lanes, min(N, budget // itemsize)), lin.MomPlan(lanes, max(1, N // 3))]
    return list(dict.fromkeys(plans))


def mom_errs(got, want) -> dict:
    """``mom_check``'s measure of two ``mom_and_mu_coef`` results, by
    output: relative, absolute below 1; coefficients relative to the
    gene's largest."""
    errs = {}
    for key, a, b in zip(("rough", "moments", "coef", "mu"), got, want):
        if b is None:
            continue
        if key == "coef":
            errs[key] = ((a - b).abs() / torch.clamp(b.abs().amax(1, keepdim=True), min=1.0)).max().item()
        else:
            errs[key] = scaled_err(a, b)
    return errs


def mom_plain_noise(lin, c, sf, X, pinv, normed) -> dict:
    """The plain version against itself with the samples reversed (the
    same function, its float32 sums and products in another order), by
    output: the rounding noise of the reference."""
    want = lin._mom_plain(c, sf, X, pinv, 0.5, True, normed)
    rev = lin._mom_plain(c.flip(1), sf.flip(0), X.flip(0), pinv.flip(1), 0.5, True, normed)
    return mom_errs((*rev[:3], rev[3].flip(1)), want)


def mom_plan_checks() -> dict:
    """``mom`` in every plan (``mom_plan_list``) at 12, 100, 1000 and 10000
    samples (MOM_PLAN_SHAPES), P = 2 on raw counts, and in the picked plan
    and one staged and one streamed plan at P = 1, 5 and in the normed-count
    mode, float32 and float64: each launched twice and equal to itself bit
    for bit, with and without mu, within ``mom_check``'s tolerances of the
    plain version (1e-5 / 1e-12 relative, absolute below 1; coefficients
    relative to the gene's largest). Where the plain version misses that
    tolerance against itself with its samples reversed
    (``mom_plain_noise``: 12 samples at P = 5, 7 residual degrees of
    freedom, where a rough estimate sums terms of very different sizes),
    its own disagreement is the limit of that output, as ``irls``'s plan
    checks take the plain loop's. Returns {label: picked plan}."""
    from pydeseq2_tpu_torch.ops import linreg as lin

    picked = {}
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        isz = torch.finfo(dtype).bits // 8
        for N, g32, g64 in MOM_PLAN_SHAPES:
            G = g32 if dtype == torch.float32 else g64
            every = mom_plan_list(lin, N, isz)
            for P, normed in ((2, False), (1, False), (5, False), (2, True)):
                c, sf, X, pinv = mom_case(G, N, P, dtype, normed)
                label = f"{name} {N} x {G} P={P}{' normed' if normed else ''}"
                plans = every if (P, normed) == (2, False) else [every[0], every[-4], every[-1]]
                want = lin._mom_plain(c, sf, X, pinv, 0.5, True, normed)
                noise = mom_plain_noise(lin, c, sf, X, pinv, normed)
                limit = {k: max(rtol, v) for k, v in noise.items()}
                worst = {}
                for plan in dict.fromkeys(plans):
                    got = lin._mom_cuda(c, sf, X, pinv, 0.5, True, normed, plan=plan)
                    again = lin._mom_cuda(c, sf, X, pinv, 0.5, True, normed, plan=plan)
                    no_mu = lin._mom_cuda(c, sf, X, pinv, 0.5, False, normed, plan=plan)
                    check(all(bits_equal(a, b) for a, b in zip(got, again)),
                          f"mom {label} plan {tuple(plan)}: a second launch differs")
                    check(no_mu[3] is None and all(bits_equal(a, b) for a, b in zip(no_mu[:3], got[:3])),
                          f"mom {label} plan {tuple(plan)}: the launch without mu differs")
                    for key, e in mom_errs(got, want).items():
                        worst[key] = max(worst.get(key, 0.0), e)
                        check(e <= limit[key], f"mom {label} plan {tuple(plan)} {key}: rel err {e:.3g} > "
                                               f"{limit[key]:.3g} (the plain version against itself {noise[key]:.3g})")
                picked[label] = every[0]._asdict()
                log(f"  mom plans {label}: {[tuple(p) for p in dict.fromkeys(plans)]} (picked {tuple(every[0])}), "
                    f"each launched twice, bits equal; rel err (abs below 1) "
                    + ", ".join(f"{k} {v:.3g} (limit {limit[k]:.3g}, plain against itself {noise[k]:.3g})"
                                for k, v in worst.items()))
                del c, want
                torch.cuda.empty_cache()
    return picked


# hat_wald's plan checks: (samples, genes float32, genes float64) on each
# side of every threshold of ops/wald.py:_hat_wald_plan (64, 128, 512, 2048
# samples; a 32-lane group stages 1024 float32 / 512 float64 samples, a
# block 12288 / 6144).
HW_PLAN_SHAPES = ((12, 20_000, 4_000), (64, 8_000, 2_000), (65, 8_000, 2_000), (100, G_MAIN, 4_000),
                  (128, 4_000, 1_000), (129, 4_000, 1_000), (512, 2_000, 500), (513, 2_000, 500),
                  (1_000, 6_000, 2_000), (2_047, 1_000, 300), (2_048, 1_000, 300), (10_000, 600, 300))


def hw_case(G: int, N: int, P: int, dtype) -> tuple:
    """``(beta, disp, sf, X, contrast)`` of one ``hat_wald`` call on
    ``make_data(N, G)``: the draw's design with P - 2 seeded normal columns
    (full rank at 12 samples), median-of-ratios size factors, the
    least-squares coefficients of log((counts + 0.5) / sf) (some samples'
    mu below min_mu), seeded lognormal dispersions, the contrast on the
    condition."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G)
    rng = np.random.default_rng(14)
    X_np = np.column_stack([X_np] + [rng.normal(size=N) for _ in range(P - 2)])
    c = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=DEVICE)
    X = torch.as_tensor(X_np, dtype=dtype, device=DEVICE)
    logc = torch.log(c)
    ok = torch.isfinite(logc.mean(1))
    sf = torch.exp(torch.median(logc[ok] - logc[ok].mean(1, keepdim=True), dim=0).values)
    beta = (torch.log((c + 0.5) / sf) @ torch.linalg.pinv(X).T).contiguous()
    disp = torch.as_tensor(rng.lognormal(-2.0, 1.0, G), dtype=dtype, device=DEVICE)
    contrast = torch.zeros(P, dtype=dtype, device=DEVICE)
    contrast[1] = 1.0
    return beta, disp, sf, X, contrast


def hw_check(label: str, got, want, rtol: float, tiny: float) -> dict:
    """``hat_wald`` outputs against the plain version's: the same NaN
    places, p below ``tiny`` where the plain p is (within 1e3), and each
    output within ``rtol`` (``kernel_bench.hat_errs``' measure). Returns
    the errors."""
    from pydeseq2_tpu_torch import kernel_bench

    for key, a, b in zip(("H", "mu", "p", "stat", "se"), got, want):
        if a is not None and b is not None:
            check(torch.equal(torch.isnan(a), torch.isnan(b)), f"{label} {key}: NaN masks differ")
    p_k, p_p = got[2], want[2]
    check(bool((p_k[(p_p < tiny) & ~torch.isnan(p_p)] < 1e3 * tiny).all()), f"{label}: p tail")
    errs = kernel_bench.hat_errs(got, want, tiny)
    for key, e in errs.items():
        check(e <= rtol, f"{label} {key}: rel err {e:.3g} > {rtol:.3g}")
    return errs


def hat_wald_plan_checks() -> dict:
    """``hat_wald.cu`` in every plan (``kernel_bench.hat_plans``: 4, 8, 32
    lanes and a block, each staging what its share of shared memory holds,
    and 32 lanes and a block staging a third of the row, the rest formed
    again in pass 2) at HW_PLAN_SHAPES (12, 100, 1000, 10000 samples and
    both sides of each threshold), P = 2, and in the picked, one staged and
    one streamed plan at P = 5, float32 and float64. In each plan: the
    fused entry launched twice and equal to itself bit for bit and within
    1e-4 (f32) / 1e-10 (f64) of the plain version on H, mu, p (log p over 1
    + stat^2), stat and se (the ``hat_wald`` tolerances); the test alone
    (``want_hat=False``) equal to the fused call's p, stat and se bit for
    bit; the ``hat`` entry equal to the fused call's H and mu bit for bit,
    twice; the ``wald`` entry on the fused call's mu with the 1e-6 ridge
    equal to its p, stat and se bit for bit, twice. In float64 at the
    picked plan every alternative hypothesis. Returns {label: picked
    plan}."""
    from pydeseq2_tpu_torch import kernel_bench
    from pydeseq2_tpu_torch.ops import irls as ir
    from pydeseq2_tpu_torch.ops import wald as wd

    picked = {}
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        rtol = 1e-4 if dtype == torch.float32 else 1e-10
        tiny = 1e-30 if dtype == torch.float32 else 1e-300
        isz = torch.finfo(dtype).bits // 8
        for N, g32, g64 in HW_PLAN_SHAPES:
            G = g32 if dtype == torch.float32 else g64
            every = list(kernel_bench.hat_plans(wd, N, isz).values())
            for P in (2, 5):
                beta, disp, sf, X, contrast = hw_case(G, N, P, dtype)
                label = f"hat_wald plans {name} {N} x {G} P={P}"
                plans = every if P == 2 else list(dict.fromkeys([every[0], wd._hat_wald_staged(32, N, isz), every[-1]]))
                ridge = 1e-6 * torch.eye(P, dtype=dtype, device=DEVICE)
                alts = list(wd.ALT_CODES) if dtype == torch.float64 else [None]
                worst = {}
                for alt in alts:
                    args = (beta, disp, sf, X, contrast, 0.0, 0.5, alt)
                    want = wd._hat_wald_plain(*args)
                    for plan in (plans if alt is None else plans[:1]):
                        what = f"{label} alt={alt} plan {tuple(plan)}"
                        got = wd._hat_wald_cuda(*args, plan=plan)
                        again = wd._hat_wald_cuda(*args, plan=plan)
                        check(all(bits_equal(a, b) for a, b in zip(got, again)), f"{what}: a second launch differs")
                        for key, e in hw_check(what, got, want, rtol, tiny).items():
                            worst[key] = max(worst.get(key, 0.0), e)
                        alone = wd._hat_wald_cuda(*args, want_hat=False, plan=plan)
                        check(alone[0] is None and alone[1] is None and
                              all(bits_equal(a, b) for a, b in zip(alone[2:], got[2:])),
                              f"{what}: the test alone differs from the fused call's")
                        wald = [wd._wald_cuda(X, disp, beta, got[1], ridge, contrast, 0.0, alt, plan=plan)
                                for _ in range(2)]
                        check(all(bits_equal(a, b) for w in wald for a, b in zip(w, got[2:])),
                              f"{what}: the wald entry on the fused call's mu differs from its test")
                        if alt is None:
                            hat = [ir._hat_cuda(sf, X, disp, beta, 0.5, plan=plan) for _ in range(2)]
                            check(all(bits_equal(a, b) for h in hat for a, b in zip(h, got[:2])),
                                  f"{what}: the hat entry differs from the fused call's H and mu")
                picked[label] = every[0]._asdict()
                log(f"  {label}: plans {[tuple(p) for p in plans]} (picked {tuple(every[0])}), alternatives "
                    f"{alts}, each launched twice, bits equal, the test alone, hat and wald entries bit for bit "
                    "the fused call's; rel err " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
                    + f" (tol {rtol})")
                del beta, want
                torch.cuda.empty_cache()
    return picked


# lowess checks: the points, and each draw's counts
LOWESS_POINTS = (2, 50, 64)


def lowess_checks() -> dict:
    """``lowess`` at 2, 50 and 64 points on a dyadic grid (a point's
    neighbours tie in distance exactly; one level repeated, a zero
    distance) with rising then level counts and an all-zero row, float32
    and float64: launched twice and bit for bit, the same row as the plain
    pick and the fit within 1e-6 (f32) / 1e-13 (f64), relative (absolute
    below 1), as phase 2's check on the run's operands. Returns {label:
    row}."""
    from pydeseq2_tpu_torch.ops import stats as st

    rows = {}
    for n in LOWESS_POINTS:
        theta = np.arange(n) / 64.0 + 1 / 128
        if n > 2:
            theta[n // 2] = theta[n // 2 - 1]
        rng = np.random.default_rng(41 + n)
        rising = np.maximum(0, 500 * np.minimum(theta / 0.3, 1.0) + rng.normal(0, 10, n)).round()
        for dtype in (torch.float32, torch.float64):
            ytol = 1e-6 if dtype == torch.float32 else 1e-13
            th = torch.as_tensor(theta, dtype=dtype, device=DEVICE)
            for kind, counts in (("counts", rising), ("all-zero", np.zeros(n))):
                rej = torch.as_tensor(counts, dtype=torch.int64, device=DEVICE)
                label = f"lowess {n} points {'f32' if dtype == torch.float32 else 'f64'} {kind}"
                (yk, jk), (y2, j2) = st._lowess_pick_cuda(th, rej, 0.2), st._lowess_pick_cuda(th, rej, 0.2)
                yp, jp = st._lowess_pick_plain(th, rej, 0.2)
                check(bits_equal(yk, y2) and int(jk) == int(j2), f"{label}: a second launch differs")
                check(int(jk) == int(jp), f"{label}: row {int(jk)}, plain {int(jp)}")
                e_y = scaled_err(yk, yp)
                check(e_y <= ytol, f"{label}: fit rel err {e_y:.3g} > {ytol:.3g}")
                if kind == "all-zero":
                    check(int(jk) == 0, f"{label}: all-zero counts must pick row 0")
                rows[label] = int(jk)
                log(f"  {label}: row {int(jk)} (plain {int(jp)}), fit rel err {e_y:.3g} (tol {ytol:.3g}), "
                    f"bits equal to the plain fit: {bits_equal(yk, yp)}")
    return rows


# bh's plan checks: gene counts of the draws, and the cutoff sets (see
# bh_cutoff_sets).
BH_PLAN_G = (1, 33, G_MAIN)


def bh_draw(G: int, seed: int = 40):
    """p-values with ties (rounded to 4 digits) and ~5% NaN, base means
    with ~10% zeros, a ~97% valid mask, as numpy arrays."""
    rng = np.random.default_rng(seed)
    p = np.where(rng.random(G) < 0.3, rng.uniform(0, 1e-3, G), rng.uniform(0, 1, G))
    p = np.round(p, 4)
    p[rng.random(G) < 0.05] = np.nan
    base_mean = np.where(rng.random(G) < 0.1, 0.0, rng.lognormal(2.0, 2.0, G))
    return p, base_mean, rng.random(G) < 0.97


def bh_cutoff_sets(base_mean: np.ndarray) -> dict:
    """The filter's 50 quantile cutoffs in order, the same shuffled, and an
    unsorted set with -inf, +inf, NaN, a repeat and a cutoff above every
    base mean (so three rows mask every gene out)."""
    cut = np.quantile(base_mean, np.linspace(0.1, 0.95, 50))
    rng = np.random.default_rng(41)
    edges = np.r_[cut[:44], np.inf, -np.inf, np.nan, cut[5], base_mean.max() * 2 + 1, 0.0]
    return {"sorted": cut, "unsorted": rng.permutation(cut), "edges": rng.permutation(edges)}


def bh_plan_checks() -> dict:
    """``bh_count`` and ``bh_adjust`` on BH_PLAN_G genes (p with ties and
    NaN, zero base means) under each cutoff set of ``bh_cutoff_sets``, in
    float64 and float32 operands: the counts against the plain
    ``(adj < alpha).sum(1)`` and every row j, picked by a 0-d tensor on the
    card, against the plain sweep's row, each launched twice and bit for
    bit; the one row without cutoffs; the picked row on clusters of 1, 2,
    4, 8 and 16 blocks (more than one round of the order below 15); 300
    rows of counts (two launches of at most 256). Returns {label: counts
    of the first rows}."""
    from pydeseq2_tpu_torch.ops import stats as st

    out = {}
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        for G in BH_PLAN_G:
            p_np, bm_np, valid_np = bh_draw(G)
            p = torch.as_tensor(p_np, dtype=dtype, device=DEVICE)
            order = torch.argsort(torch.nan_to_num(p, nan=2.0), stable=True)
            valid = torch.as_tensor(valid_np, device=DEVICE)
            bm = torch.as_tensor(bm_np, dtype=dtype, device=DEVICE)
            for cname, cut_np in bh_cutoff_sets(bm_np).items():
                cut = torch.as_tensor(cut_np, dtype=dtype, device=DEVICE)
                label = f"{name} {G} genes, {cname} cutoffs"
                adj_p, rej_p = st._bh_sweep_plain(p, order, valid, bm, cut, 0.05)
                for rep in range(2):
                    check(torch.equal(st._bh_count_cuda(p, order, valid, bm, cut, 0.05), rej_p),
                          f"bh {label}: counts differ from (adj < alpha).sum(1) (launch {rep + 1})")
                bad = [j for j in range(cut.shape[0]) for _ in range(2)
                       if not bits_equal(st.bh_adjust_row(p, order, valid, bm, cut,
                                                          torch.tensor(j, device=DEVICE)), adj_p[j])]
                check(not bad, f"bh {label}: rows {sorted(set(bad))} differ from the plain sweep's")
                out[label] = rej_p.tolist()[:4]
            one_p = st._bh_adjust_plain(p, order, valid, None, None, None)[0]
            for rep in range(2):
                check(bits_equal(st.bh_adjust_row(p, order, valid), one_p),
                      f"bh {name} {G} genes: the row without cutoffs differs (launch {rep + 1})")
            if G == G_MAIN:
                cut = torch.as_tensor(bh_cutoff_sets(bm_np)["unsorted"], dtype=dtype, device=DEVICE)
                want = st._bh_sweep_plain(p, order, valid, bm, cut, 0.05)[0][7]
                for K in (1, 2, 4, 8, 16):
                    got = st._bh_adjust_cuda(p, order, valid, bm, cut, torch.tensor(7, device=DEVICE), cluster=K)
                    check(bits_equal(got[0], want), f"bh {name}: the row on a cluster of {K} differs")
                many = torch.as_tensor(np.random.default_rng(42).permutation(
                    np.quantile(bm_np, np.linspace(0.0, 0.99, 300))), dtype=dtype, device=DEVICE)
                check(torch.equal(st._bh_count_cuda(p, order, valid, bm, many, 0.05),
                                  st._bh_sweep_plain(p, order, valid, bm, many, 0.05)[1]),
                      f"bh {name}: the counts of 300 rows differ")
    log(f"  bh plans: counts and every row bit for bit on {len(out)} draws, float64 and float32, each launched "
        f"twice; clusters of 1-16 blocks; 300 rows")
    return out


def plan_edge(fits, lo: int, hi: int) -> int:
    """The largest n in [lo, hi) with fits(n), fits monotone (True, then
    False)."""
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def trim_plan_checks() -> dict:
    """Phase 2, the trimmed moments of ``cooks`` and ``trimmed_var`` in
    every plan they have (``ops/stats.py:_trim_plan``), each launched twice
    (the second launch equal to the first bit for bit) and held to its
    plain version with the tolerances of ``cooks_check`` (1e-3 f32 / 1e-9
    f64 relative on the distances and the robust dispersion; flags equal but
    for genes at the cutoff in f32), of the streamed refit (the exceed bits
    and refit flags bit for bit but within 1e-5 / 1e-12 of the cutoff) and
    of ``class_kernel_checks``' trimmed_var (1e-6 f32 / 1e-12 f64 relative).
    ``cooks`` in summary and refit mode: at the atlas cohort shape
    (TRIM_ATLAS_G genes x N_ATLAS samples, two cohorts of 5000, f32) on
    lognormal and on tie-heavy counts; tie-heavy at 100 samples (cohorts of
    50, rank count) in both types and at 400 (cohorts of 200, a warp's radix
    select); cohorts of 3, 2, 1 and 7 members (k = 1, 0, 0, 1) and one
    trimmed variance over 7 samples (k = 0); cohort sizes rank_max and
    rank_max + 1; one cohort of the longest row a warp takes and one sample
    more (a block); the longest row a block holds in shared memory and one
    sample more (the streamed workspace), f64. ``trimmed_var``: cohorts of
    50 on tie-heavy counts in both types, of 3, 2, 1 and 7, of rank_max and
    rank_max + 1, of the longest a warp takes and one more; a column of
    TRIM_COLUMN dispersions (streamed) in both types, a tie-heavy column,
    and columns of the longest a block holds in shared memory and one more
    (f32), and of 1000 (a warp). Returns {label: plan}."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import cooks as ck
    from pydeseq2_tpu_torch.ops import stats as st

    sms = kernels.sm_count(torch.device(DEVICE))
    plans = {}
    f32, f64 = torch.float32, torch.float64

    def warp_edge(isz):
        return plan_edge(lambda n: not st._trim_plan(isz, [n], 4000, True, sms).block, 1, 1 << 16)

    def shared_edge(isz):
        return plan_edge(lambda n: st._trim_plan(isz, [n], 64, True, sms).shared, 1, 1 << 20)

    # -- cooks ----------------------------------------------------------------
    cooks_cases = [
        ("atlas cohorts", TRIM_ATLAS_G, N_ATLAS, [5000, 5000], f32, False),
        ("atlas cohorts, tie-heavy", TRIM_ATLAS_G, N_ATLAS, [5000, 5000], f32, True),
        ("tie-heavy, cohorts of 50", 4000, 100, [50, 50], f32, True),
        ("tie-heavy, cohorts of 50", 4000, 100, [50, 50], f64, True),
        ("tie-heavy, cohorts of 200", 1000, 400, [200, 200], f32, True),
        ("cohorts of 3, 2, 1, 7", 4000, 13, [3, 2, 1, 7], f64, False),
        ("cohorts of 3, 2, 1, 7", 4000, 13, [3, 2, 1, 7], f32, True),
        ("one trimmed variance over 7 samples", 4000, 7, None, f64, False),
    ]
    for dtype in (f32, f64):
        r = st._TRIM_RANK_MAX[torch.finfo(dtype).bits // 8]
        cooks_cases.append((f"cohorts of rank_max {r} and {r + 1}", 2000, 2 * r + 1, [r, r + 1], dtype, False))
        w = warp_edge(torch.finfo(dtype).bits // 8)
        for n in (w, w + 1):
            cooks_cases.append((f"one cohort of {n} (warp edge {w})", 1000, n, [n], dtype, False))
    e = shared_edge(8)
    for n in (e, e + 1):
        cooks_cases.append((f"one cohort of {n} (shared-memory edge {e})", 64, n, [n], f64, False))
    for i, (what, G, N, sizes, dtype, ties) in enumerate(cooks_cases):
        name = "f32" if dtype == f32 else "f64"
        cargs = cooks_case(G, N, sizes, dtype, 100 + i, ties)
        plan = st._trim_plan(torch.finfo(dtype).bits // 8, sizes or [N], G, True, sms)
        label = f"cooks {name} {G} x {N}, {what}"
        plans[label] = plan._asdict()
        got = ck._cooks_cuda(*cargs, plan=plan)
        again = ck._cooks_cuda(*cargs, plan=plan)
        check(all(bits_equal(a.double(), b.double()) for a, b in zip(got, again)),
              f"{label}: a second launch differs from the first")
        cooks_check(name, cargs, 0, {})
        repl = (True,) * N
        got = ck._cooks_cuda(*cargs, repl, False, plan=plan)
        again = ck._cooks_cuda(*cargs, repl, False, plan=plan)
        check(all(bits_equal(a.double(), b.double()) for a, b in zip(got[1:], again[1:])),
              f"{label} refit: a second launch differs from the first")
        refit_agree(f"{label} refit", got, ck._cooks_plain(*cargs, repl, True), cargs[8], dtype == f32)
        log(f"  {label}: plan {plan}, repeats bit-equal")
        del cargs, got, again

    # -- trimmed_var: cohorts (mode 1) and columns (mode 0) ---------------------
    def cells_of(sizes, rng):
        ids = np.repeat(np.arange(len(sizes)), sizes)
        rng.shuffle(ids)
        return ids

    trim_cases = [
        ("tie-heavy, cohorts of 50", 4000, [50, 50], f64, True),
        ("tie-heavy, cohorts of 50", 4000, [50, 50], f32, True),
        ("cohorts of 3, 2, 1, 7", 4000, [3, 2, 1, 7], f64, False),
    ]
    for dtype in (f32, f64):
        r = st._TRIM_RANK_MAX[torch.finfo(dtype).bits // 8]
        trim_cases.append((f"cohorts of rank_max {r} and {r + 1}", 2000, [r, r + 1], dtype, False))
        w = warp_edge(torch.finfo(dtype).bits // 8)
        for n in (w, w + 1):
            trim_cases.append((f"cohorts of {n} (warp edge {w})", 500, [n, n], dtype, False))
    for i, (what, G, sizes, dtype, ties) in enumerate(trim_cases):
        rng = np.random.default_rng(200 + i)
        N = sum(sizes)
        mean = rng.uniform(0.1, 3.0, G) if ties else rng.lognormal(3.0, 1.5, G)
        sf = np.ones(N) if ties else np.exp(rng.normal(0.0, 0.3, N))
        x = torch.as_tensor(rng.poisson(sf[:, None] * mean[None, :]) / sf[:, None], dtype=dtype, device=DEVICE)
        cells = cells_of(sizes, rng)
        plan = st._trim_plan(x.element_size(), sizes, G, False, sms)
        label = f"trimmed_var {'f32' if dtype == f32 else 'f64'} {G} genes, {what}"
        plans[label] = plan._asdict()
        got = st._trimmed_cell_variance_cuda(x, cells, plan)
        check(bits_equal(got, st._trimmed_cell_variance_cuda(x, cells, plan)),
              f"{label}: a second launch differs from the first")
        want = st._trimmed_cell_variance_plain(x, cells)
        vtol = 1e-6 if dtype == f32 else 1e-12
        e_v = rel_err(got.double(), want.double(), 1e-300)
        check(e_v <= vtol, f"{label}: rel err {e_v:.3g} > {vtol}")
        log(f"  {label}: plan {plan}, rel err {e_v:.3g} (tol {vtol}), {int((got != want).sum())} not bit-equal, "
            "repeat bit-equal")
    column_cases = [(TRIM_COLUMN, f32, False), (TRIM_COLUMN, f64, False), (TRIM_COLUMN, f32, True), (1000, f32, False)]
    e = shared_edge(4)
    column_cases += [(e, f32, False), (e + 1, f32, False)]
    for i, (n, dtype, ties) in enumerate(column_cases):
        rng = np.random.default_rng(300 + i)
        col = rng.lognormal(-2.0, 1.0, n)
        if ties:
            col = np.round(col * 20.0) / 20.0
        column = torch.as_tensor(col, dtype=dtype, device=DEVICE)
        plan = st._trim_plan(column.element_size(), [n], 1, False, sms)
        label = (f"trimmed_var {'f32' if dtype == f32 else 'f64'} column of {n}" + (", tie-heavy" if ties else "")
                 + (f" (shared-memory edge {e})" if n in (e, e + 1) else ""))
        plans[label] = plan._asdict()
        got = st.trimmed_mean(column, 0.001)
        check(bits_equal(got, st.trimmed_mean(column, 0.001)), f"{label}: a second launch differs from the first")
        want = st._trimmed_mean_plain(column, 0.001, 0)
        vtol = 1e-6 if dtype == f32 else 1e-12
        e_m = rel_err(got.double().reshape(1), want.double().reshape(1), 1e-300)
        check(e_m <= vtol, f"{label}: rel err {e_m:.3g} > {vtol}")
        log(f"  {label}: plan {plan}, {got.item()!r} (plain {want.item()!r}), rel err {e_m:.3g} (tol {vtol})")
    return plans


def impute_case(K: int, N: int, dtype, seed: int, unit_sf: bool = False) -> tuple:
    """``impute_outliers``' operands on K seeded rows of N samples, four
    kinds in turn: Poisson counts at lognormal means, tie-heavy (means
    0.1-3: zeros and equal counts at both trimmed boundaries), zero-heavy
    (~90% zeros), and rows left all zero where N >= 5 (zeros but one count
    of 50 in a flagged replaceable sample). Exceed bits at ~3% of the cells,
    every 7th sample not replaceable, lognormal size factors (all 1 with
    ``unit_sf``: the normalised counts tie exactly where the counts do), the
    last eighth of the rows padding."""
    from pydeseq2_tpu_torch.ops.cooks import pack_bits

    rng = np.random.default_rng(seed)
    sf = np.ones(N) if unit_sf else np.exp(rng.normal(0.0, 0.3, N))
    kind = np.arange(K) % 4
    mean = np.where(kind == 0, rng.lognormal(3.0, 1.5, K), rng.uniform(0.1, 3.0, K))
    counts = rng.poisson(mean[:, None] * sf[None, :]).astype(np.float64)
    counts[kind == 2] *= rng.random((int((kind == 2).sum()), N)) < 0.1
    exceeds = rng.random((K, N)) < 0.03
    repl = np.arange(N) % 7 != 6
    zero = kind == 3
    counts[zero] = 0.0
    exceeds[zero] = False
    exceeds[zero, 0] = True
    counts[zero, 0] = 50.0
    mask = np.arange(K) < K - K // 8

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=DEVICE)

    return (t(counts), pack_bits(t(exceeds, torch.bool)).contiguous(), tuple(bool(r) for r in repl), t(sf),
            t(mask, torch.bool))


def impute_plan_checks() -> dict:
    """Phase 2, ``impute`` in every trimmed-moment plan
    (``ops/stats.py:_trim_plan``): the plan picked at each of
    IMPUTE_PLAN_N samples in both types (a warp a row by rank count to 96
    samples and by radix select above; a block a row with the keys in
    shared memory from 1000 samples in float64 and 10000 in float32) and
    at IMPUTE_WS_N in float64 (a block a row over the workspace), and up to
    1000 samples every other plan that fits (``kernel_bench.other_plans``),
    on :func:`impute_case` tiles, and on tie-heavy tiles with unit size
    factors at 100 and 1000 samples. Each launched twice (bit for bit the
    same) and held to the plain version by the floor rule
    (:func:`impute_agree`). Returns {label: plan}."""
    from pydeseq2_tpu_torch import kernel_bench, kernels
    from pydeseq2_tpu_torch.ops import refit as rf
    from pydeseq2_tpu_torch.ops import stats as st

    sms = kernels.sm_count(torch.device(DEVICE))
    plans = {}
    cases = [(N, dtype, False) for N in IMPUTE_PLAN_N for dtype in (torch.float32, torch.float64)]
    cases += [(IMPUTE_WS_N, torch.float64, False)]
    cases += [(N, dtype, True) for N in (100, 1_000) for dtype in (torch.float32, torch.float64)]
    for i, (N, dtype, unit_sf) in enumerate(cases):
        K = IMPUTE_PLAN_K if N <= 1_000 else IMPUTE_PLAN_K // 16
        args = impute_case(K, N, dtype, 500 + i, unit_sf)
        tile, sf = args[0], args[3]
        isz = tile.element_size()
        picked = st._trim_plan(isz, [N], K, True, sms)
        want = rf._impute_plain(*args)
        others = kernel_bench.other_plans(picked, isz, N, N, K) if N <= 1_000 else {}
        for pname, plan in {"picked": picked, **others}.items():
            label = (f"impute {'f32' if dtype == torch.float32 else 'f64'} {K} x {N}"
                     + (", unit size factors" if unit_sf else "") + f", {pname}")
            plans[label] = plan._asdict()
            got = rf._impute_cuda(*args, plan=plan)
            again = rf._impute_cuda(*args, plan=plan)
            check(bits_equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"{label}: a second launch differs from the first")
            differ = impute_agree(label, tile, sf, got, want)
            log(f"  {label}: plan {plan}, {differ} cells floor one count apart, new_all_zero {int(got[1].sum())} "
                f"(plain {int(want[1].sum())}), repeat bit-equal")
        del args, tile, want, got, again
    return plans


def newton_box_plan_checks(readings) -> dict:
    """Phase 2, ``newton_box`` on ``kernel_bench.box_operands``' lanes: a
    NB_TILE-lane tile at each of BOX_PLAN_N samples and a 16-lane tile at
    N_GRID_WIDE samples (past the stage), P = 2, 3, 5, both types, and
    BOX_TIE_SEEDS draws at BOX_TIE_CASE in float32. Every lane, then 1, 2,
    16 and all of them selected: each launched twice and bit for bit the
    same, the selected lanes (coefficients, flags, passes) bit for bit the
    all-lane launch's, the others left at their start; every lane held to
    the plain version by the tie rule (:func:`agree_or_tie`; in float32 the
    limit is the larger of TIE_UNITS and the plain search's own worst tie
    against itself with the samples reversed, which passes TIE_UNITS at 12
    samples, P = 3) and its flag to the plain exit test at the kernel's
    point (:func:`box_exit`, as :func:`rescue_checks`). Returns {label:
    plan}; ``readings`` gets each case's ties, limit and passes."""
    from pydeseq2_tpu_torch import kernel_bench
    from pydeseq2_tpu_torch.ops import irls as irl

    plans = {}
    sweep_log = []
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        btol = 1e-4 if dtype == torch.float32 else 1e-9
        shapes = [(N, NB_TILE) for N in BOX_PLAN_N] + [(N_GRID_WIDE[dtype], 16)]
        for N, lanes in shapes:
            for P in BOX_PLAN_P:
                sweep = dtype == torch.float32 and (N, P) == BOX_TIE_CASE
                for k in range(BOX_TIE_SEEDS if sweep else 1):
                    seed = 600 + N + P + 1000 * k
                    box = kernel_bench.box_operands(lanes, N, P, dtype, seed=seed)
                    counts, sf, X, disp, beta_init, min_mu, max_beta, _ = box
                    what = f"newton_box {name} {lanes} lanes x {N}, P = {P}" + (f", seed {seed}" if sweep else "")
                    plans[what] = irl._box_plan(N, P, counts.element_size())._asdict()
                    every = irl._newton_box_cuda(*box)
                    again = irl._newton_box_cuda(*box)
                    check(all(bits_equal(a.double(), b.double()) for a, b in zip(every, again)),
                          f"{what}: a second launch differs from the first")
                    bk, okk, passes = every
                    bp, _ = irl._newton_box_plain(*box)
                    unit = noise_unit(N, dtype) * term_scale(counts)
                    f_p = nb_objective64(counts, sf, X, disp, bp, min_mu)
                    limit = TIE_UNITS
                    if dtype == torch.float32:
                        # the plain float32 search's own noise: its stop with
                        # the samples reversed, where it ties beyond TIE_UNITS
                        rev = torch.arange(N - 1, -1, -1, device=counts.device)
                        br, _ = irl._newton_box_plain(counts[:, rev].contiguous(), sf[rev].contiguous(),
                                                      X[rev].contiguous(), *box[3:])
                        own = ((br - bp).abs().amax(1) > btol) * (nb_objective64(counts, sf, X, disp, br, min_mu)
                                                                  - f_p).abs() / unit
                        limit = max(TIE_UNITS, own.max().item())
                    far, worst = agree_or_tie(what, bk, bp, nb_objective64(counts, sf, X, disp, bk, min_mu), f_p,
                                              btol, unit, limit)
                    sup, noise = box_exit(counts, sf, X, disp, bk, min_mu, max_beta)
                    wrong = (okk != (sup < 1e-5)) & ~((sup - 1e-5).abs() <= noise)
                    check(not bool(wrong.any()), f"{what}: {int(wrong.sum())} exits differ from the plain test at "
                                                 "the kernel's point")
                    for n_sel in sorted({1, 2, 16, lanes}):
                        sel = torch.zeros(lanes, dtype=torch.bool, device=counts.device)
                        sel[torch.linspace(0, lanes - 1, n_sel, device=counts.device).round().long()] = True
                        got = irl._newton_box_cuda(*box, sel)
                        check(all(bits_equal(a.double(), b.double())
                                  for a, b in zip(got, irl._newton_box_cuda(*box, sel))),
                              f"{what}, {n_sel} selected: a second launch differs from the first")
                        check(all(bits_equal(a[sel].double(), b[sel].double()) for a, b in zip(got, every)),
                              f"{what}, {n_sel} selected: the selected lanes differ from the all-lane launch")
                        check(torch.equal(got[0][~sel], beta_init[~sel]) and not bool(got[1][~sel].any())
                              and int(got[2][~sel].abs().sum()) == 0,
                              f"{what}, {n_sel} selected: a lane not selected was worked on")
                    readings[what] = {"lanes": lanes, "tied": far, "tie_max_units": worst,
                                      "tie_limit_units": limit, "passes_max": int(passes.max()),
                                      "converged": int(okk.sum())}
                    if sweep:
                        sweep_log.append((seed, limit, worst))
                    log(f"  {what}: plan {plans[what]}, {far} lanes off by > {btol} with tied objectives (largest "
                        f"gap {worst:.4g} of the limit {limit:.4g} units, {limit - worst:.4g} below it), "
                        f"{int(okk.sum())} converged, passes mean {passes.double().mean().item():.2f} max "
                        f"{int(passes.max())}; repeats and 1/2/16/all selected bit-equal to the all-lane launch")
                    del box, counts, every, again, bp
    log("  newton_box f32 tie sweep at {} samples, P = {}: (seed, limit, largest kernel gap) in units {}; the "
        "kernel's gap within TIE_UNITS on {} of {} draws".format(
            *BOX_TIE_CASE, [(sd, round(lim, 4), round(w, 4)) for sd, lim, w in sweep_log],
            sum(w <= TIE_UNITS for _, _, w in sweep_log), len(sweep_log)))
    return plans


def vst_kernel_checks(dtype, G, N, reps, timings):
    """Phase 2, the blind VST: ``vst`` against its plain version on the
    operands one ``vst_pipeline`` run of ``make_data(N, G)`` hands it
    (parametric as run, with the ``used_mean`` flag forced each way, and the
    mean form), every 7th gene masked out; and ``mom``, ``disp_scan``,
    ``disp_newton`` and ``trend`` at P = 1 on that run's blind-design
    operands. Returns {name: max_abs_err} and fills ``timings``."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused, fused_stream
    from pydeseq2_tpu_torch.ops import dispersion as dsp
    from pydeseq2_tpu_torch.ops import vst as vs
    from pydeseq2_tpu_torch.synthetic import make_data

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    counts = torch.as_tensor(make_data(N, G)[0].T.copy(), dtype=dtype, device=DEVICE)
    seen = capture([(fused_stream, ("vst_transform", "mom_and_mu_coef")), (fused, ("parametric_trend",)),
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


def vst_plan_checks() -> dict:
    """``vst`` in every plan of ``ops/vst.py:_vst_plan``: the row lengths of
    VST_PLAN_N at ~VST_PLAN_CELLS cells (an odd gene count), 100 samples on
    a pointer 4 bytes off, and the atlas block (5000 genes x 10000
    samples), in both types, on ``kernel_bench.vst_operands``' counts with
    every 7th gene masked: the parametric form, ``used_mean`` set and the
    mean form, each launched twice and bit for bit, NaN on exactly the
    masked rows, within vst_kernel_checks' vtol of the plain version.
    Returns {label: plan}."""
    from pydeseq2_tpu_torch import kernel_bench, kernels
    from pydeseq2_tpu_torch.ops import vst as vs

    rows = {}
    for dtype, ns in VST_PLAN_N.items():
        name = "f32" if dtype == torch.float32 else "f64"
        vtol = 1e-6 if dtype == torch.float32 else 1e-13
        wide = 4 if dtype == torch.float32 else 2
        cases = [(N, max(1, VST_PLAN_CELLS // N) | 1, offset) for N, offset in [(N, False) for N in ns] + [(100, True)]]
        cases.append((10_000, G_ATLAS_BLOCK, False))
        for N, G, offset in cases:
            c, sf, coeffs, flag, mean_disp, _ = kernel_bench.vst_operands(G, N, dtype)
            if offset:
                buf = torch.empty(G * N + 1, dtype=dtype, device=DEVICE)
                buf[1:] = c.flatten()
                c = buf[1:].view(G, N)
            masked = torch.arange(G, device=DEVICE) % 7 != 0
            plan = vs._vst_plan(G, N, c.element_size(), c.data_ptr(), sms=kernels.sm_count(c.device))
            label = f"vst {name} {G} x {N}" + (" offset pointer" if offset else "")
            check(plan.vec == (wide if N % wide == 0 and not offset else 1), f"{label}: plan {plan}")
            worst, exact = {}, {}
            for form, fl, mean_only in (("parametric", flag, False), ("used_mean", torch.tensor(True, device=DEVICE),
                                                                        False), ("mean", None, True)):
                got = vs._vst_cuda(c, sf, coeffs, fl, mean_disp, masked, mean_only)
                again = vs._vst_cuda(c, sf, coeffs, fl, mean_disp, masked, mean_only)
                want = vs._vst_plain(c, sf, coeffs, fl, mean_disp, masked, mean_only)
                check(bits_equal(got, again), f"{label} {form}: a second launch differs")
                check(bool(torch.isnan(got).all(1).eq(~masked).all()) and not bool(torch.isnan(got[masked]).any()),
                      f"{label} {form}: NaN cells are not the masked rows")
                worst[form] = scaled_err(got, want)
                exact[form] = bits_equal(got, want)
                del got, again, want
            check(all(v <= vtol for v in worst.values()), f"{label}: errors {worst} beyond {vtol}")
            rows[label] = plan._asdict()
            log(f"  {label}: plan {plan._asdict()}, rel err (abs below 1) "
                + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (tol {vtol}), bits equal to the plain "
                f"version {exact}")
            del c, sf, masked
            torch.cuda.empty_cache()
    return rows


def fine_list_checks() -> dict:
    """``disp_scan_fine`` and its grouping on FINE_LIST_SHAPES' draws
    (``kernel_bench.inputs``: ``make_data``, P - 2 batch indicators beyond
    P = 2, the OLS mu), their centres from the coarse scan, in each of
    FINE_LISTS: ``fine_check`` (on the la_init list, the genes with a finite
    point; the others must keep their centre, as the plain version does),
    ``fine_group_check`` and ``fine_order_check``. Returns {label: bucket
    counts}."""
    from pydeseq2_tpu_torch import kernel_bench
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    rows = {}
    for dtype, G, P in FINE_LIST_SHAPES:
        counts, mu, X = kernel_bench.inputs(G, N_MAIN, P, dtype)
        max_disp = float(max(10, N_MAIN))
        lo_f, hi_f = math.log(1e-8), math.log(max_disp)
        K = 32
        step1_f = (hi_f - lo_f) / (K - 1)
        lo = torch.tensor(lo_f, dtype=dtype, device=DEVICE)
        la_grid = lo + torch.arange(K, dtype=dtype, device=DEVICE) * torch.tensor(step1_f, dtype=dtype, device=DEVICE)
        la_init = (lo_f + hi_f) / 2
        la_hat = torch.zeros(G, dtype=dtype, device=DEVICE)
        pdv = torch.tensor(1.0, dtype=dtype, device=DEVICE)
        la1, _ = dsp.scan_coarse(counts, mu, X, la_grid, *dsp._scan_branches(K, step1_f, lo_f), la_init, True, False,
                                 la_hat, pdv)
        for kind in FINE_LISTS:
            label = f"{'f32' if dtype == torch.float32 else 'f64'} {G} x {N_MAIN} P={P} {kind}"
            if kind == "la_init":
                c, m, lh, ctr = counts, mu.clone(), la_hat, la1.clone()
                g = torch.arange(G, device=DEVICE)
                nan_g = g % NAN_EVERY == 0
                ctr[(g % LA_INIT_EVERY == 0) | nan_g] = la_init
                m[nan_g] = math.nan
            else:
                c, m, lh, ctr = kernel_bench.fine_lists(counts, mu, la_hat, la1, kind, step1_f, lo_f, hi_f)
            args = (c, m, X, ctr, step1_f, FINE_LENGTH, lo_f, hi_f, True, False, lh, pdv)
            buckets = fine_group_check(label, ctr, lo_f, hi_f, step1_f)
            fine_order_check(label, args)
            if kind == "la_init":
                la_k, la_p = dsp.scan_grid(*args), dsp.scan_grid_plain(*args)
                check(bits_equal(la_k[nan_g], ctr[nan_g]) and bits_equal(la_p[nan_g], ctr[nan_g]),
                      f"disp_scan_fine {label}: a gene with no finite point left its centre")
                check(buckets[-1] >= int(((g % LA_INIT_EVERY == 0) | nan_g).sum()),
                      f"disp_scan_fine {label}: la_init bucket {buckets[-1]}")
                ok = ~nan_g
                args = (c[ok].contiguous(), m[ok].contiguous(), X, ctr[ok].contiguous(), *args[4:10],
                        lh[ok].contiguous(), pdv)
            fine_check(label, args)
            rows[label] = buckets
            log(f"  disp_scan_group {label}: {int(torch.unique(ctr).numel())} centres, bucket counts {buckets}")
            del c, m, lh, ctr, args
        del counts, mu, X, la1
        torch.cuda.empty_cache()
    return rows


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
# BH counts, the lowess pick, the picked row), lfc_shrink() and vst(). The rescue tiers
# launch only where a lane stays flagged after IRLS, grid_apeglm only where
# Newton fails: their counts are reported, not required.
CLASS_KERNELS = ("select", "mom", "disp_scan", "disp_newton", "trend_fit", "irls", "hat", "trimmed_var", "wald",
                 "bh_count", "bh_adjust", "lowess", "shrink", "vst")


def as_frames(counts_gn: np.ndarray, X_np: np.ndarray):
    """Gene-major (G, N) counts and their two-column design as a user hands
    them over: ``(counts DataFrame (N, G) of ints, metadata with a condition
    column)``."""
    import pandas as pd

    G, N = counts_gn.shape
    samples = [f"sample{i}" for i in range(N)]
    counts_df = pd.DataFrame(counts_gn.T.astype(np.int64), index=samples, columns=[f"gene{j}" for j in range(G)])
    metadata = pd.DataFrame({"condition": np.where(X_np[:, 1] > 0, "B", "A")}, index=samples)
    return counts_df, metadata


def class_inputs(N: int, G: int, seed: int = 0):
    """``make_data(N, G)`` with an outlier planted in every OUTLIER_EVERY-th
    gene, as the class API takes it: ``(counts DataFrame (N, G) of ints,
    metadata with a condition column, design (N, 2), gene-major counts)``."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G, seed=seed)
    counts_gn = plant_outliers(counts_np.T)
    return (*as_frames(counts_gn, X_np), X_np, counts_gn)


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
    from pydeseq2_tpu_torch import kernels
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
            "passes": n_loss + n_grad,
            "plan": tr._trend_plan(Gt, isz)._asdict(),
        }
        timings["trend_fit"]["ms_per_pass"] = timings["trend_fit"]["ms"] / (n_loss + n_grad)

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
        cohort_rows = [counts_nt.T[:, torch.tensor(c, device=counts_nt.device)].contiguous() for c in cohorts]
        timings["trimmed_var"] = {
            "ms": cuda_ms(lambda: st._trimmed_cell_variance_cuda(counts_nt, cells), reps),
            "plain_ms": cuda_ms(lambda: st._trimmed_cell_variance_plain(counts_nt, cells), reps),
            "library_ms": None,
            # the yardstick: torch.sort of the cohort rows (of the column), the sort alone
            "sort_ms": cuda_ms(lambda: [torch.sort(r, dim=1) for r in cohort_rows], reps),
            "column_ms": cuda_ms(lambda: st.trimmed_mean(column, 0.001), reps),
            "column_sort_ms": cuda_ms(lambda: torch.sort(column), reps),
            "plan": st._trim_plan(vsz, members, Gv, False, kernels.sm_count(column.device))._asdict(),
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
            # per (gene, sample): pass 1 linear predictor, exp, the product by
            # sf, clamp, weight, the thresholded Gram triangle; pass 2 x^T
            # M^-1 x and H
            "ops": Gh * Nh * ((2 * P + 6 + 3 * ntri) + (2 * P * P + 2 * P + 1)),
            "plan": wd._hat_wald_plan(Nh, P, isz)._asdict(),
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
            "plan": {"lanes": wd._hat_wald_plan(Nw, P, isz).lanes},
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
    from pydeseq2_tpu_torch import kernels, tracing

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
        with tracing.enabled(i == 0):  # the counted run records the box passes
            dds, ds, results, t = run()
        if i == 0:
            launches = dict(kernels.STATS.launches)
            peak = torch.cuda.max_memory_allocated()
            box = box_selection(kernels.STATS.box_passes)
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
    log(f"  launches in one run {launches}; newton_box per launch [selected, tile lanes, slowest lane's passes] "
        f"{box}")
    return {"walls_s": walls, "best_s": best, "peak_bytes": peak, "trace_deseq2": trace, "stage_ms": stage_ms,
            "launches": launches, "box_selection": box, "refitted": n_refit, "gaps_vs_stream": gaps}


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



# deseq2()'s stages in order (reference pydeseq2/dds.py:516-562): phase 4h
# saves after the second and resumes with the rest.
DESEQ2_STAGES = ("fit_size_factors", "fit_genewise_dispersions", "fit_dispersion_trend", "fit_dispersion_prior",
                 "fit_MAP_dispersions", "fit_LFC", "calculate_cooks", "refit", "cooks_outlier")
RESULT_COLUMNS = ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue", "padj")


def result_columns(out: dict, contrast: np.ndarray) -> dict:
    """A pipeline's per-gene outputs as ``run_deseq2``'s columns."""
    ln2 = np.log(2)
    return {"baseMean": out["base_mean"], "log2FoldChange": out["lfc"] @ contrast / ln2, "lfcSE": out["se"] / ln2,
            "stat": out["statistics"], "pvalue": out["p_values"], "padj": out["padj"]}


def frame_columns(results) -> dict:
    return {c: results[c].to_numpy() for c in RESULT_COLUMNS}


def columns_close(label: str, got: dict, want: dict, rtol: float) -> float:
    """Each of RESULT_COLUMNS within ``rtol`` of ``want``'s, NaN and
    infinite entries equal; returns the largest relative difference."""
    worst = 0.0
    for c in RESULT_COLUMNS:
        g, w = np.asarray(got[c], np.float64), np.asarray(want[c], np.float64)
        m = np.isfinite(w)
        check(np.array_equal(g[~m], w[~m], equal_nan=True), f"{label} {c}: NaN or infinite entries differ")
        check(np.allclose(g[m], w[m], rtol=rtol, atol=0.0), f"{label} {c}: beyond rtol {rtol}")
        worst = max(worst, float(np.max(np.abs(g[m] - w[m]) / np.maximum(np.abs(w[m]), 1e-300), initial=0.0)))
    return worst


# Where phase 3l's one profiled run_deseq2 call spends its host time:
# (label, file, function name as pstats gives it, the calling file or None
# for every caller), cumulative, the card synchronised at the call's end.
API_PROFILE = (("DeseqDataSet", "dataset.py", "__init__", None),
               ("validate", "__init__.py", "test_valid_counts", None),
               ("host transpose", "~", "<built-in method numpy.ascontiguousarray>", "api.py"),
               ("counts to device", "~", "<method 'to' of 'torch._C.TensorBase' objects>", "api.py"),
               ("pipeline", "fused_stream.py", "run_summary_streamed", None),
               ("pipeline", "fused_stream.py", "summary_pipeline", "api.py"),
               ("host copy", "fused_stream.py", "_to_host", "api.py"))


def api_profile(call) -> dict:
    """Milliseconds of API_PROFILE's functions in one call under cProfile,
    and the call's wall under the profiler."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    call()
    torch.cuda.synchronize()
    prof.disable()
    out = {"profiled_wall_ms": (time.perf_counter() - t0) * 1e3}
    for label, file, name, caller in API_PROFILE:
        for (f, _, n), (_, _, _, cum, callers) in pstats.Stats(prof).stats.items():
            if n == name and f.endswith(file):
                if caller is not None:
                    cum = sum(c[3] for (cf, _, _), c in callers.items() if cf.endswith(caller))
                out[label] = out.get(label, 0.0) + cum * 1e3
    return out


def api_path(reps: int) -> dict:
    """Phase 3l: ``run_deseq2`` at 100 x 60000 float32 on the card from
    pandas DataFrames, on phase 3e's draw (an outlier planted in every
    OUTLIER_EVERY-th gene; the default refit route) and on phase 3b's
    (``refit_cooks=False``). For each route: the warm wall of the call and
    of the direct pipeline call it makes on the same counts
    (``run_summary_streamed(refit_cooks=True)``, the counts already on the
    card, or ``summary_pipeline``), best of ``reps`` each; the launches of
    one call, which must be > 0 for every kernel of the route and equal to
    the direct call's, kernel by kernel; and every column within rtol 1e-6
    of the direct call's, NaN masks equal."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_MAIN)
    contrast = np.array([0.0, 1.0])
    routes = {}
    for label, refit in (("refit", True), ("no refit", False)):
        counts_gn = plant_outliers(counts_np.T) if refit else np.ascontiguousarray(counts_np.T)
        counts_df, metadata = as_frames(counts_gn, X_np)
        if refit:
            kw = stream_kwargs(counts_gn, X_np, torch.float32, DEVICE)
            direct = lambda: pt.run_summary_streamed(**kw)  # noqa: E731
        else:
            kw = summary_kwargs(counts_gn, X_np, torch.float32, DEVICE, beta_tol=1e-6)
            direct = lambda: pt.outputs_to_numpy(pt.summary_pipeline(**kw))  # noqa: E731

        def call():
            return pt.run_deseq2(counts_df, metadata, contrast=["condition", "B", "A"], refit_cooks=refit,
                                 dtype=torch.float32, device=DEVICE)

        seen = {}
        for name, fn in (("run_deseq2", call), ("direct", direct)):
            fn()  # warm-up
            walls = []
            for i in range(reps):
                if i == 0:
                    kernels.STATS.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if i == 0:
                    launches = dict(kernels.STATS.launches)
            seen[name] = (out, walls, launches)
        (res, walls, launches), (ref, dwalls, dlaunches) = seen["run_deseq2"], seen["direct"]
        for k in STREAM_KERNELS if refit else SUMMARY_KERNELS:
            check(launches[k] > 0, f"phase 3l {label}: kernel {k} was not launched by run_deseq2")
        check(launches == dlaunches, f"phase 3l {label}: run_deseq2 launches {launches}, the direct call "
                                     f"{dlaunches}")
        check(list(res.columns) == list(RESULT_COLUMNS) and res.shape == (G_MAIN, 6),
              f"phase 3l {label}: results shape")
        worst = columns_close(f"phase 3l {label} against the direct call", frame_columns(res),
                              result_columns(ref, contrast), 1e-6)
        padj = res["padj"].to_numpy()
        fin = np.isfinite(padj)
        check(fin.mean() > 0.5 and np.all((padj[fin] >= 0) & (padj[fin] <= 1)), f"phase 3l {label}: padj")
        best, dbest = min(walls), min(dwalls)
        host = api_profile(call)
        log(f"  {label}: run_deseq2 wall (warm) {[round(w, 4) for w in walls]} s, best {best:.4f} s; direct call "
            f"{[round(w, 4) for w in dwalls]} s, best {dbest:.4f} s; host cost of the entry point "
            f"{(best - dbest) * 1e3:.1f} ms; columns within {worst:.3g} of the direct call's")
        log(f"  {label}: launches in one call {launches} (the direct call's the same)")
        log(f"  {label}: one call under cProfile, ms: {host}")
        routes[label] = {"walls_s": walls, "best_s": best, "direct_walls_s": dwalls, "direct_best_s": dbest,
                         "profile_ms": host,
                         "launches": launches, "max_rel_vs_direct": worst,
                         "refitted": int(ref["refitted"].sum()) if refit else None}
    return routes


def api_card_vs_cpu() -> None:
    """Phase 4h: float64 ``run_deseq2`` on the card against the CPU at 100 x
    2000: the refit route (planted outliers, phase 4d's draw), the no-refit
    route, poscounts, control genes and the zero-inflated switch to
    iterative mode (warned on both), every column at rtol 1e-6 with equal
    NaN masks and the same refitted genes and Cook's outliers
    (:func:`compare_outputs`). Then an io resume: a dataset fitted on the
    card through its size factors and genewise dispersions is saved,
    loaded with a card inference and resumed through the stages left and
    ``summary()``, which must equal the uninterrupted card run at rtol
    1e-12; the same file loads and resumes on the CPU, within rtol 1e-6."""
    import tempfile
    import warnings
    from pathlib import Path

    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import io
    from pydeseq2_tpu_torch.synthetic import make_data, zero_per_gene

    counts_np, X_np = make_data(N_MAIN, G_CPU_CMP, seed=1)
    plain = np.ascontiguousarray(counts_np.T)
    outliers = plant_outliers(plain)
    zero_free = [f"gene{j}" for j in np.flatnonzero((plain > 0).all(axis=1))[:200]]
    cases = (("refit", outliers, {}), ("no refit", plain, {"refit_cooks": False}),
             ("poscounts", plain, {"size_factors_fit_type": "poscounts"}),
             ("control genes", plain, {"control_genes": zero_free, "refit_cooks": False}),
             ("zero-inflated", zero_per_gene(plain), {"refit_cooks": False}))
    for label, counts_gn, kw in cases:
        counts_df, metadata = as_frames(counts_gn, X_np)
        side = {}
        for dev in (DEVICE, "cpu"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res, state = pt.run_deseq2(counts_df, metadata, contrast=["condition", "B", "A"],
                                           dtype=torch.float64, return_state=True, device=dev, **kw)
            switched = any("Switching to iterative mode" in str(w.message) for w in caught)
            check(switched == (label == "zero-inflated"), f"phase 4h {label} on {dev}: switched {switched}")
            side[dev] = {**frame_columns(res), "cooks_outlier": np.asarray(state["cooks_outlier"]),
                         "size_factors": np.asarray(state["size_factors"])}
            if kw.get("refit_cooks", True):
                side[dev]["refitted"] = np.asarray(state["refitted"])
        if label == "refit":
            check(int(side[DEVICE]["refitted"].sum()) > 0, "phase 4h refit: no gene was refitted")
        compare_outputs(f"run_deseq2 f64 {label}", side[DEVICE], side["cpu"])

    counts_df, metadata = as_frames(outliers, X_np)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # this draw's trend falls back to the mean
        dds = class_deseq2(counts_df, metadata, torch.float64, DEVICE)
    want = frame_columns(class_summary(dds).results_df)
    check(int(dds.var["refitted"].sum()) > 0, "phase 4h resume: no gene was refitted")
    partial = pt.DeseqDataSet(counts=counts_df, metadata=metadata, design="~condition", quiet=True, beta_tol=1e-8,
                              inference=pt.TorchInference(dtype=torch.float64, device=DEVICE))
    for stage in DESEQ2_STAGES[:2]:
        getattr(partial, stage)()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "partial.pkl"
        io.save_dataset(partial, path)
        for dev, rtol in ((DEVICE, 1e-12), ("cpu", 1e-6)):
            back = io.load_dataset(path, inference=pt.TorchInference(dtype=torch.float64, device=dev))
            check(back._dev["_mu_hat"].device.type == torch.device(dev).type, f"phase 4h resume on {dev}: store")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for stage in DESEQ2_STAGES[2:]:
                    getattr(back, stage)()
            got = frame_columns(class_summary(back).results_df)
            check(np.array_equal(back.var["refitted"].to_numpy(), dds.var["refitted"].to_numpy()),
                  f"phase 4h resume on {dev}: refitted genes differ")
            worst = columns_close(f"phase 4h resume on {dev}", got, want, rtol)
            log(f"  io resume after the genewise dispersions, loaded on {dev}: results within {worst:.3g} of the "
                f"uninterrupted card run (limit {rtol})")


MESH_ROUTES = (("refit", True), ("no refit", False))


def mesh_draws() -> dict:
    """Phase 3m's DataFrames, phase 3l's draws: {route label: (counts_df,
    metadata)} at N_MAIN x G_MAIN, outliers planted on the refit route."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_MAIN)
    return {label: as_frames(plant_outliers(counts_np.T) if refit else np.ascontiguousarray(counts_np.T), X_np)
            for label, refit in MESH_ROUTES}


def mesh_call(frames, refit: bool, mesh):
    import pydeseq2_tpu_torch as pt

    res, state = pt.run_deseq2(*frames, contrast=["condition", "B", "A"], refit_cooks=refit, dtype=torch.float32,
                               return_state=True, mesh=mesh, device=None if mesh is not None else DEVICE)
    return frame_columns(res), np.asarray(state["refitted"]) if refit else None


# What torch.profiler names the collectives: the c10d operators on the host
# and the NCCL kernels on the card (gloo runs none there).
COLLECTIVE_KEYS = ("c10d::", "nccl")


def collective_times(call) -> dict:
    """One call under torch.profiler: its wall (the profiler's overhead
    included), and the host time of the c10d collective operators and the
    device time of the NCCL kernels, in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = dev = 0.0
    calls = {}
    for e in prof.key_averages():
        key = e.key.lower()
        if key.startswith("c10d::"):
            host += e.cpu_time_total / 1e3
            calls[e.key] = e.count
        elif "nccl" in key and getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) > 0:
            dev += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) / 1e3
    return {"profiled_wall_ms": wall * 1e3, "collectives_host_ms": host, "nccl_device_ms": dev,
            "collective_calls": calls}


def mesh_rank_main(rank: int, world: int, store: str, out_dir: str) -> int:
    """A rank of phase 3m's two-rank mesh on the one card (run as
    ``chip_smoke.py --mesh-rank RANK WORLD STORE OUT_DIR``): gloo over CUDA
    tensors (NCCL takes one rank a device), both routes of ``run_deseq2``
    on the phase's draws, a warm-up, one timed call and one profiled call
    each; pickles the columns, refitted genes,
    walls, launches and collective times to OUT_DIR/rank<RANK>.pkl, or the
    traceback to rank<RANK>.err (exit 3)."""
    import pickle
    import traceback
    import warnings
    from datetime import timedelta
    from pathlib import Path

    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.parallel.mesh import init_distributed, make_gene_mesh

    out = Path(out_dir)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        init_distributed(backend="gloo", device="cuda", init_method=f"file://{store}", rank=rank, world_size=world,
                         timeout=timedelta(seconds=MESH_RANK_TIMEOUT_S))
        mesh = make_gene_mesh()
        results = {}
        for label, refit in MESH_ROUTES:
            frames = mesh_draws()[label]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mesh_call(frames, refit, mesh)  # warm-up
                kernels.STATS.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cols, refitted = mesh_call(frames, refit, mesh)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(kernels.STATS.launches)
                prof = collective_times(lambda: mesh_call(frames, refit, mesh))
            results[label] = {"columns": cols, "refitted": refitted, "wall_s": wall, "launches": launches,
                              "profile": prof}
        torch.distributed.destroy_process_group()
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
        return 0
    except Exception:  # reported to the parent, which raises or states why
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        return 3


def two_rank_mesh(none_runs: dict) -> dict:
    """Phase 3m's two ranks on the one card: MESH_RANKS_2 processes of
    :func:`mesh_rank_main`, under MESH_RANK_TIMEOUT_S, every process
    stopped at the end. Each rank's columns must equal the ``mesh=None``
    run's bit for bit where they agree and within rtol 1e-6 where they do
    not (NaN masks equal), each differing gene named, with the same
    refitted genes. A rank that fails fails the phase, whatever the
    failure."""
    import pickle
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, "--mesh-rank", str(r), str(MESH_RANKS_2),
                                   str(Path(tmp) / "store"), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for r in range(MESH_RANKS_2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MESH_RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        errs = {r: (Path(tmp) / f"rank{r}.err").read_text() for r in range(MESH_RANKS_2)
                if (Path(tmp) / f"rank{r}.err").exists()}
        for r, e in errs.items():
            log(f"  two ranks: rank {r} failed:\n{e}")
        check(not errs, f"phase 3m: ranks {sorted(errs)} of the two-rank mesh failed (see above)")
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"phase 3m: rank {r} exited {p.returncode}:\n{logs[r][-4000:]}")
        ranks = []
        for r in range(MESH_RANKS_2):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    out = {}
    names = mesh_draws()["refit"][0].columns
    for label, refit in MESH_ROUTES:
        want, want_refit = none_runs[label]
        differ = np.zeros(G_MAIN, dtype=bool)
        for r, rank in enumerate(ranks):
            got = rank[label]
            if refit:
                check(np.array_equal(got["refitted"], want_refit), f"phase 3m two ranks {label}: refitted genes differ")
            for c in RESULT_COLUMNS:
                g, w = np.asarray(got["columns"][c], np.float64), np.asarray(want[c], np.float64)
                same = (g == w) | (np.isnan(g) & np.isnan(w))
                differ |= ~same
            columns_close(f"phase 3m two ranks {label} rank {r}", got["columns"], want, 1e-6)
        out[label] = {"walls_s": [rank[label]["wall_s"] for rank in ranks],
                      "launches_rank0": ranks[0][label]["launches"],
                      "profile_rank0": ranks[0][label]["profile"],
                      "genes_differing": int(differ.sum()),
                      "differing_names": [str(n) for n in names[np.flatnonzero(differ)][:50]]}
        prof = ranks[0][label]["profile"]
        out[label]["collective_host_share"] = prof["collectives_host_ms"] / (ranks[0][label]["wall_s"] * 1e3)
        log(f"  two ranks {label}: walls {[round(w, 4) for w in out[label]['walls_s']]} s; every column within "
            f"rtol 1e-6 of mesh=None, bit for bit but for {int(differ.sum())} genes: {out[label]['differing_names']}; "
            f"rank 0's collectives {prof} (host {out[label]['collective_host_share']:.4f} of its timed wall)")
    return out


def mesh_path(reps: int) -> dict:
    """Phase 3m: ``run_deseq2(mesh=)`` at N_MAIN x G_MAIN float32 on both
    routes (phase 3l's draws). One rank over NCCL (``init_distributed``, a
    ``file://`` store, ``make_gene_mesh()``): every column and the refitted
    genes bit for bit the ``mesh=None`` call's; the warm walls of both,
    best of ``reps``; the launches of one call, kernel by kernel those of
    ``mesh=None`` but for the size-factor median, whose ``select`` launches
    become ``select_hist``'s and ``select_pick``'s (one each a radix pass);
    one profiled call's
    collective time. Then :func:`two_rank_mesh`."""
    import tempfile
    import warnings
    from pathlib import Path

    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops.select import _passes
    from pydeseq2_tpu_torch.parallel.mesh import init_distributed, make_gene_mesh

    draws = mesh_draws()
    out, none_runs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(device="cuda", init_method=f"file://{Path(tmp) / 'store'}", rank=0, world_size=1)
        try:
            mesh = make_gene_mesh()
            check(torch.distributed.get_backend() == "nccl" and mesh.size() == 1, "phase 3m: not one NCCL rank")
            for label, refit in MESH_ROUTES:
                seen = {}
                for name, m in (("mesh=None", None), ("mesh", mesh)):
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        mesh_call(draws[label], refit, m)  # warm-up
                        walls = []
                        for i in range(reps):
                            if i == 0:
                                kernels.STATS.reset()
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            res = mesh_call(draws[label], refit, m)
                            torch.cuda.synchronize()
                            walls.append(time.perf_counter() - t0)
                            if i == 0:
                                launches = dict(kernels.STATS.launches)
                    seen[name] = (res, walls, launches)
                (ref, none_walls, none_l), (got, walls, launches) = seen["mesh=None"], seen["mesh"]
                none_runs[label] = ref
                for c in RESULT_COLUMNS:
                    check(np.array_equal(got[0][c], ref[0][c], equal_nan=True),
                          f"phase 3m {label}: {c} is not bit for bit the mesh=None call's")
                if refit:
                    check(np.array_equal(got[1], ref[1]) and ref[1].any(), f"phase 3m {label}: refitted genes")
                medians = none_l["select"] - launches["select"]
                npass = _passes(torch.float32)
                want = {**none_l, "select": none_l["select"] - medians, "select_hist": npass * medians,
                        "select_pick": npass * medians}
                check(medians > 0 and launches == want,
                      f"phase 3m {label}: launches {launches}, expected mesh=None's with the median's select as "
                      f"select_hist and select_pick {want}")
                for k in STREAM_KERNELS if refit else SUMMARY_KERNELS:
                    check(launches[k] > 0, f"phase 3m {label}: kernel {k} was not launched")
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    prof = collective_times(lambda: mesh_call(draws[label], refit, mesh))
                share = prof["collectives_host_ms"] / (min(walls) * 1e3)
                log(f"  one rank {label}: run_deseq2(mesh=) wall (warm) {[round(w, 4) for w in walls]} s, best "
                    f"{min(walls):.4f} s; mesh=None {[round(w, 4) for w in none_walls]} s, best {min(none_walls):.4f} "
                    f"s; every column bit for bit; launches {launches}; collectives {prof} (host "
                    f"{share:.4f} of the best warm wall)")
                out[label] = {"walls_s": walls, "best_s": min(walls), "none_walls_s": none_walls,
                              "none_best_s": min(none_walls), "launches": launches, "none_launches": none_l,
                              "profile": prof, "collective_host_share": share}
        finally:
            torch.distributed.destroy_process_group()
    out["two_ranks"] = two_rank_mesh(none_runs)
    return out


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
    plans = cluster_kernel_checks()
    plans.update(trim_plan_checks())
    plans.update(grid_design_checks(readings))
    plans.update(nll_grid_plan_checks(readings))
    plans.update(grid_nb_plan_checks(readings))
    plans.update(select_plan_checks())
    plans.update(irls_plan_checks())
    plans.update(mom_plan_checks())
    plans.update(bh_plan_checks())
    plans.update(hat_wald_plan_checks())
    plans.update(lowess_checks())
    plans.update(impute_plan_checks())
    plans.update(newton_box_plan_checks(readings))
    plans.update(vst_plan_checks())
    plans.update(fine_list_checks())
    plans.update(dnb_plan_checks())
    plans.update(newton_split_check())
    errs32.update(select_hist_checks(timings))

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
    log(f"phase 3l: run_deseq2 from DataFrames, {N_MAIN} x {G_MAIN} float32: the refit route on phase 3e's draw, "
        "refit_cooks=False on phase 3b's, each beside the direct call it makes")
    api = api_path(3)
    log(f"phase 3m: run_deseq2(mesh=) on a gene mesh, {N_MAIN} x {G_MAIN} float32, both routes: one rank over "
        f"NCCL bit for bit mesh=None, then {MESH_RANKS_2} ranks on the one card over gloo")
    mesh = mesh_path(3)

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
    log("phase 4h: float64 run_deseq2 (both routes, poscounts, control genes, the zero-inflated switch), card "
        "against CPU, 100 x 2000, then an io save / load / resume on the card and on the CPU")
    api_card_vs_cpu()

    # name -> (source, TPU program it replaces, the run whose launches count)
    replaces = {
        "order_stats_select": ("pydeseq2_tpu_torch/csrc/select.cu", "pydeseq2_tpu/ops/select.py:65", "select"),
        # order_stats_select's radix pass, taken out of the cluster for the gene mesh
        "select_hist": ("pydeseq2_tpu_torch/csrc/select.cu", "pydeseq2_tpu/ops/select.py:65", "select_hist"),
        # and its digit pick from the ranks' summed counts
        "select_pick": ("pydeseq2_tpu_torch/csrc/select.cu", "pydeseq2_tpu/ops/select.py:65", "select_pick"),
        "disp_scan": ("pydeseq2_tpu_torch/csrc/disp_scan.cu", "pydeseq2_tpu/ops/dispersion.py:196", "disp_scan"),
        "disp_newton": ("pydeseq2_tpu_torch/csrc/disp_newton.cu", "pydeseq2_tpu/ops/dispersion.py:361", "disp_newton"),
        "disp_scan_fine": ("pydeseq2_tpu_torch/csrc/disp_scan.cu", "pydeseq2_tpu/ops/dispersion.py:170",
                           "disp_scan_fine"),
        "disp_scan_group": ("pydeseq2_tpu_torch/csrc/disp_scan.cu", "pydeseq2_tpu/ops/dispersion.py:170",
                            "disp_scan_group"),
        "dnb_nll": ("pydeseq2_tpu_torch/csrc/dnb_nll.cu", "pydeseq2_tpu/ops/nb.py:381", "dnb_nll"),
        "irls": ("pydeseq2_tpu_torch/csrc/irls.cu", "pydeseq2_tpu/ops/irls.py:45", "irls"),
        "newton_box": ("pydeseq2_tpu_torch/csrc/newton_box.cu", "pydeseq2_tpu/ops/irls.py:272", "newton_box"),
        "grid_nb": ("pydeseq2_tpu_torch/csrc/grid.cu", "pydeseq2_tpu/ops/irls.py:375", "grid_nb"),
        "hat_wald": ("pydeseq2_tpu_torch/csrc/hat_wald.cu",
                     "pydeseq2_tpu/ops/irls.py:444 + pydeseq2_tpu/ops/wald.py:28", "hat_wald"),
        "cooks": ("pydeseq2_tpu_torch/csrc/cooks.cu",
                  "pydeseq2_tpu/ops/stats.py:108 + pydeseq2_tpu/fused.py:702", "cooks"),
        "bh_count": ("pydeseq2_tpu_torch/csrc/bh.cu", "pydeseq2_tpu/ops/stats.py:145", "bh_count"),
        "bh_adjust": ("pydeseq2_tpu_torch/csrc/bh.cu", "pydeseq2_tpu/ops/stats.py:145", "bh_adjust"),
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
        "lgamma_table": ("pydeseq2_tpu_torch/csrc/sizefactors.cu", "pydeseq2_tpu/ops/sizefactors.py:34",
                         "lgamma_table"),
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
    # path (3k) for disp_scan_fine, its grouping and dnb_nll.
    launches = {**summary["launches"], "shrink": shrink["launches"]["shrink"],
                "grid_apeglm": weak["launches"]["grid_apeglm"],
                **{k: stream["launches"][k] for k in ("mom", "trend", "lowess", "impute")},
                **{k: stream_zi["launches"][k] for k in ("sf_nll", "sf_newton", "lgamma_table")},
                "vst": vst["launches"]["vst"],
                **{k: klass["launches"][k] for k in ("trend_fit", "trimmed_var", "hat", "wald")},
                **{k: fine["launches"][k] for k in ("disp_scan_fine", "disp_scan_group", "dnb_nll")},
                **{k: mesh["refit"]["launches"][k] for k in ("select_hist", "select_pick")}}
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
        for extra in ("test_only_ms", "sort_ms", "all_lanes_ms", "all_rows_ms", "refit_ms", "ms_with_mu", "steps", "column_ms", "column_sort_ms",
                      "wide_ms", "wide_plain_ms", "passes", "ms_per_pass", "plan", "terms", "cells", "median_ms",
                      "median_wall_ms", "median_launches"):
            if extra in t:
                # hat_wald without H and mu (the refit's call); the sort before the BH counts, or the torch.sort yardstick of
                # the trimmed moments' cohort rows (and column); a rescue kernel over every lane
                # of its tile; bh_adjust over every row; cooks in the streamed refit mode; mom writing mu;
                # the Newton steps of one sf_newton launch; trimmed_var over the
                # mean trend's one column; the atlas block's times of disp_scan
                # and disp_newton; the reduction passes of one trend or
                # trend_fit launch and the time per pass, or newton_box's
                # serial passes; a kernel's launch plan; the apeGLM terms or
                # NLL cells the run's data needs; the one-rank sharded
                # median whole (events, host clock, its launches)
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
    log("run_deseq2 path: " + json.dumps(api))
    log("gene mesh path: " + json.dumps(mesh))
    log("ties of the rescue and grid kernels with their plain versions: " + json.dumps(readings))
    log("cluster, trimmed-moment, sf_nll, grid_apeglm, grid_nb, select, irls, mom, bh, hat_wald, lowess, impute, "
        "newton_box, vst and dnb_nll kernel plans, and the fine scan's bucket counts: "
        + json.dumps(plans))
    print(json.dumps({"kernels": rows}), flush=True)
    name = torch.cuda.get_device_name(0)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
