"""Device time of hand-written kernels at the shapes the pipelines give
them, for one or more checkouts of this repository, on a CUDA card: the
dispersion kernels ``disp_scan`` and ``disp_newton`` (suite ``disp``), the
trimmed size-factor solve's ``sf_newton`` round and ``sf_nll`` pass
(``sf``), the dispersion trend's gamma-GLM fit, ``trend`` with its
exclusion rounds and the standalone ``trend_fit`` (``trend``), the trimmed
moments of ``cooks`` and ``trimmed_var`` (``cooks``), the grid rescues
``grid_apeglm`` and ``grid_nb`` (``grid``), the apeGLM MAP fit
``shrink`` (``shrink``), the order statistics of ``select`` (``select``),
the masked IRLS ``irls`` (``irls``), the method-of-moments pass ``mom``
(``mom``), the Benjamini-Hochberg kernels of the independent filter
(``bh``), the hat diagonals and Wald test of ``hat_wald.cu`` (``hat``),
the filter's ``lowess`` (``lowess``), the refit's Cook's imputation
``impute`` (``impute``), the IRLS rescue's projected Newton
``newton_box`` (``box``), the blind VST's transform ``vst`` (``vst``),
the fine dispersion scan ``disp_scan_fine`` with its gene grouping
``disp_scan_group`` (``fine``), ``dnb_nll`` (``dnb``) and the gene
mesh's radix passes ``select_hist`` with their pick ``select_pick``
(``hist``).

    python3 -m pydeseq2_tpu_torch.kernel_bench [--detail] [--only SUITE[,SUITE]] [TREE ...]

Each TREE (default: this checkout) is the root of a checkout, for example
an earlier commit unpacked with ``git archive`` into an ignored directory.
Each runs in a process of its own that imports ``pydeseq2_tpu_torch`` from
that tree and builds there only the sources of the suites asked for (all
of them by default). To compare two versions in one call, name them parent,
change, change, parent.

``disp`` shapes (``make_data`` seed 0, linear mu, the 32-point coarse grid,
four Newton steps from the kernel scan's argmin; P > 2 adds indicator
columns of a seeded batch factor to the two-level condition): 100 x 60000
float32 at P = 2, 3, 5; 100 x 4000 and 100 x 10000 float32 at P = 2; 100 x
2000 float64 at P = 2; 100 x 4000 float64 at P = 2, 5; 100 x 60000 float64
at P = 2; the atlas dispersion block, 5000 genes x 10000 samples at P = 1,
in float32 and float64; the benchmark cells' gene blocks, 2816 x 17382
float32 (``gtex.refit``) and 30336 x 1224 float64 (``brca.refit``), at P =
2. Per tree and shape: the mean ms of 20 warm wrapper
calls (5 at the atlas block) by CUDA events, which on short gene lists
include the host's launch time, and by torch.profiler the device time of the
kernel alone and of all the wrapper runs on the card; the largest
differences from the plain version (scan: best log-alpha, the objective
cache relative to 1 + |f|; Newton: log-alpha, f relative to 1 + |f|), and
per kernel instantiation the registers and spill bytes (stores, loads) of
the ``-Xptxas -v`` report the build keeps. ``--detail`` adds, where the
tree has them, the atlas scan with its rows unsplit (one segment), and the
Newton launch on rows ordered by the final branch (r = exp(-la) < 8 or not)
with the share of warps whose genes end in both branches, in gene order and
in the wrapper's order; and, on rows over 1024 samples, the Newton launch
at each split of a gene's row over 1, 2, 4 and 8 warps
(``ops.dispersion._newton_plan``, which it names): its device time, the
blocks an SM holds, its largest differences from the plain version and
from the unsplit launch, and the genes whose log-alpha is not bit for bit
the unsplit launch's.

``sf`` shapes: one round's 8 Newton steps at 100 x 60000, 1000 x 60000 and
the atlas 10000 x 60000 in float32 and 100 x 60000 in float64, on Poisson
counts drawn on the card from a seeded generator (lognormal gene means,
seeded size factors), the per-gene mean of counts / sf0 as the coefficient,
seeded dispersions and a seeded keep set of ~95% of the genes; and one
``sf_nll`` pass at the same shapes, with that set as its mask, on the same
counts and on a zero-heavy copy of them (``zero_heavy``: ~60% of the cells
zero, one cell in every 100th gene at or above the lgamma table's bound,
one row of non-integer counts); and ``lgamma_table`` beside ``torch.lgamma``
of the same arange(1, 4097), float32 and float64, device time by the
profiler. ``trend``
shapes: 4000 and 60000 lanes in float32 and float64, seeded lanes (a trend
0.05 + 2 / base_mean times gamma noise, ~97% valid). Per shape the same
events and profiler times (kernels named ``sf_`` or ``trend``), the largest
difference from the plain version, the plan a tree's wrapper picks where it
has one, and for the trend the plain fit's reduction passes (loss, gradient
+ Fisher). ``--detail`` adds the other modes and cluster sizes of a tree
that has plans, and ``sf_nll`` with its lgamma table off (every cell
computing lgamma(y + 1)).

``cooks`` shapes: ``cooks`` at 100 x 60000 in float32 and float64 in
summary mode (distances written), at 1000 x 60000 float32 and on the atlas
block (5000 genes x 10000 samples) in refit mode, two equal cohorts, on
Poisson counts drawn on the card (lognormal gene means, seeded size
factors, mu their product, H uniform below 2 P / N); ``trimmed_var`` on
60000 genes x 100 samples of normalised counts (two cohorts of 50, the
class API's cell variances) in float64 and float32, and its mode 0 on a
59038-value float32 column of lognormal dispersions (the mean trend's
0.001-trimmed mean). Beside each, as a yardstick, the device time of
``torch.sort`` of the same cohort rows (the column), the sort alone. Per
shape the same events and profiler times (kernels named ``cooks_`` or
``trimmed_``), the largest relative differences from the plain version and
the plan a tree's wrapper picks where it has one; ``--detail`` adds the
other plans: the radix select where the rank count is picked and the rank
count where it may run, a block a row where a warp is picked and the other
way round, and the streamed workspace; and ``cooks`` (f32, f64) on
RANK_SWEEP_GENES genes in two cohorts of each size of RANK_SWEEP by each
method.

``grid`` shapes: ``grid_apeglm`` on the weak-effect tile (the operands that
``run_lfc_shrink_streamed`` hands the grid after ``summary_pipeline`` on
``make_data(100, WEAK_G, lfc_sd=0.1)``, float32: every lane of the tile,
then the pipeline's selection), on 1, 4 and 16 lanes of ``make_data(N, 16,
seed=3)`` at 8000 samples in float32 and 4000 in float64, and on a design
with a continuous covariate (intercept and a seeded normal column: no
sample skips a term) at the tile's 937 x 100 and at 16 x 8000 float32.
Per shape the same times (kernels named ``grid_apeglm``), the share of
lanes where kernel and plain version pick the same grid point, the plan a
tree's wrapper picks; ``--detail`` every cluster size 1-16, on these
shapes and on tiles of 64, 256 and 494 lanes at 100 samples in float32 and
of 937 in float64 (GRID_DETAIL_SHAPES). Then ``grid_nb`` through
``grid_fit_beta_batch`` as a caller calls it: on the IRLS rescue tile of
``summary_pipeline`` on ``make_data(100, RESCUE_G)`` float32 with the
pipeline's selection (and count), then every lane of that tile, and on
GRID_NB_SHAPES (``grid_operands``' counts, design and size factors e^offset,
dispersions 1 / size: 937 lanes x 100, 1 and 16 lanes x 8000 float32, 4
lanes x 4000 float64): times (kernels named ``grid_nb``), the share of
selected lanes at the plain version's grid point, the plan; ``--detail``
every cluster size.

``shrink`` shapes: ``nbinom_glm_batch``'s fit at 100 x 60000 float32 and
float64 and 1000 x 60000 float32 (``make_data``, median-of-ratios size
factors of counts + 0.5 as the offset, seeded dispersions, prior scales 15
and 0.5): times (kernels named ``shrink``), a digest of the coefficients'
bits (equal in two trees where the iterates are), the converged share,
Newton steps, the passes over the row the JAX order needs (the kernel's
count) and, where the tree's kernel reports them, the evaluations it made
and its reads of the row; ``--detail`` the other round size (1 or 3
candidates).

``select`` shapes (SELECT_SHAPES): the size-factor tile, 100 samples x
60000 genes reduced over the genes (log-ratios of Poisson counts drawn
on the card, genes with a zero excluded at +inf, the two middle ranks of
each sample), in float32 and float64 and at 1000 samples; one column of
60000 normal values with ~10% excluded (the prior's centre and MAD); the
trimmed solve's keep quantile, a column of 60000 lognormal values with
~5% excluded and the ranks either side of (n - 1) 0.95. Per shape the
events and device times (kernels named ``select``), whether the result
equals the plain version (a sort) and a repeated launch bit for bit, the
plan where the tree has one, and ``torch.sort`` of the same columns as
the yardstick; ``--detail`` every cluster size, staged where it fits and
streamed.

``irls`` shapes (IRLS_SHAPES): phase 1 of the LFC fit (``maxiter=8``) at
100 x 60000 float32 for P = 2, 3, 5, at 12, 200 and 1000 x 60000 and on the atlas
refit block (5000 genes x 10000 samples) in float32, at 100 x 60000 in
float64 (``make_data`` counts and design, median-of-ratios size factors,
seeded dispersions, ``irls_beta_init``); and the phase-2 tile, the call
of ``irls_core`` that ``summary_pipeline`` on ``make_data(100, RESCUE_G)``
makes after phase 1 (937 lanes, the 242-trip budget). Per shape the
events and device times of ``_irls_cuda`` alone (the parent's wrapper is
handed the deviance constant from PyTorch) and of ``irls_core`` whole
(all it runs on the card: the parent's constant pass shows there), the
share of lanes within 1e-4 (f32) / 1e-7 (f64) of the plain version, of
equal flags, the slowest lane's trips beside the plain loop's, and the
plan; ``--detail`` every lane count the design builds.

``mom`` shapes (MOM_SHAPES): ``make_data``'s counts and design (P = 1 the
intercept, P = 5 with a seeded batch's indicators, as :func:`inputs`),
median-of-ratios size factors: 100 x 60000 float32 at P = 1, 2, 5 without
mu, P = 2 with mu and on normalised counts (the class API's mode), 12 x
60000, 1000 x 60000, the atlas block 5000 x 10000 at P = 1, and 100 x
60000 float64. Per shape the events and device times (kernels named
``mom``; the device time of everything the wrapper runs holds the
parent's PyTorch mean(1/sf)), the largest relative difference from the
plain version, the plan where the tree has one, and as the yardstick the
device time of ``torch.matmul`` of the normalised counts and pinv(X)^T,
the OLS product alone; ``--detail`` every other plan built for the shape.

``bh`` shapes: the operands of ``device_padj`` in ``summary_pipeline`` on
``make_data(100, BH_G)`` float32 (p-values as float64, their stable order,
the valid mask, 50 base-mean cutoffs; base means and cutoffs widened to
float64), the row the run's lowess picks. Per tree the events and device
times (kernels named ``bh_``) of the whole (50, G) sweep
(``_bh_sweep_cuda``), of the one row without cutoffs (the
``independent_filter=False`` path), of ``device_padj`` whole in both
modes, and, where the tree has them, of the counts alone, the picked row
alone and the two together; the sweep with float32 operands; whether the
kernels equal the plain versions bit for bit; and as the yardstick the
device time of ``torch.argsort(stable=True)`` of the p-values.

``hat`` shapes (HAT_SHAPES): :func:`hat_operands` (``make_data`` counts
and design as :func:`inputs`, median-of-ratios size factors, the
least-squares coefficients of log((counts + 0.5) / sf), seeded
dispersions) at 100 x 60000 float32 for P = 2 and 5, 12 and 1000 x 60000,
the atlas block 5000 x 10000, 100 x 60000 float64, and the streamed
refit's 4096-gene tile at 100 samples. Per shape the events and device
times (kernels named ``hat_wald``) of the fused entry, the ``hat`` entry,
the ``wald`` entry on the fused call's mu and, where the tree has it, the
test alone (``want_hat=False``, the refit's call), beside the device time
of ``fill_`` on 2 x G x N values (the bytes of H and mu written alone, the
card's write rate as a yardstick); the largest differences
from the plain version as ``chip_smoke.py`` measures them; whether a
repeat and the test alone equal the fused call bit for bit; the plan
where the tree has one; ``--detail`` every other plan built for the shape.

``lowess`` shapes: the 50 cutoffs and rejection counts of the filter in
``summary_pipeline`` on ``make_data(100, BH_G)`` (as the ``bh`` suite
takes them), the quantile levels in float32 and float64: events and device
times (kernels named ``lowess``), the row and the fit against the plain
version, a repeat bit for bit; ``--detail`` adds seeded draws of 2 and 64
points.

``impute`` shapes (IMPUTE_SHAPES): the first refit tile (4096 rows) of
one ``run_summary_streamed(refit_cooks=True)`` run on ``make_data(N,
IMPUTE_G)`` with an outlier planted in every 100th gene, at 100 samples
in float32 and float64 and at 1000 in float32 (each run builds every
kernel lazily), and a seeded atlas tile of 4096 rows x 10000 samples
(:func:`impute_tile`). Per shape the events, the host clock's median
(``wall_ms``) and device times (kernels named ``impute``), the plain version's time, the cells that floor one
count apart from the plain version and those beyond the floor rule
(:func:`impute_floor_diffs`), a repeat bit for bit, the plan where the
tree has one; ``--detail`` every other trimmed-moment plan that fits.

``box`` shapes: the IRLS rescue tile that ``summary_pipeline`` on
``make_data(100, RESCUE_G)`` hands ``newton_box_nbglm`` (937 lanes), in
float32 and in float64 with two injected outliers, with the pipeline's
selection and with every lane, and BOX_SHAPES (:func:`box_operands`' 16
lanes at 8000 samples in float32 and 4000 in float64). Per shape the
events, the host clock's median of 7 windows (``wall_ms``) and device
times (kernels named ``newton_box``), the plain version's time, the
serial passes over each selected lane's row and, where the kernel reports
them, the evaluations of the sequential search, the shares of lanes at the
plain version's point and with its flag, a repeat bit for bit;
``--detail`` the plan and the kernel staged and with no sample staged
(every pass reading the row from device memory), twice each in turn over
5 x the shape's calls.

``vst`` shapes (VST_SHAPES): Poisson counts drawn on the card
(``vst_operands``: lognormal gene means times seeded size factors, the
parametric trend (0.05, 2.0), the mean dispersion 0.1) at 100 x 60000,
1000 x 60000 and the atlas block 5000 x 10000, each in float32 and
float64, and 101 x 60000 (a row length that takes the scalar accesses).
Per shape the device times (kernels named ``vst``) of the parametric
form, ``used_mean`` set, the mean form and every 7th gene masked, the
largest difference of each from the plain version (relative, absolute
below 1), a repeat bit for bit, NaN on exactly the masked rows (asserted),
the events of the parametric call and all it runs on the card, the bytes
bound, ``fill_`` of the output alone as the card's write rate, and the
plan where the tree has one.

``fine`` shapes (FINE_SHAPES), K = FINE_K = 8 points a gene around the
centres of a coarse scan (``disp_scan``, 32 points) of ``inputs``' draw:
100 x 60000 float32 at P = 2, 1 and 5, float64 at P = 2, the atlas block
5000 x 10000 at P = 1 (rows over segments), and two diagnostic gene lists
at 100 x 60000 float32 P = 2 (``fine_lists``): every gene at the most
common centre, and genes alternating so that every tile straddles r = 8
at every point. Per shape the events and device times of all that
``scan_grid`` runs (kernels named ``disp_scan``: the scan and, where the
tree has it, the grouping) and of the grouping alone, the (gene, point)
pairs of each form, the share of warps whose lanes take both forms in the
genes' order and in the tree's grouped order, the share of genes at the
plain version's point, the segments, and a digest of the best log-alpha
bits; ``main`` fails unless every tree gives the same digests.

``dnb`` shapes (DNB_SHAPES): ``inputs``' counts and mu at 100, 1000 and 12
x 60000 float32, 100 x 60000 float64 and the atlas block 5000 x 10000
float32, seeded lognormal dispersions: the events and device times
(kernels named ``dnb``), the gap from the plain version relative to the
summed magnitudes, a repeat bit for bit, the bytes bound, the tree's plan;
``--detail`` the device time of every plan (DNB_LANES) at each shape and
at DNB_EDGE_SHAPES, row lengths near the plan's thresholds.
The ``sf`` suite's ``lgamma_table`` rows carry the launch floor: the
device time of ``fill_`` on a one-element tensor of the type.

``hist`` shapes (HIST_SHAPES): the size-factor tile's log-ratios
(:func:`select_operands`' "tile", genes with a zero at +inf) at 100
samples x 60000 genes in float32 and float64, its first 15000 genes as one
shard of a four-rank mesh (the whole tile's ranks and digits), 1000 x
60000 and 8000 x 6000 float32, and an atlas shard of 10000 samples x
15000 genes float32. Per shape each radix pass with the digits of the
passes before it (the bytes of the two middle elements, from the
``select`` kernel): the device time (kernels named ``select_hist``), the
plain version's counts bit for bit, a repeat bit for bit, the bytes bound
and ``torch.bincount`` of pass 0's masked bins; where the tree has it, the
pick launch; then the one-rank ``sharded_masked_median`` whole: its device
time (everything it runs on the card), the kernels it launches a call
(the profiler's count), the host clock's median a call (``wall_ms``), bit
for bit the ``select`` kernel's median. ``--detail`` adds, where the tree
has a plan, each pass at half and twice the plan's rows.

``--detail`` also reports, per kernel instantiation of the suites'
sources, the instruction counts of its loops that call a transcendental,
from ``cuobjdump -sass`` of the built library: the loop's instructions, and
the shortest and longest path through one trip (``sass_loops``).

Prints the card first and, as the last line, every number as one JSON
object.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__" and "--child" in sys.argv:
    # Run as a file inside a tree: import that tree's package, not the
    # directory of this file.
    sys.path[0] = os.getcwd()

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEVICE = "cuda"
SOURCES = ("disp_scan.cu", "disp_newton.cu")  # the disp suite's
SUITES = {"disp": SOURCES, "sf": ("sizefactors.cu",), "trend": ("trend.cu",), "cooks": ("cooks.cu", "trimmed.cu"),
          "grid": ("grid.cu",), "shrink": ("shrink.cu",), "select": ("select.cu",), "irls": ("irls.cu",),
          "mom": ("mom.cu",), "bh": ("bh.cu", "lowess.cu"), "hat": ("hat_wald.cu",),
          "lowess": ("bh.cu", "lowess.cu"), "impute": ("impute.cu",), "box": ("newton_box.cu",),
          "vst": ("vst.cu",), "fine": ("disp_scan.cu",), "dnb": ("dnb_nll.cu",), "hist": ("select.cu",)}
VST_SHAPES = (
    # label, genes, samples, dtype, timed calls
    ("f32 100x60000", 60_000, 100, torch.float32, 20),
    ("f64 100x60000", 60_000, 100, torch.float64, 20),
    ("f32 1000x60000", 60_000, 1_000, torch.float32, 10),
    ("f64 1000x60000", 60_000, 1_000, torch.float64, 10),
    ("f32 atlas 5000x10000", 5_000, 10_000, torch.float32, 10),
    ("f64 atlas 5000x10000", 5_000, 10_000, torch.float64, 10),
    ("f32 101x60000 (unaligned rows)", 60_000, 101, torch.float32, 20),
    ("f64 101x60000 (unaligned rows)", 60_000, 101, torch.float64, 20),
)
FINE_K = 8  # the fine scan's points (alpha_mle_batch(fine_length=8))
FINE_SHAPES = (
    # label, genes, samples, P, dtype, gene list (fine_lists' kind), timed calls
    ("f32 100x60000 P=2", 60_000, 100, 2, torch.float32, "coarse", 20),
    ("f32 100x60000 P=1", 60_000, 100, 1, torch.float32, "coarse", 20),
    ("f32 100x60000 P=5", 60_000, 100, 5, torch.float32, "coarse", 10),
    ("f64 100x60000 P=2", 60_000, 100, 2, torch.float64, "coarse", 10),
    ("f32 atlas 5000x10000 P=1", 5_000, 10_000, 1, torch.float32, "coarse", 5),
    ("f32 100x60000 P=2 one centre", 60_000, 100, 2, torch.float32, "one", 20),
    ("f32 100x60000 P=2 every tile straddles", 60_000, 100, 2, torch.float32, "straddle", 20),
)
DNB_SHAPES = (
    # label, genes, samples, dtype, timed calls
    ("f32 100x60000", 60_000, 100, torch.float32, 20),
    ("f32 1000x60000", 60_000, 1_000, torch.float32, 10),
    ("f64 100x60000", 60_000, 100, torch.float64, 20),
    ("f32 12x60000", 60_000, 12, torch.float32, 20),
    ("f32 atlas 5000x10000", 5_000, 10_000, torch.float32, 10),
)
DNB_LANES = (4, 8, 32, 256)  # every plan of ops/nb.py:_dnb_plan (256: a block a row)
# --detail also sweeps the plans at row lengths near _dnb_plan's thresholds
DNB_EDGE_SHAPES = (
    ("f32 32x60000", 60_000, 32, torch.float32, 20),
    ("f32 48x60000", 60_000, 48, torch.float32, 20),
    ("f32 64x60000", 60_000, 64, torch.float32, 20),
    ("f32 129x60000", 60_000, 129, torch.float32, 20),
    ("f32 256x60000", 60_000, 256, torch.float32, 20),
    ("f32 2048x30000", 30_000, 2_048, torch.float32, 10),
    ("f32 4096x15000", 15_000, 4_096, torch.float32, 10),
)
MOM_SHAPES = (
    # label, genes, samples, P, dtype, want_mu, normed, timed calls
    ("f32 100x60000 P=2", 60_000, 100, 2, torch.float32, False, False, 20),
    ("f32 100x60000 P=2 mu", 60_000, 100, 2, torch.float32, True, False, 20),
    ("f32 100x60000 P=1", 60_000, 100, 1, torch.float32, False, False, 20),
    ("f32 100x60000 P=5", 60_000, 100, 5, torch.float32, False, False, 20),
    ("f32 100x60000 P=2 normed", 60_000, 100, 2, torch.float32, False, True, 20),
    ("f32 12x60000 P=2", 60_000, 12, 2, torch.float32, False, False, 20),
    ("f32 1000x60000 P=2", 60_000, 1_000, 2, torch.float32, False, False, 10),
    ("f32 atlas 5000x10000 P=1", 5_000, 10_000, 1, torch.float32, False, False, 10),
    ("f64 100x60000 P=2", 60_000, 100, 2, torch.float64, False, False, 20),
)
IMPUTE_SHAPES = (
    # label, samples, dtype, tile (impute_tile's kind), timed calls
    ("f32 stream tile 4096x100", 100, torch.float32, "stream", 50),
    ("f64 stream tile 4096x100", 100, torch.float64, "stream", 50),
    ("f32 stream tile 4096x1000", 1_000, torch.float32, "stream", 20),
    ("f32 atlas tile 4096x10000", 10_000, torch.float32, "atlas", 5),
)
IMPUTE_G = 60_000  # genes of the draws whose refit tile the impute suite takes
IMPUTE_ROWS = 4_096  # rows of the seeded atlas tile
BOX_SHAPES = (
    # label, lanes, samples, P, dtype, timed calls (box_operands' lanes, every lane)
    ("f32 16 lanes x 8000 P=2", 16, 8_000, 2, torch.float32, 10),
    ("f64 16 lanes x 4000 P=2", 16, 4_000, 2, torch.float64, 10),
)
BH_G = 60_000  # genes of the draw whose device_padj operands the bh and lowess suites take
HAT_SHAPES = (
    # label, genes, samples, P, dtype, timed calls
    ("f32 100x60000 P=2", 60_000, 100, 2, torch.float32, 20),
    ("f32 12x60000 P=2", 60_000, 12, 2, torch.float32, 20),
    ("f32 1000x60000 P=2", 60_000, 1_000, 2, torch.float32, 10),
    ("f32 100x60000 P=5", 60_000, 100, 5, torch.float32, 20),
    ("f64 100x60000 P=2", 60_000, 100, 2, torch.float64, 20),
    ("f32 atlas 5000x10000 P=2", 5_000, 10_000, 2, torch.float32, 5),
    ("f32 refit tile 100x4096 P=2", 4_096, 100, 2, torch.float32, 50),
)
SELECT_SHAPES = (
    # label, kind ("tile", "column" or "quantile"), columns, values a column, dtype, timed calls
    ("f32 tile 100x60000", "tile", 100, 60_000, torch.float32, 20),
    ("f32 column 60000", "column", 1, 60_000, torch.float32, 20),
    ("f32 keep quantile 60000", "quantile", 1, 60_000, torch.float32, 20),
    ("f32 tile 1000x60000", "tile", 1_000, 60_000, torch.float32, 10),
    ("f64 tile 100x60000", "tile", 100, 60_000, torch.float64, 20),
)
HIST_SHAPES = (
    # label, samples (columns), genes (values a column), genes of the shard timed (None: all), dtype, timed calls
    ("f32 100x60000", 100, 60_000, None, torch.float32, 20),
    ("f32 100x60000 shard of 15000", 100, 60_000, 15_000, torch.float32, 20),
    ("f64 100x60000", 100, 60_000, None, torch.float64, 20),
    ("f64 100x60000 shard of 15000", 100, 60_000, 15_000, torch.float64, 20),
    ("f32 1000x60000", 1_000, 60_000, None, torch.float32, 10),
    ("f32 8000x6000", 8_000, 6_000, None, torch.float32, 10),
    ("f32 atlas shard 10000x15000", 10_000, 15_000, None, torch.float32, 5),
)
IRLS_SHAPES = (
    # label, genes, samples, P, dtype, maxiter, timed calls
    ("f32 phase 1 100x60000 P=2", 60_000, 100, 2, torch.float32, 8, 20),
    ("f32 phase 1 12x60000 P=2", 60_000, 12, 2, torch.float32, 8, 20),
    ("f32 phase 1 200x60000 P=2", 60_000, 200, 2, torch.float32, 8, 10),
    ("f32 phase 1 100x60000 P=3", 60_000, 100, 3, torch.float32, 8, 10),
    ("f32 phase 1 100x60000 P=5", 60_000, 100, 5, torch.float32, 8, 10),
    ("f32 phase 1 1000x60000 P=2", 60_000, 1_000, 2, torch.float32, 8, 5),
    ("f32 atlas refit block 5000x10000 P=2", 5_000, 10_000, 2, torch.float32, 8, 3),
    ("f64 phase 1 100x60000 P=2", 60_000, 100, 2, torch.float64, 8, 10),
)
SF_SHAPES = (
    # label, genes, samples, dtype, timed calls
    ("f32 100x60000", 60_000, 100, torch.float32, 20),
    ("f32 1000x60000", 60_000, 1_000, torch.float32, 10),
    ("f64 100x60000", 60_000, 100, torch.float64, 20),
    ("f32 atlas 10000x60000", 60_000, 10_000, torch.float32, 3),
)
ZERO_SHARE = 0.6  # cells the zero-heavy sf_nll draw sets to zero
WEAK_G = 60_000  # genes of the weak-effect draw whose grid tile the grid suite takes
GRID_SHAPES = (
    # label, lanes, samples, dtype, design ("indicator" or "continuous"), timed calls
    ("f32 1 lane x 8000", 1, 8_000, torch.float32, "indicator", 5),
    ("f32 4 lanes x 8000", 4, 8_000, torch.float32, "indicator", 5),
    ("f32 16 lanes x 8000", 16, 8_000, torch.float32, "indicator", 5),
    ("f64 1 lane x 4000", 1, 4_000, torch.float64, "indicator", 5),
    ("f64 4 lanes x 4000", 4, 4_000, torch.float64, "indicator", 5),
    ("f64 16 lanes x 4000", 16, 4_000, torch.float64, "indicator", 5),
    ("f32 continuous 937 x 100", 937, 100, torch.float32, "continuous", 5),
    ("f32 continuous 16 x 8000", 16, 8_000, torch.float32, "continuous", 5),
)
GRID_NB_SHAPES = (
    # label, lanes, samples, dtype, timed calls (the indicator design)
    ("f32 937 lanes x 100", 937, 100, torch.float32, 5),
    ("f32 1 lane x 8000", 1, 8_000, torch.float32, 3),
    ("f32 16 lanes x 8000", 16, 8_000, torch.float32, 3),
    ("f64 4 lanes x 4000", 4, 4_000, torch.float64, 3),
)
# --detail's grid tiles between 16 and 937 lanes, and the tile's width in
# float64, where the cluster size the plan picks changes
GRID_DETAIL_SHAPES = (
    ("f32 64 lanes x 100", 64, 100, torch.float32, "indicator", 5),
    ("f32 256 lanes x 100", 256, 100, torch.float32, "indicator", 5),
    ("f32 494 lanes x 100", 494, 100, torch.float32, "indicator", 5),
    ("f64 937 lanes x 100", 937, 100, torch.float64, "indicator", 5),
)
RESCUE_G = 60_000  # genes of the main draw whose IRLS rescue tile the grid suite takes
SHRINK_SHAPES = (
    # label, genes, samples, dtype, timed calls
    ("f32 100x60000", 60_000, 100, torch.float32, 10),
    ("f64 100x60000", 60_000, 100, torch.float64, 5),
    ("f32 1000x60000", 60_000, 1_000, torch.float32, 3),
)
TREND_SHAPES = (
    # label, lanes, dtype, timed calls
    ("f32 4000", 4_000, torch.float32, 20),
    ("f32 60000", 60_000, torch.float32, 20),
    ("f64 4000", 4_000, torch.float64, 20),
    ("f64 60000", 60_000, torch.float64, 20),
)
COOKS_SHAPES = (
    # label, genes, samples, dtype, refit mode, timed calls
    ("f32 100x60000", 60_000, 100, torch.float32, False, 20),
    ("f64 100x60000", 60_000, 100, torch.float64, False, 20),
    ("f32 1000x60000 refit", 60_000, 1_000, torch.float32, True, 10),
    ("f32 atlas 5000x10000 refit", 5_000, 10_000, torch.float32, True, 5),
)
RANK_SWEEP = (32, 64, 96, 128)  # cohort sizes of --detail's rank-count sweep (2 cohorts)
RANK_SWEEP_GENES = 60_000
TRIM_SHAPES = (
    # label, genes (column: values), samples (column: 0), dtype, timed calls
    ("f64 cohorts 60000x100", 60_000, 100, torch.float64, 20),
    ("f32 cohorts 60000x100", 60_000, 100, torch.float32, 20),
    ("f32 column 59038", 59_038, 0, torch.float32, 20),
)
SHAPES = (
    # label, genes, samples, P, dtype, timed calls
    ("f32 100x60000 P=2", 60_000, 100, 2, torch.float32, 20),
    ("f32 100x60000 P=3", 60_000, 100, 3, torch.float32, 20),
    ("f32 100x60000 P=5", 60_000, 100, 5, torch.float32, 20),
    ("f32 100x4000 P=2", 4_000, 100, 2, torch.float32, 20),
    ("f32 100x10000 P=2", 10_000, 100, 2, torch.float32, 20),
    ("f64 100x2000 P=2", 2_000, 100, 2, torch.float64, 20),
    ("f64 100x4000 P=2", 4_000, 100, 2, torch.float64, 20),
    ("f64 100x4000 P=5", 4_000, 100, 5, torch.float64, 20),
    ("f64 100x60000 P=2", 60_000, 100, 2, torch.float64, 20),
    ("f32 atlas 5000x10000 P=1", 5_000, 10_000, 1, torch.float32, 5),
    ("f64 atlas 5000x10000 P=1", 5_000, 10_000, 1, torch.float64, 5),
    # the benchmark cells' gene blocks: gtex.refit's and brca.refit's
    ("f32 gtex block 2816x17382 P=2", 2_816, 17_382, 2, torch.float32, 5),
    ("f64 brca block 30336x1224 P=2", 30_336, 1_224, 2, torch.float64, 5),
)


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


def wall_ms(fn, reps: int, windows: int = 7) -> float:
    """Median over ``windows`` windows of ``reps`` warm calls of ``fn`` of
    the host clock's time per call, each window closed by a synchronise:
    where the host is slower than the card, the wrapper's host time per
    call, less swayed by one slow window than :func:`cuda_ms`."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / reps * 1e3)
    return float(np.median(per))


def device_ms(fn, reps: int, name: str) -> tuple[float, float]:
    """Mean device time of ``fn`` over ``reps`` warm calls from
    torch.profiler, which a host slower than the card does not inflate: (the
    kernels whose name holds ``name``, everything ``fn`` runs on the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    own = sum(e.self_device_time_total for e in kern if name in e.key)
    return own / reps / 1e3, sum(e.self_device_time_total for e in kern) / reps / 1e3


def inputs(G: int, N: int, P: int, dtype):
    """(counts, mu, X) on the card: ``make_data``'s counts and design (for
    P = 1 the intercept; for P > 2 besides indicator columns of a seeded
    (P - 1)-level batch), median-of-ratios size factors and the OLS mean,
    clamped at 0.5, as the pipelines' first mu."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G)
    X_np = X_np[:, :P]
    if P > 2:
        batch = np.random.default_rng(1).integers(0, P - 1, N)
        X_np = np.column_stack([X_np] + [(batch == b).astype(float) for b in range(1, P - 1)])
    counts = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=DEVICE)
    X = torch.as_tensor(X_np, dtype=dtype, device=DEVICE)
    logc = torch.log(counts)
    ok = torch.isfinite(logc.mean(1))
    sf = torch.exp(torch.median(logc[ok] - logc[ok].mean(1, keepdim=True), dim=0).values)
    beta = (counts / sf) @ torch.linalg.pinv(X).T
    mu = torch.clamp((beta @ X.T) * sf, min=0.5)
    return counts, mu.contiguous(), X


def ptxas(kernels, sources=SOURCES) -> dict:
    """{source: {key: [registers, spill stores, spill loads]}}, the key "P<p>
    f32|f64" for a kernel templated on the design width ("P<p> f32|f64 M<m>"
    where also on shrink's round size, "... split" for disp_newton's row
    split over warps, "... S<s>" on irls' lanes a gene,
    "... S<s> registers|shared" on mom's lanes and storage, "... S<s>
    fused|hat|test" on hat_wald's lanes and mode), "<kernel>
    f32|f64 shared|streamed" for a cluster kernel templated on its mode,
    "<kernel> f32|f64 S<s>" for one templated on its type and lanes a row
    (``dnb_nll``) and "<kernel> f32|f64" for one templated on its type
    alone."""
    out = {}
    for src in sources:
        text = kernels._lib_path(src).with_suffix(".ptxas.txt").read_text()
        rows = {}
        for m in re.finditer(r"Compiling entry function '([^']+)'(.*?)Used (\d+) registers", text, re.S):
            inst = re.search(r"ILi(\d+)E([fd])(?:Li(\d+)E)?(?:Lb([01])E)?E", m.group(1))
            hw = re.search(r"hat_wald_kernelILi(\d+)E([fd])Li(\d+)ELi([012])EE", m.group(1))
            mode = re.search(r"\d+([a-z][a-z_]*_kernel)I([fd])Lb([01])E", m.group(1))
            typed = re.search(r"\d+([a-z][a-z_]*_kernel)I([fd])E", m.group(1))
            lanes = re.search(r"\d+([a-z][a-z_]*_kernel)I([fd])Li(\d+)EE", m.group(1))
            if hw is not None:
                key = (f"P{hw.group(1)} {'f32' if hw.group(2) == 'f' else 'f64'} S{hw.group(3)} "
                       f"{('fused', 'hat', 'test')[int(hw.group(4))]}")
            elif inst is not None and "disp_newton_kernel" in m.group(1):
                # the row split over several warps a gene, its own instantiation
                key = f"P{inst.group(1)} {'f32' if inst.group(2) == 'f' else 'f64'}" + (
                    " split" if inst.group(4) == "1" else "")
            elif inst is not None:
                # irls' and mom's lanes a gene, shrink's round; mom's registers or shared memory
                third = "S" if "irls_kernel" in m.group(1) or "mom_kernel" in m.group(1) else "M"
                key = f"P{inst.group(1)} {'f32' if inst.group(2) == 'f' else 'f64'}" + (
                    f" {third}{inst.group(3)}" if inst.group(3) else "") + (
                    f" {'registers' if inst.group(4) == '1' else 'shared'}" if inst.group(4) else "")
            elif mode is not None:
                key = (f"{mode.group(1)} {'f32' if mode.group(2) == 'f' else 'f64'} "
                       f"{'shared' if mode.group(3) == '1' else 'streamed'}")
            elif lanes is not None:
                key = f"{lanes.group(1)} {'f32' if lanes.group(2) == 'f' else 'f64'} S{lanes.group(3)}"
            elif typed is not None:
                key = f"{typed.group(1)} {'f32' if typed.group(2) == 'f' else 'f64'}"
            else:
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", m.group(2))
            rows[key] = [int(m.group(3)), int(sp.group(1)) if sp else 0, int(sp.group(2)) if sp else 0]
        out[src] = rows
    return out


def disp_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    rows = {}
    for label, G, N, P, dtype, reps in SHAPES:
        counts, mu, X = inputs(G, N, P, dtype)
        max_disp = float(max(10, N))
        lo_f, hi_f = math.log(1e-8), math.log(max_disp)
        K = 32
        step1_f = (hi_f - lo_f) / (K - 1)
        lo = torch.tensor(lo_f, dtype=dtype, device=DEVICE)
        step1 = torch.tensor(step1_f, dtype=dtype, device=DEVICE)
        la_grid = lo + torch.arange(K, dtype=dtype, device=DEVICE) * step1
        bs, be = dsp._scan_branches(K, step1_f, lo_f)
        la_hat = torch.zeros(G, dtype=dtype, device=DEVICE)
        pdv = torch.tensor(1.0, dtype=dtype, device=DEVICE)
        scan_args = (counts, mu, X, la_grid, bs, be, (lo_f + hi_f) / 2, True, False, la_hat, pdv)
        la1, coarse = dsp.scan_coarse(*scan_args)
        la1_p, coarse_p = dsp.scan_coarse_plain(*scan_args)
        newton_args = (counts, mu, X, la1, lo_f, hi_f, step1_f, step1_f / 3.5, 4, True, False, la_hat, pdv)
        out = dsp.newton_polish(*newton_args)
        out_p = dsp.newton_polish_plain(*newton_args)
        scan_dev = device_ms(lambda: dsp.scan_coarse(*scan_args), reps, "disp_scan")
        newton_dev = device_ms(lambda: dsp.newton_polish(*newton_args), reps, "disp_newton")
        row = {
            "disp_scan_ms": cuda_ms(lambda: dsp.scan_coarse(*scan_args), reps),
            "disp_newton_ms": cuda_ms(lambda: dsp.newton_polish(*newton_args), reps),
            "disp_scan_kernel_ms": scan_dev[0], "disp_scan_device_ms": scan_dev[1],
            "disp_newton_kernel_ms": newton_dev[0], "disp_newton_device_ms": newton_dev[1],
            "scan_la_err": (la1 - la1_p).abs().max().item(),
            "scan_f_err": ((coarse - coarse_p).abs() / (1 + coarse_p.abs())).max().item(),
            "newton_la_err": (out[0] - out_p[0]).abs().max().item(),
            "newton_f_err": ((out[1] - out_p[1]).abs() / (1 + out_p[1].abs())).max().item(),
        }
        if detail and N > 1024 and hasattr(dsp, "_scan_segments"):
            split = dsp._scan_segments
            dsp._scan_segments = lambda G_, N_, sms: 1
            try:
                row["disp_scan_one_segment_ms"] = cuda_ms(lambda: dsp.scan_coarse(*scan_args), reps)
            finally:
                dsp._scan_segments = split
        if detail:
            plain_gene = torch.exp(-out_p[0]) < 8.0
            perm = torch.argsort(plain_gene.to(torch.int8), stable=True)
            sorted_args = (counts[perm].contiguous(), mu[perm].contiguous(), X, la1[perm].contiguous(),
                           *newton_args[4:11], la_hat[perm].contiguous(), pdv)
            row["disp_newton_branch_sorted_ms"] = cuda_ms(lambda: dsp.newton_polish(*sorted_args), reps)
            # 32 / L genes a warp, L the lanes a gene by N (csrc/disp_newton.cu;
            # short gene lists take more)
            L = 4 if N <= 64 else (8 if N <= 128 else (16 if N <= 256 else 32))
            per_warp = 32 // L

            def mixed_share(flags):
                pw = flags[: G - G % per_warp].reshape(-1, per_warp)
                return (pw.any(1) & ~pw.all(1)).double().mean().item()

            start_order = torch.argsort((la1 > -math.log(8.0)).to(torch.uint8), stable=True)
            row["plain_branch_share"] = plain_gene.double().mean().item()
            row["mixed_warps_gene_order"] = mixed_share(plain_gene)
            row["mixed_warps_wrapper_order"] = mixed_share(plain_gene[start_order])
        if detail and N > 1024 and hasattr(dsp, "_newton_plan"):
            row["disp_newton_plan"] = dsp._newton_device_plan(G, N, P, dtype, DEVICE)
            row["disp_newton_split"] = newton_split_sweep(dsp, newton_args, out, out_p, reps)
        rows[label] = row
        print(f"  {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del counts, mu, X, coarse, coarse_p, out, out_p
        torch.cuda.empty_cache()
    return rows




def newton_split_sweep(dsp, newton_args, out, out_p, reps: int) -> dict:
    """{warps a gene: readings} of the ``disp_newton`` launch at each split
    of a gene's row (``_newton_polish_cuda(plan=wg)``): device ms, the
    blocks an SM holds, the largest log-alpha and relative objective gaps
    from the plain version (``out_p``) and from the launch the wrapper's
    plan made (``out``), and the genes whose log-alpha differs in any bit
    from the unsplit launch's."""
    counts, mu, X = newton_args[:3]
    G, N = counts.shape
    isz = counts.element_size()
    sweep, unsplit = {}, None
    for wg in dsp._NEWTON_WARPS:
        def run(wg=wg):
            return dsp._newton_polish_cuda(*newton_args, plan=wg)

        o = run()
        if unsplit is None:
            unsplit = o
        sweep[wg] = {
            "device_ms": device_ms(run, reps, "disp_newton")[0],
            "per_sm": dsp._newton_card_per_sm(torch.device(DEVICE), isz, X.shape[1], N, wg),
            "la_err": (o[0] - out_p[0]).abs().max().item(),
            "f_err": ((o[1] - out_p[1]).abs() / (1 + out_p[1].abs())).max().item(),
            "la_gap_plan": (o[0] - out[0]).abs().max().item(),
            "la_gap_unsplit": (o[0] - unsplit[0]).abs().max().item(),
            "genes_not_bit_equal_unsplit": int((o[0] != unsplit[0]).sum().item()),
        }
        print(f"    disp_newton {wg} warps a gene: {json.dumps(sweep[wg])}", file=sys.stderr, flush=True)
    return sweep


def sf_operands(G: int, N: int, dtype):
    """One trimmed-solve round's operands on the card, from a seeded
    generator there (so a 10000 x 60000 draw takes no host time): Poisson
    counts (G, N) at lognormal gene means times seeded size factors sf0,
    the per-gene mean of counts / sf0, dispersions, a keep set of ~95%."""
    g = torch.Generator(device=DEVICE).manual_seed(0)

    def randn(n):
        return torch.randn(n, generator=g, device=DEVICE, dtype=torch.float64)

    base = torch.exp(3.0 + 1.5 * randn(G))
    s0 = 0.3 * randn(N)
    counts = torch.poisson(base[:, None] * torch.exp(s0)[None, :], generator=g).to(dtype)
    disp = torch.clamp(torch.exp(-2.0 + randn(G)), 1e-3, 5.0).to(dtype)
    keep = torch.rand(G, generator=g, device=DEVICE) < 0.95
    s0 = s0.to(dtype)
    sf0, inv_sf0 = torch.exp(s0), torch.exp(-s0)
    coef = (counts * inv_sf0[None, :]).mean(1)
    return counts, coef, sf0, inv_sf0, s0, disp, keep


def zero_heavy(counts: torch.Tensor) -> torch.Tensor:
    """A copy of (G, N) counts with ZERO_SHARE of the cells set to zero (a
    seeded draw), one cell in every 100th gene set at or above the lgamma
    table's bound (4096 + the gene's index), and gene 1 made non-integer
    (1.5 y + 0.25)."""
    g = torch.Generator(device=counts.device).manual_seed(1)
    G, N = counts.shape
    out = torch.where(torch.rand(G, N, generator=g, device=counts.device) < ZERO_SHARE, 0.0, counts)
    genes = torch.arange(0, G, 100, device=counts.device)
    out[genes, genes % N] = (4096.0 + genes).to(counts.dtype)
    out[min(1, G - 1)] = 1.5 * out[min(1, G - 1)] + 0.25
    return out


def nll_row(ops, reps: int, detail: bool, gene_block: int | None) -> dict:
    """``sf_nll`` at the round's start on ``ops`` (``sf_operands``' tuple,
    its keep set as the mask): times, the largest relative difference from
    the plain version and its bit-equal share, the plan; ``--detail`` the
    other lane counts."""
    from pydeseq2_tpu_torch.ops import sizefactors as sz

    c, coef, sf0, inv_sf0, s0, disp, mask = ops
    args = (c, coef, sf0, inv_sf0, s0, disp, mask, 0.5)
    got, want = sz._sf_nll_cuda(*args), sz._sf_nll_plain(*args, gene_block)
    on = mask
    kern, dev = device_ms(lambda: sz._sf_nll_cuda(*args), reps, "sf_nll")
    row = {"sf_nll_ms": cuda_ms(lambda: sz._sf_nll_cuda(*args), reps), "sf_nll_kernel_ms": kern,
           "sf_nll_device_ms": dev,
           "rel_err": ((got[on] - want[on]).abs() / want[on].abs().clamp(min=1.0)).max().item(),
           "bit_equal_share": (got[on] == want[on]).double().mean().item(),
           "zero_share": (c == 0).double().mean().item()}
    if hasattr(sz, "_nll_plan"):
        plan = sz._nll_plan(c.shape[1], c.element_size())
        row["plan"] = plan._asdict()
        if detail and hasattr(sz, "LGAMMA_TABLE_LEN"):
            # the picked plan with every cell computing lgamma(y + 1)
            full = sz.LGAMMA_TABLE_LEN
            sz.LGAMMA_TABLE_LEN = 0
            try:
                row["kernel_ms table off"] = device_ms(lambda: sz._sf_nll_cuda(*args), reps, "sf_nll")[0]
                row["table off bit_equal"] = bool(torch.equal(sz._sf_nll_cuda(*args), got))
            finally:
                sz.LGAMMA_TABLE_LEN = full
        if detail:
            for lanes in (4, 8, 16, 32):
                if lanes != plan.lanes:
                    other = plan._replace(lanes=lanes)
                    row[f"kernel_ms lanes={lanes}"] = device_ms(lambda: sz._sf_nll_cuda(*args, plan=other), reps,
                                                                "sf_nll")[0]
    return row


def sf_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch.ops import sizefactors as sz

    rows = {}
    for label, G, N, dtype, reps in SF_SHAPES:
        ops = sf_operands(G, N, dtype)
        args = (*ops, 0.5, 8)
        err = (sz._sf_newton_cuda(*args) - sz._sf_newton_plain(*args)).abs().max().item()
        kern, dev = device_ms(lambda: sz._sf_newton_cuda(*args), reps, "sf_newton")
        row = {"sf_newton_ms": cuda_ms(lambda: sz._sf_newton_cuda(*args), reps), "sf_newton_kernel_ms": kern,
               "sf_newton_device_ms": dev, "err": err}
        if hasattr(sz, "_sf_plan"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count if ops[0].is_cuda else 132
            plan = sz._sf_plan(G, N, ops[0].element_size(), sms)
            row["plan"] = plan._asdict()
            if detail:
                others = {"streamed": plan._replace(shared=False, max_clusters=0)}
                if plan.C > 1:
                    others[f"C={plan.C // 2}"] = plan._replace(C=plan.C // 2)
                for name, other in others.items():
                    row[f"kernel_ms {name}"] = device_ms(
                        lambda: sz._sf_newton_cuda(*args, plan=other), reps, "sf_newton")[0]
        # the plain NLL in blocks of 5000 genes, so the atlas fits the card
        gene_block = 5_000 if G * N > 10_000_000 else None
        row["sf_nll"] = nll_row(ops, reps, detail, gene_block)
        row["sf_nll zero_heavy"] = nll_row((zero_heavy(ops[0]), *ops[1:]), reps, detail, gene_block)
        rows[label] = row
        print(f"  sf {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del ops, args
        torch.cuda.empty_cache()
    if hasattr(sz, "_lgamma_table_cuda"):
        for dtype in (torch.float32, torch.float64):
            rows[f"lgamma_table {'f32' if dtype == torch.float32 else 'f64'}"] = lgamma_row(dtype)
    return rows


def lgamma_row(dtype) -> dict:
    """``lgamma_table`` (lgamma(i + 1), i < the table's length) against
    ``torch.lgamma`` of the same arange(1, length + 1), device time by
    the profiler (each kernel alone), the wrapper by events, the launch
    floor (the device time of ``fill_`` on one element: the least a launch
    takes) and the largest difference."""
    from pydeseq2_tpu_torch.ops import sizefactors as sz

    x = torch.arange(1, sz.LGAMMA_TABLE_LEN + 1, dtype=dtype, device=DEVICE)
    one = torch.empty(1, dtype=dtype, device=DEVICE)
    table = sz._lgamma_table_cuda(dtype, x.device)
    return {"lgamma_table_kernel_ms": device_ms(lambda: sz._lgamma_table_cuda(dtype, x.device), 50,
                                                "lgamma_table")[0],
            "lgamma_table_ms": cuda_ms(lambda: sz._lgamma_table_cuda(dtype, x.device), 50),
            "torch_lgamma_kernel_ms": device_ms(lambda: torch.lgamma(x), 50, "lgamma")[0],
            "torch_lgamma_ms": cuda_ms(lambda: torch.lgamma(x), 50),
            "launch_floor_ms": device_ms(lambda: one.fill_(1.0), 50, "")[1],
            "max_abs_diff": (table - torch.lgamma(x)).abs().max().item()}


def trend_lanes(G: int, dtype):
    """Seeded lanes: covariates 1 / base_mean (lognormal means), targets
    0.05 + 2 / base_mean times gamma noise, a mask of ~97%, base_mean."""
    rng = np.random.default_rng(0)
    base_mean = rng.lognormal(4.0, 2.0, G)
    targets = (0.05 + 2.0 / base_mean) * rng.gamma(2.0, 0.5, G)
    valid = rng.random(G) < 0.97

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=DEVICE)

    return t(1.0 / base_mean), t(targets), torch.as_tensor(valid, device=DEVICE), t(base_mean)


def count_passes(tr, run) -> tuple[int, int]:
    """(loss passes, gradient + Fisher passes) of the plain fit in run()."""
    calls = {"trend_loss": 0, "trend_grad": 0}
    originals = {n: getattr(tr, n) for n in calls}

    def counted(name):
        def fn(*a, **k):
            calls[name] += 1
            return originals[name](*a, **k)

        return fn

    try:
        for n in calls:
            setattr(tr, n, counted(n))
        run()
    finally:
        for n, fn in originals.items():
            setattr(tr, n, fn)
    return calls["trend_loss"], calls["trend_grad"]


def trend_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import trend as tr

    rows = {}
    for label, G, dtype, reps in TREND_SHAPES:
        cov, tar, valid, bm = trend_lanes(G, dtype)
        mean_disp = tar[valid].mean()

        def fit(**kw):
            return tr._trend_fit_cuda(cov, tar, valid, 60, **kw)

        def trend(**kw):
            return tr._parametric_trend_cuda(bm, tar, valid, mean_disp, 20, **kw)

        def rel(a, b):
            return ((a - b).abs() / b.abs()).max().item()

        want_fit = tr._trend_fit_plain(cov, tar, valid, 60)
        want_trend = tr._parametric_trend_plain(bm, tar, valid, mean_disp, 20)
        fit_k, fit_dev = device_ms(fit, reps, "trend")
        trend_k, trend_dev = device_ms(trend, reps, "trend")
        row = {"trend_ms": cuda_ms(trend, reps), "trend_kernel_ms": trend_k, "trend_device_ms": trend_dev,
               "trend_fit_ms": cuda_ms(fit, reps), "trend_fit_kernel_ms": fit_k, "trend_fit_device_ms": fit_dev,
               "trend_fit_coef_err": rel(fit()[0], want_fit[0]), "trend_coef_err": rel(trend()[1], want_trend[1]),
               "trend_rounds": int(want_trend[3]),
               "fit_passes": count_passes(tr, lambda: tr._trend_fit_plain(cov, tar, valid, 60)),
               "trend_passes": count_passes(tr, lambda: tr._parametric_trend_plain(bm, tar, valid, mean_disp, 20))}
        if hasattr(tr, "_trend_plan"):
            plan = tr._trend_plan(G, cov.element_size())
            row["plan"] = plan._asdict()
            if detail:
                for K in (1, 2, 4, 8, 16):
                    for shared in (True, False):
                        other = tr.TrendPlan(K, shared)
                        if K > G or (shared and tr._trend_smem_bytes(-(-G // K), cov.element_size(), True)
                                     > kernels.SMEM_BLOCK_MAX):
                            continue
                        row[f"K={K} {'shared' if shared else 'streamed'}"] = [
                            device_ms(lambda: fit(plan=other), reps, "trend")[0],
                            device_ms(lambda: trend(plan=other), reps, "trend")[0]]
        rows[label] = row
        print(f"  trend {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
    return rows


def cooks_operands(G: int, N: int, dtype, refit: bool):
    """The ``cooks`` wrapper's arguments on the card, from a seeded
    generator there: Poisson counts at lognormal gene means times seeded
    size factors, mu their product, H uniform below 2 P / N (P = 2), two
    equal cohorts of every sample, a cutoff of 4.8; in refit mode every
    sample replaceable and no distances written."""
    g = torch.Generator(device=DEVICE).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE, dtype=torch.float64)

    base = torch.exp(3.0 + 1.5 * randn(G))
    sf = torch.exp(0.3 * randn(N))
    mu = base[:, None] * sf[None, :]
    counts = torch.poisson(mu, generator=g).to(dtype)
    H = (torch.rand(G, N, generator=g, device=DEVICE, dtype=torch.float64) * (4.0 / N)).to(dtype)
    cohort_ids = tuple(2 * i // N for i in range(N))
    args = (counts, sf.to(dtype), mu.to(dtype), H, (counts > 0).any(1), 2, cohort_ids, (True,) * N,
            torch.tensor(4.8, dtype=dtype, device=DEVICE))
    return args + (((True,) * N, False) if refit else ())


def cohort_rows(x: torch.Tensor, cohort_ids) -> list[torch.Tensor]:
    """The (G, n) rows of each cohort of the (G, N) values ``x``."""
    return [x[:, torch.tensor([i for i, c in enumerate(cohort_ids) if c == lvl], device=x.device)].contiguous()
            for lvl in dict.fromkeys(cohort_ids)]


def other_plans(plan, itemsize: int, n: int, buf_len: int, rows: int) -> dict:
    """The plans ``--detail`` times beside the one picked, where they fit
    (``buf_len`` staged keys a row): the radix select where the rank count
    is picked, the rank count where the cohorts (``n`` the longest) allow
    it, the other group (a block of 256 a row, a warp a row), a block of
    1024, and the streamed workspace."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import stats as st

    def fits(p):
        radix = n > p.rank_max
        if not p.block:
            return 8 * st._trim_group_bytes(buf_len, itemsize, radix, True, False) <= kernels.SMEM_BLOCK_MAX
        return not p.shared or st._trim_group_bytes(buf_len, itemsize, radix, True, True) <= kernels.SMEM_BLOCK_MAX

    others = {}
    if n <= plan.rank_max:
        others["radix"] = plan._replace(rank_max=0)
    elif n <= st._TRIM_RANK_CAP:
        others["rank count"] = plan._replace(rank_max=st._TRIM_RANK_CAP)
    if plan.block:
        others["warp a row"] = plan._replace(block=False, threads=256, shared=True, blocks=0)
        if plan.threads == 256:
            others["block of 1024"] = plan._replace(threads=1024)
    else:
        others["block a row"] = plan._replace(block=True, threads=256)
    if plan.shared:
        others["streamed"] = plan._replace(block=True, shared=False, blocks=min(rows, 2 * 132))
    return {name: p for name, p in others.items() if fits(p)}


def cooks_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import cooks as ck
    from pydeseq2_tpu_torch.ops import stats as st

    rows = {}
    for label, G, N, dtype, refit, reps in COOKS_SHAPES:
        args = cooks_operands(G, N, dtype, refit)
        got = ck._cooks_cuda(*args)
        want = ck._cooks_plain(*args[:9], args[9] if refit else None, True)
        rel = ((got[2] - want[2]).abs() / want[2].abs()).nan_to_num(0.0).max().item()
        kern, dev = device_ms(lambda: ck._cooks_cuda(*args), reps, "cooks_")
        normed = args[0] / args[1][None, :]
        sorts = cohort_rows(normed, args[6])
        row = {"cooks_ms": cuda_ms(lambda: ck._cooks_cuda(*args), reps), "cooks_kernel_ms": kern,
               "cooks_device_ms": dev, "disp_rel_err": rel,
               "sort_ms": device_ms(lambda: [torch.sort(r, dim=1) for r in sorts], reps, "")[1]}
        if refit:
            row["bits_equal"] = bool(torch.equal(got[3], want[3]))
        else:
            row["cooks_rel_err"] = ((got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-12)).nan_to_num(0.0).max().item()
        if hasattr(st, "_trim_plan"):
            sizes = [r.shape[1] for r in sorts]
            plan = st._trim_plan(args[0].element_size(), sizes, G, True, kernels.sm_count(args[0].device))
            row["plan"] = plan._asdict()
            if detail:
                for name, other in other_plans(plan, args[0].element_size(), max(sizes), sum(sizes), G).items():
                    row[f"kernel_ms {name}"] = device_ms(lambda: ck._cooks_cuda(*args, plan=other), reps, "cooks_")[0]
        rows[label] = row
        print(f"  cooks {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del args, got, want, normed, sorts
        torch.cuda.empty_cache()
    if detail and hasattr(st, "_trim_plan"):
        # where the rank count stops paying: two cohorts of n, each method
        for dtype in (torch.float32, torch.float64):
            for n in RANK_SWEEP:
                args = cooks_operands(RANK_SWEEP_GENES, 2 * n, dtype, False)
                plan = st._trim_plan(args[0].element_size(), [n, n], RANK_SWEEP_GENES, True,
                                     kernels.sm_count(args[0].device))
                row = {name: device_ms(lambda: ck._cooks_cuda(*args, plan=plan._replace(rank_max=r)), 10,
                                       "cooks_")[0] for name, r in (("rank count", st._TRIM_RANK_CAP), ("radix", 0))}
                rows[f"rank sweep {'f32' if dtype == torch.float32 else 'f64'} cohorts of {n}"] = row
                print(f"  cooks rank sweep {dtype} n={n}: {json.dumps(row)}", file=sys.stderr, flush=True)
                del args
    return rows


def trim_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import stats as st

    rows = {}
    for label, G, N, dtype, reps in TRIM_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(0)
        if N:
            # (N, G) sample-major normalised counts, as the class API hands them
            base = torch.exp(3.0 + 1.5 * torch.randn(G, generator=g, device=DEVICE, dtype=torch.float64))
            sf = torch.exp(0.3 * torch.randn(N, generator=g, device=DEVICE, dtype=torch.float64))
            x = (torch.poisson(sf[:, None] * base[None, :], generator=g) / sf[:, None]).to(dtype)
            cells = np.array([2 * i // N for i in range(N)])
            cohorts = st._cohorts(cells)[0]
            sizes = [len(c) for c in cohorts]

            def run(**kw):
                return st._trimmed_cell_variance_cuda(x, cells, **kw)

            want = st._trimmed_cell_variance_plain(x, cells)
            sorts = cohort_rows(x.T, cells.tolist())
        else:
            x = torch.exp(-2.0 + torch.randn(G, generator=g, device=DEVICE, dtype=torch.float64)).to(dtype)
            sizes = [G]

            def run(**kw):
                k = math.floor(G * 0.001)
                return st._trimmed_rows_cuda(x[None, :], [k], **kw)[0] if kw else st.trimmed_mean(x, 0.001)

            want = st._trimmed_mean_plain(x, 0.001, 0)
            sorts = [x]
        got = run()
        kern, dev = device_ms(run, reps, "trimmed_")
        row = {"trimmed_var_ms": cuda_ms(run, reps), "trimmed_var_kernel_ms": kern, "trimmed_var_device_ms": dev,
               "rel_err": ((got - want).double().abs() / want.double().abs().clamp(min=1e-300)).max().item(),
               "sort_ms": device_ms(lambda: [torch.sort(r, dim=-1) for r in sorts], reps, "")[1]}
        if hasattr(st, "_trim_plan"):
            R = G if N else 1
            plan = st._trim_plan(x.element_size(), sizes, R, False, kernels.sm_count(x.device))
            row["plan"] = plan._asdict()
            if detail:
                for name, other in other_plans(plan, x.element_size(), max(sizes), max(sizes), R).items():
                    row[f"kernel_ms {name}"] = device_ms(lambda: run(plan=other), reps, "trimmed_")[0]
        rows[label] = row
        print(f"  trimmed_var {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del x, got, want, sorts
        torch.cuda.empty_cache()
    return rows


def first_call(module, name: str, run, **kw):
    """``run(**kw)`` with ``module.name`` recorded: the (args, kwargs) of
    its first call, or None where the run made none."""
    seen = []
    fn = getattr(module, name)

    def recorded(*args, **kwargs):
        seen.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        run(**kw)
    finally:
        setattr(module, name, fn)
    return seen[0] if seen else None


def weak_tile(dtype=torch.float32):
    """The grid tile of the weak-effect draw: ``summary_pipeline`` on
    ``make_data(100, WEAK_G, lfc_sd=0.1)``, then ``run_lfc_shrink_streamed``
    on its results with the first call of the grid recorded. Returns (the
    grid's arguments but ``sel``, ``sel``), or None where no lane failed
    Newton."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused_stream
    from pydeseq2_tpu_torch.ops import shrink as sh
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(100, WEAK_G, lfc_sd=0.1)
    host = pt.summary_host_inputs(X_np)
    kw = pt.inputs_from_numpy(counts_np.T, X_np, np.array([0.0, 1.0]), 0.0, cooks_cutoff=host["cooks_cutoff"],
                              dtype=dtype, device=DEVICE, cohort_ids=host["cohort_ids"],
                              use_for_max=host["use_for_max"], max_disp=100.0, beta_tol=1e-6)
    out = pt.summary_pipeline(**kw)
    seen = first_call(fused_stream, "grid_fit_shrink_beta_batch", pt.run_lfc_shrink_streamed,
                      counts=kw["counts"], design_matrix=kw["design_matrix"], coeff_idx=1,
                      dispersions=out["dispersions"], size_factors=out["size_factors"], mle_lfc=out["lfc"][:, 1],
                      mle_se=out["se"], adapt=True, dtype=dtype, device=DEVICE)
    if seen is None:
        return None
    b = inspect.signature(sh.grid_fit_shrink_beta_batch).bind(*seen[0], **seen[1])
    b.apply_defaults()
    args = tuple(b.arguments.values())
    return args[:-1], args[-1]


def grid_operands(lanes: int, N: int, dtype, design: str):
    """``grid_apeglm``'s arguments (every lane selected) on the first
    ``lanes`` genes of ``make_data(N, 16, seed=3)``: median-of-ratios size
    factors of counts + 0.5, seeded dispersions, prior scale 0.5 and the
    objective's scale at zero as the shrink path takes it (``_grid_tile``);
    the design the draw's intercept and condition (``indicator``), the
    intercept and a seeded normal column
    (``continuous``: no sample skips a term), or the two conditions' own
    indicators (``zero-first``: a zero in the first column, so every sample
    skips the term of one coefficient)."""
    from pydeseq2_tpu_torch.ops import shrink as sh
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, max(lanes, 16), seed=3)
    rng = np.random.default_rng(4)
    if design == "continuous":
        X_np = np.column_stack([np.ones(N), rng.normal(0.0, 1.0, N)])
    elif design == "zero-first":
        X_np = np.column_stack([1.0 - X_np[:, 1], X_np[:, 1]])
    counts = torch.as_tensor(counts_np.T[:lanes].copy(), dtype=dtype, device=DEVICE)
    X = torch.as_tensor(X_np, dtype=dtype, device=DEVICE)
    logc = np.log(counts_np.T + 0.5)
    sf = torch.as_tensor(np.exp(np.median(logc - logc.mean(1, keepdims=True), axis=0)), dtype=dtype, device=DEVICE)
    disp = torch.as_tensor(np.clip(rng.lognormal(-2.0, 1.0, lanes), 1e-3, 5.0), dtype=dtype, device=DEVICE)
    size, offset = 1.0 / disp, torch.log(sf)
    zeros = torch.zeros((lanes, 2), dtype=dtype, device=DEVICE)
    cnst = torch.clamp(sh.nbinom_fn_batch(zeros, X, counts, size, offset, 15.0, 0.5, 1), min=1.0)
    return (counts, offset, X, size, 15.0, 0.5, cnst, 1, 60, -30.0, 30.0)


def grid_row(grid, sel, reps: int, detail: bool) -> dict:
    """``grid_apeglm`` on ``grid`` (every lane, or the lanes of ``sel``):
    times, the share of selected lanes at the plain version's grid point
    (within 1e-6 x 30), the plan; ``--detail`` every cluster size."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import shrink as sh

    got = sh._grid_shrink_cuda(*grid, sel)
    want = sh._grid_shrink_plain(*grid)
    lanes = sel if sel is not None else torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    kern, dev = device_ms(lambda: sh._grid_shrink_cuda(*grid, sel), reps, "grid_apeglm")
    row = {"grid_apeglm_ms": cuda_ms(lambda: sh._grid_shrink_cuda(*grid, sel), reps), "grid_apeglm_kernel_ms": kern,
           "grid_apeglm_device_ms": dev, "lanes": int(lanes.sum()),
           "same_point_share": ((got - want).abs().amax(1)[lanes] <= 30e-6).double().mean().item()}
    if hasattr(sh, "_grid_plan"):
        K, N = grid[0].shape
        plan = sh._grid_device_plan(K, N, grid[8], grid[0].dtype, grid[0].device)
        row["plan"] = plan._asdict()
        if detail:
            for k in (1, 2, 4, 8, 16):
                other = plan._replace(K=k)
                fits = sh._grid_smem_bytes(grid[8], k, plan.chunk, grid[0].element_size()) <= kernels.SMEM_BLOCK_MAX
                if k != plan.K and k <= grid[8] and fits:
                    row[f"kernel_ms K={k}"] = device_ms(lambda: sh._grid_shrink_cuda(*grid, sel, plan=other), reps,
                                                        "grid_apeglm")[0]
    return row


def grid_rows(detail: bool) -> dict:
    rows = {}
    tile = weak_tile()
    if tile is None:
        rows["weak tile"] = "no lane failed Newton"
    else:
        grid, sel = tile
        rows["f32 weak tile, every lane"] = grid_row(grid, None, 5, detail)
        rows["f32 weak tile, the pipeline's selection"] = grid_row(grid, sel, 5, detail)
    for label, lanes, N, dtype, design, reps in GRID_SHAPES + (GRID_DETAIL_SHAPES if detail else ()):
        grid = grid_operands(lanes, N, dtype, design)
        rows[label] = grid_row(grid, None, reps, detail)
        print(f"  grid {label}: {json.dumps(rows[label])}", file=sys.stderr, flush=True)
    rows["grid_nb"] = grid_nb_rows(detail)
    return rows


def rescue_tile(dtype=torch.float32):
    """The IRLS rescue tile of the main draw: ``summary_pipeline`` on
    ``make_data(100, RESCUE_G)`` with the call of ``grid_fit_beta_batch``
    recorded. Returns its (args, kwargs) as the pipeline made them (the
    pipeline's selection and, where the tree passes it, its count), or None
    where no lane reached the grid."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(100, RESCUE_G)
    host = pt.summary_host_inputs(X_np)
    kw = pt.inputs_from_numpy(counts_np.T, X_np, np.array([0.0, 1.0]), 0.0, cooks_cutoff=host["cooks_cutoff"],
                              dtype=dtype, device=DEVICE, cohort_ids=host["cohort_ids"],
                              use_for_max=host["use_for_max"], max_disp=100.0, beta_tol=1e-6)
    return first_call(fused, "grid_fit_beta_batch", pt.summary_pipeline, **kw)


def nb_grid(grid) -> tuple:
    """``grid_nb``'s operands on an apeGLM grid's counts, design and
    offset (size factors e^offset), dispersions 1 / size."""
    counts, offset, X, size = grid[:4]
    return counts, torch.exp(offset), X, 1.0 / size


def grid_nb_row(args, kwargs, reps: int, detail: bool) -> dict:
    """``grid_nb`` through ``grid_fit_beta_batch(*args, **kwargs)``, as a
    caller makes the call: times (kernels named ``grid_nb``), the share of
    selected lanes at the plain version's grid point (within 1e-6 x 30), the
    plan where the tree's wrapper has one; ``--detail`` every cluster size."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import irls as irl

    def run():
        return irl.grid_fit_beta_batch(*args, **kwargs)

    got = run()
    want = irl._grid_fit_beta_plain(*args[:4], kwargs.get("min_mu", 0.5), 60, -30.0, 30.0)
    sel = kwargs.get("sel")
    lanes = sel if sel is not None else torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    kern, dev = device_ms(run, reps, "grid_nb")
    row = {"grid_nb_ms": cuda_ms(run, reps), "grid_nb_kernel_ms": kern, "grid_nb_device_ms": dev,
           "lanes": int(lanes.sum()), "tile": got.shape[0],
           "same_point_share": ((got - want).abs().amax(1)[lanes] <= 30e-6).double().mean().item()}
    if "plan" in inspect.signature(irl._grid_fit_beta_cuda).parameters:
        from pydeseq2_tpu_torch.ops import shrink as sh

        counts = args[0]
        n_sel = kwargs.get("n_sel")
        n = counts.shape[0] if n_sel is None else min(max(int(n_sel), 1), counts.shape[0])
        plan = sh._grid_device_plan(n, counts.shape[1], 60, counts.dtype, counts.device, kernel="grid_nb")
        row["plan"] = plan._asdict()
        if detail:
            full = (*args[:4], kwargs.get("min_mu", 0.5), 60, -30.0, 30.0, sel, n_sel)
            for k in (1, 2, 4, 8, 16):
                other = plan._replace(K=k)
                fits = sh._grid_smem_bytes(60, k, plan.chunk, counts.element_size(), 8) <= kernels.SMEM_BLOCK_MAX
                if k != plan.K and fits:
                    row[f"kernel_ms K={k}"] = device_ms(lambda: irl._grid_fit_beta_cuda(*full, plan=other), reps,
                                                        "grid_nb")[0]
    return row


def grid_nb_rows(detail: bool) -> dict:
    """``grid_nb`` on the pipeline's rescue tile (its selection, then every
    lane) and on GRID_NB_SHAPES."""
    rows = {}
    rec = rescue_tile()
    if rec is None:
        rows["rescue tile"] = "no lane reached the grid"
    else:
        args, kwargs = rec
        rows["f32 rescue tile, the pipeline's selection"] = grid_nb_row(args, kwargs, 20, detail)
        every = {k: v for k, v in kwargs.items() if k not in ("sel", "n_sel")}
        rows["f32 rescue tile, every lane"] = grid_nb_row(args, every, 5, detail)
    for label, lanes, N, dtype, reps in GRID_NB_SHAPES:
        rows[label] = grid_nb_row(nb_grid(grid_operands(lanes, N, dtype, "indicator")), {}, reps, detail)
    for label, row in rows.items():
        print(f"  grid_nb {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
    return rows


def shrink_operands(G: int, N: int, dtype):
    """``nbinom_glm_batch``'s arguments on ``make_data(N, G)``: the draw's
    design, median-of-ratios size factors of counts + 0.5 as the offset,
    seeded dispersions (size 1 / dispersion), the prior scales 15 and 0.5,
    the condition's coefficient shrunk, 60 steps at most."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G)
    logc = np.log(counts_np.T + 0.5)
    sf = np.exp(np.median(logc - logc.mean(1, keepdims=True), axis=0))
    disp = np.clip(np.random.default_rng(4).lognormal(-2.0, 1.0, G), 1e-3, 5.0)
    counts = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=DEVICE)
    X = torch.as_tensor(X_np, dtype=dtype, device=DEVICE)
    size = torch.as_tensor(1.0 / disp, dtype=dtype, device=DEVICE)
    offset = torch.as_tensor(np.log(sf), dtype=dtype, device=DEVICE)
    return (X, counts, size, offset, 15.0, 0.5, 1, 60)


def shrink_rows(detail: bool) -> dict:
    """``shrink`` at SHRINK_SHAPES: times (kernels named ``shrink``), a
    digest of its coefficients' bits (equal in two trees where the iterates
    are), the Newton steps, and the work counts the tree's wrapper returns;
    ``--detail`` every round size the tree's kernel takes."""
    import hashlib

    from pydeseq2_tpu_torch.ops import shrink as sh

    rows = {}
    for label, G, N, dtype, reps in SHRINK_SHAPES:
        fit = shrink_operands(G, N, dtype)
        out = sh._nbinom_glm_cuda(*fit)
        kern, dev = device_ms(lambda: sh._nbinom_glm_cuda(*fit), reps, "shrink")
        row = {"shrink_ms": cuda_ms(lambda: sh._nbinom_glm_cuda(*fit), reps), "shrink_kernel_ms": kern,
               "shrink_device_ms": dev, "beta_bits": hashlib.sha256(out[0].cpu().numpy().tobytes()).hexdigest()[:16],
               "converged": out[2].double().mean().item(), "steps_mean": out[3].double().mean().item(),
               "passes": int(out[4].sum())}
        if len(out) > 5:
            row["evaluations"] = int(out[5].sum())
            row["rounds"] = int(out[6].sum())
            row["round"] = sh._shrink_round(dtype, fit[0].shape[1])
            if detail:
                for m in (1, 3):
                    if m != row["round"]:
                        row[f"kernel_ms round={m}"] = device_ms(lambda: sh._nbinom_glm_cuda(*fit, cands=m), reps,
                                                                "shrink")[0]
        rows[label] = row
        print(f"  shrink {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del fit, out
        torch.cuda.empty_cache()
    return rows


def select_operands(kind: str, C: int, L: int, dtype):
    """``(x, ranks, axis)`` of one ``order_stats_select`` call on the card,
    from a seeded generator there (see SELECT_SHAPES)."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    if kind == "tile":
        base = torch.exp(3.0 + 1.5 * torch.randn(L, generator=g, device=DEVICE, dtype=torch.float64))
        sf = torch.exp(0.3 * torch.randn(C, generator=g, device=DEVICE, dtype=torch.float64))
        counts = torch.poisson(base[:, None] * sf[None, :], generator=g).to(dtype)
        logc = torch.log(counts)
        logmeans = logc.mean(1)
        ok = torch.isfinite(logmeans)
        x = torch.where(ok[:, None], logc - logmeans[:, None], torch.full_like(logc, math.inf))
        n = ok.sum()
        return x, (torch.clamp((n - 1) // 2, min=0), n // 2), 0
    vals = torch.randn(L, generator=g, device=DEVICE, dtype=torch.float64)
    share = 0.1 if kind == "column" else 0.05
    if kind == "quantile":
        vals = torch.exp(vals)
    off = torch.rand(L, generator=g, device=DEVICE) < share
    x = torch.where(off, math.inf, vals).to(dtype)[:, None]
    n = (~off).sum()
    if kind == "column":
        return x, (torch.clamp((n - 1) // 2, min=0), n // 2), 0
    h = (n - 1).double() * 0.95
    return x, (torch.floor(h).long(), torch.ceil(h).long()), 0


def select_plans(sel, plan, L: int, itemsize: int) -> dict:
    """The plans ``--detail`` times beside the one picked: every cluster
    size at the plan's group width, staged where it fits and streamed."""
    from pydeseq2_tpu_torch import kernels

    others = {}
    for K in (1, 2, 4, 8, 16):
        for staged in (True, False):
            p = plan._replace(K=K, staged=staged)
            if p != plan and sel._select_smem_bytes(plan.B, -(-L // K), itemsize, staged) <= kernels.SMEM_BLOCK_MAX:
                others[f"K={K} {'shared' if staged else 'streamed'}"] = p
    return others


def select_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch.ops import select as sel

    def key_equal(a, b):
        return all(torch.equal(sel._monotone_key(u), sel._monotone_key(v)) for u, v in zip(a, b))

    rows = {}
    for label, kind, C, L, dtype, reps in SELECT_SHAPES:
        x, ranks, axis = select_operands(kind, C, L, dtype)

        def run(**kw):
            return sel._order_stats_select_cuda(x, ranks, axis, **kw) if kw else sel.order_stats_select(x, ranks, axis)

        got, again = run(), run()
        kern, dev = device_ms(run, reps, "select")
        row = {"select_ms": cuda_ms(run, reps), "select_kernel_ms": kern, "select_device_ms": dev,
               "bits_equal": key_equal(got, sel.order_stats_select_plain(x, ranks, axis)),
               "repeat_equal": key_equal(got, again),
               "sort_ms": device_ms(lambda: torch.sort(x, dim=axis), reps, "")[1]}
        if hasattr(sel, "_select_plan"):
            plan = sel._select_device_plan(C, L, dtype, x.device, adjacent=C > 1)
            row["plan"] = plan._asdict()
            if detail:
                for name, other in select_plans(sel, plan, L, x.element_size()).items():
                    row[f"kernel_ms {name}"] = device_ms(lambda: run(plan=other), reps, "select")[0]
        rows[label] = row
        print(f"  select {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del x, got, again
        torch.cuda.empty_cache()
    return rows


def profile_launches(fn, reps: int) -> tuple[float, float]:
    """(device ms a call of everything ``fn`` runs on the card, kernels it
    launches a call) from torch.profiler over ``reps`` warm calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern) / reps / 1e3, sum(e.count for e in kern) / reps)


def hist_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import select as sel

    rows = {}
    for label, C, G, shard, dtype, reps in HIST_SHAPES:
        whole, (k_lo, k_hi), _ = select_operands("tile", C, G, dtype)
        n = torch.isfinite(whole[:, 0]).sum()
        npass = sel._passes(dtype)
        # every pass's prefix: the bytes of the whole tile's two middle keys, MSB first
        keys = torch.stack([sel._unsigned_key(v) for v in sel.order_stats_select(whole, (k_lo, k_hi))], dim=-1)
        digits = torch.stack([(keys >> (8 * (npass - 1 - j))) & 0xFF for j in range(npass)], dim=-1)
        digits = digits.to(torch.uint8).contiguous()  # (C, 2, npass)
        x = whole[:shard] if shard else whole
        row = {"bytes_bound_ms": (x.numel() * x.element_size() + C * 2 * 256 * 4 + C * 2 * npass) / 3.35e12 * 1e3}
        plan = sel._hist_device_plan(sel._columns(x, 0)) if hasattr(sel, "_hist_device_plan") else None
        if plan is not None:
            row["plan"] = plan._asdict()

        def hist(p, **kw):
            return sel._select_hist_cuda(x, digits, p, 0, **kw)

        for p in range(npass):
            got, again = hist(p), hist(p)
            row[f"pass {p} kernel_ms"] = device_ms(lambda p=p: hist(p), reps, "select_hist")[0]
            row[f"pass {p} bits_equal"] = torch.equal(got, sel.select_hist_plain(x, digits, p))
            row[f"pass {p} repeat_equal"] = torch.equal(got, again)
            row[f"pass {p} matched"] = int(got[:, 0].sum())
            if detail and plan is not None:
                for f in (0.5, 2):
                    rows_f = max(32, int(plan.rows * f) // 32 * 32)
                    row[f"pass {p} kernel_ms rows {rows_f}"] = device_ms(
                        lambda p=p, r=rows_f: hist(p, plan=plan._replace(rows=r)), reps, "select_hist")[0]
            if p == 0:
                keys0 = sel._unsigned_key(x).T  # (C, L)
                bins = (torch.arange(C * 2, device=x.device).reshape(C, 2, 1) * 256
                        + ((keys0 >> (8 * (npass - 1))) & 0xFF)[:, None, :]).expand(C, 2, x.shape[0]).reshape(-1)
                del keys0
                row["bincount_ms"] = device_ms(lambda: torch.bincount(bins, minlength=C * 2 * 256), reps, "")[1]
                del bins
                if hasattr(sel, "_select_pick_cuda"):
                    r_out = torch.zeros((C, 2), dtype=torch.int32, device=x.device)
                    d_k = digits.clone()
                    row["pick_kernel_ms"] = device_ms(
                        lambda: sel._select_pick_cuda(got, n, r_out, d_k, 0), reps, "select_pick")[0]
            del got, again
        if not shard:
            want = sel.masked_median_select(x, n)
            med = sel.sharded_masked_median(x, n)
            row["median_bits_equal"] = torch.equal(sel._monotone_key(med), sel._monotone_key(want))
            row["median_device_ms"], row["median_kernels_per_call"] = profile_launches(
                lambda: sel.sharded_masked_median(x, n), reps)
            row["median_ms"] = cuda_ms(lambda: sel.sharded_masked_median(x, n), reps)
            row["median_wall_ms"] = wall_ms(lambda: sel.sharded_masked_median(x, n), reps)
            kernels.STATS.reset()
            sel.sharded_masked_median(x, n)
            row["median_launches"] = {k: v for k, v in kernels.STATS.launches.items() if v}
            row["select_median_device_ms"] = profile_launches(lambda: sel.masked_median_select(x, n), reps)[0]
        rows[label] = row
        print(f"  hist {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del x, whole, digits, keys
        torch.cuda.empty_cache()
    return rows


def irls_operands(G: int, N: int, P: int, dtype) -> dict:
    """``irls_core``'s operands at phase 1: ``make_data``'s counts and design
    (P > 2 adds indicator columns of a seeded batch, as :func:`inputs`),
    median-of-ratios size factors, seeded dispersions, ``irls_beta_init``,
    the pipelines' tolerances for the type."""
    from pydeseq2_tpu_torch.ops import irls as irl

    counts, _, X = inputs(G, N, P, dtype)
    logc = torch.log(counts)
    ok = torch.isfinite(logc.mean(1))
    sf = torch.exp(torch.median(logc[ok] - logc[ok].mean(1, keepdim=True), dim=0).values)
    g = torch.Generator(device=DEVICE).manual_seed(2)
    disp = torch.clamp(torch.exp(-2.0 + torch.randn(G, generator=g, device=DEVICE, dtype=torch.float64)),
                       1e-4, 10.0).to(dtype)
    f32 = dtype == torch.float32
    return {"counts": counts, "size_factors": sf, "design_matrix": X, "disp": disp,
            "beta_init": irl.irls_beta_init(counts, sf, X), "beta_tol": 1e-6 if f32 else 1e-8}


def irls_tile(dtype=torch.float32):
    """The phase-2 call of ``irls_core`` in ``summary_pipeline`` on
    ``make_data(100, RESCUE_G)``: its (args, kwargs), recorded, or None
    where phase 1 left no lane unfinished."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(100, RESCUE_G)
    host = pt.summary_host_inputs(X_np)
    kw = pt.inputs_from_numpy(counts_np.T, X_np, np.array([0.0, 1.0]), 0.0, cooks_cutoff=host["cooks_cutoff"],
                              dtype=dtype, device=DEVICE, cohort_ids=host["cohort_ids"],
                              use_for_max=host["use_for_max"], max_disp=100.0, beta_tol=1e-6)
    seen = []
    core = fused.irls_core

    def recorded(*args, **kwargs):
        seen.append((args, kwargs))
        return core(*args, **kwargs)

    fused.irls_core = recorded
    try:
        pt.summary_pipeline(**kw)
    finally:
        fused.irls_core = core
    return seen[1] if len(seen) > 1 else None


def irls_row(ops: dict, maxiter: int, reps: int, detail: bool) -> dict:
    """``_irls_cuda`` and ``irls_core`` on ``ops`` (``irls_core``'s keyword
    arguments): times, agreement with the plain version, the plan;
    ``--detail`` every lane count built for the design."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.ops.nb import nb_nll

    counts, sf, X, disp, beta_init = (ops[k] for k in ("counts", "size_factors", "design_matrix", "disp",
                                                       "beta_init"))
    beta_tol = ops.get("beta_tol", 1e-8)
    f32 = counts.dtype == torch.float32
    step_tol = 1e-5 if f32 else 0.0
    G, N = counts.shape
    P = X.shape[1]
    log_sf = torch.log(sf)
    log_min_mu = torch.log(torch.tensor(0.5, dtype=counts.dtype, device=counts.device))
    mu0, log_mu0, _ = irl._mu_from_xb(beta_init, X, sf, log_sf[None, :], 0.5, log_min_mu)
    r = 1.0 / disp[:, None]
    nll_const = nb_nll(counts, mu0, disp) - irl._mu_part(counts, counts + r, r, mu0, log_mu0)
    del mu0, log_mu0
    own_const = "nll_const" not in inspect.signature(irl._irls_cuda).parameters

    def kernel(**kw):
        if own_const:
            return irl._irls_cuda(counts, sf, X, disp, beta_init, log_sf, 0.5, beta_tol, 30.0, maxiter, step_tol, 2,
                                  **kw)
        return irl._irls_cuda(counts, sf, X, disp, beta_init, nll_const, log_sf, 0.5, beta_tol, 30.0, maxiter,
                              step_tol, 2)

    def core():
        return irl.irls_core(counts, sf, X, disp, beta_init, beta_tol=beta_tol, maxiter=maxiter)

    bp, fbp, it_p = irl._irls_plain(counts, sf, X, disp, beta_init, nll_const, log_sf[None, :], 0.5, log_min_mu,
                                    beta_tol, 30.0, maxiter, step_tol, 2)
    btol = 1e-4 if f32 else 1e-7

    def agreement(out) -> dict:
        bk, fbk, trips = out
        return {"close_share": ((bk - bp).abs().amax(1) <= btol).double().mean().item(),
                "flags_share": (fbk == fbp).double().mean().item(),
                "beta_max_abs_err": (bk - bp).abs().max().item(),
                "max_trips": int(trips.max()), "plain_trips": int(it_p), "trips_mean": trips.double().mean().item()}

    out = kernel()
    kern, dev = device_ms(kernel, reps, "irls")
    core_kern, core_dev = device_ms(core, reps, "irls")
    row = {"irls_ms": cuda_ms(kernel, reps), "irls_kernel_ms": kern, "irls_device_ms": dev,
           "irls_core_ms": cuda_ms(core, reps), "irls_core_kernel_ms": core_kern, "irls_core_device_ms": core_dev,
           "genes": G, "samples": N, "P": P, "maxiter": maxiter, **agreement(out)}
    if hasattr(irl, "_irls_device_plan"):
        plan = irl._irls_device_plan(G, N, P, counts.dtype, counts.device)
        row["plan"] = plan._asdict()
        if detail:
            for lanes in irl._irls_lane_choices(P) + (irl._IRLS_BLOCK,):
                if lanes != plan.lanes:
                    row[f"kernel_ms lanes={lanes}"] = device_ms(lambda: kernel(plan=irl.IrlsPlan(lanes)), reps, "irls")[0]
                    row[f"agreement lanes={lanes}"] = agreement(kernel(plan=irl.IrlsPlan(lanes)))
    del out, bp, fbp, nll_const
    torch.cuda.empty_cache()
    return row


def irls_rows(detail: bool) -> dict:
    rows = {}
    for label, G, N, P, dtype, maxiter, reps in IRLS_SHAPES:
        rows[label] = irls_row(irls_operands(G, N, P, dtype), maxiter, reps, detail)
        print(f"  irls {label}: {json.dumps(rows[label])}", file=sys.stderr, flush=True)
    tile = irls_tile()
    if tile is not None:
        args, kwargs = tile
        names = ("counts", "size_factors", "design_matrix", "disp", "beta_init")
        ops = {**dict(zip(names, args)), **{k: v for k, v in kwargs.items() if k in names + ("beta_tol",)}}
        rows["f32 phase 2 tile"] = irls_row(ops, kwargs.get("maxiter", 250), 20, detail)
        print(f"  irls f32 phase 2 tile: {json.dumps(rows['f32 phase 2 tile'])}", file=sys.stderr, flush=True)
    return rows


def mom_operands(G: int, N: int, P: int, dtype):
    """``(counts, sf, X, pinv)`` of one ``mom`` call on the card:
    :func:`inputs`' counts and design, median-of-ratios size factors."""
    counts, _, X = inputs(G, N, P, dtype)
    logc = torch.log(counts)
    ok = torch.isfinite(logc.mean(1))
    sf = torch.exp(torch.median(logc[ok] - logc[ok].mean(1, keepdim=True), dim=0).values)
    return counts, sf, X, torch.linalg.pinv(X)


def mom_plans(lin, plan, N: int, itemsize: int) -> dict:
    """The plans ``--detail`` times beside the one picked: every lane count
    that holds the row in registers, 32 lanes and a block staged as the
    picker would stage them, and a block staging half the row."""
    others = {}
    for lanes in (4, 8, 32):
        if N <= lin._MOM_REG_ITEMS * lanes:
            others[f"lanes={lanes} registers"] = lin.MomPlan(lanes, 0)
    others["lanes=32 staged"] = lin.MomPlan(32, min(N, lin._MOM_GROUP_STAGE // itemsize))
    others["lanes=256 staged"] = lin.MomPlan(256, min(N, lin._MOM_BLOCK_STAGE // itemsize))
    others["lanes=256 half staged"] = lin.MomPlan(256, max(1, N // 2))
    return {k: p for k, p in others.items() if p != plan}


def mom_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch.ops import linreg as lin

    rows = {}
    for label, G, N, P, dtype, want_mu, normed, reps in MOM_SHAPES:
        counts, sf, X, pinv = mom_operands(G, N, P, dtype)
        if normed:
            counts = counts / sf
        y = counts if normed else counts / sf
        pinv_t = pinv.T.contiguous()

        def run(**kw):
            return lin._mom_cuda(counts, sf, X, pinv, 0.5, want_mu, normed, **kw)

        got = run()
        want = lin._mom_plain(counts, sf, X, pinv, 0.5, want_mu, normed)
        err = max(((a.double() - b.double()).abs() / torch.clamp(b.double().abs(), min=1.0)).max().item()
                  for a, b in zip(got, want) if b is not None and a.ndim == 1)
        kern, dev = device_ms(run, reps, "mom")
        row = {"mom_ms": cuda_ms(run, reps), "mom_kernel_ms": kern, "mom_device_ms": dev, "max_rel_err": err,
               "matmul_ms": device_ms(lambda: torch.matmul(y, pinv_t), reps, "")[1],
               "genes": G, "samples": N, "P": P, "want_mu": want_mu, "normed": normed}
        if hasattr(lin, "_mom_plan"):
            plan = lin._mom_plan(N, counts.element_size())
            row["plan"] = plan._asdict()
            if detail:
                for name, other in mom_plans(lin, plan, N, counts.element_size()).items():
                    row[f"kernel_ms {name}"] = device_ms(lambda: run(plan=other), reps, "mom")[0]
        rows[label] = row
        print(f"  mom {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del counts, y, got, want
        torch.cuda.empty_cache()
    return rows


def bh_operands(dtype=torch.float32):
    """The sweep of ``device_padj`` in ``summary_pipeline`` on
    ``make_data(100, BH_G)``: ``(p, order, valid, base_mean, cutoffs,
    alpha)`` as it forms them (p float64; base means and cutoffs widened to
    float64), the pipeline's own arguments of ``device_padj``, the lowess
    pick ``j`` of the sweep's counts, and the pick's operands ``(theta,
    num_rej)`` (the 50 quantile levels, the counts on the card)."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused
    from pydeseq2_tpu_torch.ops import stats as st
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(100, BH_G)
    host = pt.summary_host_inputs(X_np)
    kw = pt.inputs_from_numpy(counts_np.T, X_np, np.array([0.0, 1.0]), 0.0, cooks_cutoff=host["cooks_cutoff"],
                              dtype=dtype, device=DEVICE, cohort_ids=host["cohort_ids"],
                              use_for_max=host["use_for_max"], max_disp=100.0, beta_tol=1e-6)
    seen = []
    padj = fused.device_padj

    def recorded(*args, **kwargs):
        seen.append((args, kwargs))
        return padj(*args, **kwargs)

    fused.device_padj = recorded
    try:
        pt.summary_pipeline(**kw)
    finally:
        fused.device_padj = padj
    b = inspect.signature(padj).bind(*seen[0][0], **seen[0][1])
    b.apply_defaults()
    p, base_mean, gene_mask, alpha, _ = b.arguments.values()
    dt = base_mean.dtype
    valid = ~torch.isnan(p) & gene_mask
    p_filled = torch.nan_to_num(p, nan=1.0).to(torch.float64)
    order = torch.argsort(p_filled, stable=True)
    base_m = torch.where(gene_mask, base_mean, torch.tensor(float("nan"), dtype=dt, device=p.device))
    lower_q = (((base_m == 0) & gene_mask).sum().to(torch.float64) /
               torch.clamp(gene_mask.sum(), min=1).to(torch.float64)).to(dt)
    upper_q = torch.where(lower_q < 0.95, torch.tensor(0.95, dtype=dt, device=p.device),
                          torch.tensor(1.0, dtype=dt, device=p.device))
    theta = lower_q + (upper_q - lower_q) * torch.linspace(0.0, 1.0, 50, dtype=dt, device=p.device)
    cutoffs = st.nanquantile(base_m, theta)
    sweep = (p_filled, order, valid, base_mean.double(), cutoffs.double(), alpha)
    _, num_rej = st._bh_sweep_plain(*sweep)
    num_rej = num_rej.to(p.device)
    j = st.lowess_pick(theta, num_rej, frac=1.0 / 5.0)[1]
    return sweep, tuple(b.arguments.values()), j, (theta, num_rej)


def bh_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch import fused
    from pydeseq2_tpu_torch.ops import stats as st

    del detail  # one set of shapes
    sweep, padj_args, j, _ = bh_operands()
    p, order, valid, base_mean, cutoffs, alpha = sweep
    reps = 20
    adj_p, rej_p = st._bh_sweep_plain(*sweep)
    adj_k, rej_k = st._bh_sweep_cuda(*sweep)

    def same(a, b):
        return torch.equal(a.nan_to_num(2.0), b.nan_to_num(2.0))

    def one_row():
        if hasattr(st, "bh_adjust_row"):
            return st.bh_adjust_row(p, order, valid)
        return st._bh_sweep_cuda(p, order, valid, None, None, alpha)[0][0]

    f32 = (p.float(), order, valid, base_mean.float(), cutoffs.float(), alpha)
    row = {"genes": p.shape[0], "rows": cutoffs.shape[0], "picked_row": int(j),
           "sweep_bits_equal": same(adj_k, adj_p) and torch.equal(rej_k, rej_p),
           "one_row_bits_equal": same(one_row(), st._bh_sweep_plain(p, order, valid, None, None, alpha)[0][0]),
           "argsort_ms": device_ms(lambda: torch.argsort(p, stable=True), reps, "")[1]}
    for name, fn in (("sweep", lambda: st._bh_sweep_cuda(*sweep)), ("one_row", one_row),
                     ("sweep_f32", lambda: st._bh_sweep_cuda(*f32)),
                     ("device_padj", lambda: fused.device_padj(*padj_args)),
                     ("device_padj_bh", lambda: fused.device_padj(*padj_args[:4], False))):
        kern, dev = device_ms(fn, reps, "bh_")
        row[f"{name}_ms"], row[f"{name}_kernel_ms"], row[f"{name}_device_ms"] = cuda_ms(fn, reps), kern, dev
    if hasattr(st, "_bh_count_cuda"):
        row["counts_bits_equal"] = torch.equal(st._bh_count_cuda(*sweep), rej_p)
        row["picked_row_bits_equal"] = same(st._bh_adjust_cuda(p, order, valid, base_mean, cutoffs, j)[0], adj_p[int(j)])
        for name, fn in (("counts", lambda: st._bh_count_cuda(*sweep)),
                         ("picked_row", lambda: st._bh_adjust_cuda(p, order, valid, base_mean, cutoffs, j)),
                         ("counts_and_row", lambda: (st._bh_count_cuda(*sweep),
                                                     st._bh_adjust_cuda(p, order, valid, base_mean, cutoffs, j)))):
            kern, dev = device_ms(fn, reps, "bh_")
            row[f"{name}_ms"], row[f"{name}_kernel_ms"], row[f"{name}_device_ms"] = cuda_ms(fn, reps), kern, dev
    print(f"  bh: {json.dumps(row)}", file=sys.stderr, flush=True)
    return {"f64 50x60000": row}


def hat_operands(G: int, N: int, P: int, dtype):
    """``(beta, disp, sf, X, contrast)`` of one ``hat_wald`` call on the
    card: :func:`inputs`' counts and design, median-of-ratios size factors,
    the least-squares fit of log((counts + 0.5) / sf) as the coefficients
    (some samples' mu below min_mu), seeded lognormal dispersions, the
    contrast on the design's second column (the first where P = 1)."""
    counts, _, X = inputs(G, N, P, dtype)
    logc = torch.log(counts)
    ok = torch.isfinite(logc.mean(1))
    sf = torch.exp(torch.median(logc[ok] - logc[ok].mean(1, keepdim=True), dim=0).values)
    beta = (torch.log((counts + 0.5) / sf) @ torch.linalg.pinv(X).T).contiguous()
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    disp = torch.exp(torch.randn(G, generator=gen, device=DEVICE, dtype=dtype) - 2.0)
    contrast = torch.zeros(P, dtype=dtype, device=DEVICE)
    contrast[min(1, P - 1)] = 1.0
    del counts
    return beta, disp, sf, X.contiguous(), contrast


def hat_errs(got, want, tiny: float = 1e-30) -> dict:
    """The largest differences of ``hat_wald`` outputs from the plain
    version's, as ``chip_smoke.py`` measures them: relative on H (absolute
    below 1e-2), mu, the statistic (absolute below 1e-3) and the SE, and on
    log p scaled by 1 + stat^2 (p at or above ``tiny``)."""
    errs = {}
    for key, a, b, floor in zip(("H", "mu", "p", "stat", "se"), got, want, (1e-2, 1e-300, 0.0, 1e-3, 1e-300)):
        if a is None or b is None:
            continue
        a, b = a.double(), b.double()
        if key == "p":
            big = b >= tiny
            scale = 1.0 + want[3][big].double().square()
            errs[key] = ((a[big].log() - b[big].log()).abs() / scale).max().item() if bool(big.any()) else 0.0
        else:
            m = ~torch.isnan(b)
            errs[key] = ((a[m] - b[m]).abs() / torch.clamp(b[m].abs(), min=floor)).max().item() if bool(m.any()) else 0.0
    return errs


def hat_plans(wd, N: int, itemsize: int) -> dict:
    """{name: plan} of ``hat_wald.cu`` for N samples: the one the wrapper
    picks first, then every lane count staging what its share of the stage
    holds, and 32 lanes and a block staging a third of the row (the rest
    formed again in pass 2)."""
    plans = {"picked": wd._hat_wald_plan(N, 2, itemsize)}
    for lanes in wd._HW_LANES:
        plans[f"lanes={lanes} staged"] = wd._hat_wald_staged(lanes, N, itemsize)
    for lanes in (32, wd._HW_BLOCK):
        plans[f"lanes={lanes} third staged"] = wd.HatWaldPlan(lanes, N // 3)
    first = {}  # each plan once, under its first name
    for name, plan in plans.items():
        if plan not in first.values():
            first[name] = plan
    return first


def hat_rows(detail: bool) -> dict:
    from pydeseq2_tpu_torch.ops import irls as ir
    from pydeseq2_tpu_torch.ops import wald as wd

    test_only = "want_hat" in inspect.signature(wd._hat_wald_cuda).parameters
    rows = {}
    for label, G, N, P, dtype, reps in HAT_SHAPES:
        beta, disp, sf, X, contrast = hat_operands(G, N, P, dtype)
        ridge = 1e-6 * torch.eye(P, dtype=dtype, device=DEVICE)
        null = torch.zeros((), dtype=dtype, device=DEVICE)  # a 0-d tensor on the card, as the pipelines pass it
        args = (beta, disp, sf, X, contrast, null, 0.5, None)

        def fused(**kw):
            return wd._hat_wald_cuda(*args, **kw)

        got = fused()
        want = wd._hat_wald_plain(*args)
        mu = got[1]
        runs = {"hat_wald": fused, "hat": lambda: ir._hat_cuda(sf, X, disp, beta, 0.5),
                "wald": lambda: wd._wald_cuda(X, disp, beta, mu, ridge, contrast, null, None)}
        if test_only:
            runs["test_only"] = lambda: fused(want_hat=False)
        out = torch.empty((2, G, N), dtype=dtype, device=DEVICE)
        row = {"genes": G, "samples": N, "P": P, "clamped_share": (want[1] < 0.5).double().mean().item(),
               "errs": hat_errs(got, want),
               "repeat_bits_equal": all(torch.equal(a, b) for a, b in zip(got, fused())),
               "fill_ms": device_ms(lambda: out.fill_(1.0), reps, "")[1]}
        del out
        for name, fn in runs.items():
            kern, dev = device_ms(fn, reps, "hat_wald")
            row[f"{name}_ms"], row[f"{name}_kernel_ms"], row[f"{name}_device_ms"] = cuda_ms(fn, reps), kern, dev
        if test_only:
            alone = fused(want_hat=False)
            row["test_only_bits_equal"] = alone[0] is None and all(
                torch.equal(a, b) for a, b in zip(alone[2:], got[2:]))
        if hasattr(wd, "_hat_wald_plan"):
            plan = wd._hat_wald_plan(N, P, beta.element_size())
            row["plan"] = plan._asdict()
            if detail:
                for name, other in list(hat_plans(wd, N, beta.element_size()).items())[1:]:
                    row[f"kernel_ms {name}"] = device_ms(lambda: fused(plan=other), reps, "hat_wald")[0]
                    row[f"bits {name}"] = all(torch.equal(a, b) for a, b in zip(fused(plan=other), fused(plan=other)))
        rows[label] = row
        print(f"  hat {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del got, want, mu, runs
        torch.cuda.empty_cache()
    return rows


def lowess_rows(detail: bool) -> dict:
    """``lowess`` on the 50 cutoffs of one ``summary_pipeline`` run (see
    :func:`bh_operands`), float32 and float64: events and device times,
    the row and the fit against the plain version, a repeat bit for bit;
    ``--detail`` adds seeded draws of 2 and 64 points."""
    from pydeseq2_tpu_torch.ops import stats as st

    theta, num_rej = bh_operands()[3]
    draws = {"f32 run 50": (theta.float(), num_rej), "f64 run 50": (theta.double(), num_rej)}
    if detail:
        rng = np.random.default_rng(14)
        for n in (2, 64):
            t = np.linspace(0.05, 0.95, n)
            rej = np.maximum(0, 500 * np.minimum(t / 0.4, 1.0) + rng.normal(0, 10, n)).round()
            draws[f"f32 draw {n}"] = (torch.as_tensor(t, dtype=torch.float32, device=DEVICE),
                                      torch.as_tensor(rej, dtype=torch.int64, device=DEVICE))
    rows = {}
    for label, (th, rej) in draws.items():
        def run():
            return st._lowess_pick_cuda(th, rej, 0.2)

        def same(a, b):  # bit for bit, NaN where NaN (2 points: one weighted point, 0/0)
            return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))

        (yk, jk), (yp, jp) = run(), st._lowess_pick_plain(th, rej, 0.2)
        kern, dev = device_ms(run, 50, "lowess")
        rows[label] = {"points": th.shape[0], "row": int(jk), "plain_row": int(jp),
                       "fit_max_rel_err": ((yk.double() - yp.double()).abs() /
                                           torch.clamp(yp.double().abs(), min=1.0)).nan_to_num(0.0).max().item(),
                       "fit_bits_equal": same(yk, yp), "repeat_bits_equal": same(run()[0], yk),
                       "lowess_ms": cuda_ms(run, 50), "lowess_kernel_ms": kern, "lowess_device_ms": dev,
                       "plain_ms": cuda_ms(lambda: st._lowess_pick_plain(th, rej, 0.2), 20)}
        print(f"  lowess {label}: {json.dumps(rows[label])}", file=sys.stderr, flush=True)
    return rows



def impute_floor_diffs(tile, sf, got, want) -> tuple[int, int]:
    """The cells where the kernel's imputed tile ``got`` differs from the
    plain version's ``want`` (each ``(imputed, new_all_zero)``), and those
    that break the floor rule: a cell may differ only by one count where
    the plain product trim02 sf_n lies within 4 ulps of an integer (the
    two sum the trimmed mean in other orders, and floor() is
    discontinuous), and ``new_all_zero`` only on rows with such a cell."""
    from pydeseq2_tpu_torch.ops import refit as rf
    from pydeseq2_tpu_torch.ops import stats as st

    prod = st._trimmed_mean_plain(tile / sf[None, :], rf.TRIM, 1)[:, None] * sf[None, :]
    ulp = torch.nextafter(prod.abs(), torch.full_like(prod, math.inf)) - prod.abs()
    near_int = (prod - torch.round(prod)).abs() <= 4 * ulp
    differ = got[0] != want[0]
    bad = differ & ~(near_int & ((got[0] - want[0]).abs() == 1))
    naz_bad = (got[1] != want[1]) & ~differ.any(1)
    return int(differ.sum()), int(bad.sum()) + int(naz_bad.sum())


def impute_tile(N: int, dtype, kind: str) -> tuple:
    """``impute_outliers``' operands ``(tile, exceeds_packed, replaceable,
    sf, tile_mask)``. ``stream``: the first refit tile of one
    ``run_summary_streamed(refit_cooks=True)`` run on ``make_data(N,
    IMPUTE_G)`` with an outlier planted in every 100th gene (the run builds
    every kernel lazily). ``atlas``: IMPUTE_ROWS seeded rows of N samples,
    Poisson counts at lognormal means times lognormal size factors, every
    row's exceed bit set at one sample (every 10th row at five), every
    sample replaceable, the last quarter of the rows padding."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused_stream
    from pydeseq2_tpu_torch.ops import refit as rf
    from pydeseq2_tpu_torch.synthetic import make_data, plant_outliers

    if kind == "atlas":
        K, W = IMPUTE_ROWS, -(-N // 32)
        g = torch.Generator(device=DEVICE).manual_seed(15)
        base = torch.exp(2.0 + 1.5 * torch.randn(K, generator=g, device=DEVICE, dtype=torch.float64))
        sf = torch.exp(0.3 * torch.randn(N, generator=g, device=DEVICE, dtype=torch.float64))
        tile = torch.poisson(base[:, None] * sf[None, :], generator=g).to(dtype)
        rng = np.random.default_rng(15)
        words = np.zeros((K, W), dtype=np.uint32)
        for r in range(K):
            for n in rng.choice(N, 5 if r % 10 == 0 else 1, replace=False):
                words[r, n // 32] |= np.uint32(1) << np.uint32(n % 32)
        packed = torch.as_tensor(words.view(np.int32), device=DEVICE)
        mask = torch.arange(K, device=DEVICE) < 3 * K // 4
        return tile, packed, (True,) * N, sf.to(dtype), mask
    counts_np, X_np = make_data(N, IMPUTE_G)
    contrast = np.zeros(X_np.shape[1])
    contrast[-1] = 1.0
    kw = dict(counts=torch.as_tensor(plant_outliers(counts_np.T, 100), dtype=dtype, device=DEVICE),
              design_matrix=X_np, contrast=contrast, dtype=dtype, refit_cooks=True, max_disp=float(max(10, N)),
              beta_tol=1e-6 if dtype == torch.float32 else 1e-8, device=DEVICE)
    args, kwargs = first_call(fused_stream, "impute_outliers", pt.run_summary_streamed, **kw)
    return tuple(inspect.signature(rf.impute_outliers).bind(*args, **kwargs).arguments.values())


def impute_rows(detail: bool) -> dict:
    """``impute`` on IMPUTE_SHAPES: events and device times (kernels named
    ``impute``), the plain version's time, the cells floor one count apart
    and those beyond the floor rule, a repeat bit for bit, the plan where
    the tree has one; ``--detail`` every other plan that fits."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import cooks as ck
    from pydeseq2_tpu_torch.ops import refit as rf
    from pydeseq2_tpu_torch.ops import stats as st

    planned = "plan" in inspect.signature(rf._impute_cuda).parameters
    rows = {}
    for label, N, dtype, kind, reps in IMPUTE_SHAPES:
        args = impute_tile(N, dtype, kind)
        tile, packed, repl, sf, mask = args

        def run(**kw):
            return rf._impute_cuda(*args, **kw)

        got, want = run(), rf._impute_plain(*args)
        differ, beyond = impute_floor_diffs(tile, sf, got, want)
        again = run()
        kern, dev = device_ms(run, reps, "impute")
        swapped = ck.unpack_bits(packed, N) & torch.as_tensor(repl, device=tile.device)[None, :] & mask[:, None]
        row = {"impute_ms": cuda_ms(run, reps), "impute_wall_ms": wall_ms(run, reps), "impute_kernel_ms": kern,
               "impute_device_ms": dev,
               "plain_ms": cuda_ms(lambda: rf._impute_plain(*args), 3), "rows": tile.shape[0],
               "live_rows": int(mask.sum()), "imputed_cells": int(swapped.sum()), "cells_floor_apart": differ,
               "beyond_floor_rule": beyond, "new_all_zero": int(got[1].sum()),
               "repeat_bits_equal": bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))}
        if planned:
            isz = tile.element_size()
            plan = st._trim_plan(isz, [N], tile.shape[0], True, kernels.sm_count(tile.device))
            row["plan"] = plan._asdict()
            if detail:
                for name, other in other_plans(plan, isz, N, N, tile.shape[0]).items():
                    row[f"kernel_ms {name}"] = device_ms(lambda: run(plan=other), reps, "impute")[0]
                    row[f"beyond_floor_rule {name}"] = impute_floor_diffs(tile, sf, run(plan=other), want)[1]
        rows[label] = row
        print(f"  impute {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del args, tile, got, want, again
        torch.cuda.empty_cache()
    return rows


def box_operands(lanes: int, N: int, P: int, dtype, seed: int = 5) -> tuple:
    """``newton_box_nbglm``'s operands in ``_newton_box_cuda``'s order
    ``(counts, sf, X, disp, beta_init, min_mu, max_beta, maxiter)`` on
    ``lanes`` seeded lanes of N samples: the intercept, a two-level
    condition (alternate samples) and P - 2 seeded normal columns;
    lognormal size factors; NB counts at lognormal means, N(0, 1)
    condition and N(0, 0.3) further coefficients, lognormal dispersions.
    Every 4th lane has no count in the condition's second level (its
    coefficient falls until that level's means reach the min_mu clamp, to
    the box's edge where the intercept is large) and every 7th lane means
    near 1e4. The start is log(mean(counts / sf) + 0.5) in the intercept, zeros
    elsewhere."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), np.arange(N) % 2] + [rng.normal(0.0, 1.0, N) for _ in range(P - 2)])
    sf = np.exp(rng.normal(0.0, 0.3, N))
    beta = np.column_stack([rng.normal(2.0, 1.5, lanes), rng.normal(0.0, 1.0, lanes)]
                           + [rng.normal(0.0, 0.3, lanes) for _ in range(P - 2)])
    beta[::7, 0] = np.log(1e4)
    disp = np.clip(rng.lognormal(-2.0, 1.0, lanes), 1e-3, 5.0)
    mu = sf[None, :] * np.exp(np.clip(beta @ X.T, -30.0, 15.0))
    r = 1.0 / disp[:, None]
    counts = rng.negative_binomial(r, r / (r + mu)).astype(np.float64)
    counts[::4, 1::2] = 0.0
    beta_init = np.zeros((lanes, P))
    beta_init[:, 0] = np.log((counts / sf[None, :]).mean(1) + 0.5)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=DEVICE).contiguous()

    return t(counts), t(sf), t(X), t(disp), t(beta_init), 0.5, 30.0, 60


def box_tile(dtype) -> tuple:
    """The IRLS rescue tile that ``summary_pipeline`` on ``make_data(100,
    RESCUE_G)`` (float64: with outliers injected at genes 0 and 3, as
    ``chip_smoke.py``'s float64 draw) hands ``newton_box_nbglm``: its
    operands in ``_newton_box_cuda``'s order and the pipeline's selection,
    or None where no lane reached the box. The run builds every kernel
    lazily."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import fused
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(100, RESCUE_G)
    counts = counts_np.T.copy()
    if dtype == torch.float64:
        counts[0, 0] = counts.max() * 10 + 100
        counts[3, 5] = counts.max() * 8 + 50
    host = pt.summary_host_inputs(X_np)
    kw = pt.inputs_from_numpy(counts, X_np, np.array([0.0, 1.0]), 0.0, cooks_cutoff=host["cooks_cutoff"],
                              dtype=dtype, device=DEVICE, cohort_ids=host["cohort_ids"],
                              use_for_max=host["use_for_max"], max_disp=100.0,
                              beta_tol=1e-6 if dtype == torch.float32 else 1e-8)
    seen = first_call(fused, "newton_box_nbglm", pt.summary_pipeline, **kw)
    if seen is None:
        return None
    b = inspect.signature(irl.newton_box_nbglm).bind(*seen[0], **seen[1])
    b.apply_defaults()
    *ops, sel = b.arguments.values()
    return tuple(ops), sel


def per_lane(v: torch.Tensor):
    """A per-lane count as a list (16 lanes or fewer), else its sum, mean
    and max."""
    if v.numel() <= 16:
        return v.tolist()
    return {"sum": int(v.sum()), "mean": v.double().mean().item(), "max": int(v.max())}


def box_row(box: tuple, sel, reps: int, detail: bool = False) -> dict:
    """``newton_box`` on ``box`` (every lane, or the lanes of ``sel``):
    events, the host clock's median (:func:`wall_ms`) and device times
    (kernels named ``newton_box``), the serial passes over each selected
    lane's row and, where the tree's kernel reports them, the objective and
    gradient evaluations of the sequential search; the share of selected
    lanes within 1e-4 (f32) / 1e-9 (f64) of the plain version and of equal
    flags; a repeat bit for bit; with ``detail`` the plan and the kernel's
    device time staged and with nothing staged, each twice over 5 x
    ``reps`` calls in turn."""
    from pydeseq2_tpu_torch.ops import irls as irl

    def run():
        return irl._newton_box_cuda(*box, sel)

    out, again = run(), run()
    bp, okp = irl._newton_box_plain(*box)
    lanes = sel if sel is not None else torch.ones(bp.shape[0], dtype=torch.bool, device=bp.device)
    btol = 1e-4 if bp.dtype == torch.float32 else 1e-9
    kern, dev = device_ms(run, reps, "newton_box")
    row = {"box_ms": cuda_ms(run, reps), "box_wall_ms": wall_ms(run, reps), "box_kernel_ms": kern,
           "box_device_ms": dev, "plain_ms": cuda_ms(lambda: irl._newton_box_plain(*box), 2),
           "lanes": int(lanes.sum()), "tile": bp.shape[0], "N": box[0].shape[1], "P": box[2].shape[1],
           "passes": per_lane(out[2][lanes]),
           "close_share": ((out[0] - bp).abs().amax(1)[lanes] <= btol).double().mean().item(),
           "flags_share": (out[1] == okp)[lanes].double().mean().item(),
           "repeat_bits_equal": bool(torch.equal(out[0], again[0]) and torch.equal(out[1], again[1]))}
    if len(out) > 3:
        row["evaluations"] = per_lane(out[3][lanes])
    if detail and "plan" in inspect.signature(irl._newton_box_cuda).parameters:
        plan = irl._box_plan(box[0].shape[1], box[2].shape[1], box[0].element_size())
        row["plan"] = plan._asdict()
        for _ in range(2):
            for name, p in (("staged", plan), ("unstaged", plan._replace(stage=0))):
                row.setdefault(f"kernel_ms {name}", []).append(
                    device_ms(lambda: irl._newton_box_cuda(*box, sel, plan=p), 5 * reps, "newton_box")[0])
    return row


def box_rows(detail: bool) -> dict:
    """``newton_box`` on the pipeline's rescue tile, float32 and float64
    (its selection, then every lane), and on BOX_SHAPES (every lane)."""
    rows = {}
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        tile = box_tile(dtype)
        if tile is None:
            rows[f"{name} rescue tile"] = "no lane reached the box"
            continue
        box, sel = tile
        rows[f"{name} rescue tile, the pipeline's selection"] = box_row(box, sel, 20, detail)
        rows[f"{name} rescue tile, every lane"] = box_row(box, None, 5, detail)
        del box, sel, tile
    for label, lanes, N, P, dtype, reps in BOX_SHAPES:
        rows[label] = box_row(box_operands(lanes, N, P, dtype), None, reps, detail)
    for label, row in rows.items():
        print(f"  newton_box {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
    return rows


def vst_operands(G: int, N: int, dtype):
    """``vst_transform``'s operands on the card, from a seeded generator
    there: Poisson counts (G, N) at lognormal gene means times seeded size
    factors, those size factors, the parametric trend (0.05, 2.0), the
    ``used_mean`` flag off, the mean dispersion 0.1 and every gene kept."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    means = torch.exp(3.0 + 1.5 * torch.randn(G, 1, generator=g, device=DEVICE, dtype=torch.float64))
    sf = torch.exp(0.2 * torch.randn(N, generator=g, device=DEVICE, dtype=torch.float64))
    counts = torch.poisson(means * sf[None, :], generator=g).to(dtype)
    return (counts, sf.to(dtype), torch.tensor([0.05, 2.0], dtype=dtype, device=DEVICE),
            torch.tensor(False, device=DEVICE), torch.tensor(0.1, dtype=dtype, device=DEVICE),
            torch.ones(G, dtype=torch.bool, device=DEVICE))


def vst_rows(detail: bool) -> dict:
    """``vst`` on VST_SHAPES in its four cases: events and device times
    (kernels named ``vst``) beside the bytes bound, the largest difference
    from the plain version (relative, absolute below 1), NaN on exactly the
    masked rows (asserted), a repeat bit for bit, the plan where the tree
    has one; ``--detail`` the parametric case with tiles of 1, 4, 8 and 16
    vectors a thread and each count in flight the tree's kernel is built
    for."""
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import vst as vs

    rows = {}
    for label, G, N, dtype, reps in VST_SHAPES:
        c, sf, coeffs, flag, mean_disp, keep = vst_operands(G, N, dtype)
        masked = torch.arange(G, device=DEVICE) % 7 != 0
        isz = c.element_size()
        row = {"genes": G, "samples": N,
               "bytes_bound_ms": (isz * (2 * G * N + N + 3) + G + 1) / 3.35e12 * 1e3}
        cases = {"parametric": (flag, keep, False), "used_mean": (torch.tensor(True, device=DEVICE), keep, False),
                 "mean": (None, keep, True), "masked": (flag, masked, False)}
        for case, (fl, gmask, mean_only) in cases.items():
            def run():
                return vs._vst_cuda(c, sf, coeffs, fl, mean_disp, gmask, mean_only)

            got, again = run(), run()
            want = vs._vst_plain(c, sf, coeffs, fl, mean_disp, gmask, mean_only)
            nan_rows = torch.isnan(got).all(1)
            if not bool(nan_rows.eq(~gmask).all()) or bool(torch.isnan(got[gmask]).any()):
                raise AssertionError(f"vst {label} {case}: NaN rows are not the masked ones")
            scale = torch.clamp(want.abs(), min=1.0)
            row[f"{case}_kernel_ms"] = device_ms(run, reps, "vst")[0]
            row[f"{case}_err"] = ((got - want).abs() / scale).nan_to_num(0.0).max().item()
            row[f"{case}_repeat_bits_equal"] = bool(torch.equal(got.view(torch.uint8), again.view(torch.uint8)))
            del got, again, want, scale
        row["vst_ms"] = cuda_ms(lambda: vs._vst_cuda(c, sf, coeffs, flag, mean_disp, keep, False), reps)
        row["vst_device_ms"] = device_ms(lambda: vs._vst_cuda(c, sf, coeffs, flag, mean_disp, keep, False), reps,
                                         "vst")[1]
        row["fill_ms"] = device_ms(lambda: torch.empty_like(c).fill_(1.0), reps, "")[1]
        if hasattr(vs, "_vst_plan"):
            row["plan"] = vs._vst_plan(G, N, isz, c.data_ptr(), sms=kernels.sm_count(c.device))._asdict()
            base = vs._vst_plan(G, N, isz, c.data_ptr())
            for items in getattr(vs, "VST_ITEMS_BUILT", ()) if detail else ():
                for per_thread in (1, 4, 8, 16):
                    tile_rows = max(1, min(G, vs._VST_THREADS * per_thread // (base.cols // base.vec)))
                    plan = base._replace(rows=tile_rows, items=items)
                    row[f"parametric_kernel_ms items={items} rows={tile_rows}"] = device_ms(
                        lambda: vs._vst_cuda(c, sf, coeffs, flag, mean_disp, keep, False, plan=plan), reps,
                        "vst")[0]
        rows[label] = row
        print(f"  vst {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del c, sf, masked
        torch.cuda.empty_cache()
    return rows


def fine_forms(center, hw_f: float, length: int, lo_f: float, hi_f: float) -> torch.Tensor:
    """(length, G) bool: whether each fine point of each gene takes the
    auto form's plain part (r = exp(-la) < 8), as ``disp_scan_fine`` picks
    it."""
    dt, dev = center.dtype, center.device
    lo, hi, hw, step = (torch.tensor(v, dtype=dt, device=dev) for v in (lo_f, hi_f, hw_f, 2.0 * hw_f / (length - 1)))
    ks = torch.arange(length, dtype=dt, device=dev)
    la = torch.clamp(center[None, :] - hw + ks[:, None] * step, lo, hi)
    return torch.exp(-la) < 8.0


def mixed_warps(forms: torch.Tensor) -> float:
    """The share of (tile of 32 genes, point) warps whose lanes take both
    forms, in the genes' order."""
    K, G = forms.shape
    pad = -G % 32
    f = torch.cat([forms, forms[:, -1:].expand(K, pad)], 1).reshape(K, -1, 32)
    return (f.any(2) & ~f.all(2)).double().mean().item()


def fine_lists(counts, mu, la_hat, la1, kind: str, hw_f: float, lo_f: float, hi_f: float):
    """The genes of one ``fine`` shape: the draw as the coarse scan leaves
    it (``coarse``); every gene at the most common centre (``one``); or
    genes whose eight points all take one form, alternating with genes
    whose points all take the other (``straddle``: every tile of 32 holds
    16 of each, genes drawn again where a side has fewer)."""
    if kind == "coarse":
        return counts, mu, la_hat, la1
    if kind == "one":
        vals, cnt = torch.unique(la1, return_counts=True)
        return counts, mu, la_hat, torch.full_like(la1, vals[cnt.argmax()].item())
    forms = fine_forms(la1, hw_f, FINE_K, lo_f, hi_f)
    sides = [torch.nonzero(forms.all(0)).flatten(), torch.nonzero(~forms.any(0)).flatten()]
    if min(s.numel() for s in sides) == 0:
        order = torch.argsort(la1)
        sides = [order[-(la1.numel() // 2):], order[: la1.numel() // 2]]
    G = la1.numel()
    i = torch.arange(G, device=la1.device)
    idx = torch.where(i % 2 == 0, sides[0][(i // 2) % sides[0].numel()], sides[1][(i // 2) % sides[1].numel()])
    return counts[idx].contiguous(), mu[idx].contiguous(), la_hat[idx].contiguous(), la1[idx].contiguous()


def fine_rows(detail: bool) -> dict:
    """``disp_scan_fine`` through ``scan_grid`` on FINE_SHAPES, K = FINE_K
    points around the centres of a coarse scan (``disp_scan``) of the same
    draw: events and device times of every kernel ``scan_grid`` runs (the
    names holding ``disp_scan``: the scan and, where the tree has it, its
    gene grouping) and of the grouping alone, the (gene, point) pairs of
    each form, the share of warps whose lanes take both forms in the genes'
    order and in the tree's order, the share of genes at the plain
    version's point, and a digest of the kernel's best log-alpha bits
    (``main`` holds it equal across trees)."""
    import hashlib

    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    rows = {}
    for label, G, N, P, dtype, kind, reps in FINE_SHAPES:
        counts, mu, X = inputs(G, N, P, dtype)
        max_disp = float(max(10, N))
        lo_f, hi_f = math.log(1e-8), math.log(max_disp)
        step1_f = (hi_f - lo_f) / 31
        lo = torch.tensor(lo_f, dtype=dtype, device=DEVICE)
        la_grid = lo + torch.arange(32, dtype=dtype, device=DEVICE) * torch.tensor(step1_f, dtype=dtype, device=DEVICE)
        bs, be = dsp._scan_branches(32, step1_f, lo_f)
        la_hat = torch.zeros(G, dtype=dtype, device=DEVICE)
        pdv = torch.tensor(1.0, dtype=dtype, device=DEVICE)
        la1, _ = dsp.scan_coarse(counts, mu, X, la_grid, bs, be, (lo_f + hi_f) / 2, True, False, la_hat, pdv)
        counts, mu, la_hat, center = fine_lists(counts, mu, la_hat, la1, kind, step1_f, lo_f, hi_f)
        args = (counts, mu, X, center, step1_f, FINE_K, lo_f, hi_f, True, False, la_hat, pdv)
        got = dsp.scan_grid(*args)
        want = dsp.scan_grid_plain(*args)
        forms = fine_forms(center, step1_f, FINE_K, lo_f, hi_f)
        kern, dev = device_ms(lambda: dsp.scan_grid(*args), reps, "disp_scan")
        row = {"genes": G, "samples": N, "P": P, "centres": int(torch.unique(center).numel()),
               "fine_ms": cuda_ms(lambda: dsp.scan_grid(*args), reps), "fine_kernel_ms": kern, "fine_device_ms": dev,
               "group_kernel_ms": device_ms(lambda: dsp.scan_grid(*args), reps, "group")[0],
               "plain_pairs": int(forms.sum()), "stable_pairs": int((~forms).sum()),
               "mixed_warps_gene_order": mixed_warps(forms),
               "same_point_share": (got == want).double().mean().item(),
               "segments": dsp._scan_segments(G, N, kernels.sm_count(torch.device(DEVICE))),
               "best_la_bits": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]}
        if hasattr(dsp, "_fine_order_plain"):
            order = dsp._fine_order_plain(center, lo_f, step1_f, dsp._fine_buckets(lo_f, hi_f, step1_f))[0]
            row["mixed_warps_tree_order"] = mixed_warps(forms[:, order.long()])
        rows[label] = row
        print(f"  fine {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del counts, mu, X, la1, center, got, want, forms
        torch.cuda.empty_cache()
    return rows


def dnb_rows(detail: bool) -> dict:
    """``dnb_nll`` on DNB_SHAPES (``inputs``' counts and mu, seeded
    lognormal dispersions): events and device times (kernels named
    ``dnb``), the largest gap from the plain version relative to the
    summed magnitudes of its terms (as ``chip_smoke.py``'s dnb_check), a
    repeat bit for bit; where the tree has ``_dnb_plan``, its lanes a row
    and (``detail``) every plan's device time."""
    from pydeseq2_tpu_torch.ops import nb

    rows = {}
    for label, G, N, dtype, reps in DNB_SHAPES + (DNB_EDGE_SHAPES if detail else ()):
        counts, mu, _ = inputs(G, N, 2, dtype)
        rng = np.random.default_rng(6)
        alpha = torch.as_tensor(np.clip(rng.lognormal(-2.0, 1.0, G), 1e-3, 5.0), dtype=dtype, device=DEVICE)
        got, again = nb.dnb_nll(counts, mu, alpha), nb.dnb_nll(counts, mu, alpha)
        want = nb._dnb_nll_plain(counts, mu, alpha)
        r = 1.0 / alpha[:, None]
        scale = (nb._psi_fast(r).abs() + nb._psi_fast(counts + r).abs() + torch.log1p(mu * alpha[:, None]).abs()
                 + ((counts - mu) / (mu + r)).abs()).sum(-1) / alpha**2
        kern, dev = device_ms(lambda: nb.dnb_nll(counts, mu, alpha), reps, "dnb")
        row = {"dnb_ms": cuda_ms(lambda: nb.dnb_nll(counts, mu, alpha), reps), "dnb_kernel_ms": kern,
               "dnb_device_ms": dev, "err": ((got - want).abs() / scale).max().item(),
               "repeat_bits_equal": bool(torch.equal(got, again)),
               "bytes_bound_ms": (2 * G * N + 2 * G) * counts.element_size() / 3.35e12 * 1e3}
        if hasattr(nb, "_dnb_plan"):
            row["lanes"] = nb._dnb_plan(N, counts.element_size())
            if detail:
                for lanes in DNB_LANES:
                    row[f"kernel_ms lanes={lanes}"] = device_ms(
                        lambda: nb._dnb_nll_cuda(counts, mu, alpha, lanes), reps, "dnb")[0]
        rows[label] = row
        print(f"  dnb {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del counts, mu, alpha, got, again, want, scale
        torch.cuda.empty_cache()
    return rows


def cuobjdump(kernels) -> str | None:
    """The toolkit's cuobjdump: on the PATH, beside nvcc, or in Triton's
    package; None where there is none."""
    found = [shutil.which("cuobjdump")]
    try:
        found.append(str(Path(kernels._nvcc()).parent / "cuobjdump"))
    except RuntimeError:
        pass
    try:
        import triton

        found.append(str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"))
    except ImportError:
        pass
    return next((t for t in found if t and Path(t).exists()), None)


# Sources whose loops call no transcendental: sass_loops reports every loop.
SASS_ALL_LOOPS = ("select.cu",)


def sass_loops(kernels, sources) -> dict:
    """{source: {function: [loop, ...]}} for the loops that call a
    transcendental (a MUFU instruction; every loop for SASS_ALL_LOOPS) in
    ``cuobjdump -sass`` of each built library, each loop {"instructions":
    its count, "min_path" / "max_path": the fewest and most instructions
    one trip can issue (the shortest and longest path from its head to its
    back edge, inner loops counted once), "mufu": its MUFU instructions};
    {} where the toolkit has no cuobjdump."""
    tool = cuobjdump(kernels)
    if tool is None:
        return {}
    out = {}
    for src in sources:
        text = subprocess.run([tool, "-sass", str(kernels._lib_path(src))], capture_output=True, text=True,
                              timeout=300).stdout
        funcs = sass_functions(text, mufu_only=src not in SASS_ALL_LOOPS)
        out[src] = {name: loops for name, loops in funcs.items() if loops}
    return out


_SASS_FN = re.compile(r"^\s*Function : (\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# a branch and its target: a label (nvdisasm) or an address (cuobjdump)
_SASS_BRA = re.compile(r"^(@!?U?P\w+\s+)?BRA(?:\.\w+)*\s+((?:\S+\s+)*?)`?\(?(\.L_x_\d+|0x[0-9a-f]+)\)?")


def sass_functions(text: str, mufu_only: bool = True) -> dict:
    """{function: [loop, ...]} of one ``cuobjdump -sass`` listing (see
    :func:`sass_loops`)."""
    funcs, name, body, targets = {}, None, [], {}

    def close():
        if name is not None:
            funcs[name] = _loops(body, targets, mufu_only)

    for line in text.splitlines():
        m = _SASS_FN.match(line)
        if m:
            close()
            name, body, targets = m.group(1), [], {}
            continue
        if name is None:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            targets[m.group(1)] = len(body)
            continue
        m = _SASS_INSTR.search(line)
        if m:
            targets[hex(int(m.group(1), 16))] = len(body)
            body.append(m.group(2).strip())
    close()
    return funcs


def _target(ins: str, targets: dict):
    """(conditional, index of the target) of a branch, else None; a branch
    on a predicate (``@P0 BRA``) or on an operand (``BRA !UP0, ...``) is
    conditional."""
    m = _SASS_BRA.match(ins)
    if not m:
        return None
    t = m.group(3)
    return bool(m.group(1) or m.group(2)), targets.get(t if t.startswith(".") else hex(int(t, 16)))


def _is_mufu(ins: str) -> bool:
    return ins.startswith("MUFU") or " MUFU" in ins


def _loops(body: list[str], targets: dict, mufu_only: bool = True) -> list[dict]:
    loops = []
    for i, ins in enumerate(body):
        br = _target(ins, targets)
        if br is None or br[1] is None or br[1] > i:
            continue
        head = br[1]
        span = body[head:i + 1]
        if mufu_only and not any(_is_mufu(x) for x in span):
            continue
        lo, hi = _paths(span, {k: v - head for k, v in targets.items() if head <= v <= i})
        loops.append({"instructions": len(span), "min_path": lo, "max_path": hi,
                      "mufu": sum(1 for x in span if _is_mufu(x))})
    return loops


def _paths(span: list[str], targets: dict) -> tuple[int, int]:
    """The fewest and most instructions on a path from span[0] to its last
    instruction (the back edge), following forward branches and falling
    through; a branch out of the span ends no path that counts. (None,
    None) where no path reaches the back edge."""
    n = len(span)
    inf = float("inf")
    lo, hi = [inf] * (n + 1), [-inf] * (n + 1)
    lo[0] = hi[0] = 0
    for i in range(n):
        if lo[i] == inf:
            continue
        br = _target(span[i], targets)
        succ = []
        if br is not None:
            if br[1] is not None and br[1] > i:
                succ.append(br[1])
            if br[0] or i == n - 1:  # conditional, or the back edge itself
                succ.append(i + 1)
        elif not span[i].startswith(("EXIT", "RET")):
            succ.append(i + 1)
        for j in succ:
            lo[j] = min(lo[j], lo[i] + 1)
            hi[j] = max(hi[j], hi[i] + 1)
    return (None, None) if lo[n] == inf else (int(lo[n]), int(hi[n]))


def child(detail: bool, suites=("disp",)) -> dict:
    from pydeseq2_tpu_torch import kernels

    # Build the suites' sources only.
    sources = tuple(src for suite in suites for src in SUITES[suite])
    full = kernels.KERNELS, kernels.HELPERS
    kernels.KERNELS = {k: v for k, v in full[0].items() if v[0] in sources}
    kernels.HELPERS = {}
    try:
        kernels.build()
    finally:
        kernels.KERNELS, kernels.HELPERS = full

    res = {"ptxas": ptxas(kernels, sources)}
    if detail:
        res["sass_loops"] = sass_loops(kernels, sources)
    if "disp" in suites:
        res["shapes"] = disp_rows(detail)
    if "sf" in suites:
        res["sf"] = sf_rows(detail)
    if "trend" in suites:
        res["trend"] = trend_rows(detail)
    if "cooks" in suites:
        res["cooks"] = cooks_rows(detail)
        res["trimmed_var"] = trim_rows(detail)
    if "grid" in suites:
        res["grid"] = grid_rows(detail)
    if "shrink" in suites:
        res["shrink"] = shrink_rows(detail)
    if "select" in suites:
        res["select"] = select_rows(detail)
    if "irls" in suites:
        res["irls"] = irls_rows(detail)
    if "mom" in suites:
        res["mom"] = mom_rows(detail)
    if "bh" in suites:
        res["bh"] = bh_rows(detail)
    if "hat" in suites:
        res["hat"] = hat_rows(detail)
    if "lowess" in suites:
        res["lowess"] = lowess_rows(detail)
    if "impute" in suites:
        res["impute"] = impute_rows(detail)
    if "box" in suites:
        res["box"] = box_rows(detail)
    if "vst" in suites:
        res["vst"] = vst_rows(detail)
    if "fine" in suites:
        res["fine"] = fine_rows(detail)
    if "dnb" in suites:
        res["dnb"] = dnb_rows(detail)
    if "hist" in suites:
        res["hist"] = hist_rows(detail)
    return res


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def summary(res: dict) -> dict:
    """The headline times of one tree's run, by suite and shape."""
    out = {}
    for k, v in res.get("shapes", {}).items():
        out[f"disp {k}"] = {"scan": v["disp_scan_ms"], "newton": v["disp_newton_ms"],
                            "scan_kernel": v["disp_scan_kernel_ms"], "newton_kernel": v["disp_newton_kernel_ms"]}
    for k, v in res.get("sf", {}).items():
        if k.startswith("lgamma_table"):
            out[f"sf {k}"] = {"kernel": v["lgamma_table_kernel_ms"], "torch_lgamma": v["torch_lgamma_kernel_ms"],
                              "launch_floor": v["launch_floor_ms"]}
            continue
        out[f"sf {k}"] = {"ms": v["sf_newton_ms"], "kernel": v["sf_newton_kernel_ms"],
                          "sf_nll_kernel": v["sf_nll"]["sf_nll_kernel_ms"],
                          "sf_nll_zero_heavy_kernel": v["sf_nll zero_heavy"]["sf_nll_kernel_ms"]}
    for k, v in res.get("grid", {}).items():
        if k == "grid_nb":
            for kk, vv in v.items():
                if isinstance(vv, dict):
                    out[f"grid_nb {kk}"] = {"ms": vv["grid_nb_ms"], "kernel": vv["grid_nb_kernel_ms"]}
        elif isinstance(v, dict):
            out[f"grid {k}"] = {"ms": v["grid_apeglm_ms"], "kernel": v["grid_apeglm_kernel_ms"]}
    for k, v in res.get("shrink", {}).items():
        out[f"shrink {k}"] = {"ms": v["shrink_ms"], "kernel": v["shrink_kernel_ms"], "bits": v["beta_bits"]}
    for k, v in res.get("trend", {}).items():
        out[f"trend {k}"] = {"trend": v["trend_ms"], "trend_kernel": v["trend_kernel_ms"],
                             "trend_fit": v["trend_fit_ms"], "trend_fit_kernel": v["trend_fit_kernel_ms"]}
    for k, v in res.get("select", {}).items():
        out[f"select {k}"] = {"ms": v["select_ms"], "kernel": v["select_kernel_ms"], "device": v["select_device_ms"],
                              "sort": v["sort_ms"], "bits": v["bits_equal"] and v["repeat_equal"]}
    for k, v in res.get("irls", {}).items():
        out[f"irls {k}"] = {"ms": v["irls_ms"], "kernel": v["irls_kernel_ms"], "core": v["irls_core_ms"],
                            "core_device": v["irls_core_device_ms"], "close": v["close_share"],
                            "flags": v["flags_share"], "trips": [v["max_trips"], v["plain_trips"]]}
    for k, v in res.get("mom", {}).items():
        out[f"mom {k}"] = {"ms": v["mom_ms"], "kernel": v["mom_kernel_ms"], "device": v["mom_device_ms"],
                           "matmul": v["matmul_ms"], "err": v["max_rel_err"]}
    for k, v in res.get("hat", {}).items():
        out[f"hat {k}"] = {key: v[key] for key in ("hat_wald_kernel_ms", "hat_kernel_ms", "wald_kernel_ms",
                                                   "test_only_kernel_ms", "fill_ms", "hat_wald_ms", "errs") if key in v}
    for k, v in res.get("lowess", {}).items():
        out[f"lowess {k}"] = {key: v[key] for key in ("lowess_kernel_ms", "lowess_ms", "row", "plain_row",
                                                      "fit_bits_equal")}
    for k, v in res.get("bh", {}).items():
        out[f"bh {k}"] = {key: v[key] for key in ("sweep_kernel_ms", "one_row_kernel_ms", "device_padj_device_ms",
                                                  "counts_and_row_kernel_ms", "argsort_ms", "sweep_bits_equal",
                                                  "counts_bits_equal", "picked_row_bits_equal") if key in v}
    for k, v in res.get("impute", {}).items():
        out[f"impute {k}"] = {key: v[key] for key in ("impute_kernel_ms", "impute_ms", "impute_wall_ms", "plain_ms",
                                                      "beyond_floor_rule", "repeat_bits_equal") if key in v}
    for k, v in res.get("box", {}).items():
        if not isinstance(v, dict):
            continue
        out[f"box {k}"] = {key: v[key] for key in ("box_kernel_ms", "box_ms", "box_wall_ms", "lanes", "passes",
                                                   "evaluations", "close_share", "repeat_bits_equal") if key in v}
    for k, v in res.get("vst", {}).items():
        out[f"vst {k}"] = {key: v[key] for key in ("parametric_kernel_ms", "masked_kernel_ms", "mean_kernel_ms",
                                                   "vst_ms", "bytes_bound_ms", "parametric_err") if key in v}
    for k, v in res.get("fine", {}).items():
        out[f"fine {k}"] = {key: v[key] for key in ("fine_kernel_ms", "group_kernel_ms", "fine_ms",
                                                    "mixed_warps_gene_order", "mixed_warps_tree_order",
                                                    "best_la_bits") if key in v}
    for k, v in res.get("dnb", {}).items():
        out[f"dnb {k}"] = {key: v[key] for key in ("dnb_kernel_ms", "dnb_ms", "err", "lanes") if key in v}
    for k, v in res.get("hist", {}).items():
        out[f"hist {k}"] = {key: v[key] for key in v if key.endswith("kernel_ms") or key.startswith("median")
                            or key in ("bincount_ms", "bytes_bound_ms", "pick_kernel_ms")}
    for suite in ("cooks", "trimmed_var"):
        for k, v in res.get(suite, {}).items():
            if not k.startswith("rank sweep"):
                out[f"{suite} {k}"] = {"ms": v[f"{suite}_ms"], "kernel": v[f"{suite}_kernel_ms"], "sort": v["sort_ms"]}
    return out


def main(argv: list[str]) -> int:
    detail = "--detail" in argv
    suites = tuple(SUITES)
    if "--only" in argv:
        suites = tuple(argv[argv.index("--only") + 1].split(","))
        argv = argv[:argv.index("--only")] + argv[argv.index("--only") + 2:]
        unknown = set(suites) - set(SUITES)
        if unknown:
            print(f"kernel_bench: unknown suites {sorted(unknown)}; known: {sorted(SUITES)}", file=sys.stderr)
            return 2
    if "--child" in argv:
        print("RESULT " + json.dumps(child(detail, suites)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is visible", file=sys.stderr)
        return 1
    trees = [a for a in argv if not a.startswith("--")] or ["."]
    print(f"card: {card_line()}", flush=True)
    runs = []
    for tree in trees:
        cmd = ([sys.executable, str(Path(__file__).resolve()), "--child", "--only", ",".join(suites)]
               + (["--detail"] if detail else []))
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=1800)
        sys.stderr.write(proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(f"kernel_bench: the run in {tree} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        runs.append({"tree": tree, **json.loads(lines[-1][len("RESULT "):])})
        print(f"{tree}: " + json.dumps(summary(runs[-1])), flush=True)
    differ = []
    if "fine" in suites:
        # the scan's per-gene sums do not depend on the gene order: every
        # tree's best log-alpha must be the same bits
        differ = sorted(k for k in runs[0]["fine"]
                        if len({r["fine"][k]["best_la_bits"] for r in runs}) > 1)
        print(f"fine: best_la bits equal across trees: {not differ}" + (f", differ at {differ}" if differ else ""),
              flush=True)
    print(json.dumps({"card": card_line(), "runs": runs}), flush=True)
    return 1 if "fine" in suites and differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
