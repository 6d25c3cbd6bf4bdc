"""The entry the window drives for a mix with ``"entry": "refit_summary"``.

``run_summary_streamed(counts, design, contrast, dtype=..., refit_cooks=True)``
of ``pydeseq2_tpu_torch.fused_stream``, with the knobs ``run_deseq2`` passes
it on its refit route: counts on the device, gene-major; per-gene numpy
results back. The reference is ``dea_bench.reference.deseq2.refit_summary``
with the same inputs and knobs.

``numbers`` says how far the program's results lie from the reference's:
statistics of each quantity's per-gene gaps over all genes, their largest
over the expressed genes and over the refitted ones (see ``QUANTITIES``,
``STATISTICS`` and ``SUBSETS``), and the trend checked as a stage of its
own; a cell's limits (``dea_bench/limits/<workload>.json``) name the ones
it holds and the limit of each.
"""

from __future__ import annotations

import numpy as np
import torch

MIN_DISP = 1e-8
# The base-mean floor of the expressed genes: below it a float32 dispersion
# fit of the program and of the reference may stop far apart where the NB
# likelihood is flat in the dispersion (PERF.md §2).
EXPRESSED = 20.0


def knobs(n_samples: int, dtype: torch.dtype) -> dict:
    """``run_deseq2``'s defaults on its refit route (``api.py``): max_disp
    max(10, N), beta_tol 1e-8 in float64 and 1e-6 in float32, Cook's
    filtering and independent filtering at alpha 0.05, min_replicates 7."""
    return dict(max_disp=float(max(10, n_samples)), beta_tol=1e-8 if dtype == torch.float64 else 1e-6,
                min_mu=0.5, min_disp=MIN_DISP, alpha=0.05, cooks_filter=True, independent_filter=True,
                trend_type="parametric")


def program(study, dtype: torch.dtype, kn: dict) -> dict:
    """One study through the program; returns once its numpy results are
    on the host."""
    from pydeseq2_tpu_torch.fused_stream import run_summary_streamed

    return run_summary_streamed(study.counts, study.design, study.contrast, dtype=dtype, refit_cooks=True,
                                min_replicates=7, device=study.counts.device, **kn)


def reference(study, dtype: torch.dtype, kn: dict, tf32: bool = False) -> dict:
    """The same study through the plain reference, in ``dtype``."""
    from dea_bench.reference.deseq2 import refit_summary

    counts = study.counts if study.counts.dtype == dtype else study.counts.to(dtype)
    return refit_summary(counts, study.design, study.contrast, min_replicates=7, tf32=tf32, **kn)


_TINY = np.finfo(np.float64).tiny


def _pair(a, b):
    """Both as float64, NaN on each side where either is not finite."""
    a, b = np.array(a, np.float64), np.array(b, np.float64)
    bad = ~(np.isfinite(a) & np.isfinite(b))
    a[bad] = b[bad] = np.nan
    return a, b


def _rel(a, b):
    """|a - b| / |b| where both are finite, else NaN."""
    a, b = _pair(a, b)
    return np.abs(a - b) / np.maximum(np.abs(b), _TINY)


def _log_gap(a, b):
    """|log a - log b| where both are positive (dispersions: a relative gap
    that stays fair where one side is ~0), else NaN."""
    a, b = _pair(a, b)
    ok = (a > 0) & (b > 0)
    out = np.full(a.shape, np.nan)
    out[ok] = np.abs(np.log(a[ok]) - np.log(b[ok]))
    return out


def _p_gap(a, b, floor):
    """The gap in -log10 p over max(1, -log10 p_ref): p-values span hundreds
    of decades, and below ``floor`` (the dtype's smallest normal) both
    sides read as ``floor``."""
    a, b = _pair(a, b)
    la = -np.log10(np.maximum(a, floor))
    lb = -np.log10(np.maximum(b, floor))
    return np.abs(la - lb) / np.maximum(1.0, lb)


def trend_inputs(res: dict, main: dict) -> tuple[np.ndarray, np.ndarray]:
    """The base means and genewise dispersions that the trend of result
    ``res`` was fitted on: ``res``'s own, except for the genes its refit
    replaced, whose main-pass values ``main`` (a reference result) gives."""
    rep = np.asarray(res["replaced"], bool)
    bm = np.array(res["base_mean"], np.float64)
    gw = np.array(res["genewise_dispersions"], np.float64)
    bm[rep] = np.asarray(main["main_base_mean"], np.float64)[rep]
    gw[rep] = np.asarray(main["main_genewise_dispersions"], np.float64)[rep]
    return bm, gw


def trend_stage(prog: dict, ref: dict, dtype: torch.dtype | None = None) -> np.ndarray:
    """Per gene, the |log gap| between the program's fitted dispersions and
    the plain trend (``dea_bench.reference``) fitted again, in ``dtype``
    (default the program's), on the program's own trend inputs: the trend
    checked as a stage, apart from the genewise fits that feed it."""
    from dea_bench.reference.deseq2 import fit_fused_trend

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    t = dtype or torch.from_numpy(np.asarray(prog["fitted_dispersions"])[:1]).dtype
    bm, gw = trend_inputs(prog, ref)
    non_zero = torch.as_tensor(np.isfinite(gw), device=dev)
    _, c, failed, mean_disp = fit_fused_trend(torch.as_tensor(bm, device=dev).to(t),
                                              torch.as_tensor(gw, device=dev).to(t), non_zero, MIN_DISP,
                                              "parametric")
    c = c.double().cpu().numpy()
    bm_out = np.asarray(prog["base_mean"], np.float64)
    with np.errstate(divide="ignore"):
        fitted = np.full(bm_out.shape, float(mean_disp)) if bool(failed) else c[0] + c[1] / bm_out
    return _log_gap(prog["fitted_dispersions"], fitted)


# quantity -> what it reads
QUANTITIES = {
    "size_factors": "relative gap of the size factors",
    "base_mean": "relative gap of the base means",
    "disp_genewise": "|log gap| of the genewise dispersions",
    "disp_fitted": "|log gap| of the trend's fitted dispersions",
    "disp_map": "|log gap| of the MAP dispersions",
    "lfc": "gap of the LFC over the reference's SE",
    "se": "relative gap of the LFC's SE",
    "stat": "gap of the Wald statistic",
    "pvalue": "gap of -log10 p over max(1, -log10 p_ref)",
    "padj": "gap of -log10 padj over max(1, -log10 padj_ref)",
    "trend_stage": "|log gap| of the fitted dispersions against the plain trend on the program's own inputs",
    "nan_genes": "genes whose NaN pattern differs in any compared column",
    "flag_genes": "genes whose replaced, refitted or cooks_outlier flag differs",
}

_COLUMNS = ("base_mean", "genewise_dispersions", "fitted_dispersions", "MAP_dispersions", "lfc", "se",
            "statistics", "p_values", "padj")


def gaps(prog: dict, ref: dict, contrast: np.ndarray, trend_dtype: torch.dtype | None = None) -> dict:
    """Per-gene (size factors: per-sample) gaps of each quantity, program
    ``prog`` against reference ``ref``, both as the entry returns them; NaN
    where a side is not finite. The two counts are boolean per gene.
    ``trend_dtype`` is the dtype of the trend stage's plain fit."""
    floor = float(np.finfo(np.asarray(ref["size_factors"]).dtype).tiny)
    lfc_p = np.asarray(prog["lfc"], np.float64) @ contrast
    lfc_r = np.asarray(ref["lfc"], np.float64) @ contrast
    lfc_p, lfc_r = _pair(lfc_p, lfc_r)
    se_r = np.asarray(ref["se"], np.float64)
    G = len(ref["base_mean"])
    nan_bad = np.zeros(G, bool)
    for col in _COLUMNS:
        x, y = np.asarray(prog[col], np.float64), np.asarray(ref[col], np.float64)
        if x.ndim == 2:
            x, y = x @ contrast, y @ contrast
        nan_bad |= np.isnan(x) != np.isnan(y)
    flag_bad = np.zeros(G, bool)
    for col in ("replaced", "refitted", "cooks_outlier"):
        flag_bad |= np.asarray(prog[col], bool) != np.asarray(ref[col], bool)
    return {
        "size_factors": _rel(prog["size_factors"], ref["size_factors"]),
        "base_mean": _rel(prog["base_mean"], ref["base_mean"]),
        "disp_genewise": _log_gap(prog["genewise_dispersions"], ref["genewise_dispersions"]),
        "disp_fitted": _log_gap(prog["fitted_dispersions"], ref["fitted_dispersions"]),
        "disp_map": _log_gap(prog["MAP_dispersions"], ref["MAP_dispersions"]),
        "lfc": np.abs(lfc_p - lfc_r) / np.maximum(np.abs(se_r), _TINY),
        "se": _rel(prog["se"], ref["se"]),
        "stat": np.abs(np.subtract(*_pair(prog["statistics"], ref["statistics"]))),
        "pvalue": _p_gap(prog["p_values"], ref["p_values"], floor),
        "padj": _p_gap(prog["padj"], ref["padj"], floor),
        "trend_stage": trend_stage(prog, ref, trend_dtype),
        "nan_genes": nan_bad,
        "flag_genes": flag_bad,
    }


# The statistics of each quantity's gaps that a cell's limits may name, as
# "<quantity>.<statistic>": the largest gap and three quantiles over the
# genes; the two gene counts as "<quantity>.count".
STATISTICS = {"max": None, "q999": 0.999, "q99": 0.99, "median": 0.5}

# The gene subsets over which a per-gene quantity's largest gap is taken,
# as "<quantity>.<subset>": the genes whose reference base mean is at least
# EXPRESSED, and the genes the reference refitted.
SUBSETS = {
    "max_expr": lambda ref: np.asarray(ref["base_mean"], np.float64) >= EXPRESSED,
    "max_refit": lambda ref: np.asarray(ref["refitted"], bool),
}


def largest(g: np.ndarray, where: np.ndarray | None = None) -> float:
    """The largest finite gap (of the genes ``where``), 0 where none is."""
    ok = np.isfinite(g) if where is None else np.isfinite(g) & where
    return float(np.max(g[ok])) if ok.any() else 0.0


def numbers(prog: dict, ref: dict, contrast: np.ndarray, trend_dtype: torch.dtype | None = None) -> dict:
    """Every number a limit may name, for one study."""
    G = len(ref["base_mean"])
    subsets = {name: pick(ref) for name, pick in SUBSETS.items()}
    out = {}
    for k, g in gaps(prog, ref, contrast, trend_dtype).items():
        if g.dtype == bool:
            out[f"{k}.count"] = float(g.sum())
            continue
        fin = g[np.isfinite(g)]
        for stat, q in STATISTICS.items():
            out[f"{k}.{stat}"] = 0.0 if not fin.size else float(np.max(fin) if q is None else np.quantile(fin, q))
        if k != "size_factors" and g.shape[0] == G:
            for name, where in subsets.items():
                out[f"{k}.{name}"] = largest(g, where)
    return out
