"""Statistics layer: Wald tests, multiplicity control, apeGLM shrinkage.

Port of ``pydeseq2_tpu/models/stats.py`` (reference pydeseq2/ds.py:19-601):
the same public surface (``results_df``, ``p_values``, ``statistics``,
``SE``, ``padj``, ``LFC``, ``base_mean``) and statistical semantics.

- The Wald pass forms mu = sf e^{X beta} on the device and runs the Wald-only
  entry of ``csrc/hat_wald.cu`` through the dataset's backend; it is
  memoised on its hypothesis key ``(lfc_null, alt_hypothesis)``.
- Independent filtering is the ``bh`` kernel's sweep over the 50 base-mean
  cutoffs (one shared stable sort of the p-values) and the ``lowess``
  kernel's fit and pick; plain BH is the same sweep with one row. Both in
  float64, as the JAX package adjusts p-values in float64.
- ``lfc_shrink`` runs the apeGLM fit through the backend; the prior
  variance is a plain bisection on the host.
"""

from __future__ import annotations

import sys
import time
import warnings
from typing import Literal, NamedTuple

import numpy as np
import pandas as pd
import torch

from pydeseq2_tpu_torch.inference import Inference
from pydeseq2_tpu_torch.ops.stats import bh_sweep, lowess_pick

LN2 = float(np.log(2.0))

_TWO_SIDED_ALTS = frozenset({"greaterAbs", "lessAbs"})

# The lowess kernel fits 1 to 64 points (csrc/lowess.cu: one 64-thread block).
MAX_CUTOFFS = 64


def _require_positive_null(lfc_null: float, alt_hypothesis: str | None) -> None:
    """Absolute-value alternatives need a non-negative null LFC."""
    if alt_hypothesis in _TWO_SIDED_ALTS and lfc_null < 0:
        raise ValueError(
            f"lfc_null must be >= 0 under the '{alt_hypothesis}' alternative "
            f"hypothesis; got {lfc_null}."
        )


class _WaldArrays(NamedTuple):
    """Raw per-gene Wald outputs, before labeling/masking."""

    p: np.ndarray
    stat: np.ndarray
    se: np.ndarray


def _bh_inputs(p_values: np.ndarray, device):
    """p (NaN -> 1), its stable ascending order and the testable mask, as
    float64 device tensors."""
    testable = torch.as_tensor(~np.isnan(p_values), device=device)
    p = torch.as_tensor(np.nan_to_num(p_values, nan=1.0), dtype=torch.float64, device=device)
    return p, torch.argsort(p, stable=True), testable


def _independent_filter_padj(
    p_values: np.ndarray,
    base_mean: np.ndarray,
    alpha: float,
    n_cutoffs: int = 50,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Adjusted p-values with base-mean independent filtering.

    Semantics of ``pydeseq2_tpu/models/stats.py:61`` (reference
    pydeseq2/ds.py:486-527): sweep ``n_cutoffs`` base-mean quantile
    thresholds, BH-adjust the surviving genes at each (the ``bh`` kernel),
    smooth the rejection counts with lowess(frac=1/5) and keep the first
    threshold whose count clears max - sqrt(MSE) (the ``lowess`` kernel),
    the first when no row has more than 10 rejections. Raises for more than
    64 cutoffs, the most the lowess kernel fits.
    """
    if not 0 < n_cutoffs <= MAX_CUTOFFS:
        raise ValueError(f"n_cutoffs={n_cutoffs}; the lowess fit takes 1 to {MAX_CUTOFFS} cutoffs")
    zero_frac = float(np.mean(base_mean == 0))
    hi = 0.95 if zero_frac < 0.95 else 1.0
    quantiles = np.linspace(zero_frac, hi, n_cutoffs)
    thresholds = np.quantile(base_mean, quantiles)

    p, order, testable = _bh_inputs(p_values, device)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), device=device)

    adj, num_rej = bh_sweep(p, order, testable, t(base_mean), t(thresholds), alpha)
    _, chosen = lowess_pick(t(quantiles), num_rej, frac=1 / 5)
    return adj[chosen].cpu().numpy()


def _bh_padj(p_values: np.ndarray, device: str | torch.device = "cuda") -> np.ndarray:
    """Plain Benjamini-Hochberg over the non-NaN p-values (no filtering):
    the ``bh`` kernel's sweep with one row."""
    p, order, testable = _bh_inputs(p_values, device)
    adj, _ = bh_sweep(p, order, testable)
    return adj[0].cpu().numpy()


def _apeglm_prior_variance(
    mle_lfc: np.ndarray,
    se: np.ndarray,
    lo: float = 1e-6,
    hi: float = 400.0,
    iters: int = 80,
) -> float:
    """apeGLM adaptive prior variance (reference pydeseq2/ds.py:552-588).

    Solves g(a) = sum_i w_i(a) (S_i - D_i) / sum_i w_i(a) - a = 0 with
    w_i = (a + D_i)^-2, where S = squared MLE LFCs and D = squared SEs, by
    bisection on [lo, hi] (g is continuous; g(lo) < 0 short-circuits to lo as
    in the reference). ~80 halvings reach ~1e-15 relative width. Port of
    ``pydeseq2_tpu/models/stats.py:110``.
    """
    ok = ~np.isnan(mle_lfc)
    S = np.square(mle_lfc[ok])
    D = np.square(se[ok])

    def resid(a: float) -> float:
        w = 1.0 / np.square(a + D)
        return float((w * (S - D)).sum() / w.sum()) - a

    if resid(lo) < 0:
        return lo
    a_lo, a_hi = lo, hi
    for _ in range(iters):
        mid = 0.5 * (a_lo + a_hi)
        if resid(mid) > 0:
            a_lo = mid
        else:
            a_hi = mid
    return 0.5 * (a_lo + a_hi)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class DeseqStats:
    """Differential-expression statistics on a fitted ``DeseqDataSet``.

    Public API (constructor signature, ``summary()``, ``run_wald_test()``,
    ``lfc_shrink()``, ``plot_MA()``, result attributes) matches the reference
    class (pydeseq2/ds.py:131-223). ``inference`` defaults to the dataset's
    backend, so both run on one device.
    """

    def __init__(
        self,
        dds,
        contrast,
        alpha: float = 0.05,
        cooks_filter: bool = True,
        independent_filter: bool = True,
        prior_LFC_var: np.ndarray | None = None,
        lfc_null: float = 0.0,
        alt_hypothesis: (
            Literal["greaterAbs", "lessAbs", "greater", "less"] | None
        ) = None,
        inference: Inference | None = None,
        quiet: bool = False,
        n_cpus: int | None = None,
    ) -> None:
        assert "LFC" in dds.varm, (
            "The DeseqDataSet is not fitted - run its `deseq2` method before "
            "constructing DeseqStats."
        )
        if dds.refit_cooks and "replaced" not in dds.var:
            raise AttributeError(
                "refit_cooks is enabled on the dataset but outliers were never "
                "refitted; call dds.refit() (or construct with "
                "refit_cooks=False)."
            )
        _require_positive_null(lfc_null, alt_hypothesis)

        self.dds = dds
        self.alpha = alpha
        self.cooks_filter = cooks_filter
        self.independent_filter = independent_filter
        self.prior_LFC_var = prior_LFC_var
        self.lfc_null = lfc_null
        self.alt_hypothesis = alt_hypothesis
        self.quiet = quiet

        # Labeled working copies; lfc_shrink edits these in place.
        self.base_mean = dds.var["_normed_means"].copy()
        self.design_matrix = dds.obsm["design_matrix"].copy()
        self.LFC = dds.varm["LFC"].copy()

        self.contrast = self._resolve_contrast(contrast)
        self.shrunk_LFCs = False
        self.inference = inference or dds.inference
        self.device = dds.device
        if inference is not None and n_cpus is not None:
            if hasattr(inference, "n_cpus"):
                inference.n_cpus = n_cpus
            else:
                warnings.warn(
                    "n_cpus was given but the inference backend has no n_cpus "
                    "attribute; ignoring it.",
                    UserWarning,
                    stacklevel=2,
                )

        # Wald memo: the hypothesis key the stored arrays were computed under.
        self._wald_key: tuple[float, str | None] | None = None

    # ------------------------------------------------------------- contrast
    def _resolve_contrast(self, contrast) -> np.ndarray | list:
        """Accept a numeric contrast vector or a (factor, test, ref) triplet;
        sets ``contrast_vector`` (reference pydeseq2/ds.py:174-190,590-601)."""
        if contrast is None:
            raise ValueError(
                "A contrast is required: pass ['factor', 'tested_level', "
                "'ref_level'] or a numeric vector of length n_design_columns."
            )
        if isinstance(contrast, np.ndarray):
            n_cols = self.design_matrix.shape[1]
            if contrast.shape[0] != n_cols:
                raise ValueError(
                    f"Contrast vector length {contrast.shape[0]} != number of "
                    f"design columns {n_cols}."
                )
            self.contrast_vector = contrast
            return contrast
        factor, tested, ref = contrast
        self.contrast_vector = self.dds.contrast(
            column=factor, baseline=ref, group_to_compare=tested
        )
        return contrast

    @property
    def variables(self):
        """Names of the variables in the model definition."""
        return self.dds.variables

    # --------------------------------------------------------------- summary
    def summary(self, **kwargs) -> None:
        """Run the analysis and publish ``results_df``.

        ``lfc_null`` / ``alt_hypothesis`` keyword overrides update the stored
        hypothesis and force a Wald rerun (reference pydeseq2/ds.py:223-301).
        """
        if "lfc_null" in kwargs:
            self.lfc_null = kwargs["lfc_null"]
        if "alt_hypothesis" in kwargs:
            self.alt_hypothesis = kwargs["alt_hypothesis"]
        _require_positive_null(self.lfc_null, self.alt_hypothesis)

        key = (self.lfc_null, self.alt_hypothesis)
        wald_reran = False
        if self._wald_key != key:
            self.run_wald_test()
            wald_reran = True

        if self.cooks_filter:
            self._cooks_filtering()

        if wald_reran or not hasattr(self, "padj"):
            if self.independent_filter:
                self._independent_filtering()
            else:
                self._p_value_adjustment()

        self.results_df = pd.DataFrame(
            {
                "baseMean": self.base_mean,
                "log2FoldChange": self.LFC @ self.contrast_vector / LN2,
                "lfcSE": self.SE / LN2,
                "stat": self.statistics,
                "pvalue": self.p_values,
                "padj": self.padj,
            },
            index=self.dds.var_names,
        )

        if not self.quiet:
            if isinstance(self.contrast, np.ndarray):
                header = (
                    f"Log2 fold change & Wald test p-value, contrast vector: "
                    f"{self.contrast}"
                )
            else:
                factor, tested, ref = self.contrast
                header = (
                    f"Log2 fold change & Wald test p-value: "
                    f"{factor} {tested} vs {ref}"
                )
            print(header)
            print(self.results_df)

    def run_wald_test(self) -> None:
        """Per-gene Wald tests under the current hypothesis (one device pass)."""
        if self.shrunk_LFCs and not self.quiet:
            print(
                "Note: running Wald test on shrunk LFCs. Some sequencing "
                "datasets show better performance with the testing separated "
                "from the use of the LFC prior.",
                file=sys.stderr,
            )

        res = self._compute_wald(self.lfc_null, self.alt_hypothesis)
        self._wald_key = (self.lfc_null, self.alt_hypothesis)

        genes = self.dds.var_names
        self.p_values = pd.Series(res.p, index=genes)
        self.statistics = pd.Series(res.stat, index=genes)
        self.SE = pd.Series(res.se, index=genes)

    def _compute_wald(self, lfc_null: float, alt_hypothesis: str | None) -> _WaldArrays:
        """Array-level Wald pass, including the refit-all-zero neutralisation.
        mu = sf e^{X beta} is formed on the device, gene-major."""
        design = self.design_matrix.values
        lfc = self.LFC.values
        dev = self.device
        X = torch.as_tensor(np.array(design, dtype=np.float64), device=dev)
        sf = torch.as_tensor(self.dds.obs["size_factors"].to_numpy(dtype=np.float64, copy=True), device=dev)
        mu = torch.exp(torch.as_tensor(np.array(lfc, dtype=np.float64), device=dev) @ X.T) * sf[None, :]

        if self.prior_LFC_var is not None:
            ridge = np.diag(1.0 / np.square(self.prior_LFC_var))
        else:
            ridge = 1e-6 * np.eye(design.shape[1])

        if not self.quiet:
            print("Running Wald tests...", file=sys.stderr)
        t0 = time.time()
        p, stat, se = self.inference.wald_test(
            design_matrix=design,
            disp=self.dds.var["dispersions"].values,
            lfc=lfc,
            mu=mu.T,
            ridge_factor=ridge,
            contrast=self.contrast_vector,
            lfc_null=LN2 * lfc_null,  # results are log2; kernels run in ln
            alt_hypothesis=alt_hypothesis,
        )
        if not self.quiet:
            print(f"... done in {time.time() - t0:.2f} seconds.\n", file=sys.stderr)

        p, stat, se = (_np(a).astype(float) for a in (p, stat, se))
        # Genes that went all-zero during outlier replacement carry neutral
        # statistics (reference pydeseq2/ds.py:356-360).
        if self.dds.refit_cooks and self.dds.var["replaced"].sum() > 0:
            dead = self.dds.var_names.get_indexer(self.dds.new_all_zeroes_genes)
            se[dead] = 0.0
            stat[dead] = 0.0
            p[dead] = 1.0
        return _WaldArrays(p=p, stat=stat, se=se)

    # ------------------------------------------------------------- shrinkage
    def lfc_shrink(self, coeff: str, adapt: bool = True) -> None:
        """Shrink one LFC coefficient with the apeGLM Cauchy prior.

        Batched MAP fits on the device (the ``shrink`` kernel, and
        ``grid_apeglm`` where Newton fails at P == 2); p-values are left
        untouched (reference pydeseq2/ds.py:363-447).
        """
        if coeff not in self.LFC.columns:
            raise KeyError(
                f"'{coeff}' is not an LFC coefficient; choose from "
                f"{list(self.LFC.columns[1:])}."
            )
        shrink_idx = int(self.LFC.columns.get_loc(coeff))

        prior_scale = 1.0
        if adapt:
            prior_var = _apeglm_prior_variance(
                self.LFC.values[:, shrink_idx], self.SE.values
            )
            prior_scale = min(np.sqrt(prior_var), 1.0)

        nz_pos = self.dds.var_names.get_indexer(self.dds.non_zero_genes)
        dispersions = self.dds.var["dispersions"].values

        if not self.quiet:
            print("Fitting MAP LFCs...", file=sys.stderr)
        t0 = time.time()
        map_lfc, inv_hess, converged = self.inference.lfc_shrink_nbinom_glm(
            design_matrix=self.design_matrix.values,
            counts=self.dds._counts_nz().T,
            size=1.0 / dispersions[nz_pos],
            offset=np.log(self.dds.obs["size_factors"].values),
            prior_no_shrink_scale=15,
            prior_scale=prior_scale,
            optimizer="L-BFGS-B",
            shrink_index=shrink_idx,
        )
        if not self.quiet:
            print(f"... done in {time.time() - t0:.2f} seconds.\n", file=sys.stderr)

        # Scatter the non-zero-gene results back into the full-length columns.
        shrunk_col = self.LFC.values[:, shrink_idx].copy()
        shrunk_col[nz_pos] = _np(map_lfc)[:, shrink_idx]
        self.LFC[coeff] = shrunk_col

        se_full = self.SE.values.copy()
        se_full[nz_pos] = np.sqrt(np.abs(_np(inv_hess)[:, shrink_idx, shrink_idx]))
        self.SE = pd.Series(se_full, index=self.dds.var_names)

        conv_full = np.full(self.dds.n_vars, np.nan)
        conv_full[nz_pos] = _np(converged).astype(float)
        self._LFC_shrink_converged = pd.Series(conv_full, index=self.dds.var_names)

        self.shrunk_LFCs = True

        if hasattr(self, "results_df"):
            self.results_df["log2FoldChange"] = self.LFC[coeff] / LN2
            self.results_df["lfcSE"] = self.SE / LN2
            if not self.quiet:
                print(f"Shrunk log2 fold change & Wald test p-value: {coeff}")
                print(self.results_df)

    # ------------------------------------------------------------- filtering
    def _ensure_wald(self) -> None:
        if self._wald_key is None:
            self.run_wald_test()

    def _independent_filtering(self) -> None:
        """padj via the batched base-mean filtering sweep."""
        self._ensure_wald()
        padj = _independent_filter_padj(
            self.p_values.values, self.base_mean.values, self.alpha, device=self.device
        )
        self.padj = pd.Series(padj, index=self.dds.var_names)

    def _p_value_adjustment(self) -> None:
        """padj via plain BH (independent filtering disabled)."""
        self._ensure_wald()
        self.padj = pd.Series(
            _bh_padj(self.p_values.values, device=self.device), index=self.dds.var_names
        )

    def _cooks_filtering(self) -> None:
        """NaN out p-values of Cook's-outlier genes (reference ds.py:544-550)."""
        self._ensure_wald()
        self.p_values[self.dds.cooks_outlier()] = np.nan

    def _fit_prior_var(
        self, coeff_idx: int, min_var: float = 1e-6, max_var: float = 400.0
    ) -> float:
        """Kept for API compatibility; delegates to the bisection solver."""
        return _apeglm_prior_variance(
            self.LFC.values[:, coeff_idx], self.SE.values, lo=min_var, hi=max_var
        )

    def plot_MA(self, log: bool = True, save_path: str | None = None, **kwargs):
        """MA plot of the results (reference pydeseq2/ds.py:449-484)."""
        if not hasattr(self, "results_df"):
            raise AttributeError(
                "No results to plot - run summary() before plot_MA()."
            )
        from pydeseq2_tpu_torch.utils.plots import make_MA_plot

        make_MA_plot(
            self.results_df,
            padj_thresh=self.alpha,
            log=log,
            save_path=save_path,
            lfc_null=self.lfc_null,
            alt_hypothesis=self.alt_hypothesis,
            **kwargs,
        )
