"""DeseqDataSet: the DESeq2 pipeline driver over a device-resident backend.

Port of ``pydeseq2_tpu/models/dataset.py`` (reference pydeseq2/dds.py:33-1563).
The class owns the pipeline state in AnnData-style slots of a
:class:`~pydeseq2_tpu_torch.container.DeseqDataContainer` and drives

    size factors -> genewise dispersions -> dispersion trend -> dispersion
    prior -> MAP dispersions -> LFCs -> Cook's distances -> outlier refit

where every per-gene stage runs through the :class:`Inference` backend
(:class:`~pydeseq2_tpu_torch.torch_inference.TorchInference` by default).

Where the state lives. The counts go to the backend's device once. The
(N, G) intermediates that a later stage reads (normalised counts, the mu of
the dispersion fit and of the LFC fit, the hat diagonals, Cook's distances)
stay device tensors in a private store, gene-major; each stage hands them to
the next without a host copy. The public ``layers`` / ``obsm`` entries are
numpy, exported once when the public step that made them ends; per-gene
columns go to ``var`` as numpy. The refit's sub-dataset and the iterative
size factors' inner rounds export nothing. Host code does the label
bookkeeping, the small scalar statistics (F and polygamma cutoffs), the
exclusion loop of the trend and the data-dependent refit orchestration.
"""

from __future__ import annotations

import sys
import time
import warnings
from contextlib import contextmanager
from typing import Literal

import numpy as np
import pandas as pd
import torch

from pydeseq2_tpu_torch.container import DeseqDataContainer
from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.default_inference import DefaultInference
from pydeseq2_tpu_torch.formula import DesignMatrix
from pydeseq2_tpu_torch.inference import Inference
from pydeseq2_tpu_torch.ops import stats as stats_ops
from pydeseq2_tpu_torch.ops.cooks import first_argmax
from pydeseq2_tpu_torch.ops.sizefactors import trimmed_sf_newton
from pydeseq2_tpu_torch.ops.vst import vst_transform
from pydeseq2_tpu_torch.preprocessing import (
    norm_fit_t,
    norm_transform_t,
    poscounts_fit_t,
    poscounts_size_factors_t,
)
from pydeseq2_tpu_torch.utils import (
    dispersion_trend,
    n_or_more_replicates,
    nb_nll_numpy,
    test_valid_counts,
    trimmed_mean_numpy,
)


def _np(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor."""
    return t.detach().cpu().numpy()


class DeseqDataSet(DeseqDataContainer):
    r"""Dispersion and log fold-change estimation (DESeq2 on PyTorch).

    Parameters mirror the reference class (pydeseq2/dds.py:206-229). The
    ``inference`` backend defaults to :class:`DefaultInference` (float64 on
    ``"cuda"``; raises if CUDA is absent); pass ``TorchInference(device=
    "cpu")`` for the plain PyTorch path, or ``dtype=torch.float32``. The
    dataset's own device tensors (counts, normalised counts, Cook's
    distances) live on the backend's device in float64, as the JAX package
    keeps them in float64 whatever the solvers' dtype. ``n_cpus`` is
    accepted for API compatibility only.
    """

    def __init__(
        self,
        *,
        adata=None,
        counts: pd.DataFrame | np.ndarray | None = None,
        metadata: pd.DataFrame | None = None,
        design: str | pd.DataFrame = "~condition",
        design_factors: str | list[str] | None = None,
        continuous_factors: list[str] | None = None,
        ref_level: list[str] | None = None,
        fit_type: Literal["parametric", "mean"] = "parametric",
        size_factors_fit_type: Literal["ratio", "poscounts", "iterative"] = "ratio",
        control_genes=None,
        min_mu: float = 0.5,
        min_disp: float = 1e-8,
        max_disp: float = 10.0,
        refit_cooks: bool = True,
        min_replicates: int = 7,
        beta_tol: float = 1e-8,
        n_cpus: int | None = None,
        inference: Inference | None = None,
        quiet: bool = False,
        low_memory: bool = False,
    ) -> None:
        if adata is not None:
            if counts is not None:
                warnings.warn(
                    "adata was provided; ignoring counts.", UserWarning, stacklevel=2
                )
            if metadata is not None:
                warnings.warn(
                    "adata was provided; ignoring metadata.", UserWarning, stacklevel=2
                )
            test_valid_counts(adata.X)
            super().__init__(
                np.asarray(adata.X).astype(int), obs=adata.obs, var=adata.var
            )
        elif counts is not None and metadata is not None:
            test_valid_counts(counts)
            if isinstance(counts, pd.DataFrame):
                x = counts.to_numpy().astype(int)
                var = pd.DataFrame(index=counts.columns)
                obs_index = counts.index
            else:
                x = np.asarray(counts).astype(int)
                var = None
                obs_index = metadata.index
            if not metadata.index.equals(obs_index):
                raise ValueError(
                    "The count matrix and metadata indexes do not match."
                )
            super().__init__(x, obs=metadata, var=var)
        else:
            raise ValueError(
                "Either adata or both counts and metadata arguments must be provided."
            )

        self.fit_type = fit_type
        self.design = design

        if continuous_factors is not None:
            warnings.warn(
                "continuous_factors is deprecated; continuous factors are "
                "detected from dtypes or cast with the C() operator.",
                DeprecationWarning,
                stacklevel=2,
            )
        if ref_level is not None:
            warnings.warn(
                "ref_level is deprecated and has no effect.",
                DeprecationWarning,
                stacklevel=2,
            )
        if design_factors is not None:
            warnings.warn(
                "design_factors is deprecated; provide a formula via the "
                "design argument instead.",
                DeprecationWarning,
                stacklevel=2,
            )
            design_factors = (
                design_factors if isinstance(design_factors, list) else [design_factors]
            )
            self.design = "~" + " + ".join(design_factors)

        if not isinstance(self.design, (str, pd.DataFrame)):
            raise ValueError(
                "design must be a string representing a formula, or a pandas "
                "DataFrame."
            )

        if isinstance(self.design, str):
            self._design_obj: DesignMatrix | None = DesignMatrix(self.obs, self.design)
            self.obsm["design_matrix"] = self._design_obj.matrix
        else:
            self._design_obj = None
            if not self.design.index.equals(self.obs_names):
                raise ValueError(
                    "Design matrix and metadata indexes do not match."
                )
            self.obsm["design_matrix"] = self.design

        if self.obsm["design_matrix"].isna().any().any():
            raise ValueError("NaNs are not allowed in the design.")

        self._check_full_rank_design()

        self.min_mu = min_mu
        self.min_disp = min_disp
        self.max_disp = np.maximum(max_disp, self.n_obs)
        self.refit_cooks = refit_cooks
        self.min_replicates = min_replicates
        self.beta_tol = beta_tol
        self.quiet = quiet
        self.low_memory = low_memory
        self.size_factors_fit_type = size_factors_fit_type
        self.control_genes = control_genes
        self.logmeans: np.ndarray | None = None
        self.filtered_genes: np.ndarray | None = None

        self.inference = inference or DefaultInference()
        self.device = getattr(self.inference, "device", None) or resolve_device("cuda")
        # Private device store: gene-major (G, N) float64 counts and
        # normalised counts; (G_nz, N) mu, hat diagonals and Cook's
        # distances of the non-zero genes. ``_exports`` False keeps the
        # public (N, G) layers unwritten (the refit's sub-dataset).
        self._dev: dict[str, torch.Tensor] = {}
        self._counts_src: np.ndarray | None = None
        self._exports = True

    # ------------------------------------------------------- device store
    def _counts(self) -> torch.Tensor:
        """(G, N) float64 counts on the device, copied once per X."""
        if self._counts_src is not self._X:
            self._dev["counts"] = torch.as_tensor(
                np.ascontiguousarray(self._X.T, dtype=np.float64), device=self.device)
            self._counts_src = self._X
            self._dev.pop("counts_nz", None)
        return self._dev["counts"]

    def _counts_nz(self) -> torch.Tensor:
        """(G_nz, N) counts of the non-zero genes."""
        if "counts_nz" not in self._dev:
            self._dev["counts_nz"] = self._counts()[self._nz_index()]
        return self._dev["counts_nz"]

    def _nz_index(self) -> torch.Tensor:
        return torch.as_tensor(self.non_zero_idx, device=self.device)

    def _export(self, slot, key: str, value: torch.Tensor, full: bool = False) -> None:
        """Publish a gene-major device tensor as an (N, G) numpy entry of
        ``slot``; ``full`` widens a non-zero-gene tensor to every gene with
        NaN columns (float64)."""
        if not self._exports:
            return
        host = _np(value.T)
        if full:
            out = np.full((self.n_obs, self.n_vars), np.nan)
            out[:, self.var["non_zero"].to_numpy()] = host
            host = out
        slot[key] = host

    def _gene_major(self, a) -> torch.Tensor:
        """A backend's (N, G) result as a contiguous (G, N) device tensor
        (no copy for the transposed tensors TorchInference returns)."""
        return torch.as_tensor(a).to(self.device).T.contiguous()

    def _set_normed(self, normed_gn: torch.Tensor) -> None:
        self._dev["normed"] = normed_gn.contiguous()
        self._export(self.layers, "normed_counts", self._dev["normed"])

    def _drop(self, *keys: str) -> None:
        for k in keys:
            self._dev.pop(k, None)

    # ------------------------------------------------------------ properties
    @property
    def variables(self):
        """Names of the variables in the model definition."""
        if self._design_obj is None:
            raise ValueError(
                "Retrieving variables is only possible if the model was "
                "initialized using a formula."
            )
        return self._design_obj.variables

    def cond(self, **kwargs):
        """Contrast-style model-matrix row for a condition (reference
        pydeseq2/dds.py:564-578)."""
        if self._design_obj is None:
            raise ValueError(
                "cond() requires the model to be initialized with a formula."
            )
        return self._design_obj.cond(**kwargs)

    def contrast(self, *args, **kwargs):
        """Contrast vector for a simple pairwise comparison (reference
        pydeseq2/dds.py:580-582)."""
        if self._design_obj is None:
            raise ValueError(
                "contrast() requires the model to be initialized with a formula."
            )
        return self._design_obj.contrast(*args, **kwargs)

    # -------------------------------------------------------------- pipeline
    def deseq2(self, fit_type: Literal["parametric", "mean"] | None = None) -> None:
        """Run the full dispersion + LFC estimation pipeline (reference
        pydeseq2/dds.py:516-562)."""
        if fit_type is not None:
            self.fit_type = fit_type
            if not self.quiet:
                print(f"Using {self.fit_type} fit type.")

        self.fit_size_factors(
            fit_type=self.size_factors_fit_type, control_genes=self.control_genes
        )
        self.fit_genewise_dispersions()
        self.fit_dispersion_trend()
        self.fit_dispersion_prior()
        self.fit_MAP_dispersions()
        self.fit_LFC()
        self.calculate_cooks()
        if self.refit_cooks:
            self.refit()
        self.cooks_outlier()

    def _control_gene_mask(self, control_genes) -> np.ndarray:
        """Boolean gene mask from any valid gene indexer (or all-True)."""
        if control_genes is None:
            control_genes = self.control_genes
            if control_genes is not None and not self.quiet:
                print(
                    f"Using {control_genes} as control genes, passed at "
                    "DeseqDataSet initialization"
                )
        mask = np.zeros(self.n_vars, dtype=bool)
        if control_genes is None:
            mask[:] = True
        else:
            mask[self.normalize_gene_indexer(control_genes)] = True
        return mask

    def fit_size_factors(
        self,
        fit_type: Literal["ratio", "poscounts", "iterative"] | None = None,
        control_genes=None,
    ) -> None:
        """Fit sample-wise size factors: ``ratio`` (median of ratios),
        ``poscounts`` or ``iterative``, with the reference's automatic
        ratio -> iterative switch when every gene has a zero (reference
        pydeseq2/dds.py:584-711)."""
        fit_type = fit_type or self.size_factors_fit_type
        if not self.quiet:
            print("Fitting size factors...", file=sys.stderr)
        start = time.time()

        if fit_type == "iterative":
            self._fit_iterate_size_factors()
        elif fit_type == "poscounts":
            self._size_factors_poscounts(self._control_gene_mask(control_genes))
        elif not (self.X > 0).all(0).any():
            warnings.warn(
                "Every gene contains at least one zero, cannot compute log "
                "geometric means. Switching to iterative mode.",
                UserWarning,
                stacklevel=2,
            )
            self._fit_iterate_size_factors()
        else:
            self._size_factors_ratio(self._control_gene_mask(control_genes))

        self.var["_normed_means"] = _np(self._dev["normed"].mean(dim=1))
        if not self.quiet:
            print(f"... done in {time.time() - start:.2f} seconds.\n", file=sys.stderr)

    def _size_factors_ratio(self, control_mask: np.ndarray) -> None:
        """Median-of-ratios estimator (the ``select`` kernel's medians)."""
        x = self._counts().T
        logmeans, filtered = norm_fit_t(x)
        self.logmeans, self.filtered_genes = _np(logmeans), _np(filtered)
        mask = torch.as_tensor(control_mask, device=self.device) & filtered
        normed, sf = norm_transform_t(x, logmeans, mask)
        self.obs["size_factors"] = _np(sf)
        self._set_normed(normed.T)

    def _size_factors_poscounts(self, control_mask: np.ndarray) -> None:
        """Positive-counts estimator, one batched ragged median."""
        x = self._counts().T
        logmeans, usable = poscounts_fit_t(x)
        self.logmeans, self.filtered_genes = _np(logmeans), _np(usable)
        mask = torch.as_tensor(control_mask, device=self.device) & usable
        sf = poscounts_size_factors_t(x, logmeans, mask)
        self.obs["size_factors"] = _np(sf)
        self._set_normed((x / sf[:, None]).T)

    def _sf(self) -> torch.Tensor:
        return torch.as_tensor(self.obs["size_factors"].to_numpy(dtype=np.float64, copy=True), device=self.device)

    def fit_genewise_dispersions(self, vst: bool = False) -> None:
        """Per-gene NB dispersion MLE (reference pydeseq2/dds.py:713-797)."""
        if "size_factors" not in self.obs:
            self.fit_size_factors(fit_type=self.size_factors_fit_type)

        self.var["non_zero"] = ~(self.X == 0).all(axis=0)
        self.non_zero_idx = np.arange(self.n_vars)[self.var["non_zero"]]
        self.non_zero_genes = self.var_names[self.var["non_zero"]]
        self._drop("counts_nz")

        self._fit_MoM_dispersions()

        design_matrix = self.obsm["design_matrix"].values
        size_factors = self.obs["size_factors"].values

        # mu init: linear regression when design groups <-> columns are 1:1,
        # else one IRLS pass with MoM dispersions
        # (reference pydeseq2/dds.py:743-765).
        if (
            len(self.obsm["design_matrix"].value_counts())
            == self.obsm["design_matrix"].shape[-1]
        ):
            mu_hat_ = self.inference.lin_reg_mu(
                counts=self._counts_nz().T,
                size_factors=size_factors,
                design_matrix=design_matrix,
                min_mu=self.min_mu,
            )
        else:
            _, mu_hat_, _, _ = self.inference.irls(
                counts=self._counts_nz().T,
                size_factors=size_factors,
                design_matrix=design_matrix,
                disp=self.var.loc[self.var["non_zero"], "_MoM_dispersions"].values,
                min_mu=self.min_mu,
                beta_tol=self.beta_tol,
            )

        mu_param_name = "_vst_mu_hat" if vst else "_mu_hat"
        disp_param_name = "vst_genewise_dispersions" if vst else "genewise_dispersions"
        self._dev[mu_param_name] = self._gene_major(mu_hat_)

        if not self.quiet:
            print("Fitting dispersions...", file=sys.stderr)
        start = time.time()
        dispersions_, converged_ = self.inference.alpha_mle(
            counts=self._counts_nz().T,
            design_matrix=design_matrix,
            mu=self._dev[mu_param_name].T,
            alpha_hat=self.var.loc[self.var["non_zero"], "_MoM_dispersions"].values,
            min_disp=self.min_disp,
            max_disp=self.max_disp,
        )
        if not self.quiet:
            print(f"... done in {time.time() - start:.2f} seconds.\n", file=sys.stderr)

        self.var[disp_param_name] = np.full(self.n_vars, np.nan)
        self.var.loc[self.var["non_zero"], disp_param_name] = np.clip(
            _np(torch.as_tensor(dispersions_)), self.min_disp, self.max_disp
        )
        self.var["_genewise_converged"] = np.full(self.n_vars, np.nan)
        self.var.loc[self.var["non_zero"], "_genewise_converged"] = _np(
            torch.as_tensor(converged_)).astype(float)
        self._export(self.layers, mu_param_name, self._dev[mu_param_name], full=True)

    def fit_dispersion_trend(self, vst: bool = False) -> None:
        """Fit the dispersion trend curve, parametric or mean (reference
        pydeseq2/dds.py:799-831)."""
        disp_param_name = "vst_genewise_dispersions" if vst else "genewise_dispersions"
        fit_type = self.vst_fit_type if vst else self.fit_type

        if disp_param_name not in self.var:
            self.fit_genewise_dispersions(vst)

        if not self.quiet:
            print("Fitting dispersion trend curve...", file=sys.stderr)
        start = time.time()
        if fit_type == "parametric":
            self._fit_parametric_dispersion_trend(vst)
        elif fit_type == "mean":
            self._fit_mean_dispersion_trend(vst)
        else:
            raise NotImplementedError(
                f"Expected 'parametric' or 'mean' trend curve fit types, "
                f"received {fit_type}"
            )
        if not self.quiet:
            print(f"... done in {time.time() - start:.2f} seconds.\n", file=sys.stderr)

    def disp_function(self, x):
        """Dispersion trend function evaluated at x."""
        if self.uns["disp_function_type"] == "parametric":
            return dispersion_trend(x, self.uns["trend_coeffs"])
        elif self.uns["disp_function_type"] == "mean":
            return np.full_like(np.asarray(x, dtype=float), self.uns["mean_disp"])

    def _on_device(self, values) -> torch.Tensor:
        return torch.as_tensor(np.array(values, dtype=np.float64), device=self.device)

    def _trim_mean(self, values) -> float:
        """0.001-trimmed mean of a per-gene column (the ``trimmed_var``
        kernel over one long column on the card)."""
        return float(stats_ops.scipy_style_trim_mean(self._on_device(values), proportiontocut=0.001))

    def fit_dispersion_prior(self) -> None:
        """Fit the dispersion prior variance (reference pydeseq2/dds.py:840-884)."""
        from scipy.special import polygamma  # host scalar only

        if "fitted_dispersions" not in self.var:
            self.fit_dispersion_trend()

        num_samples = self.n_obs
        num_vars = self.obsm["design_matrix"].shape[-1]

        if (num_samples - num_vars) <= 3:
            warnings.warn(
                "As the residual degrees of freedom is less than 3, the "
                "distribution of log dispersions is especially asymmetric and "
                "likely to be poorly estimated by the MAD.",
                UserWarning,
                stacklevel=2,
            )

        gw = self.var.loc[self.var["non_zero"], "genewise_dispersions"]
        fitted = self.var.loc[self.var["non_zero"], "fitted_dispersions"]
        disp_residuals = np.log(gw.values) - np.log(fitted.values)
        above_min_disp = gw.values >= (100 * self.min_disp)

        mad = float(stats_ops.mean_absolute_deviation(self._on_device(disp_residuals[above_min_disp])))
        self.uns["_squared_logres"] = mad**2
        self.uns["prior_disp_var"] = np.maximum(
            self.uns["_squared_logres"] - polygamma(1, (num_samples - num_vars) / 2),
            0.25,
        ).item()

    def fit_MAP_dispersions(self) -> None:
        """MAP dispersion shrinkage toward the trend curve (reference
        pydeseq2/dds.py:886-935)."""
        if "prior_disp_var" not in self.uns:
            self.fit_dispersion_prior()

        design_matrix = self.obsm["design_matrix"].values
        if not self.quiet:
            print("Fitting MAP dispersions...", file=sys.stderr)
        start = time.time()
        dispersions_, converged_ = self.inference.alpha_mle(
            counts=self._counts_nz().T,
            design_matrix=design_matrix,
            mu=self._dev["_mu_hat"].T,
            alpha_hat=self.var.loc[self.var["non_zero"], "fitted_dispersions"].values,
            min_disp=self.min_disp,
            max_disp=self.max_disp,
            prior_disp_var=float(self.uns["prior_disp_var"]),
            cr_reg=True,
            prior_reg=True,
        )
        if not self.quiet:
            print(f"... done in {time.time() - start:.2f} seconds.\n", file=sys.stderr)

        self.var["MAP_dispersions"] = np.full(self.n_vars, np.nan)
        self.var.loc[self.var["non_zero"], "MAP_dispersions"] = np.clip(
            _np(torch.as_tensor(dispersions_)), self.min_disp, self.max_disp
        )
        self.var["_MAP_converged"] = np.full(self.n_vars, np.nan)
        self.var.loc[self.var["non_zero"], "_MAP_converged"] = _np(torch.as_tensor(converged_)).astype(float)

        # Shrinkage outliers keep their genewise estimates
        # (reference pydeseq2/dds.py:925-932).
        self.var["dispersions"] = self.var["MAP_dispersions"].copy()
        with np.errstate(invalid="ignore"):
            self.var["_outlier_genes"] = np.log(
                self.var["genewise_dispersions"]
            ) > np.log(self.var["fitted_dispersions"]) + 2 * np.sqrt(
                self.uns["_squared_logres"]
            )
        self.var.loc[self.var["_outlier_genes"], "dispersions"] = self.var.loc[
            self.var["_outlier_genes"], "genewise_dispersions"
        ]

        if self.low_memory:
            self.layers.pop("_mu_hat", None)
            self._drop("_mu_hat")

    def fit_LFC(self) -> None:
        """Fit LFC coefficients (natural log scale; reference
        pydeseq2/dds.py:937-984)."""
        if "dispersions" not in self.var:
            self.fit_MAP_dispersions()

        design_matrix = self.obsm["design_matrix"].values
        if not self.quiet:
            print("Fitting LFCs...", file=sys.stderr)
        start = time.time()
        mle_lfcs_, mu_, hat_diagonals_, converged_ = self.inference.irls(
            counts=self._counts_nz().T,
            size_factors=self.obs["size_factors"].values,
            design_matrix=design_matrix,
            disp=self.var.loc[self.var["non_zero"], "dispersions"].values,
            min_mu=self.min_mu,
            beta_tol=self.beta_tol,
        )
        if not self.quiet:
            print(f"... done in {time.time() - start:.2f} seconds.\n", file=sys.stderr)

        self.varm["LFC"] = pd.DataFrame(
            np.nan,
            index=self.var_names,
            columns=self.obsm["design_matrix"].columns,
        )
        self.varm["LFC"].update(
            pd.DataFrame(
                _np(torch.as_tensor(mle_lfcs_)).astype(np.float64),
                index=self.non_zero_genes,
                columns=self.obsm["design_matrix"].columns,
            )
        )
        self._dev["_mu_LFC"] = self._gene_major(mu_)
        self._dev["_hat_diagonals"] = self._gene_major(hat_diagonals_)
        self._export(self.obsm, "_mu_LFC", self._dev["_mu_LFC"])
        self._export(self.obsm, "_hat_diagonals", self._dev["_hat_diagonals"])
        self.var["_LFC_converged"] = np.full(self.n_vars, np.nan)
        self.var.loc[self.var["non_zero"], "_LFC_converged"] = _np(torch.as_tensor(converged_)).astype(float)

    def calculate_cooks(self) -> None:
        """Cook's distances for outlier detection (reference
        pydeseq2/dds.py:986-1040), on the device."""
        if "dispersions" not in self.var:
            self.fit_MAP_dispersions()

        if not self.quiet:
            print("Calculating cook's distance...", file=sys.stderr)
        start = time.time()
        num_vars = self.obsm["design_matrix"].shape[-1]
        normed_nz = self._dev["normed"][self._nz_index()]
        dispersions = self._robust_mom_dispersions(normed_nz.T)

        mu = self._dev["_mu_LFC"]
        squared_pearson_res = (self._counts_nz() - mu) ** 2
        V = mu + dispersions[:, None] * mu**2
        squared_pearson_res = squared_pearson_res / V / num_vars

        H = self._dev["_hat_diagonals"]
        diag_mul = H / (1 - H) ** 2
        self._dev["cooks"] = squared_pearson_res * diag_mul

        if self.low_memory:
            self.obsm.pop("_mu_LFC", None)
            self.obsm.pop("_hat_diagonals", None)
            self._drop("_mu_LFC", "_hat_diagonals")

        self._export(self.layers, "cooks", self._dev["cooks"], full=True)
        if not self.quiet:
            print(f"... done in {time.time() - start:.2f} seconds.\n", file=sys.stderr)

    def _robust_mom_dispersions(self, normed_counts: torch.Tensor) -> torch.Tensor:
        """Trimmed method-of-moments dispersions for Cook's distances, (G,)
        from (N, G) normalised counts: the ``trimmed_var`` kernel on the
        card (reference pydeseq2/utils.py:914-960)."""
        design_df = self.obsm["design_matrix"]
        three_or_more = n_or_more_replicates(design_df, 3)
        if three_or_more.any():
            rows = torch.as_tensor(np.flatnonzero(three_or_more.to_numpy()), device=normed_counts.device)
            filtered_counts = normed_counts.T[:, rows].T  # gene-major gather
            filtered_design = design_df.loc[three_or_more, :]
            cell_id = filtered_design.groupby(
                filtered_design.columns.values.tolist()
            ).ngroup()
            v = stats_ops.trimmed_cell_variance(filtered_counts, cell_id.to_numpy())
        else:
            v = stats_ops.trimmed_variance(normed_counts)
        m = normed_counts.mean(0)
        alpha = (v - m) / m**2
        return torch.clamp(alpha, min=0.04)

    # ----------------------------------------------------------- refit logic
    def refit(self) -> None:
        """Replace Cook outliers and refit affected genes (reference
        pydeseq2/dds.py:1042-1064)."""
        self._replace_outliers()
        if not self.quiet:
            print(
                f"Replacing {sum(self.var['replaced'])} outlier genes.\n",
                file=sys.stderr,
            )
        if sum(self.var["replaced"]) > 0:
            self._refit_without_outliers()
        else:
            self.var["refitted"] = np.full(self.n_vars, False)

    def _cooks_cutoff(self) -> float:
        """99th-percentile F cutoff for Cook's distances (host scalar)."""
        from scipy.stats import f

        p = self.obsm["design_matrix"].shape[-1]
        return float(f.ppf(0.99, p, self.n_obs - p))

    def cooks_outlier(self):
        """Boolean gene mask of Cook's outliers for p-value masking.

        Behavior parity: reference pydeseq2/dds.py:1066-1110. A gene is
        flagged when any well-replicated sample (cohort >= 3) exceeds the F
        cutoff, unless at least 3 samples have higher counts than the
        worst-Cook's sample. Computed on the device over the non-zero genes
        (a zero gene's distances are NaN and never flag).
        """
        if "_pvalue_cooks_outlier" in self.var.keys():
            return self.var["_pvalue_cooks_outlier"]

        cutoff = self._cooks_cutoff()
        well_replicated = n_or_more_replicates(
            self.obsm["design_matrix"], 3
        ).values

        refit_ran = (
            self.refit_cooks
            and self.var["refitted"].sum() > 0
            and "replace_cooks" in self._dev
        )
        distances = self._dev["replace_cooks" if refit_ran else "cooks"]
        rows = torch.as_tensor(np.flatnonzero(well_replicated), device=self.device)
        flagged = (distances[:, rows] > cutoff).any(dim=1)

        # Count-based veto, computed on the pre-replacement distances.
        counts = self._counts_nz()
        worst_sample = first_argmax(self._dev["cooks"])
        worst_counts = counts.gather(1, worst_sample[:, None])
        n_above_worst = (counts > worst_counts).sum(dim=1)
        outliers = np.zeros(self.n_vars, dtype=bool)
        outliers[self.non_zero_idx] = _np(flagged & (n_above_worst < 3))

        if self.low_memory:
            self.layers.pop("cooks", None)
            self.layers.pop("replace_cooks", None)
            self._drop("cooks", "replace_cooks")

        self.var["_pvalue_cooks_outlier"] = outliers
        return self.var["_pvalue_cooks_outlier"]

    def _replace_outliers(self) -> None:
        """Impute counts whose Cook's distance exceeds the F(0.99) cutoff.

        Behavior parity: reference pydeseq2/dds.py:1301-1358. Flagged
        entries in well-replicated cohorts (>= ``min_replicates``) are
        replaced by trimmed-mean(0.2) baselines rescaled per sample (host
        numpy on the replaced genes only); the affected genes are split off
        into ``counts_to_refit``.
        """
        if "cooks" not in self._dev:
            self.calculate_cooks()

        replaceable = n_or_more_replicates(
            self.obsm["design_matrix"], self.min_replicates
        ).values
        self.obs["replaceable"] = replaceable
        if not replaceable.any():
            self.var["replaced"] = np.zeros(self.n_vars, dtype=bool)
            return

        exceeds_nz = self._dev["cooks"] > self._cooks_cutoff()  # (G_nz, N)
        hit = exceeds_nz.any(dim=1)
        replaced = np.zeros(self.n_vars, dtype=bool)
        replaced[self.non_zero_idx] = _np(hit)
        self.var["replaced"] = replaced
        if not replaced.any():
            return

        sub = self.subset_genes(replaced)
        sf_col = self.obs["size_factors"].values[:, None]
        robust_base = trimmed_mean_numpy(sub.X / sf_col, trim=0.2, axis=0)
        imputed = (robust_base[None, :] * sf_col).astype(int)
        exceeds = _np(exceeds_nz[hit]).T  # (N, replaced genes), in gene order
        swap = replaceable[:, None] & exceeds
        sub.X = np.where(swap, imputed, sub.X)
        self.counts_to_refit = sub

    # Slots the refit sub-pipeline inherits from the parent fit instead of
    # recomputing (trend curve and dispersion prior: reference
    # pydeseq2/dds.py:1421-1438).
    _REFIT_INHERITED_UNS = (
        "disp_function_type",
        "trend_coeffs",
        "mean_disp",
        "_squared_logres",
        "prior_disp_var",
    )
    # Per-gene results copied back from the sub-fit into the parent.
    _REFIT_RESULT_COLUMNS = (
        "_normed_means",
        "genewise_dispersions",
        "fitted_dispersions",
        "dispersions",
    )

    def _refit_without_outliers(self) -> None:
        """Re-run the pipeline on replaced genes, reusing trend and prior.

        Behavior parity: reference pydeseq2/dds.py:1360-1458. Genes that
        became all-zero after replacement are dropped from the refit and get
        neutral results; the rest go through a sub-:class:`DeseqDataSet`
        running genewise -> MAP -> LFC with the parent's trend curve and
        dispersion prior injected. The masked distances (``replace_cooks``)
        are formed on the device.
        """
        assert self.refit_cooks, (
            "refit was requested but refit_cooks is disabled on this dataset."
        )
        if "replaced" not in self.var:
            self._replace_outliers()

        went_all_zero = (self.counts_to_refit.X == 0).all(axis=0)
        self.new_all_zeroes_genes = self.counts_to_refit.var_names[went_all_zero]

        refitted = self.var["replaced"].values.copy()
        refitted[refitted] = ~went_all_zero
        self.var["refitted"] = refitted

        if went_all_zero.any():
            self.var.loc[self.new_all_zeroes_genes, "_normed_means"] = 0
            self.varm["LFC"].loc[self.new_all_zeroes_genes, :] = 0

        if not refitted.any():
            return

        self.counts_to_refit = self.counts_to_refit.subset_genes(~went_all_zero)
        sub = self._spawn_refit_pipeline(self.counts_to_refit)

        # Merge the sub-fit results back into the parent slots.
        for col in self._REFIT_RESULT_COLUMNS:
            self.var.loc[refitted, col] = sub.var[col].values
        self.varm["LFC"].loc[refitted, :] = sub.varm["LFC"].values

        # Refitted genes no longer count as Cook's outliers in replaceable
        # samples: zero their distances in a dedicated layer.
        masked = self._dev["cooks"].clone()
        cols = torch.as_tensor(np.flatnonzero(refitted[self.non_zero_idx]), device=self.device)
        rows = torch.as_tensor(np.flatnonzero(self.obs["replaceable"].values), device=self.device)
        masked[cols[:, None], rows[None, :]] = 0.0
        self._dev["replace_cooks"] = masked
        self._export(self.layers, "replace_cooks", masked, full=True)

    def _spawn_refit_pipeline(self, subset) -> "DeseqDataSet":
        """Run genewise -> MAP -> LFC on a gene subset with inherited trend/prior."""
        sub = DeseqDataSet(
            counts=pd.DataFrame(
                subset.X, index=subset.obs_names, columns=subset.var_names
            ),
            metadata=self.obs,
            design=self.design,
            min_mu=self.min_mu,
            min_disp=self.min_disp,
            max_disp=self.max_disp,
            refit_cooks=self.refit_cooks,
            min_replicates=self.min_replicates,
            beta_tol=self.beta_tol,
            inference=self.inference,
            quiet=self.quiet,
        )
        sub._exports = False
        sub.obs["size_factors"] = self.obs["size_factors"].values
        sub._set_normed(sub._counts() / sub._sf()[None, :])

        sub.fit_genewise_dispersions()

        for key in self._REFIT_INHERITED_UNS:
            if key in self.uns:
                sub.uns[key] = self.uns[key]
        sub.var["_normed_means"] = _np(sub._dev["normed"].mean(dim=1))
        sub.var["fitted_dispersions"] = sub.disp_function(sub.var["_normed_means"])

        sub.fit_MAP_dispersions()
        sub.fit_LFC()
        return sub

    # ------------------------------------------------------------------- VST
    def vst(
        self,
        use_design: bool = False,
        fit_type: Literal["parametric", "mean"] | None = None,
    ) -> None:
        """Variance-stabilizing transform -> ``layers["vst_counts"]``
        (reference pydeseq2/dds.py:349-382)."""
        self.vst_fit_type = fit_type if fit_type is not None else self.fit_type
        if not self.quiet:
            print(f"Fit type used for VST : {self.vst_fit_type}")
        self.vst_fit(use_design=use_design)
        self.layers["vst_counts"] = self.vst_transform()

    def vst_fit(self, use_design: bool = False) -> None:
        """Fit the VST: size factors, dispersions, trend (reference
        pydeseq2/dds.py:384-436; intercept-only design unless
        ``use_design``)."""
        if "size_factors" not in self.obs or self.logmeans is None:
            self.fit_size_factors(fit_type=self.size_factors_fit_type)

        if not hasattr(self, "vst_fit_type"):
            self.vst_fit_type = self.fit_type

        if use_design:
            if self.vst_fit_type == "parametric":
                self._fit_parametric_dispersion_trend(vst=True)
            else:
                warnings.warn(
                    "use_design=True is only useful when fit_type='parametric'. ",
                    UserWarning,
                    stacklevel=2,
                )
                self.fit_genewise_dispersions(vst=True)
        else:
            with self._intercept_only_design():
                self.fit_genewise_dispersions(vst=True)
                if self.vst_fit_type == "parametric":
                    self._fit_parametric_dispersion_trend(vst=True)

    def vst_transform(self, counts: np.ndarray | None = None) -> np.ndarray:
        """Apply the fitted VST to counts, (N, G) numpy: the ``vst`` kernel
        on the card (reference pydeseq2/dds.py:438-514; external counts use
        the fitted log-means)."""
        if "size_factors" not in self.obs:
            raise RuntimeError(
                "The vst_fit method should be called prior to vst_transform."
            )
        if counts is None:
            x = self._counts()
            sf = self._sf()
        else:
            xs = torch.as_tensor(np.array(counts, dtype=np.float64), device=self.device)
            if self.logmeans is None:
                warnings.warn(
                    "The size factors were fitted iteratively. They will be "
                    "re-computed with the counts to be transformed. In a "
                    "train/test setting with a downstream task, this would "
                    "result in a leak of data from test to train set.",
                    UserWarning,
                    stacklevel=2,
                )
                logmeans, filtered = norm_fit_t(xs)
            else:
                logmeans = torch.as_tensor(self.logmeans, device=self.device)
                filtered = torch.as_tensor(self.filtered_genes, device=self.device)
            _, sf = norm_transform_t(xs, logmeans, filtered)
            x = xs.T.contiguous()

        every_gene = torch.ones(x.shape[0], dtype=torch.bool, device=self.device)
        if self.vst_fit_type == "parametric":
            if "vst_trend_coeffs" not in self.uns:
                raise RuntimeError("Fit the dispersion curve prior to applying VST.")
            coeffs = torch.as_tensor(self.uns["vst_trend_coeffs"].to_numpy(dtype=np.float64, copy=True), device=self.device)
            out = vst_transform(x, sf, coeffs, torch.tensor(False, device=self.device),
                                torch.ones((), dtype=torch.float64, device=self.device), every_gene)
        elif self.vst_fit_type == "mean":
            gene_dispersions = self.var["vst_genewise_dispersions"]
            use_for_mean = gene_dispersions > 10 * self.min_disp
            mean_disp = self._trim_mean(gene_dispersions[use_for_mean].values)
            out = vst_transform(x, sf, None, None, torch.tensor(mean_disp, dtype=torch.float64, device=self.device),
                                every_gene, trend_type="mean")
        else:
            raise NotImplementedError(
                f"Found fit_type '{self.vst_fit_type}'. "
                "Expected 'parametric' or 'mean'."
            )
        return _np(out.T)

    # -------------------------------------------------------------- internals
    def _fit_MoM_dispersions(self) -> None:
        """Initial dispersions: min(rough OLS, method of moments), clipped
        (reference pydeseq2/dds.py:1140-1162)."""
        if "normed" not in self._dev:
            self.fit_size_factors(fit_type=self.size_factors_fit_type)
        normed_counts = self._dev["normed"][self._nz_index()].T
        rde = self.inference.fit_rough_dispersions(
            normed_counts, self.obsm["design_matrix"].values
        )
        mde = self.inference.fit_moments_dispersions(
            normed_counts, self.obs["size_factors"].values
        )
        alpha_hat = _np(torch.minimum(torch.as_tensor(rde), torch.as_tensor(mde)))
        self.var["_MoM_dispersions"] = np.full(self.n_vars, np.nan)
        self.var.loc[self.var["non_zero"], "_MoM_dispersions"] = np.clip(
            alpha_hat, self.min_disp, self.max_disp
        )

    def _fit_parametric_dispersion_trend(self, vst: bool = False):
        """Iterated gamma-GLM fit of alpha(mu) = a1/mu + a0.

        Behavior parity: reference pydeseq2/dds.py:1199-1275. Alternates
        gamma-GLM fits (one ``trend_fit`` launch each on the card; the host
        reads the coefficients, the predictions and the flag) with the
        exclusion of genes whose dispersion is far off the fitted curve
        (ratio < 1e-4 or >= 15) until successive coefficient vectors agree
        to 1e-6 in squared log-distance; falls back to the mean trend when
        a fit fails or degenerates.
        """
        disp_col = "vst_genewise_dispersions" if vst else "genewise_dispersions"
        if disp_col not in self.var:
            self.fit_genewise_dispersions(vst)

        alphas = self.var.loc[self.non_zero_genes, disp_col].values
        means = self.var.loc[self.non_zero_genes, "_normed_means"].values
        with np.errstate(divide="ignore"):
            inv_means = 1.0 / means
        usable = np.isfinite(inv_means) & ~np.isnan(alphas)
        alphas, inv_means = alphas[usable], inv_means[usable]

        coeffs = np.array([1.0, 1.0])  # drift sentinel, matching the reference
        while True:
            fitted, predictions, glm_ok = self.inference.dispersion_trend_gamma_glm(inv_means, alphas)
            fitted = _np(torch.as_tensor(fitted)).astype(float)
            if not bool(glm_ok) or (fitted <= 1e-10).any():
                warnings.warn(
                    "The dispersion trend curve fitting did not converge. "
                    "Switching to a mean-based dispersion trend.",
                    UserWarning,
                    stacklevel=2,
                )
                self._fit_mean_dispersion_trend(vst)
                return
            drift = float(np.sum(np.log(np.abs(fitted / coeffs)) ** 2))
            coeffs = fitted

            ratio = alphas / _np(torch.as_tensor(predictions))
            on_curve = (ratio >= 1e-4) & (ratio < 15)
            alphas, inv_means = alphas[on_curve], inv_means[on_curve]
            if drift < 1e-6:
                break

        key = "vst_trend_coeffs" if vst else "trend_coeffs"
        self.uns[key] = pd.Series(coeffs, index=["a0", "a1"])
        if not vst:
            self.uns["disp_function_type"] = "parametric"
            self.var["fitted_dispersions"] = np.full(self.n_vars, np.nan)
            self.var.loc[self.var["non_zero"], "fitted_dispersions"] = (
                self.disp_function(
                    self.var.loc[self.var["non_zero"], "_normed_means"]
                )
            )

    def _fit_mean_dispersion_trend(self, vst: bool = False):
        """Trimmed-mean trend curve (reference pydeseq2/dds.py:1277-1299)."""
        disp_param_name = "vst_genewise_dispersions" if vst else "genewise_dispersions"
        sel = self.var[disp_param_name] > 10 * self.min_disp
        self.uns["mean_disp"] = self._trim_mean(self.var.loc[sel, disp_param_name].values)
        if vst:
            self.vst_fit_type = "mean"
        else:
            self.uns["disp_function_type"] = "mean"
        self.var["fitted_dispersions"] = np.full(self.n_vars, self.uns["mean_disp"])

    @contextmanager
    def _intercept_only_design(self):
        """Temporarily swap the design matrix for an intercept-only column
        (blind VST and the iterative size factors, reference
        pydeseq2/dds.py:424-436,1478-1484)."""
        saved = self.obsm["design_matrix"]
        self.obsm["design_matrix"] = pd.DataFrame(
            1, index=self.obs_names, columns=["Intercept"]
        )
        try:
            yield
        finally:
            self.obsm["design_matrix"] = saved

    def _fit_iterate_size_factors(
        self,
        niter: int = 10,
        quant: float = 0.95,
        method: Literal["powell", "device"] | None = None,
    ) -> None:
        """Trimmed-likelihood MLE size factors for zero-rich datasets.

        Behavior parity: reference pydeseq2/dds.py:1460-1548. Alternates (a)
        an intercept-only dispersion fit at the current size factors with (b)
        a search over per-sample log size factors minimising the NB
        likelihood of the best ``quant``-fraction of genes, until the
        log-size-factor update is small.

        ``method="powell"`` is the reference's scipy Powell on the host
        (exact parity, O(N^2) objective sweeps); ``"device"`` is the
        per-sample Newton solver :func:`~pydeseq2_tpu_torch.ops.sizefactors.
        trimmed_sf_newton` (the ``sf_nll`` and ``sf_newton`` kernels on the
        card), in float64. Its baseline means are max(sf coef, min_mu) / sf
        with the per-gene OLS coefficient ``coef`` of the intercept-only
        design; the dispersion fit's ``_mu_hat`` is max(sf_n coef, min_mu),
        so coef = mu_hat / sf at the sample of the largest size factor
        (where all are clamped, that gives the same clamped means). Default
        (None): powell up to 500 samples, device beyond. The inner rounds
        export no layer.
        """
        from scipy.optimize import minimize

        if method is None:
            method = "powell" if self.n_obs <= 500 else "device"

        exports, self._exports = self._exports, False
        self.obs["size_factors"] = np.ones(self.n_obs)
        self._dev["normed"] = self._counts()

        with self._intercept_only_design():
            for it in range(niter):
                self.fit_genewise_dispersions()
                informative = (
                    self.var["genewise_dispersions"] > 10 * self.min_disp
                ) & self.var["non_zero"]
                if not informative.any():
                    print(
                        "No genes have a dispersion above 10 * min_disp in "
                        "_fit_iterate_size_factors.",
                        file=sys.stderr,
                    )
                    break
                self.var["fitted_dispersions"] = np.full(
                    self.n_vars,
                    self._trim_mean(self.var.loc[informative, "genewise_dispersions"].values),
                )
                self.fit_dispersion_prior()
                self.fit_MAP_dispersions()

                log_sf0 = np.log(self.obs["size_factors"].values)
                nz = self.var["non_zero"].values
                disp_nz = self.var.loc[nz, "dispersions"].values

                if method == "device":
                    sf0 = self._sf()
                    j = int(torch.argmax(sf0))
                    coef = self._dev["_mu_hat"][:, j].to(torch.float64) / sf0[j]
                    fitted, _ = trimmed_sf_newton(
                        self._counts_nz(), coef, self._on_device(disp_nz), torch.log(sf0),
                        quant=quant, min_mu=self.min_mu,
                    )
                    fitted = _np(fitted)
                    log_sf = fitted - fitted.mean()
                    self.obs["size_factors"] = np.exp(log_sf)
                else:
                    # Size-factor-free baseline means: mu_hat was fitted under
                    # the current size factors, so divide them back out once
                    # and let the optimizer rescale per candidate.
                    counts_nz = self.X[:, nz]
                    base_mu = _np(self._dev["_mu_hat"].T).astype(float) * np.exp(-log_sf0)[:, None]

                    def trimmed_nll(log_sf: np.ndarray) -> float:
                        sf = np.exp(log_sf - log_sf.mean())
                        per_gene = nb_nll_numpy(
                            counts_nz, base_mu * sf[:, None], disp_nz
                        )
                        keep = per_gene < np.quantile(per_gene, quant)
                        return float(per_gene[keep].sum())

                    best = minimize(trimmed_nll, log_sf0, method="Powell")
                    log_sf = best.x - best.x.mean()
                    self.obs["size_factors"] = np.exp(log_sf)

                    if not best.success:
                        print(
                            "A size factor fitting iteration failed.",
                            file=sys.stderr,
                        )
                        break
                if it > 1 and np.sum((log_sf0 - log_sf) ** 2) < 1e-4:
                    break
                if it == niter - 1:
                    print(
                        "Iterative size factor fitting did not converge.",
                        file=sys.stderr,
                    )

        self._exports = exports
        self._set_normed(self._counts() / self._sf()[None, :])

    def _check_full_rank_design(self):
        """Warn if the design matrix is rank-deficient (reference
        pydeseq2/dds.py:1550-1563)."""
        rank = np.linalg.matrix_rank(self.obsm["design_matrix"].values)
        num_vars = self.obsm["design_matrix"].shape[1]
        if rank < num_vars:
            warnings.warn(
                "The design matrix is not full rank, so the model cannot be "
                "fitted, but some operations like design-free VST remain "
                "possible. To perform differential expression analysis, "
                "please remove the design variables that are linear "
                "combinations of others.",
                UserWarning,
                stacklevel=2,
            )

    # ---------------------------------------------------------------- export
    def to_picklable_anndata(self):
        """Export to a plain AnnData object (reference pydeseq2/dds.py:1112-1138)."""
        return self.to_anndata()

    def plot_dispersions(self, log: bool = True, save_path=None, **kwargs) -> None:
        """Scatter plot of genewise/final/fitted dispersions (reference
        pydeseq2/dds.py:1164-1197)."""
        from pydeseq2_tpu_torch.utils.plots import make_scatter

        disps = [
            self.var["genewise_dispersions"],
            self.var["dispersions"],
            self.var["fitted_dispersions"],
        ]
        make_scatter(
            disps,
            legend_labels=["Estimated", "Final", "Fitted"],
            x_val=self.var["_normed_means"],
            log=log,
            save_path=save_path,
            **kwargs,
        )
