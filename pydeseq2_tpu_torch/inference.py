"""Abstract inference backend contract.

A copy of ``pydeseq2_tpu/inference.py``, kept here so the port does not
import the JAX package. :class:`~pydeseq2_tpu_torch.torch_inference.
TorchInference` implements it; its methods take numpy arrays or tensors and
return tensors on their device.

Parity target (reference, owkin/PyDESeq2): pydeseq2/inference.py:9-362 - the
pluggable seam between the model layer and the numerical backend. Array
orientation follows the reference: ``counts`` and ``mu`` are sample-major
(n_samples, n_genes); implementations are free to re-layout internally (the
PyTorch backend works gene-major on the device).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Literal

import numpy as np


class Inference(ABC):
    """DESeq2-related inference routines."""

    @abstractmethod
    def lin_reg_mu(
        self,
        counts: np.ndarray,
        size_factors: np.ndarray,
        design_matrix: np.ndarray,
        min_mu: float,
    ) -> np.ndarray:
        """Linear-regression estimate of NB means, (n_samples, n_genes).

        Parity: reference pydeseq2/inference.py lin_reg_mu.
        """

    @abstractmethod
    def irls(
        self,
        counts: np.ndarray,
        size_factors: np.ndarray,
        design_matrix: np.ndarray,
        disp: np.ndarray,
        min_mu: float,
        beta_tol: float,
        min_beta: float = -30,
        max_beta: float = 30,
        optimizer: Literal["BFGS", "L-BFGS-B"] = "L-BFGS-B",
        maxiter: int = 250,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Fit per-gene NB GLM coefficients.

        Returns (lfcs (G,P), mu (N,G), hat_diagonals (N,G), converged (G,)).
        """

    @abstractmethod
    def alpha_mle(
        self,
        counts: np.ndarray,
        design_matrix: np.ndarray,
        mu: np.ndarray,
        alpha_hat: np.ndarray,
        min_disp: float,
        max_disp: float,
        prior_disp_var: float | None = None,
        cr_reg: bool = True,
        prior_reg: bool = False,
        optimizer: Literal["BFGS", "L-BFGS-B"] = "L-BFGS-B",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-gene dispersion (MLE or MAP). Returns (alpha (G,), converged)."""

    @abstractmethod
    def wald_test(
        self,
        design_matrix: np.ndarray,
        disp: np.ndarray,
        lfc: np.ndarray,
        mu: np.ndarray,
        ridge_factor: np.ndarray,
        contrast: np.ndarray,
        lfc_null: float,
        alt_hypothesis: Literal["greaterAbs", "lessAbs", "greater", "less"] | None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-gene Wald tests. Returns (pvals, stats, se), each (G,)."""

    @abstractmethod
    def fit_rough_dispersions(
        self, normed_counts: np.ndarray, design_matrix: np.ndarray
    ) -> np.ndarray:
        """Residual-based rough dispersions, (G,)."""

    @abstractmethod
    def fit_moments_dispersions(
        self, normed_counts: np.ndarray, size_factors: np.ndarray
    ) -> np.ndarray:
        """Method-of-moments dispersions, (G,)."""

    @abstractmethod
    def dispersion_trend_gamma_glm(
        self, covariates, targets
    ) -> tuple[np.ndarray, np.ndarray, bool]:
        """Gamma-GLM trend fit. Returns (coeffs (2,), predictions (G,), ok)."""

    @abstractmethod
    def lfc_shrink_nbinom_glm(
        self,
        design_matrix: np.ndarray,
        counts: np.ndarray,
        size: np.ndarray,
        offset: np.ndarray,
        prior_no_shrink_scale: float,
        prior_scale: float,
        optimizer: str,
        shrink_index: int,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """apeGLM MAP shrinkage. Returns (beta, inv_hessians, converged)."""
