"""PyTorch inference backend: the per-gene device programs behind the
Inference ABC.

Port of ``pydeseq2_tpu/jax_inference.py``: each of the eight methods runs
its gene-batched kernels on one device. Two things differ from the JAX
backend by design:

- **Nothing (G, N) goes back to the host.** Methods take numpy arrays or
  tensors and return tensors on the device, so a dataset that keeps its
  (N, G) intermediates on the device (``models/dataset.py``) hands them
  from stage to stage without a copy. The JAX backend exported every stage's
  (G, N) buffers to numpy and imported them again, the flaw behind its
  slow class API at atlas width.
- **No lane padding.** Rescue lanes are gathered as they are: PyTorch
  compiles nothing per shape, so the JAX backend's bucket padding has no
  use here.

Orientation follows the ABC: counts and mu are sample-major (N, G) at the
boundary; inside, every kernel works gene-major. A (N, G) tensor that is the
transpose of a contiguous (G, N) one (what the methods return) goes in
without a copy.

Routes, each a kernel on CUDA tensors (plain PyTorch on the CPU):

- ``lin_reg_mu`` and the two MoM methods: ``mom`` (the MoM methods in its
  normalised-count mode, since the ABC hands them counts / sf);
- ``irls``: ``irls`` with the two-phase tail and the rescue tiers
  (``newton_box``, and ``grid_nb`` at P == 2) through
  ``fused._irls_with_rescue``, then the hat-only entry ``hat``;
- ``alpha_mle``: ``disp_scan`` and ``disp_newton``;
- ``wald_test``: the Wald-only entry ``wald``;
- ``dispersion_trend_gamma_glm``: ``trend_fit``;
- ``lfc_shrink_nbinom_glm``: ``shrink``, and ``grid_apeglm`` at P == 2 on
  the lanes Newton leaves unconverged.
"""

from __future__ import annotations

import warnings
from typing import Literal

import numpy as np
import torch

from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.fused import _irls_with_rescue
from pydeseq2_tpu_torch.inference import Inference
from pydeseq2_tpu_torch.ops.dispersion import alpha_mle_batch
from pydeseq2_tpu_torch.ops.irls import hat_diagonals, irls_beta_init
from pydeseq2_tpu_torch.ops.linreg import mom_and_mu_coef, ols_pinv
from pydeseq2_tpu_torch.ops.shrink import _hess, grid_fit_shrink_beta_batch, nbinom_fn_batch, nbinom_glm_batch
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv
from pydeseq2_tpu_torch.ops.trend import gamma_glm_trend_fit
from pydeseq2_tpu_torch.ops.wald import wald_test_batch

# The IRLS trip budget (reference pydeseq2/utils.py:273, maxiter=250).
IRLS_MAXITER = 250


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch float dtype from a torch or numpy one."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


class TorchInference(Inference):
    """Gene-batched PyTorch inference backend.

    Parameters
    ----------
    dtype : torch or numpy float dtype
        Compute dtype of the solvers (default float64, the reference's
        numerics; float32 passes the golden-file tolerances on the repo's
        fixtures).
    device : str or torch.device
        Where every method runs (default ``"cuda"``; raises if CUDA is
        requested and absent). Pass ``"cpu"`` for the plain PyTorch path.
    gene_batch_size : int, optional
        Genes per batch. ``None`` sizes batches so that ~20 live (batch, N)
        temporaries fit a ~4 GB budget, as the gene-streamed pipelines do:
        the whole gene axis up to ~1000 samples.
    """

    _BUDGET_BYTES = 4_000_000_000
    _LIVE_BUFFERS = 20

    def __init__(self, dtype=torch.float64, device: str | torch.device = "cuda", gene_batch_size: int | None = None):
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        self.gene_batch_size = gene_batch_size

    # ------------------------------------------------------------------ utils
    def _t(self, a, contiguous: bool = True) -> torch.Tensor:
        """``a`` as a tensor of the compute dtype on the device, contiguous
        unless asked otherwise (a design from pandas is column-major)."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.require(np.asarray(a), requirements="W"))
        a = a.to(self.device, self.dtype)
        return a.contiguous() if contiguous else a

    def _gene_major(self, a) -> torch.Tensor:
        """A sample-major (N, G) array as a contiguous (G, N) tensor."""
        return self._t(a, contiguous=False).T.contiguous()

    def _batch(self, G: int, N: int) -> int:
        if self.gene_batch_size is not None:
            return self.gene_batch_size
        itemsize = torch.finfo(self.dtype).bits // 8
        raw = int(max(1024, min(G, self._BUDGET_BYTES // (self._LIVE_BUFFERS * N * itemsize))))
        n_blocks = -(-G // raw)
        return ((-(-G // n_blocks) + 7) // 8) * 8

    def _over_batches(self, G: int, N: int, fn):
        """Run ``fn(slice)`` over gene batches and join its outputs (a tuple
        of tensors, each with genes first) along the gene axis."""
        bs = self._batch(G, N)
        outs = [fn(slice(b, b + bs)) for b in range(0, G, bs)]
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    # ------------------------------------------------------- Inference methods
    def lin_reg_mu(self, counts, size_factors, design_matrix, min_mu):
        """OLS mu, (N, G). Parity: reference pydeseq2/default_inference.py:58-81."""
        cnt = self._gene_major(counts)
        sf, X = self._t(size_factors), self._t(design_matrix)
        pinv = ols_pinv(X)
        G, N = cnt.shape
        (mu,) = self._over_batches(G, N, lambda sl: (mom_and_mu_coef(cnt[sl], sf, X, pinv, min_mu)[3],))
        return mu.T

    def fit_rough_dispersions(self, normed_counts, design_matrix):
        """(G,). Parity: reference pydeseq2/utils.py:814-853 (incl. the n == p guard)."""
        X = self._t(design_matrix)
        num_samples, num_vars = X.shape
        if num_samples == num_vars:
            raise ValueError(
                "The number of samples and the number of design variables are "
                "equal, i.e., there are no replicates to estimate the "
                "dispersion. Please use a design with fewer variables."
            )
        nc = self._gene_major(normed_counts)
        ones = torch.ones(num_samples, dtype=self.dtype, device=self.device)
        pinv = ols_pinv(X)
        G, N = nc.shape
        (rough,) = self._over_batches(
            G, N, lambda sl: (mom_and_mu_coef(nc[sl], ones, X, pinv, want_mu=False, normed=True)[0],))
        return rough

    def fit_moments_dispersions(self, normed_counts, size_factors):
        """(G,). Parity: reference pydeseq2/utils.py:856-885."""
        nc = self._gene_major(normed_counts)
        sf = self._t(size_factors)
        G, N = nc.shape
        X = torch.ones((N, 1), dtype=self.dtype, device=self.device)
        pinv = ols_pinv(X)
        (moments,) = self._over_batches(
            G, N, lambda sl: (mom_and_mu_coef(nc[sl], sf, X, pinv, want_mu=False, normed=True)[1],))
        return moments

    def irls(
        self,
        counts,
        size_factors,
        design_matrix,
        disp,
        min_mu,
        beta_tol,
        min_beta: float = -30,
        max_beta: float = 30,
        optimizer: Literal["BFGS", "L-BFGS-B"] = "L-BFGS-B",
        maxiter: int = 250,
    ):
        """``(beta (G, P), mu (N, G), hat diagonals (N, G), converged (G,))``.

        Parity: reference pydeseq2/utils.py:273-438; the cascade of
        ``pydeseq2_tpu/jax_inference.py:182`` through the pipelines'
        ``_irls_with_rescue`` in one phase of the whole 250-trip budget, as
        the JAX backend's single loop (the pipelines' two phases restart a
        straggler's deviance history and may stop it a trip later), then the
        rescue tiers on up to max(512, G/64) lanes a batch, the grid at P ==
        2. The design's rank is a host test: a rank-deficient design starts
        from a log-mean intercept. ``min_beta``, ``max_beta``, ``optimizer``
        and ``maxiter`` are the reference's knobs; the solver keeps its own
        (the box at 30, 250 trips).
        """
        cnt = self._gene_major(counts)
        sf, X, d = self._t(size_factors), self._t(design_matrix), self._t(disp)
        full_rank = bool(np.linalg.matrix_rank(X.cpu().numpy()) == X.shape[1])
        G, N = cnt.shape
        overflow = []

        def run(sl):
            beta_init = irls_beta_init(cnt[sl], sf, X, full_rank=full_rank)
            beta, conv, over = _irls_with_rescue(cnt[sl], sf, X, d[sl], beta_init, min_mu, beta_tol,
                                                 phase1_iters=IRLS_MAXITER)
            overflow.append(over)
            H, mu = hat_diagonals(None, sf, X, d[sl], beta, min_mu=min_mu)
            return beta, mu, H, conv

        beta, mu, H, conv = self._over_batches(G, N, run)
        n_over = int(sum(overflow))
        if n_over:
            warnings.warn(
                f"{n_over} IRLS lanes exceeded the rescue tile after the full 250-trip budget and kept their "
                "final IRLS iterate (converged=False).",
                UserWarning,
                stacklevel=2,
            )
        return beta, mu.T, H.T, conv

    def alpha_mle(
        self,
        counts,
        design_matrix,
        mu,
        alpha_hat,
        min_disp,
        max_disp,
        prior_disp_var=None,
        cr_reg: bool = True,
        prior_reg: bool = False,
        optimizer: Literal["BFGS", "L-BFGS-B"] = "L-BFGS-B",
    ):
        """``(alpha (G,), converged (G,))``: coarse scan + Newton polish.

        Parity: reference pydeseq2/utils.py:441-564.
        """
        cnt, mu_g = self._gene_major(counts), self._gene_major(mu)
        X, ah = self._t(design_matrix), self._t(alpha_hat)
        G, N = cnt.shape
        return self._over_batches(G, N, lambda sl: alpha_mle_batch(
            cnt[sl], X, mu_g[sl], ah[sl], float(min_disp), float(max_disp), prior_disp_var=prior_disp_var,
            cr_reg=cr_reg, prior_reg=prior_reg))

    def wald_test(self, design_matrix, disp, lfc, mu, ridge_factor, contrast, lfc_null, alt_hypothesis=None):
        """``(p_values, statistics, se)``, each (G,).

        Parity: reference pydeseq2/utils.py:718-811.
        """
        mu_g = self._gene_major(mu)
        X, d, lfc_t = self._t(design_matrix), self._t(disp), self._t(lfc)
        ridge, cvec = self._t(ridge_factor), self._t(contrast)
        G, N = mu_g.shape
        return self._over_batches(G, N, lambda sl: wald_test_batch(
            X, d[sl], lfc_t[sl], mu_g[sl], ridge, cvec, float(lfc_null), alt_hypothesis))

    def dispersion_trend_gamma_glm(self, covariates, targets):
        """``(coeffs (2,), predictions (G,), converged)`` of one gamma-GLM fit
        on the finite lanes. Parity: reference pydeseq2/default_inference.py:200-230."""
        cov, tar = self._t(covariates), self._t(targets)
        return gamma_glm_trend_fit(cov, tar, torch.isfinite(cov) & torch.isfinite(tar))

    def lfc_shrink_nbinom_glm(
        self,
        design_matrix,
        counts,
        size,
        offset,
        prior_no_shrink_scale,
        prior_scale,
        optimizer,
        shrink_index,
    ):
        """``(beta (G, P), inverse Hessians (G, P, P), converged (G,))``.

        Parity: reference pydeseq2/utils.py:990-1144. At P == 2 the lanes
        Newton leaves unconverged take the 2-D grid, and their inverse
        Hessians are recomputed at the grid's coefficients (``converged``
        stays Newton's flag).
        """
        cnt = self._gene_major(counts)
        X, sz, off = self._t(design_matrix), self._t(size), self._t(offset)
        pns, ps, si = float(prior_no_shrink_scale), float(prior_scale), int(shrink_index)
        G, N = cnt.shape
        P = X.shape[1]

        def run(sl):
            c, s = cnt[sl], sz[sl]
            beta, ih, conv = nbinom_glm_batch(X, c, s, off, pns, ps, shrink_index=si)
            if P == 2:
                idx = torch.nonzero(~conv).flatten()  # a host read: the lanes to rescue
                if idx.numel():
                    ci, sv = c[idx], s[idx]
                    zeros = torch.zeros((idx.numel(), P), dtype=self.dtype, device=self.device)
                    cnst = torch.clamp(nbinom_fn_batch(zeros, X, ci, sv, off, pns, ps, si), min=1.0)
                    b_grid = grid_fit_shrink_beta_batch(ci, off, X, sv, pns, ps, cnst, shrink_index=si)
                    beta, ih = beta.clone(), ih.clone()
                    beta[idx] = b_grid
                    ih[idx] = sym_inv(_hess(b_grid, X, ci, sv, off, pns, ps, si))
            return beta, ih, conv

        return self._over_batches(G, N, run)
