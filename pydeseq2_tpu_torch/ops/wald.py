"""Hat diagonals and batched Wald tests for NB GLM contrasts.

Port of ``pydeseq2_tpu/ops/wald.py:wald_test_batch`` (reference
pydeseq2/utils.py:718-811): covariance, SE, statistic and p-values for all
four alternative hypotheses, beside the hat diagonals that the Cook's
distances read.

Kernel (``csrc/hat_wald.cu``): replaces ``hat_diagonals``
(pydeseq2_tpu/ops/irls.py:444) followed by ``wald_test_batch``
(pydeseq2_tpu/ops/wald.py:28). One warp per gene: a first pass over the
gene's N samples builds both Gram matrices, X^T W_thr X on the min_mu-
thresholded mu (for the hat matrix) and X^T W X on the unthresholded mu
(for the Wald covariance, as the JAX pipeline feeds ``wald_test_batch`` the
unthresholded mu that ``hat_diagonals`` returns), reduced by warp shuffle;
the two P x P inverses and the contrast SE, statistic and p-value are
scalar work in registers; a second pass writes H and mu. It never reads the
counts. On the H100 it is bound by its writes, 2 x G x N values (48 MB at
100 x 60000 f32); the exp per sample is recomputed in the second pass
rather than stored.

The plain version (CPU tensors only) is ``ops/irls.py:hat_diagonals``
followed by :func:`wald_test_batch`.

The class API calls the two halves apart, so each has an entry of its own
in the same source: ``hat`` (``ops/irls.py:hat_diagonals``) and ``wald``
(:func:`wald_test_batch` on the caller's mu and ridge). On CUDA tensors
each launches its entry; on CPU tensors each runs its plain version.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops.irls import _hat_plain
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv, weighted_gram

# alt_hypothesis -> the kernel's branch code
ALT_CODES = {None: 0, "greaterAbs": 1, "lessAbs": 2, "greater": 3, "less": 4}


def norm_sf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal survival function via erfc."""
    return 0.5 * torch.special.erfc(x / torch.sqrt(torch.tensor(2.0, dtype=x.dtype, device=x.device)))


def _wald_plain(X, disp, lfc, mu, ridge_factor, contrast, lfc_null, alt_hypothesis):
    W = mu / (1.0 + mu * disp[:, None])
    M = weighted_gram(X, W)
    Hinv = sym_inv(M + ridge_factor[None])
    Hc = Hinv @ contrast
    se = torch.sqrt(torch.einsum("gp,gpq,gq->g", Hc, M, Hc))
    lfc_null = torch.as_tensor(lfc_null, dtype=lfc.dtype, device=lfc.device)
    zero = torch.zeros((), dtype=lfc.dtype, device=lfc.device)

    # fmax/fmin/sign apply PER COEFFICIENT before the contrast product
    # (reference pydeseq2/utils.py:778-796).
    def greater(null):
        stat = torch.fmax((lfc - null) / se[:, None], zero) @ contrast
        return stat, norm_sf(stat)

    def less(null):
        stat = torch.fmin((lfc - null) / se[:, None], zero) @ contrast
        return stat, norm_sf(torch.abs(stat))

    if alt_hypothesis == "greater":
        stat, pval = greater(lfc_null)
    elif alt_hypothesis == "less":
        stat, pval = less(lfc_null)
    elif alt_hypothesis == "greaterAbs":
        stat = (torch.sign(lfc) * torch.fmax((torch.abs(lfc) - lfc_null) / se[:, None], zero)) @ contrast
        pval = 2.0 * norm_sf(torch.abs(stat))
    elif alt_hypothesis == "lessAbs":
        stat_above, pval_above = greater(-torch.abs(lfc_null))
        stat_below, pval_below = less(torch.abs(lfc_null))
        stat = torch.where(torch.abs(stat_above) < torch.abs(stat_below), stat_above, stat_below)
        pval = torch.maximum(pval_above, pval_below)
    elif alt_hypothesis is None:
        stat = (lfc @ contrast - lfc_null * contrast.sum()) / se
        pval = 2.0 * norm_sf(torch.abs(stat))
    else:
        raise ValueError(f"unknown alt_hypothesis {alt_hypothesis!r}")
    return pval, stat, se


def _wald_cuda(X, disp, lfc, mu, ridge_factor, contrast, lfc_null, alt_hypothesis):
    """Launch the Wald-only entry of ``csrc/hat_wald.cu`` (``wald``)."""
    G, P = lfc.shape
    N = X.shape[0]
    dev = lfc.device
    lfc_null = torch.as_tensor(lfc_null, dtype=lfc.dtype, device=dev).reshape(1)
    ops = [t.contiguous() for t in (lfc, disp, mu, X, ridge_factor, contrast, lfc_null)]
    lfc, disp, mu, X, ridge_factor, contrast, lfc_null = ops
    if mu.shape != (G, N) or ridge_factor.shape != (P, P):
        raise ValueError(f"wald: mu {tuple(mu.shape)}, ridge {tuple(ridge_factor.shape)}; expected ({G}, {N}), "
                         f"({P}, {P})")
    pval = torch.empty(G, dtype=lfc.dtype, device=dev)
    stat = torch.empty_like(pval)
    se = torch.empty_like(pval)
    kernels.check_cuda_operands("wald", *ops, pval, stat, se)
    kernels.check_p("wald", P)
    kernels.launch(
        "wald",
        [int(lfc.dtype == torch.float64), P, G, N, *(t.data_ptr() for t in ops), ALT_CODES[alt_hypothesis],
         pval.data_ptr(), stat.data_ptr(), se.data_ptr()],
        dev,
    )
    return pval, stat, se


def wald_test_batch(
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    lfc: torch.Tensor,
    mu: torch.Tensor,
    ridge_factor: torch.Tensor,
    contrast: torch.Tensor,
    lfc_null: torch.Tensor | float,
    alt_hypothesis: str | None = None,
):
    """``(p_values, statistics, se)``, three (G,) tensors.

    lfc (G, P) natural-log coefficients, mu (G, N), ridge_factor (P, P),
    contrast (P,), lfc_null a natural-log scalar; ``alt_hypothesis`` one of
    None, "greaterAbs", "lessAbs", "greater", "less". Port of
    ``pydeseq2_tpu/ops/wald.py:28``. CUDA tensors launch the Wald-only entry
    of ``csrc/hat_wald.cu``; CPU tensors take the plain version.
    """
    if alt_hypothesis not in ALT_CODES:
        raise ValueError(f"unknown alt_hypothesis {alt_hypothesis!r}")
    fn = _wald_cuda if lfc.is_cuda else _wald_plain
    return fn(design_matrix, disp, lfc, mu, ridge_factor, contrast, lfc_null, alt_hypothesis)


def _hat_wald_plain(beta, disp, size_factors, X, contrast, lfc_null, min_mu, alt_hypothesis):
    H, mu = _hat_plain(size_factors, X, disp, beta, min_mu)
    ridge = 1e-6 * torch.eye(X.shape[1], dtype=beta.dtype, device=beta.device)
    pval, stat, se = _wald_plain(X, disp, beta, mu, ridge, contrast, lfc_null, alt_hypothesis)
    return H, mu, pval, stat, se


def _hat_wald_cuda(beta, disp, size_factors, X, contrast, lfc_null, min_mu, alt_hypothesis):
    G, P = beta.shape
    N = X.shape[0]
    dev = beta.device
    lfc_null = torch.as_tensor(lfc_null, dtype=beta.dtype, device=dev).reshape(1)
    ops = [t.contiguous() for t in (beta, disp, size_factors, X, contrast, lfc_null)]
    beta, disp, size_factors, X, contrast, lfc_null = ops
    H = torch.empty((G, N), dtype=beta.dtype, device=dev)
    mu = torch.empty_like(H)
    pval = torch.empty(G, dtype=beta.dtype, device=dev)
    stat = torch.empty_like(pval)
    se = torch.empty_like(pval)
    kernels.check_cuda_operands("hat_wald", *ops, H, mu, pval, stat, se)
    kernels.check_p("hat_wald", P)
    kernels.launch(
        "hat_wald",
        [
            int(beta.dtype == torch.float64), P, G, N,
            beta.data_ptr(), disp.data_ptr(), size_factors.data_ptr(), X.data_ptr(),
            contrast.data_ptr(), lfc_null.data_ptr(), float(min_mu), ALT_CODES[alt_hypothesis],
            H.data_ptr(), mu.data_ptr(), pval.data_ptr(), stat.data_ptr(), se.data_ptr(),
        ],
        dev,
    )
    return H, mu, pval, stat, se


def hat_wald(
    beta: torch.Tensor,
    disp: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    contrast: torch.Tensor,
    lfc_null: torch.Tensor | float,
    min_mu: float = 0.5,
    alt_hypothesis: str | None = None,
):
    """Hat diagonals and the Wald test from the fitted coefficients:
    ``(H (G, N), mu (G, N), p_values, statistics, se)``.

    H = W_thr x_n^T (X^T W_thr X + 1e-6 I)^-1 x_n on the min_mu-thresholded
    mu; mu is the UNthresholded sf e^{X beta}, which the Wald covariance
    uses. CUDA tensors launch the ``hat_wald`` kernel; CPU tensors take the
    plain version.
    """
    if alt_hypothesis not in ALT_CODES:
        raise ValueError(f"unknown alt_hypothesis {alt_hypothesis!r}")
    fn = _hat_wald_cuda if beta.is_cuda else _hat_wald_plain
    return fn(beta, disp, size_factors, design_matrix, contrast, lfc_null, min_mu, alt_hypothesis)
