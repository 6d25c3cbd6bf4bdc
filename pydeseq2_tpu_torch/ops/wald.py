"""Hat diagonals and batched Wald tests for NB GLM contrasts.

Port of ``pydeseq2_tpu/ops/wald.py:wald_test_batch`` (reference
pydeseq2/utils.py:718-811): covariance, SE, statistic and p-values for all
four alternative hypotheses, beside the hat diagonals that the Cook's
distances read.

Kernel (``csrc/hat_wald.cu``): replaces ``hat_diagonals``
(pydeseq2_tpu/ops/irls.py:444) followed by ``wald_test_batch``
(pydeseq2_tpu/ops/wald.py:28). A group of lanes owns a gene
(:func:`_hat_wald_plan`: 4, 8 or 32 lanes, or a block at atlas widths): a
first pass over the gene's N samples forms each sample's mu and weight once
and builds both Gram matrices, X^T W_thr X on the min_mu-thresholded mu
(for the hat matrix) and X^T W X on the unthresholded mu (for the Wald
covariance, as the JAX pipeline feeds ``wald_test_batch`` the
unthresholded mu that ``hat_diagonals`` returns), writing mu and keeping
W_thr in shared memory; each ridged matrix is inverted once a group; a
second pass writes H. It never reads the counts. Its bound on the H100 is
its writes, 2 x G x N values (48 MB at 100 x 60000 f32, 0.0143 ms); it runs
at ~2.5x that, held by instruction issue. With ``want_hat=False`` (the
streamed refit) it builds the Wald matrix alone and writes only p, the
statistic and the SE, the same bits.

The plain version (CPU tensors only) is ``ops/irls.py:hat_diagonals``
followed by :func:`wald_test_batch`.

The class API calls the two halves apart, so each has an entry of its own
in the same source: ``hat`` (``ops/irls.py:hat_diagonals``) and ``wald``
(:func:`wald_test_batch` on the caller's mu and ridge). On CUDA tensors
each launches its entry; on CPU tensors each runs its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops.irls import _hat_plain
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv, weighted_gram

# alt_hypothesis -> the kernel's branch code
ALT_CODES = {None: 0, "greaterAbs": 1, "lessAbs": 2, "greater": 3, "less": 4}


class HatWaldPlan(NamedTuple):
    """A launch of ``csrc/hat_wald.cu``: ``lanes`` a gene (4, 8, 32, or
    256: a block) and ``staged``, the samples of each row whose hat weight
    is kept in shared memory for the second pass (0 to N; past them it is
    formed again from mu). The test alone keeps nothing and takes the lanes
    only."""

    lanes: int
    staged: int


_HW_BLOCK = 256  # lanes of a block a gene (csrc/hat_wald.cu THREADS)
_HW_LANES = (4, 8, 32, _HW_BLOCK)
_HW_BLOCK_MIN_N = 2_048  # samples from which a gene takes a block
_HW_GROUPS_STAGE = 32_768  # bytes of shared memory the groups of a block stage together
_HW_BLOCK_STAGE = 49_152  # bytes a block-wide gene stages


def _hat_wald_plan(N: int, P: int, itemsize: int) -> HatWaldPlan:
    """The plan for rows of N samples of ``itemsize`` bytes at design width
    P, from the shape alone (no read of the card): the fewest lanes, 4 or 8,
    to 64 and 128 samples, then 32 below 2048, then a block a gene, the
    lane counts of ``mom`` (``ops/linreg.py:_mom_plan``). A row keeps as
    many weights as its group's share of the block's stage holds (128, 256,
    1024 float32 samples a group of 4, 8, 32 lanes, half that in float64;
    12288 or 6144 a block): the whole row but past 1024 / 512 samples on 32
    lanes and at atlas widths. P (1 to 8) moves no threshold: the stage
    holds one value a sample whatever the design."""
    del P  # no threshold depends on it (above)
    lanes = next((s for s, top in ((4, 64), (8, 128), (32, _HW_BLOCK_MIN_N - 1)) if N <= top), _HW_BLOCK)
    return _hat_wald_staged(lanes, N, itemsize)


def _hat_wald_staged(lanes: int, N: int, itemsize: int) -> HatWaldPlan:
    """``lanes`` a gene, staging as much of each row as a group's share of
    the block's stage holds."""
    stage = _HW_BLOCK_STAGE if lanes == _HW_BLOCK else _HW_GROUPS_STAGE * lanes // _HW_BLOCK
    return HatWaldPlan(lanes, min(N, stage // itemsize))


def _check_plan(name: str, plan: HatWaldPlan, N: int, keeps: bool) -> None:
    """Raise unless the kernel is built for ``plan``: lanes of
    :data:`_HW_LANES` and, where the hat weights are kept, at most N
    staged."""
    if plan.lanes not in _HW_LANES or (keeps and not 0 <= plan.staged <= N):
        raise ValueError(f"{name}: plan {tuple(plan)} is not built for {N} samples")


def _device_scalar(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``v`` as a (1,) tensor on ``device``: a tensor cast where it is, a
    number written by a fill on the device (``torch.as_tensor`` of a number
    copies it from pageable host memory, and that copy waits for the
    stream: the class API passes ``lfc_null`` as a float)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).reshape(1)
    return torch.full((1,), float(v), dtype=dtype, device=device)


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


def _wald_cuda(X, disp, lfc, mu, ridge_factor, contrast, lfc_null, alt_hypothesis, plan=None):
    """Launch the Wald-only entry of ``csrc/hat_wald.cu`` (``wald``);
    ``plan`` overrides :func:`_hat_wald_plan`'s lanes."""
    G, P = lfc.shape
    N = X.shape[0]
    dev = lfc.device
    if plan is None:
        plan = _hat_wald_plan(N, P, lfc.element_size())
    _check_plan("wald", plan, N, keeps=False)
    lfc_null = _device_scalar(lfc_null, lfc.dtype, dev)
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
         plan.lanes, pval.data_ptr(), stat.data_ptr(), se.data_ptr()],
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


def _hat_wald_plain(beta, disp, size_factors, X, contrast, lfc_null, min_mu, alt_hypothesis, want_hat=True):
    H, mu = _hat_plain(size_factors, X, disp, beta, min_mu) if want_hat else (None, None)
    mu_w = mu if want_hat else size_factors[None, :] * torch.exp(beta @ X.T)  # _hat_plain's mu
    ridge = 1e-6 * torch.eye(X.shape[1], dtype=beta.dtype, device=beta.device)
    pval, stat, se = _wald_plain(X, disp, beta, mu_w, ridge, contrast, lfc_null, alt_hypothesis)
    return H, mu, pval, stat, se


def _hat_wald_cuda(beta, disp, size_factors, X, contrast, lfc_null, min_mu, alt_hypothesis, want_hat=True,
                   plan=None):
    """Launch the ``hat_wald`` entry of ``csrc/hat_wald.cu``, without H and
    mu buffers where ``want_hat`` is False (the test alone); ``plan``
    overrides :func:`_hat_wald_plan`."""
    G, P = beta.shape
    N = X.shape[0]
    dev = beta.device
    if plan is None:
        plan = _hat_wald_plan(N, P, beta.element_size())
    _check_plan("hat_wald", plan, N, keeps=want_hat)
    lfc_null = _device_scalar(lfc_null, beta.dtype, dev)
    ops = [t.contiguous() for t in (beta, disp, size_factors, X, contrast, lfc_null)]
    beta, disp, size_factors, X, contrast, lfc_null = ops
    H = torch.empty((G, N), dtype=beta.dtype, device=dev) if want_hat else None
    mu = torch.empty_like(H) if want_hat else None
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
            plan.lanes, plan.staged, kernels.ptr(H), kernels.ptr(mu), pval.data_ptr(), stat.data_ptr(),
            se.data_ptr(),
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
    want_hat: bool = True,
):
    """Hat diagonals and the Wald test from the fitted coefficients:
    ``(H (G, N), mu (G, N), p_values, statistics, se)``.

    H = W_thr x_n^T (X^T W_thr X + 1e-6 I)^-1 x_n on the min_mu-thresholded
    mu; mu is the UNthresholded sf e^{X beta}, which the Wald covariance
    uses. With ``want_hat`` False, H and mu are None and nothing of size
    (G, N) is written; the test's outputs are the same. CUDA tensors launch
    the ``hat_wald`` kernel; CPU tensors take the plain version.
    """
    if alt_hypothesis not in ALT_CODES:
        raise ValueError(f"unknown alt_hypothesis {alt_hypothesis!r}")
    fn = _hat_wald_cuda if beta.is_cuda else _hat_wald_plain
    return fn(beta, disp, size_factors, design_matrix, contrast, lfc_null, min_mu, alt_hypothesis, want_hat)
