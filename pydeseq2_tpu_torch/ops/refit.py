"""Cook's outlier imputation of the refit tile.

Port of the imputation step of ``pydeseq2_tpu/fused_stream.py:561-575``
(``refit_pipeline_streamed``; reference pydeseq2/dds.py:1331-1390): the
counts of a gene's Cook's outliers in replaceable samples become the
gene's trimmed mean (trim 0.2) of the normalised counts, rescaled by each
sample's size factor and truncated to an integer; genes left all zero are
reported, not refitted.

Kernel (``csrc/impute.cu``): one warp per tile row unpacks the row's exceed
words (bit k of word w: sample 32 w + k), takes the trimmed mean by the key
bisection it shares with the Cook's kernel (``csrc/common.cuh``) and writes
the imputed row and the all-zero flag. It reads the tile and writes the
imputed tile, 2 x K x N values, its bytes bound on the H100. The plain
version (CPU tensors only) is the JAX package's expressions with the
sort-slice trimmed mean; the two keep the same multiset and sum it in
another order.
"""

from __future__ import annotations

import math

import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops.cooks import _mask_tensor, unpack_bits
from pydeseq2_tpu_torch.ops.stats import _trimmed_mean_plain

TRIM = 0.2


def _impute_plain(counts, exceeds_packed, replaceable, size_factors, tile_mask):
    N = counts.shape[1]
    repl = torch.as_tensor(replaceable, dtype=torch.bool, device=counts.device)
    swap = repl[None, :] & unpack_bits(exceeds_packed, N)
    trim02 = _trimmed_mean_plain(counts / size_factors[None, :], TRIM, 1)
    # .astype(int) truncation of the reference; counts are >= 0, so floor.
    imputed = torch.where(swap, torch.floor(trim02[:, None] * size_factors[None, :]), counts)
    return imputed, (imputed == 0).all(dim=1) & tile_mask


def _impute_cuda(counts, exceeds_packed, replaceable, size_factors, tile_mask):
    K, N = counts.shape
    dev = counts.device
    repl = _mask_tensor(tuple(bool(r) for r in replaceable), dev)
    ops = [t.contiguous() for t in (counts, size_factors)]
    counts, size_factors = ops
    packed = exceeds_packed.contiguous()
    mask = tile_mask.to(torch.uint8).contiguous()
    if packed.dtype != torch.int32 or packed.shape != (K, -(-N // 32)):
        raise ValueError(f"impute: exceeds_packed must be ({K}, {-(-N // 32)}) int32")
    imputed = torch.empty_like(counts)
    naz = torch.empty(K, dtype=torch.uint8, device=dev)
    kernels.check_cuda_operands("impute", *ops, packed, repl, mask, imputed, naz)
    kernels.launch(
        "impute",
        [
            int(counts.dtype == torch.float64), K, N, math.floor(N * TRIM),
            counts.data_ptr(), packed.data_ptr(), repl.data_ptr(), size_factors.data_ptr(), mask.data_ptr(),
            imputed.data_ptr(), naz.data_ptr(),
        ],
        dev,
    )
    return imputed, naz.bool()


def impute_outliers(
    counts: torch.Tensor,
    exceeds_packed: torch.Tensor,
    replaceable: tuple[bool, ...],
    size_factors: torch.Tensor,
    tile_mask: torch.Tensor,
):
    """Imputed refit tile: ``(imputed (K, N), new_all_zero (K,))``.

    counts (K, N) raw counts of the genes to refit; ``exceeds_packed``
    (K, ceil(N/32)) int32, their Cook's exceed bits from
    :func:`~pydeseq2_tpu_torch.ops.cooks.cooks_outliers`; ``replaceable``
    (N,) the samples in cohorts of at least ``min_replicates``; tile_mask
    (K,) bool, False on padding rows. A cell whose bit is set in a
    replaceable sample becomes floor(trimmed_mean_0.2(counts / sf) * sf_n);
    ``new_all_zero`` marks masked-in rows left all zero. CUDA tensors launch
    the ``impute`` kernel; CPU tensors take the plain version.
    """
    fn = _impute_cuda if counts.is_cuda else _impute_plain
    return fn(counts, exceeds_packed, replaceable, size_factors, tile_mask)
