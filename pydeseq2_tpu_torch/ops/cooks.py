"""Cook's distances and the Cook's outlier gene mask.

Port of the Cook's block of ``pydeseq2_tpu/fused.py:summary_pipeline``
(:691-716; reference pydeseq2/dds.py:986-1110): a robust method-of-moments
dispersion per gene from cohort-wise trimmed variances of the normalised
counts, the Cook's distance of every sample, and the outlier flag.

Kernel (``csrc/cooks.cu``): replaces the trimmed moments
(``ops/stats.py:88,108`` with ``ops/select.py:166 trimmed_mean_select``)
and the elementwise block after them. One warp per gene. For each cohort
it finds the two boundary order statistics of the trimmed mean by MSB-first
bisection over the values' monotone integer keys (one warp-wide count per
key bit, both ranks per pass), then sums the interior with the boundary
ties counted exactly, as ``trimmed_mean_select`` does; the normalised
counts ``y / sf`` and the squared errors are recomputed from the gene's row
on every pass instead of stored, so it works for any N with no shared
memory. A last pass over the row forms the Cook's distances, the
``use_for_max`` cutoff test and the first argmax. It reads counts, mu and H
and writes the distances: 4 x G x N values, 96 MB at 100 x 60000 f32, the
bound on the H100; the bisection passes re-read the row from L1.

The plain version (CPU tensors only) is the JAX package's block with the
sort-slice trimmed moments of ``ops/stats.py``. The two keep the same
multiset of each trimmed mean and sum it in another order.
"""

from __future__ import annotations

import functools
import math
from itertools import accumulate

import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops.stats import (
    _COHORT_SCALES,
    _COHORT_TRIM_RATIOS,
    _trimmed_cell_variance_plain,
    _trimmed_variance_plain,
    cohort_bin,
)


def cohort_layout(cohort_ids, use_for_max, n_samples: int):
    """The kernel's description of the robust-dispersion cohorts:
    ``(cohort, trims, scales)``, a cohort index per sample (-1 for samples
    in no cohort) and the trim ratio and scale of each cohort.

    Cohorts are numbered in first-seen order of ``cohort_ids`` and take the
    trim and scale of their size bin, as ``trimmed_cell_variance`` does.
    None means one cohort of all samples with ``trimmed_variance``'s fixed
    trim 0.125 and scale 1.51, whatever N is (reference
    pydeseq2/utils.py:938-952).
    """
    if cohort_ids is None:
        return (0,) * n_samples, (0.125,), (1.51,)
    levels = list(dict.fromkeys(int(c) for c in cohort_ids))
    cohort = [-1] * n_samples
    idx = [i for i, u in enumerate(use_for_max) if u]
    for i, c in zip(idx, cohort_ids, strict=True):
        cohort[i] = levels.index(int(c))
    sizes = [cohort.count(c) for c in range(len(levels))]
    trims = tuple(_COHORT_TRIM_RATIOS[cohort_bin(n)] for n in sizes)
    scales = tuple(_COHORT_SCALES[cohort_bin(n)] for n in sizes)
    return tuple(cohort), trims, scales


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along axis 1, a NaN counting as the
    maximum (``jnp.argmax``'s rule)."""
    m = x.amax(1)  # NaN where the row holds one
    hit = (x == m[:, None]) | (torch.isnan(x) & torch.isnan(m)[:, None])
    N = x.shape[1]
    idx = torch.arange(N, device=x.device)[None, :].expand_as(x)
    return torch.where(hit, idx, torch.full_like(idx, N)).amin(1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(G, N) bools -> (G, ceil(N/32)) int32 words, bit k of word w holding
    sample 32 w + k: the JAX package's uint32 words (fused_stream.py:427-433)
    as the same bit pattern in int32, which has the operators PyTorch lacks
    for uint32."""
    G, N = bits.shape
    W = -(-N // 32)
    padded = torch.zeros((G, W * 32), dtype=torch.int64, device=bits.device)
    padded[:, :N] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(G, W, 32) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(words: torch.Tensor, N: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (G, W) int32 words -> (G, N) bools.
    The arithmetic shift of a word with bit 31 set fills with ones, so the
    bit is taken with ``& 1``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)[:, :N].bool()


def _cooks_plain(counts, size_factors, mu, H, non_zero, P, cohort_ids, use_for_max, cutoff,
                 replaceable=None, want_distances=True):
    normed = counts / size_factors[None, :]
    if cohort_ids is not None:
        idx = torch.tensor([i for i, u in enumerate(use_for_max) if u], device=counts.device)
        v = _trimmed_cell_variance_plain(normed[:, idx].T, cohort_ids)
    else:
        v = _trimmed_variance_plain(normed.T, 0.125, 0)
    m = normed.mean(dim=1)
    disp_c = torch.clamp((v - m) / m**2, min=0.04)
    V = mu + disp_c[:, None] * mu**2
    squared_pearson = (counts - mu) ** 2 / (V * P)
    cooks = squared_pearson * H / (1.0 - H) ** 2

    ufm = torch.as_tensor(use_for_max, dtype=torch.bool, device=counts.device)
    neg_inf = torch.full_like(cooks, float("-inf"))
    flagged = (torch.where(ufm[None, :], cooks, neg_inf) > cutoff).any(dim=1)
    # Un-flag genes where >= 3 samples exceed the max-cooks sample's count
    # (reference pydeseq2/dds.py:1097-1101): argmax and count over ALL samples.
    max_count = counts.gather(1, first_argmax(cooks)[:, None])
    veto = (counts > max_count).sum(dim=1) < 3
    outlier = flagged & veto & non_zero
    out = (
        torch.where(non_zero[:, None], cooks, torch.full_like(cooks, float("nan"))) if want_distances else None,
        outlier,
        disp_c,
    )
    if replaceable is None:
        return out
    # Refit mode (fused_stream.py:422-445): the exceed bits of every cell,
    # and the flag a refitted gene keeps, from its use_for_max samples that
    # are not replaceable, with the veto on the original distances.
    exceeds = cooks > cutoff
    repl = torch.as_tensor(replaceable, dtype=torch.bool, device=counts.device)
    flagged_nr = (torch.where((ufm & ~repl)[None, :], cooks, neg_inf) > cutoff).any(dim=1)
    return out + (pack_bits(exceeds), exceeds.any(dim=1) & non_zero, flagged_nr & veto & non_zero)


@functools.lru_cache(maxsize=16)
def _layout_tensors(cohort, trims, scales, use_for_max, device: torch.device, dtype: torch.dtype):
    """Device copies of a cohort layout (sample order by cohort, cohort
    offsets, trim counts, scales, use_for_max), made once per layout so a
    warm run copies nothing to the card."""
    members = [[i for i, c in enumerate(cohort) if c == k] for k in range(len(trims))]
    perm = torch.tensor([i for idx in members for i in idx], dtype=torch.int32, device=device)
    offsets = torch.tensor(list(accumulate([0] + [len(i) for i in members])), dtype=torch.int32, device=device)
    ntrim = torch.tensor([math.floor(len(idx) * t) for idx, t in zip(members, trims)],
                         dtype=torch.int32, device=device)
    scale = torch.tensor(scales, dtype=dtype, device=device)
    ufm = torch.tensor(use_for_max, dtype=torch.uint8, device=device)
    return perm, offsets, ntrim, scale, ufm


@functools.lru_cache(maxsize=16)
def _mask_tensor(mask, device: torch.device) -> torch.Tensor:
    """A device copy of a static (N,) mask as uint8, made once per mask."""
    return torch.tensor(mask, dtype=torch.uint8, device=device)


def _cooks_cuda(counts, size_factors, mu, H, non_zero, P, cohort_ids, use_for_max, cutoff,
                replaceable=None, want_distances=True):
    G, N = counts.shape
    dev = counts.device
    use_for_max = tuple(bool(u) for u in use_for_max)
    cohort, trims, scales = cohort_layout(cohort_ids, use_for_max, N)
    perm, offsets, ntrim, scale, ufm = _layout_tensors(cohort, trims, scales, use_for_max, dev, counts.dtype)
    nz = non_zero.to(torch.uint8).contiguous()
    cutoff = torch.as_tensor(cutoff, dtype=counts.dtype, device=dev).reshape(1)
    ops = [t.contiguous() for t in (counts, size_factors, mu, H)]
    cooks = torch.empty((G, N), dtype=counts.dtype, device=dev) if want_distances else None
    outlier = torch.empty(G, dtype=torch.uint8, device=dev)
    disp_c = torch.empty(G, dtype=counts.dtype, device=dev)
    repl = packed = replaced = refit = None
    if replaceable is not None:
        repl = _mask_tensor(tuple(bool(r) for r in replaceable), dev)
        packed = torch.empty((G, -(-N // 32)), dtype=torch.int32, device=dev)
        replaced = torch.empty(G, dtype=torch.uint8, device=dev)
        refit = torch.empty(G, dtype=torch.uint8, device=dev)
    kernels.check_cuda_operands("cooks", *ops, cutoff, scale, cooks, disp_c, perm, offsets, ntrim, ufm, nz, repl,
                                packed, replaced, refit)
    counts, size_factors, mu, H = ops
    kernels.launch(
        "cooks",
        [
            int(counts.dtype == torch.float64), G, N, P,
            counts.data_ptr(), size_factors.data_ptr(), mu.data_ptr(), H.data_ptr(),
            nz.data_ptr(), ufm.data_ptr(), cutoff.data_ptr(),
            len(trims), perm.data_ptr(), offsets.data_ptr(), ntrim.data_ptr(), scale.data_ptr(),
            kernels.ptr(repl), kernels.ptr(cooks), outlier.data_ptr(), disp_c.data_ptr(),
            kernels.ptr(packed), kernels.ptr(replaced), kernels.ptr(refit),
        ],
        dev,
    )
    out = (cooks, outlier.bool(), disp_c)
    if replaceable is None:
        return out
    return out + (packed, replaced.bool(), refit.bool())


def cooks_outliers(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    mu: torch.Tensor,
    H: torch.Tensor,
    non_zero: torch.Tensor,
    P: int,
    cohort_ids: tuple[int, ...] | None,
    use_for_max: tuple[bool, ...],
    cutoff: torch.Tensor,
    replaceable: tuple[bool, ...] | None = None,
    want_distances: bool = True,
):
    """Cook's distances and outliers: ``(cooks (G, N), cooks_outlier (G,),
    robust dispersion (G,))``, and in refit mode three more outputs.

    counts, mu (unthresholded) and H are (G, N); ``cohort_ids`` (the cohort
    of each ``use_for_max`` sample, or None for one trimmed variance over
    all samples) and ``use_for_max`` (N,) come from ``summary_host_inputs``;
    a gene is flagged when a ``use_for_max`` sample's distance exceeds
    ``cutoff`` (a 0-d tensor, the F(0.99, P, N - P) quantile). ``cooks`` is
    NaN on genes that are not ``non_zero``. CUDA tensors launch the
    ``cooks`` kernel; CPU tensors take the plain version.

    With ``want_distances=False`` the first output is None and no (G, N)
    array is written. ``replaceable`` (N,), the samples in cohorts of at
    least ``min_replicates``, switches on the refit mode of
    ``pydeseq2_tpu/fused_stream.py:422-445``, which appends
    ``exceeds_packed`` (G, ceil(N/32)) int32 (bit k of word w: sample
    32 w + k has a distance above the cutoff, NaN distances never),
    ``replaced`` (G,) (any bit set, on non_zero genes) and
    ``cooks_outlier_refit`` (G,) (the flag a refitted gene keeps: a
    ``use_for_max`` sample that is not replaceable exceeds the cutoff, with
    the count veto of the original distances).
    """
    fn = _cooks_cuda if counts.is_cuda else _cooks_plain
    return fn(counts, size_factors, mu, H, non_zero, P, cohort_ids, use_for_max, cutoff, replaceable,
              want_distances)
