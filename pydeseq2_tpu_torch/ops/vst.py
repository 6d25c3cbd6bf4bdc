"""The variance-stabilising transform of the blind VST.

Port of the transform of ``pydeseq2_tpu/fused.py:882-912`` and
``pydeseq2_tpu/fused_stream.py:1249-1273`` (reference
pydeseq2/dds.py:493-510). With normed = counts / sf, the parametric trend
alpha(mu) = a0 + a1 / mu gives the closed form

    log2((1 + a1 + 2 a0 normed + 2 sqrt(a0 normed (1 + a1 + a0 normed))) / (4 a0))

and the mean trend d the arcsinh form (2 asinh(sqrt(d normed)) - log d -
log 4) / log 2; the parametric trend falls back to the latter where its fit
used the mean (``used_mean``, a device flag). Rows off ``gene_mask`` are
NaN.

Kernel (``csrc/vst.cu``): one elementwise pass that reads the counts once
and writes the (G, N) result once, bound by those bytes on the H100, in
row tiles that know their genes (:func:`_vst_plan`: 16 bytes a thread where
the row length and pointers allow it); the flag, coefficients and mean
dispersion are read on the device, so no host read chooses the form, and
the bool mask and flag are read as the bytes they are, so a call is one
launch. The plain version (CPU tensors only) spells the
JAX expressions: ``jnp.log2(x)`` lowers to ``log(x) / log(2)``, so the
division is written out (``torch.log2`` rounds differently), and every
scalar operand is a 0-d tensor of the counts' dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pydeseq2_tpu_torch import kernels


def _vst_plain(counts, size_factors, trend_coeffs, used_mean, mean_disp, gene_mask, mean_only):
    def const(v):
        return torch.tensor(v, dtype=counts.dtype, device=counts.device)

    ln2 = const(math.log(2.0))
    normed = counts / size_factors[None, :]
    vst = (2.0 * torch.asinh(torch.sqrt(mean_disp * normed)) - torch.log(mean_disp) - const(math.log(4.0))) / ln2
    if not mean_only:
        a0, a1 = trend_coeffs[0], trend_coeffs[1]
        parametric = torch.log(
            (1.0 + a1 + 2.0 * a0 * normed + 2.0 * torch.sqrt(a0 * normed * (1.0 + a1 + a0 * normed))) / (4.0 * a0)
        ) / ln2
        vst = torch.where(used_mean, vst, parametric)
    return torch.where(gene_mask[:, None], vst, torch.full_like(vst, float("nan")))


# csrc/vst.cu: threads a block, the bytes of a row a column tile holds at
# most, the vectors a thread keeps in flight (the counts the kernel is
# built for); blocks an SM holds.
_VST_THREADS = 256
_VST_TILE_BYTES = 4096
VST_ITEMS_BUILT = (1, 2)
_VST_BLOCKS_PER_SM = 8


class VstPlan(NamedTuple):
    """``vst``'s launch: elements a thread accesses at once (1, or 16
    bytes' worth), genes and columns of a block's tile, vectors a thread
    keeps in flight."""

    vec: int
    rows: int
    cols: int
    items: int


def _vst_plan(G: int, N: int, itemsize: int, *ptrs: int, sms: int = 132) -> VstPlan:
    """The tile of one launch from the shape, the pointers' alignment and
    the card's SMs: 16-byte accesses where N is a multiple of 16 / itemsize
    and every pointer (the counts', the output's) is 16-byte aligned, one
    in flight a thread (two for single elements); at most
    ``_VST_TILE_BYTES`` of a row a tile; genes enough for 16 vectors a
    thread where that still leaves two waves of blocks on the card, else 4
    (single elements: 8). The fastest of 1-16 vectors a thread and 1, 2
    or 4 in flight (4 ran slower everywhere) at 100, 101 and 1000 samples
    and the atlas block, both types, on an H100 (``kernel_bench --detail
    --only vst``)."""
    wide = 16 // itemsize
    vec = wide if N % wide == 0 and all(p % 16 == 0 for p in ptrs) else 1
    cols = min(N, _VST_TILE_BYTES // itemsize)
    vt = cols // vec
    col_tiles = -(-N // cols)

    def rows_for(per_thread: int) -> int:
        return max(1, min(G, _VST_THREADS * per_thread // vt))

    if vec == 1:
        return VstPlan(vec, rows_for(8), cols, 2)
    wave = sms * _VST_BLOCKS_PER_SM
    rows = rows_for(16)
    if -(-G // rows) * col_tiles < 2 * wave:
        rows = rows_for(4)
    return VstPlan(vec, rows, cols, 1)


def _vst_cuda(counts, size_factors, trend_coeffs, used_mean, mean_disp, gene_mask, mean_only, plan=None):
    G, N = counts.shape
    out = torch.empty_like(counts)
    counts, size_factors, mean_disp, gene_mask = (t.contiguous() for t in (counts, size_factors, mean_disp,
                                                                           gene_mask))
    coeffs = None if mean_only else trend_coeffs.contiguous()
    flag = None if mean_only else used_mean
    kernels.check_cuda_operands("vst", counts, size_factors, coeffs, mean_disp, out, gene_mask, flag)
    if gene_mask.dtype != torch.bool or (flag is not None and flag.dtype != torch.bool):
        raise TypeError("vst: gene_mask and used_mean must be bool tensors")
    plan = plan or _vst_plan(G, N, counts.element_size(), counts.data_ptr(), out.data_ptr(),
                             sms=kernels.sm_count(counts.device))
    kernels.launch(
        "vst",
        [int(counts.dtype == torch.float64), G, N, int(mean_only), counts.data_ptr(), size_factors.data_ptr(),
         kernels.ptr(coeffs), kernels.ptr(flag), mean_disp.data_ptr(), gene_mask.data_ptr(), out.data_ptr(),
         *plan],
        counts.device,
    )
    return out


def vst_transform(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    trend_coeffs: torch.Tensor | None,
    used_mean: torch.Tensor | None,
    mean_disp: torch.Tensor,
    gene_mask: torch.Tensor,
    trend_type: str = "parametric",
) -> torch.Tensor:
    """(G, N) VST of gene-major counts: the parametric closed form with
    ``trend_coeffs`` (2,) unless the 0-d bool ``used_mean`` is set, or the
    mean form with the 0-d ``mean_disp`` (always, for ``trend_type="mean"``,
    where the coefficients and flag are not read); NaN rows off
    ``gene_mask``. CUDA tensors launch the ``vst`` kernel; CPU tensors take
    the plain version."""
    fn = _vst_cuda if counts.is_cuda else _vst_plain
    return fn(counts, size_factors, trend_coeffs, used_mean, mean_disp, gene_mask, trend_type == "mean")
