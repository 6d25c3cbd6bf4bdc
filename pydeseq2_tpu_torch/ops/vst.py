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
and writes the (G, N) result once, bound by those bytes on the H100; the
flag, coefficients and mean dispersion are read on the device, so no host
read chooses the form. The plain version (CPU tensors only) spells the
JAX expressions: ``jnp.log2(x)`` lowers to ``log(x) / log(2)``, so the
division is written out (``torch.log2`` rounds differently), and every
scalar operand is a 0-d tensor of the counts' dtype.
"""

from __future__ import annotations

import math

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


def _vst_cuda(counts, size_factors, trend_coeffs, used_mean, mean_disp, gene_mask, mean_only):
    G, N = counts.shape
    out = torch.empty_like(counts)
    mask8 = gene_mask.to(torch.uint8).contiguous()
    counts, size_factors, mean_disp = (t.contiguous() for t in (counts, size_factors, mean_disp))
    coeffs = None if mean_only else trend_coeffs.contiguous()
    flag = None if mean_only else used_mean.to(torch.uint8).reshape(1).contiguous()
    kernels.check_cuda_operands("vst", counts, size_factors, coeffs, mean_disp, out, mask8, flag)
    kernels.launch(
        "vst",
        [int(counts.dtype == torch.float64), G, N, int(mean_only), counts.data_ptr(), size_factors.data_ptr(),
         kernels.ptr(coeffs), kernels.ptr(flag), mean_disp.data_ptr(), mask8.data_ptr(), out.data_ptr()],
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
