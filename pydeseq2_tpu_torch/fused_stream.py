"""apeGLM LFC shrinkage streamed over gene blocks.

Port of the shrink part of ``pydeseq2_tpu/fused_stream.py``:
:func:`lfc_shrink_pipeline_streamed` (``:975``) and its host wrapper
:func:`run_lfc_shrink_streamed` (``:1085``). The blocks run as a Python loop
over ``gene_block`` slices (``lax.map`` in the JAX program); inside a block
the grid rescue runs behind one host-read branch, standing for the
``lax.cond``. The streamed summary, refit and VST pipelines are not ported
yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.models.stats import _apeglm_prior_variance
from pydeseq2_tpu_torch.ops.shrink import _hess, grid_fit_shrink_beta_batch, nbinom_fn_batch, nbinom_glm_batch
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv


def _grid_tile(c, s, m, conv, offset, X, prior_scale, pns, shrink_index):
    """The grid rescue's tile of a block (fused_stream.py:1031-1045): K =
    min(B, max(256, B/64)) lanes, failed lanes first (a stable sort keeps
    ascending lane order among ties). Returns ``(idx, counts, size,
    objective scale at 0, sel)``, ``sel`` marking the failed valid lanes."""
    B, P = c.shape[0], X.shape[1]
    K = min(B, max(256, B // 64))
    idx = torch.argsort(conv.to(torch.int8), stable=True)[:K]
    ci, si = c[idx], s[idx]
    zeros = torch.zeros((K, P), dtype=c.dtype, device=c.device)
    cnst = torch.clamp(nbinom_fn_batch(zeros, X, ci, si, offset, pns, prior_scale, shrink_index), min=1.0)
    return idx, ci, si, cnst, ~conv[idx] & m[idx]


def _shrink_block(c, s, m, offset, X, prior_scale, pns, shrink_index):
    """One gene block: Newton MAP fit, then for P == 2 the grid on the
    failed lanes of a compacted tile (fused_stream.py:1023-1072)."""
    beta, ih, conv = nbinom_glm_batch(X, c, s, offset, pns, prior_scale, shrink_index=shrink_index)
    # Host-evaluated lax.cond (fused_stream.py:1063-1065).
    if X.shape[1] == 2 and bool((~conv & m).any()):
        idx, ci, si, cnst, sel = _grid_tile(c, s, m, conv, offset, X, prior_scale, pns, shrink_index)
        b_grid = grid_fit_shrink_beta_batch(ci, offset, X, si, pns, prior_scale, cnst,
                                            shrink_index=shrink_index, sel=sel)
        new_b = torch.where(sel[:, None], b_grid, beta[idx])
        ih_g = sym_inv(_hess(new_b, X, ci, si, offset, pns, prior_scale, shrink_index))
        beta, ih = beta.clone(), ih.clone()
        beta[idx] = new_b
        ih[idx] = torch.where(sel[:, None, None], ih_g, ih[idx])
    se = torch.sqrt(torch.abs(ih[:, shrink_index, shrink_index]))
    nan = torch.tensor(float("nan"), dtype=c.dtype, device=c.device)
    return {"lfc": torch.where(m[:, None], beta, nan), "se": torch.where(m, se, nan), "converged": conv}


def lfc_shrink_pipeline_streamed(
    counts: torch.Tensor,
    size: torch.Tensor,
    offset: torch.Tensor,
    design_matrix: torch.Tensor,
    prior_scale: float,
    gene_mask: torch.Tensor,
    *,
    gene_block: int = 8192,
    shrink_index: int = 1,
    prior_no_shrink_scale: float = 15.0,
) -> dict:
    """apeGLM MAP shrinkage streamed over gene blocks, on the device of
    ``counts``.

    counts (G, N) gene-major raw counts, G a multiple of ``gene_block``;
    size (G,) NB size = 1/dispersion; offset (N,) log size factors;
    prior_scale min(sqrt(prior_var), 1); gene_mask (G,) bool. Returns
    ``lfc`` (G, P) MAP coefficients (natural log), ``se`` (G,) posterior SD
    of the shrunk coefficient and ``converged`` (G,), Newton's flag even
    where the grid replaced the coefficients. CUDA tensors launch the
    ``shrink`` and ``grid_apeglm`` kernels. Contract:
    ``pydeseq2_tpu/fused_stream.py:975``.
    """
    G = counts.shape[0]
    if G % gene_block:
        raise ValueError(f"pad G={G} to a multiple of gene_block={gene_block}")
    blocks = [
        _shrink_block(counts[b:b + gene_block], size[b:b + gene_block], gene_mask[b:b + gene_block], offset,
                      design_matrix, prior_scale, prior_no_shrink_scale, shrink_index)
        for b in range(0, G, gene_block)
    ]
    return {k: torch.cat([blk[k] for blk in blocks]) for k in blocks[0]}


def _host(a, dtype=None) -> np.ndarray:
    """A host numpy copy of an array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def run_lfc_shrink_streamed(
    counts,
    design_matrix,
    coeff_idx: int,
    dispersions,
    size_factors,
    mle_lfc=None,
    mle_se=None,
    adapt: bool = True,
    gene_block: int | None = None,
    dtype=torch.float32,
    prior_no_shrink_scale: float = 15.0,
    n_genes: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Host wrapper: apeGLM-shrink coefficient ``coeff_idx`` on ``device``
    (default ``"cuda"``; raises if CUDA is requested and absent).

    Feed it the outputs of ``summary_pipeline``: ``dispersions``,
    ``size_factors`` and, with ``adapt``, the MLE ``lfc`` column and ``se``
    that the adaptive prior variance is fitted from on the host (reference
    pydeseq2/ds.py:384-397). Arrays or tensors; ``dtype`` is a torch or
    numpy float dtype. ``n_genes`` is the number of leading valid lanes when
    ``counts`` was pre-padded. Genes with NaN dispersions return NaN.
    Returns numpy ``lfc`` (G, P), ``se``, ``converged``, plus
    ``prior_scale`` and ``gene_block``. Port of
    ``pydeseq2_tpu/fused_stream.py:1085``.
    """
    dev = resolve_device(device)
    dtype = dtype if isinstance(dtype, torch.dtype) else {np.dtype(np.float32): torch.float32,
                                                          np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    if isinstance(counts, torch.Tensor):
        counts = counts.to(device=dev, dtype=dtype)
    else:
        counts = torch.tensor(np.asarray(counts, np_dtype), device=dev)
    G, N = counts.shape
    G_phys = G
    if n_genes is not None:
        if not 0 < n_genes <= G:
            raise ValueError(f"n_genes={n_genes} outside (0, {G}]")
        G = n_genes
    if not isinstance(design_matrix, torch.Tensor):
        design_matrix = getattr(design_matrix, "values", design_matrix)  # a DataFrame's array
    design = _host(design_matrix, np_dtype)
    prior_scale = 1.0
    if adapt:
        if mle_lfc is None or mle_se is None:
            raise ValueError("adapt=True needs mle_lfc and mle_se")
        prior_var = _apeglm_prior_variance(_host(mle_lfc, float), _host(mle_se, float))
        prior_scale = min(float(np.sqrt(prior_var)), 1.0)

    if gene_block is None:
        raw = int(max(1024, min(G, 4_000_000_000 // (80 * N))))
        n_blocks = -(-G // raw)
        gene_block = ((-(-G // n_blocks) + 7) // 8) * 8

    padded_G = math.ceil(G_phys / gene_block) * gene_block
    if padded_G != G_phys:
        counts = torch.cat([counts, counts.new_zeros((padded_G - G_phys, N))])
    gene_mask = np.arange(padded_G) < G

    disp = _host(dispersions, np_dtype)
    ok = np.isfinite(disp) & (disp > 0)
    size = np.ones(padded_G, dtype=np_dtype)
    size[:G][ok] = 1.0 / disp[ok]
    gene_mask = gene_mask & np.pad(ok, (0, padded_G - G))

    def on_dev(a):
        return torch.tensor(a, device=dev)  # a copy: pandas arrays may be read-only

    out = lfc_shrink_pipeline_streamed(
        counts.contiguous(),
        on_dev(size),
        on_dev(np.log(_host(size_factors, np_dtype))),
        on_dev(design),
        prior_scale,
        on_dev(gene_mask),
        gene_block=gene_block,
        shrink_index=int(coeff_idx),
        prior_no_shrink_scale=prior_no_shrink_scale,
    )
    res = {k: v[:G].cpu().numpy() for k, v in out.items()}
    res["prior_scale"] = prior_scale
    res["gene_block"] = gene_block
    return res
