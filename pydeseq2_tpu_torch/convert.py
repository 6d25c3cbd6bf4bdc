"""Device selection and numpy <-> tensor conversion at the package boundary.

DESeq2 carries no weights; what crosses over from the JAX package is the
call itself: :func:`inputs_from_numpy` turns the numpy arguments of
``pydeseq2_tpu.fused.wald_pipeline`` or ``summary_pipeline`` into keyword
arguments of the port's :func:`~pydeseq2_tpu_torch.fused.wald_pipeline` or
:func:`~pydeseq2_tpu_torch.fused.summary_pipeline`, and
:func:`outputs_to_numpy` turns the port's result into the dict that
``jax.device_get`` gives for the JAX result (same keys, same dtypes).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``; raises if CUDA is requested and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def inputs_from_numpy(
    counts,
    design_matrix,
    contrast,
    lfc_null,
    gene_mask=None,
    size_factors=None,
    *,
    cooks_cutoff=None,
    dtype: torch.dtype = torch.float64,
    device: str | torch.device = "cuda",
    **static,
) -> dict:
    """Keyword arguments for the port's ``wald_pipeline``, or with
    ``cooks_cutoff`` given, its ``summary_pipeline``.

    The array arguments and ``cooks_cutoff`` become ``dtype`` tensors on
    ``device`` (the mask a bool tensor); the static keyword arguments
    (``max_disp``, ``beta_tol``, ``alt_hypothesis``, ``cohort_ids``, ...)
    pass through unchanged.
    """
    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    kw = {
        "counts": t(counts),
        "design_matrix": t(design_matrix),
        "contrast": t(contrast),
        "lfc_null": t(lfc_null),
        "gene_mask": None if gene_mask is None else torch.as_tensor(np.asarray(gene_mask, bool), device=dev),
        "size_factors": t(size_factors),
        "device": dev,
    }
    if cooks_cutoff is not None:
        kw["cooks_cutoff"] = t(cooks_cutoff)
    kw.update(static)
    return kw


def outputs_to_numpy(out: dict) -> dict:
    """Host copy of a pipeline result: numpy arrays, same keys."""
    return {k: v.detach().cpu().numpy() for k, v in out.items()}
