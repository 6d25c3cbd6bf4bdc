"""One-call entry point: counts -> DESeq2 results DataFrame on the card.

Port of ``pydeseq2_tpu/api.py``. :func:`run_deseq2` validates the inputs and
builds the design on the host (through the port's :class:`DeseqDataSet`),
moves the counts to the device once as a contiguous gene-major (G, N)
tensor, and routes the analysis to the ported pipelines:

- ``refit_cooks=True`` (the reference's default, pydeseq2/dds.py:221):
  :func:`~pydeseq2_tpu_torch.fused_stream.run_summary_streamed`, the
  gene-streamed main pass with the Cook's outlier replacement and refit;
- ``refit_cooks=False``: :func:`~pydeseq2_tpu_torch.fused.summary_pipeline`
  (flag-then-mask, no replacement), then one host copy of the per-gene
  outputs.

Size factors: ``ratio`` and ``poscounts`` run inside the pipelines;
``iterative`` (and ``ratio`` where every gene has a zero, with the
reference's warning, pydeseq2/dds.py:682-690) runs
:func:`~pydeseq2_tpu_torch.ops.sizefactors.iterative_size_factors` on the
device counts; control genes go through the staged
:meth:`DeseqDataSet.fit_size_factors`. The computed factors are injected.
Nothing falls back to the CPU: ``device="cuda"`` without a card raises.
"""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd
import torch

__all__ = ["run_deseq2"]


def run_deseq2(
    counts,
    metadata=None,
    design: str = "~condition",
    contrast=None,
    *,
    alpha: float = 0.05,
    cooks_filter: bool = True,
    independent_filter: bool = True,
    lfc_null: float = 0.0,
    alt_hypothesis: str | None = None,
    fit_type: str = "parametric",
    size_factors_fit_type: str = "ratio",
    control_genes=None,
    refit_cooks: bool = True,
    min_replicates: int = 7,
    min_mu: float = 0.5,
    min_disp: float = 1e-8,
    max_disp: float | None = None,
    beta_tol: float | None = None,
    dtype=None,
    mesh=None,
    return_state: bool = False,
    quiet: bool = True,
    device: str | torch.device = "cuda",
):
    """Full DESeq2 Wald analysis in one call on ``device``.

    Parameters
    ----------
    counts : pandas.DataFrame
        Raw counts, samples x genes (the reference's orientation,
        pydeseq2/dds.py:110-117).
    metadata : pandas.DataFrame
        Sample annotations (index aligned with ``counts``).
    design : str or pandas.DataFrame
        Wilkinson formula (e.g. ``"~group + condition"``) or a ready design
        matrix.
    contrast : list[str] | np.ndarray
        ``["variable", "tested_level", "ref_level"]`` (reference
        pydeseq2/ds.py:91-103) or an explicit (P,) contrast vector.
    size_factors_fit_type : {"ratio", "poscounts", "iterative"}
        Normalization mode (reference pydeseq2/dds.py:584-711).
    control_genes : array-like, optional
        Restrict the ratio/poscounts estimators to these genes (names,
        positions or a boolean mask), computed by the staged layer and
        injected.
    refit_cooks : bool
        Replace Cook's-outlier counts and refit the affected genes (the
        reference's default); ``False`` flags and masks only.
    min_replicates : int
        Minimum cohort size for a sample's counts to be replaceable.
    lfc_null : float
        Null log2 fold change (natural log inside, reference
        pydeseq2/ds.py:301).
    dtype : torch or numpy float dtype, optional
        Compute dtype; ``None`` is float64 (the JAX package's default with
        x64 on). float32 is the card's fast type.
    mesh : None
        Not supported yet: a gene mesh over several cards is ROADMAP.md
        item 17. Anything but None raises.
    return_state : bool
        Also return the pipeline's per-gene outputs as a dict of numpy
        arrays (the keys of the JAX package's state dict).
    device : str or torch.device
        Where the analysis runs (default ``"cuda"``; raises if CUDA is
        requested and absent). ``"cpu"`` runs the kernels' plain versions.

    Returns
    -------
    pandas.DataFrame with baseMean, log2FoldChange, lfcSE, stat, pvalue,
    padj (the reference's ``results_df``, pydeseq2/ds.py:268-286), plus the
    state dict when ``return_state``.
    """
    from pydeseq2_tpu_torch.fused import summary_host_inputs, summary_pipeline
    from pydeseq2_tpu_torch.fused_stream import _to_host, run_summary_streamed
    from pydeseq2_tpu_torch.models.dataset import DeseqDataSet
    from pydeseq2_tpu_torch.ops.sizefactors import iterative_size_factors, pick_sf_gene_block
    from pydeseq2_tpu_torch.torch_inference import TorchInference, as_torch_dtype

    if mesh is not None:
        raise NotImplementedError(
            "run_deseq2(mesh=...) is not ported yet: the gene mesh over several cards is "
            "ROADMAP.md item 17 (parallel/mesh.py)."
        )
    tdtype = torch.float64 if dtype is None else as_torch_dtype(dtype)
    np_dtype = np.float64 if tdtype == torch.float64 else np.float32
    inference = TorchInference(dtype=tdtype, device=device)
    dev = inference.device

    # Host-only: validation and the design (no device work).
    dds = DeseqDataSet(
        counts=counts,
        metadata=metadata,
        design=design,
        refit_cooks=False,
        min_mu=min_mu,
        min_disp=min_disp,
        inference=inference,
        quiet=quiet,
    )
    design_df = dds.obsm["design_matrix"]
    n_samples, n_vars = design_df.shape

    if contrast is None:
        raise ValueError("The 'contrast' argument must be provided.")
    if isinstance(contrast, np.ndarray):
        if contrast.shape[0] != n_vars:
            raise ValueError(
                "The contrast vector must have the same length as the design matrix."
            )
        contrast_vector = np.asarray(contrast, float)
    else:
        factor, alternative, ref = contrast
        contrast_vector = np.asarray(
            dds.contrast(column=factor, baseline=ref, group_to_compare=alternative), float
        )

    if lfc_null < 0 and alt_hypothesis in {"greaterAbs", "lessAbs"}:
        raise ValueError(
            f"The alternative hypothesis being {alt_hypothesis}, please "
            f"provide a positive lfc_null value (got {lfc_null})."
        )

    if beta_tol is None:
        # float32 deviance differences bottom out near 1e-7 (the reference's
        # 1e-8 in float64, pydeseq2/dds.py:221).
        beta_tol = 1e-8 if tdtype == torch.float64 else 1e-6
    if max_disp is None:
        max_disp = float(max(10, n_samples))
    # mu init: linear regression when design groups <-> columns are 1:1,
    # else one IRLS pass (reference pydeseq2/dds.py:743-765).
    mu_init = "linear" if len(design_df.value_counts()) == n_vars else "irls"

    if size_factors_fit_type not in ("ratio", "poscounts", "iterative"):
        raise ValueError(
            f"size_factors_fit_type must be 'ratio', 'poscounts' or "
            f"'iterative', got {size_factors_fit_type!r}."
        )

    # The counts cross to the device once, gene-major and contiguous. The
    # staged control-gene estimator moves them itself (float64), and the
    # pipelines reuse that copy.
    staged_sf = control_genes is not None and size_factors_fit_type != "iterative"
    if staged_sf:
        dds.fit_size_factors(fit_type=size_factors_fit_type, control_genes=control_genes)
        counts_d = dds._counts().to(tdtype)
    else:
        counts_d = torch.from_numpy(np.ascontiguousarray(dds.X.T, dtype=np_dtype)).to(dev)
    G, N = counts_d.shape

    def _iterative_sf() -> torch.Tensor:
        sf, _ = iterative_size_factors(
            counts_d, min_disp=min_disp, max_disp=max_disp, min_mu=min_mu,
            gene_block=pick_sf_gene_block(G, N, tdtype), device=dev,
        )
        return sf

    # sf: computed (N,) factors to inject; sf_in_program: the pipelines'
    # own estimator otherwise (reference pydeseq2/dds.py:584-711).
    sf = None
    sf_in_program = "ratio"
    if staged_sf:
        sf = torch.as_tensor(dds.obs["size_factors"].to_numpy(dtype=np_dtype, copy=True), device=dev)
    elif size_factors_fit_type == "iterative":
        sf = _iterative_sf()
    elif size_factors_fit_type == "poscounts":
        sf_in_program = "poscounts"
    elif not bool((counts_d > 0).all(dim=1).any()):
        # ratio undefined: every gene has a zero (reference dds.py:682-690)
        warnings.warn(
            "Every gene contains at least one zero, cannot compute log "
            "geometric means. Switching to iterative mode.",
            UserWarning,
            stacklevel=2,
        )
        sf = _iterative_sf()

    lfc_null_ln = float(np.log(2) * lfc_null)  # log2 -> natural log
    knobs = dict(
        alpha=alpha, cooks_filter=cooks_filter, independent_filter=independent_filter, min_mu=min_mu,
        min_disp=min_disp, max_disp=max_disp, beta_tol=beta_tol, trend_type=fit_type,
        alt_hypothesis=alt_hypothesis, mu_init=mu_init, sf_fit_type=sf_in_program,
    )
    if refit_cooks:
        res = run_summary_streamed(
            counts_d, design_df, contrast_vector, lfc_null_ln, dtype=tdtype, refit_cooks=True,
            min_replicates=min_replicates, n_genes=G, size_factors=sf, device=dev, **knobs,
        )
    else:
        host = summary_host_inputs(design_df)

        def on_dev(a):
            return torch.tensor(np.asarray(a, np_dtype), device=dev).contiguous()  # a design is column-major

        out = summary_pipeline(
            counts_d, on_dev(design_df.to_numpy()), on_dev(contrast_vector), on_dev(lfc_null_ln),
            on_dev(host["cooks_cutoff"]), None, sf, cohort_ids=host["cohort_ids"],
            use_for_max=host["use_for_max"], device=dev, **knobs,
        )
        keys = out if return_state else ("lfc", "base_mean", "se", "statistics", "p_values", "padj")
        res = _to_host({k: out[k] for k in keys})  # one device-to-host copy

    ln2 = np.log(2)
    results_df = pd.DataFrame(index=dds.var_names)
    results_df["baseMean"] = res["base_mean"]
    results_df["log2FoldChange"] = res["lfc"] @ contrast_vector / ln2
    results_df["lfcSE"] = res["se"] / ln2
    results_df["stat"] = res["statistics"]
    results_df["pvalue"] = res["p_values"]
    results_df["padj"] = res["padj"]
    if not quiet:
        print(results_df)
    if return_state:
        return results_df, res
    return results_df
