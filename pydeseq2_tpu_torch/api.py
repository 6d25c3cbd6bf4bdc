"""One-call entry point: counts -> DESeq2 results DataFrame on the card.

Port of ``pydeseq2_tpu/api.py``. :func:`run_deseq2` validates the inputs and
builds the design on the host (through the port's :class:`DeseqDataSet`),
moves the counts to the device once as a contiguous gene-major (G, N)
tensor, and routes the analysis to the ported pipelines:

- ``refit_cooks=True`` (the reference's default, pydeseq2/dds.py:221):
  :func:`~pydeseq2_tpu_torch.fused_stream.run_summary_streamed`, the
  gene-streamed main pass with the Cook's outlier replacement and refit;
- ``refit_cooks=False``: :func:`~pydeseq2_tpu_torch.fused_stream.summary_pipeline`
  (flag-then-mask, no replacement), then one host copy of the per-gene
  outputs.

Size factors: ``ratio`` and ``poscounts`` run inside the pipelines;
``iterative`` (and ``ratio`` where every gene has a zero, with the
reference's warning, pydeseq2/dds.py:682-690) runs
:func:`~pydeseq2_tpu_torch.ops.sizefactors.iterative_size_factors` on the
device counts; control genes go through the staged
:meth:`DeseqDataSet.fit_size_factors`. The computed factors are injected.
Nothing falls back to the CPU: ``device="cuda"`` without a card raises.

With ``mesh`` (a 1-D gene mesh, :mod:`pydeseq2_tpu_torch.parallel.mesh`)
every rank calls with the same DataFrames and returns the same whole
``results_df``: each rank moves only its shard of the gene axis to its
device, as the JAX package's ``api.py:228-240`` (refit route, counts padded
with 0) and ``:280-295`` (the single pipeline, counts padded with 1 and a
``gene_mask``) shard it, and the per-gene results are gathered.
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
    device: str | torch.device | None = None,
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
    mesh : torch.distributed.device_mesh.DeviceMesh, optional
        A 1-D gene mesh (:func:`~pydeseq2_tpu_torch.parallel.mesh.make_gene_mesh`),
        every rank making the same call. The device is the mesh's. The
        iterative size factors and control genes run whole on every rank
        before sharding, as the JAX package's do. Anything but a
        ``DeviceMesh`` raises TypeError.
    return_state : bool
        Also return the pipeline's per-gene outputs as a dict of numpy
        arrays (the keys of the JAX package's state dict).
    device : str or torch.device, optional
        Where the analysis runs (default ``"cuda"``, or the mesh's device;
        raises if CUDA is requested and absent, or if it disagrees with the
        mesh). ``"cpu"`` runs the kernels' plain versions.

    Returns
    -------
    pandas.DataFrame with baseMean, log2FoldChange, lfcSE, stat, pvalue,
    padj (the reference's ``results_df``, pydeseq2/ds.py:268-286), plus the
    state dict when ``return_state``.
    """
    from pydeseq2_tpu_torch.fused import summary_host_inputs
    from pydeseq2_tpu_torch.fused_stream import _REPLICATED, _to_host, run_summary_streamed, summary_pipeline
    from pydeseq2_tpu_torch.models.dataset import DeseqDataSet
    from pydeseq2_tpu_torch.ops.sizefactors import iterative_size_factors, pick_sf_gene_block
    from pydeseq2_tpu_torch.parallel.mesh import (
        gather_gene_dict,
        pad_to_multiple,
        resolve_mesh_device,
        shard_gene_major,
    )
    from pydeseq2_tpu_torch.torch_inference import TorchInference, as_torch_dtype

    tdtype = torch.float64 if dtype is None else as_torch_dtype(dtype)
    np_dtype = np.float64 if tdtype == torch.float64 else np.float32
    dev = resolve_mesh_device(device, mesh)  # raises TypeError on anything but a DeviceMesh
    inference = TorchInference(dtype=tdtype, device=dev)

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
    # pipelines reuse that copy. With a mesh only the rank's shard crosses
    # (the whole counts too where the size factors need them).
    staged_sf = control_genes is not None and size_factors_fit_type != "iterative"
    counts_np = np.ascontiguousarray(dds.X.T, dtype=np_dtype)
    if staged_sf:
        dds.fit_size_factors(fit_type=size_factors_fit_type, control_genes=control_genes)
        counts_d = dds._counts().to(tdtype)
    elif mesh is None:
        counts_d = torch.from_numpy(counts_np).to(dev)
    else:
        counts_d = None
    G, N = counts_np.shape

    def _iterative_sf() -> torch.Tensor:
        sf, _ = iterative_size_factors(
            torch.from_numpy(counts_np).to(dev) if counts_d is None else counts_d, min_disp=min_disp,
            max_disp=max_disp, min_mu=min_mu, gene_block=pick_sf_gene_block(G, N, tdtype), device=dev,
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
    elif not ((counts_np > 0).all(axis=1).any() if counts_d is None else bool((counts_d > 0).all(dim=1).any())):
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
            counts_np if counts_d is None else counts_d, design_df, contrast_vector, lfc_null_ln, dtype=tdtype,
            refit_cooks=True, min_replicates=min_replicates, n_genes=G, size_factors=sf, device=dev, mesh=mesh,
            **knobs,
        )
    else:
        host = summary_host_inputs(design_df)

        def on_dev(a):
            return torch.tensor(np.asarray(a, np_dtype), device=dev).contiguous()  # a design is column-major

        gene_mask = None
        if mesh is not None:
            # Shard-even shapes: pad lanes of ones, kept out by the mask.
            counts_pad, _ = pad_to_multiple(counts_np, mesh.size(), fill=1)
            counts_d = shard_gene_major(counts_pad, mesh)
            gene_mask = shard_gene_major(np.arange(counts_pad.shape[0]) < G, mesh)
        out = summary_pipeline(
            counts_d, on_dev(design_df.to_numpy()), on_dev(contrast_vector), on_dev(lfc_null_ln),
            on_dev(host["cooks_cutoff"]), gene_mask, sf, cohort_ids=host["cohort_ids"],
            use_for_max=host["use_for_max"], device=dev, mesh=mesh, **knobs,
        )
        keys = out if return_state else ("lfc", "base_mean", "se", "statistics", "p_values", "padj")
        out = {k: out[k] for k in keys}
        if mesh is not None:  # one gather of the per-gene outputs, cut to the G genes
            out.update(gather_gene_dict({k: v for k, v in out.items() if k not in _REPLICATED}, mesh, n=G))
        res = _to_host(out)  # one device-to-host copy

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
