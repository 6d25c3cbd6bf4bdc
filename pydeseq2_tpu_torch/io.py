"""Persistence: save/load fitted datasets and results.

Port of ``pydeseq2_tpu/io.py`` (reference pydeseq2/dds.py:1112-1138,
examples/plot_pandas_io_example.py). The saved file holds numpy and pandas
only, never a tensor, so a dataset fitted on the card loads on a machine
without one. The port's :class:`DeseqDataSet` keeps the gene-major
intermediates that later stages read in a private device store;
:func:`load_dataset` rebuilds that store from the restored public slots
(``DeseqDataSet._restore_device_store``), so a reloaded dataset resumes at
any stage boundary.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import pandas as pd
import torch


_STATE_KEYS = (
    "fit_type",
    "design",
    "min_mu",
    "min_disp",
    "max_disp",
    "refit_cooks",
    "min_replicates",
    "beta_tol",
    "size_factors_fit_type",
    "logmeans",
    "filtered_genes",
)


def _host(value):
    """``value`` with a tensor replaced by its numpy copy."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


def save_dataset(dds, path: str | Path) -> None:
    """Pickle a :class:`DeseqDataSet`'s full state (resumable at any stage)."""
    state = {
        "X": np.asarray(dds.X),
        "obs": dds.obs,
        "var": dds.var,
        "obsm": {k: _host(v) for k, v in dds.obsm.items()},
        "varm": {k: _host(v) for k, v in dds.varm.items()},
        "layers": {k: np.asarray(_host(v)) for k, v in dds.layers.items()},
        "uns": {k: _host(v) for k, v in dds.uns.items()},
        "attrs": {k: _host(getattr(dds, k, None)) for k in _STATE_KEYS},
    }
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_dataset(path: str | Path, inference=None):
    """Load a :class:`DeseqDataSet` saved with :func:`save_dataset`.

    ``inference=None`` gives the default backend (float64 on ``"cuda"``);
    pass ``TorchInference(device="cpu")`` to load on a machine without a
    card. The device store is rebuilt on the backend's device. The file is
    unpickled, which can run code: load only files written by
    :func:`save_dataset`.
    """
    from pydeseq2_tpu_torch.models.dataset import DeseqDataSet

    with open(path, "rb") as f:
        state = pickle.load(f)

    attrs = state["attrs"]
    counts_df = pd.DataFrame(
        state["X"], index=state["obs"].index, columns=state["var"].index
    )
    dds = DeseqDataSet(
        counts=counts_df,
        metadata=state["obs"],
        design=attrs["design"],
        fit_type=attrs.get("fit_type", "parametric"),
        size_factors_fit_type=attrs.get("size_factors_fit_type", "ratio"),
        min_mu=attrs.get("min_mu", 0.5),
        min_disp=attrs.get("min_disp", 1e-8),
        max_disp=float(attrs.get("max_disp", 10.0)),
        refit_cooks=attrs.get("refit_cooks", True),
        min_replicates=attrs.get("min_replicates", 7),
        beta_tol=attrs.get("beta_tol", 1e-8),
        inference=inference,
        quiet=True,
    )
    # Restore fitted state on top of the fresh construction.
    dds.var = state["var"]
    for k, v in state["obsm"].items():
        dds.obsm[k] = v
    for k, v in state["varm"].items():
        dds.varm[k] = v
    for k, v in state["layers"].items():
        dds.layers[k] = v
    dds.uns = state["uns"]
    dds.logmeans = attrs.get("logmeans")
    dds.filtered_genes = attrs.get("filtered_genes")
    dds._restore_device_store()
    return dds


def save_results(results_df: pd.DataFrame, path: str | Path) -> None:
    """Write a results DataFrame to CSV (or pickle if path ends with .pkl)."""
    path = Path(path)
    if path.suffix == ".pkl":
        results_df.to_pickle(path)
    else:
        results_df.to_csv(path)


def load_results(path: str | Path) -> pd.DataFrame:
    path = Path(path)
    if path.suffix == ".pkl":
        return pd.read_pickle(path)
    return pd.read_csv(path, index_col=0)
