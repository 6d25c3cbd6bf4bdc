"""Lightweight AnnData-style state container for the DESeq2 pipeline.

A copy of ``pydeseq2_tpu/container.py`` (numpy and pandas only; the
``anndata`` import stays lazy), kept here so the port does not import the
JAX package. In the port the matrix slots hold numpy; the dataset keeps its
device tensors in a private store.

Replaces the reference's inheritance from ``anndata.AnnData``
(reference pydeseq2/dds.py:33,249) with a plain container exposing the same
named slots - ``X, obs, var, obsm, varm, uns, layers`` - so all intermediate
pipeline state lives in familiar places. Labels (obs/var) are host pandas;
matrix slots hold NumPy arrays (device residency is managed by the
inference layer). Import/export adapters to real ``anndata.AnnData`` objects
are provided for interoperability, gated on anndata availability.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


class _AlignedDict(dict):
    """dict of arrays whose first axis must match a fixed length."""

    def __init__(self, length: int, axis_name: str):
        super().__init__()
        self._length = length
        self._axis_name = axis_name

    def __setitem__(self, key, value):
        n = value.shape[0] if hasattr(value, "shape") else len(value)
        if n != self._length:
            raise ValueError(
                f"Value for '{key}' has leading dim {n}, expected "
                f"{self._length} ({self._axis_name})."
            )
        super().__setitem__(key, value)


class DeseqDataContainer:
    """Samples x genes data matrix with aligned annotation slots.

    Parameters
    ----------
    X : (n_obs, n_vars) array
        Count matrix (samples x genes), like AnnData.
    obs : pandas.DataFrame
        Per-sample annotations (indexed by sample barcode).
    var : pandas.DataFrame, optional
        Per-gene annotations (indexed by gene name).
    """

    def __init__(
        self,
        X: np.ndarray,
        obs: pd.DataFrame | None = None,
        var: pd.DataFrame | None = None,
    ):
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError("X must be 2-D (samples x genes).")
        self._X = X
        n_obs, n_vars = X.shape
        if obs is None:
            obs = pd.DataFrame(index=pd.RangeIndex(n_obs).astype(str))
        if var is None:
            var = pd.DataFrame(index=pd.RangeIndex(n_vars).astype(str))
        if len(obs) != n_obs:
            raise ValueError("obs length does not match X rows.")
        if len(var) != n_vars:
            raise ValueError("var length does not match X columns.")
        self.obs = obs.copy()
        self.var = var.copy()
        self.obsm = _AlignedDict(n_obs, "n_obs")
        self.varm = _AlignedDict(n_vars, "n_vars")
        self.layers = _AlignedDict(n_obs, "n_obs")
        self.uns: dict = {}

    # -- basic properties --------------------------------------------------
    @property
    def X(self) -> np.ndarray:
        return self._X

    @X.setter
    def X(self, value):
        value = np.asarray(value)
        if value.shape != self._X.shape:
            raise ValueError("Cannot change the shape of X in place.")
        self._X = value

    @property
    def n_obs(self) -> int:
        return self._X.shape[0]

    @property
    def n_vars(self) -> int:
        return self._X.shape[1]

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    def __repr__(self):  # pragma: no cover
        return (
            f"DeseqDataContainer(n_obs={self.n_obs}, n_vars={self.n_vars}, "
            f"layers={list(self.layers)}, varm={list(self.varm)})"
        )

    # -- gene indexing -----------------------------------------------------
    def normalize_gene_indexer(self, indexer) -> np.ndarray:
        """Resolve bool masks / integer positions / gene-name lists to
        integer positions (the same indexing AnnData accepts,
        reference pydeseq2/dds.py:640-651)."""
        return self._resolve_axis_indexer(indexer, self.n_vars, self.var_names)

    def _resolve_axis_indexer(self, indexer, n: int, names: pd.Index) -> np.ndarray:
        """Resolve one axis of an AnnData-style indexer to integer positions.

        Accepts slices, boolean masks, integer positions, name lists, and
        scalar names/positions (the forms AnnData's ``__getitem__`` takes,
        reference pydeseq2/dds.py:33 inherits them and uses e.g.
        ``self[:, self.non_zero_genes]``, dds.py:868,1330,1490).
        """
        if isinstance(indexer, slice):
            return np.arange(n)[indexer]
        if np.isscalar(indexer) and not isinstance(indexer, (bool, np.bool_)):
            if isinstance(indexer, str):
                pos = names.get_indexer([indexer])
                if pos[0] < 0:
                    raise KeyError(indexer)
                return pos
            return np.asarray([indexer], dtype=int)
        idx = np.asarray(indexer)
        if idx.dtype == bool:
            if idx.shape[0] != n:
                raise ValueError(
                    f"Boolean mask has length {idx.shape[0]}, expected {n}."
                )
            return np.where(idx)[0]
        if np.issubdtype(idx.dtype, np.integer):
            return idx
        pos = names.get_indexer(pd.Index(idx))
        if (pos < 0).any():
            missing = list(np.asarray(idx)[pos < 0][:5])
            raise KeyError(f"Names not found: {missing}")
        return pos

    def __getitem__(self, index) -> "DeseqDataContainer":
        """AnnData-style slicing: ``c[samples]``, ``c[:, genes]``,
        ``c[samples, genes]``.

        Returns a :class:`DeseqDataContainer` restricted to the selection —
        a materialized snapshot of every slot rather than AnnData's lazy
        view (state arrays here are plain NumPy buffers; reference
        scripts that do ``dds[:, genes].X`` / ``.var`` / ``.layers`` /
        ``.copy()`` work unchanged, reference pydeseq2/dds.py:868-874,1330).
        """
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) == 1:
            index = (index[0], slice(None))
        if len(index) != 2:
            raise IndexError(
                "Container indexing takes at most 2 axes (samples, genes)."
            )
        oidx, vidx = index
        out = self
        full = slice(None)
        if not (isinstance(vidx, slice) and vidx == full):
            out = out.subset_genes(
                self._resolve_axis_indexer(vidx, self.n_vars, self.var_names)
            )
        if not (isinstance(oidx, slice) and oidx == full):
            out = out.subset_obs(
                self._resolve_axis_indexer(oidx, self.n_obs, self.obs_names)
            )
        if out is self:
            out = self.subset_genes(np.arange(self.n_vars))
        return out

    def subset_obs(self, indexer) -> "DeseqDataContainer":
        """Return a copy restricted to the given samples (rows)."""
        pos = self._resolve_axis_indexer(indexer, self.n_obs, self.obs_names)
        sub = DeseqDataContainer(
            self._X[pos, :], obs=self.obs.iloc[pos], var=self.var
        )
        for k, v in self.layers.items():
            sub.layers[k] = np.asarray(v)[pos, :]
        for k, v in self.obsm.items():
            if isinstance(v, pd.DataFrame):
                sub.obsm[k] = v.iloc[pos]
            else:
                sub.obsm[k] = np.asarray(v)[pos]
        for k, v in self.varm.items():
            sub.varm[k] = v
        sub.uns = dict(self.uns)
        return sub

    def subset_genes(self, indexer) -> "DeseqDataContainer":
        """Return a copy restricted to the given genes (columns)."""
        pos = self.normalize_gene_indexer(indexer)
        sub = DeseqDataContainer(
            self._X[:, pos], obs=self.obs, var=self.var.iloc[pos]
        )
        for k, v in self.layers.items():
            sub.layers[k] = np.asarray(v)[:, pos]
        for k, v in self.varm.items():
            if isinstance(v, pd.DataFrame):
                sub.varm[k] = v.iloc[pos]
            else:
                sub.varm[k] = np.asarray(v)[pos]
        for k, v in self.obsm.items():
            sub.obsm[k] = v
        sub.uns = dict(self.uns)
        return sub

    def copy(self) -> "DeseqDataContainer":
        new = DeseqDataContainer(self._X.copy(), obs=self.obs, var=self.var)
        for k, v in self.layers.items():
            new.layers[k] = np.array(v, copy=True)
        for k, v in self.varm.items():
            new.varm[k] = v.copy()
        for k, v in self.obsm.items():
            new.obsm[k] = v.copy()
        new.uns = dict(self.uns)
        return new

    # -- AnnData interop ---------------------------------------------------
    @classmethod
    def from_anndata(cls, adata) -> "DeseqDataContainer":
        """Build a container from an ``anndata.AnnData`` object."""
        X = adata.X
        if not isinstance(X, np.ndarray):
            X = X.toarray()
        c = cls(np.asarray(X), obs=adata.obs.copy(), var=adata.var.copy())
        for k in adata.layers:
            c.layers[k] = np.asarray(adata.layers[k])
        for k in adata.obsm:
            c.obsm[k] = adata.obsm[k]
        for k in adata.varm:
            c.varm[k] = adata.varm[k]
        c.uns = dict(adata.uns)
        return c

    def to_anndata(self):
        """Export to ``anndata.AnnData`` (requires anndata installed).

        Counterpart of the reference's ``to_picklable_anndata``
        (pydeseq2/dds.py:1112-1138).
        """
        import anndata as ad

        return ad.AnnData(
            X=self._X,
            obs=self.obs,
            var=self.var,
            obsm={k: np.asarray(v) if not isinstance(v, pd.DataFrame) else v for k, v in self.obsm.items()},
            varm={k: np.asarray(v) if not isinstance(v, pd.DataFrame) else v for k, v in self.varm.items()},
            layers={k: np.asarray(v) for k, v in self.layers.items()},
            uns=self.uns,
        )
