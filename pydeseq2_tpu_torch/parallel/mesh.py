"""Gene sharding over a 1-D mesh of ``torch.distributed`` ranks.

Port of ``pydeseq2_tpu/parallel/mesh.py``. Genes are the only scaling axis
of the DESeq2 problem, so the mesh is 1-D, ``("genes",)``, with one process
per device: every rank holds a contiguous shard of the gene axis on its own
device (padded to an even size, the pad lanes kept out by ``gene_mask``)
and a replica of the design matrix and the size factors. The per-gene
kernels run on the local shard unchanged.

The JAX package lets XLA insert the few global reductions when the pipeline
is jitted with gene shardings. PyTorch runs eagerly, so the port writes each
one out, in one of two forms:

1. **Gather, then compute whole.** The trend, the prior's MAD, the
   filtering quantiles and BH run on per-gene vectors gathered from every
   rank (:func:`gather_gene_dict`); every rank runs the same kernels on the
   same whole vectors, so the result is the unsharded one, and each rank
   keeps its rows (:func:`local_rows`).
2. **The size-factor median**, the one (G, N) reduction, adds the integer
   histograms of each radix pass over the ranks
   (:func:`~pydeseq2_tpu_torch.ops.select.sharded_masked_median`), so no
   rank copies another's counts and the median is bit for bit the
   unsharded one.

The IRLS rescue takes its lane quota over the ranks that share a tile
(:class:`LaneGroup`), and the Cook's refit tile is gathered whole and refitted
on every rank.

**Every collective sits at a fixed point of the pipeline, never inside a
branch on data.** A branch on a value read back from the device (the
rescue's ``n_unfinished``, ``needs_fb.any()``, the refit's ``if``) may
skip work, but not a collective: where such a branch guards one, its
condition is first made the same on every rank, by a collective that every
rank reaches.

Entry: :func:`init_distributed` in every process (NCCL on the card, gloo
on the CPU), then :func:`make_gene_mesh`, then ``run_deseq2(mesh=)``,
``TorchInference(mesh=)`` or the pipelines' ``mesh=`` on each rank with the
same arguments.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.placement_types import Replicate, Shard

# The device type init_distributed chose ("cuda" or "cpu").
_DEVICE_TYPE: str | None = None


def init_distributed(backend: str | None = None, device: str | None = None, **kwargs) -> None:
    """Join the process group (wraps ``torch.distributed.init_process_group``).

    ``device`` is ``"cuda"`` (the default; raises if CUDA is not available)
    or ``"cpu"``, which runs the kernels' plain versions; ``backend``
    defaults to NCCL for CUDA and gloo for the CPU. On the card the process
    takes device ``LOCAL_RANK`` (else its rank modulo the visible devices)
    before the group forms. The keywords (``init_method``, ``rank``,
    ``world_size``, ``timeout``) go to ``init_process_group``; nothing
    tells a process of a cluster, so give them.
    """
    global _DEVICE_TYPE
    device = device or "cuda"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): CUDA is not available")
        rank = kwargs.get("rank", int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend=backend, **kwargs)
    _DEVICE_TYPE = device


def make_gene_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` named
    ``("genes",)`` over the ranks of the process group, one a device.

    ``n_devices`` (default: the world size) or ``devices`` (the ranks, in
    order) must cover the whole group. Its device type is the one
    :func:`init_distributed` chose (else ``"cuda"`` under NCCL, ``"cpu"``
    otherwise). Raises if no process group is initialised: there is no
    one-process mode without one.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_gene_mesh: no process group; call init_distributed first")
    world = dist.get_world_size()
    ranks = list(range(n_devices or world)) if devices is None else [int(d) for d in devices]
    if ranks != list(range(world)):
        raise ValueError(f"make_gene_mesh: the gene mesh takes every rank of the group in order (world {world}), "
                         f"got {ranks}")
    device_type = _DEVICE_TYPE or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, ranks, mesh_dim_names=("genes",))


def gene_sharding(mesh: DeviceMesh) -> list:
    """Placement of gene-major arrays: the leading axis split over the mesh."""
    return [Shard(0)]


def replicated(mesh: DeviceMesh) -> list:
    """Placement of replicated arrays (design matrix, size factors)."""
    return [Replicate()]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def resolve_mesh_device(device, mesh) -> torch.device:
    """The device a pipeline runs on: ``device`` (default ``"cuda"``)
    without a mesh; the mesh's with one, and a ``device`` that disagrees
    raises. Anything but a 1-D ``DeviceMesh`` (:func:`make_gene_mesh`)
    raises TypeError."""
    from pydeseq2_tpu_torch.convert import resolve_device

    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(f"mesh must be a 1-D torch.distributed DeviceMesh (make_gene_mesh), got {type(mesh).__name__}")
    dev = mesh_device(mesh)
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None and want.index != dev.index):
            raise ValueError(f"device {device!r} disagrees with the mesh, whose rank {mesh.get_local_rank()} runs on {dev}")
    return dev


def pad_to_multiple(arr: np.ndarray, multiple: int, fill=0):
    """Pad the leading axis to a multiple of ``multiple`` (shard-even sizes).

    Returns (padded_array, original_length).
    """
    g = arr.shape[0]
    rem = (-g) % multiple
    if rem == 0:
        return arr, g
    pad_width = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill), g


def shard_bounds(n_rows: int, mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's rows ``[start, stop)`` of a gene axis of ``n_rows`` (a
    multiple of the mesh size)."""
    R = mesh.size()
    if n_rows % R:
        raise ValueError(f"{n_rows} rows do not split evenly over {R} ranks: pad with pad_to_multiple")
    S = n_rows // R
    r = mesh.get_local_rank()
    return r * S, (r + 1) * S


def shard_gene_major(arr, mesh: DeviceMesh, fill=0) -> torch.Tensor:
    """This rank's rows of a gene-leading array, padded with ``fill`` to a
    multiple of the mesh size, as a local tensor on the rank's device (the
    kernels take local tensors, not DTensors)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    padded, _ = pad_to_multiple(np.asarray(arr), mesh.size(), fill)
    lo, hi = shard_bounds(padded.shape[0], mesh)
    return torch.as_tensor(np.ascontiguousarray(padded[lo:hi]), device=mesh_device(mesh))


def local_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a whole (gathered) gene-leading tensor."""
    lo, hi = shard_bounds(x.shape[0], mesh)
    return x[lo:hi]


# ----------------------------------------------------------------- collectives
def all_reduce_sum(x: torch.Tensor, mesh: DeviceMesh | None) -> torch.Tensor:
    """Sum a contiguous tensor over the ranks, in place; returns it."""
    if mesh is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return x


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``x`` (of one shape on every rank) stacked along a new
    leading axis: ``(R, *x.shape)``."""
    out = torch.empty((mesh.size(),) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().reshape((1,) + tuple(x.shape)), group=mesh.get_group())
    return out


def gather_genes(x: torch.Tensor, mesh: DeviceMesh, n: int | None = None) -> torch.Tensor:
    """The whole gene axis of a sharded gene-leading tensor, cut to its
    first ``n`` rows (default: every rank's padded rows)."""
    whole = all_gather_rows(x, mesh).reshape((-1,) + tuple(x.shape[1:]))
    return whole if n is None else whole[:n]


def gather_gene_dict(tensors: dict, mesh: DeviceMesh, n: int | None = None) -> dict:
    """:func:`gather_genes` of each gene-leading tensor of ``tensors`` (all
    with this rank's rows first) in ONE collective: the tensors are widened
    to one dtype, joined along their trailing axes, gathered, split and cast
    back. float32 where every tensor is float32 or bool, else float64 (exact
    for the bools, small integers, float32 and float64 held here)."""
    if not tensors:
        return {}
    first = next(iter(tensors.values()))
    S = first.shape[0]
    narrow = all(v.dtype in (torch.float32, torch.bool) for v in tensors.values())
    wide = torch.float32 if narrow else torch.float64
    flat = torch.cat([v.reshape(S, -1).to(wide) for v in tensors.values()], dim=1)
    whole = gather_genes(flat, mesh, n)
    out, at = {}, 0
    for k, v in tensors.items():
        w = int(np.prod(v.shape[1:]))
        out[k] = whole[:, at:at + w].reshape((whole.shape[0],) + tuple(v.shape[1:])).to(v.dtype)
        at += w
    return out


class LaneGroup(NamedTuple):
    """One IRLS tile whose lanes are split over consecutive ranks.

    Ranks ``first .. first + members - 1`` each hold an equal share of the
    tile's lanes, in rank order; ``lanes`` is the tile's lane count that
    sizes the rescue (K = min(lanes, max(512, lanes // 64))), and a lane at
    a tile position at or beyond it is padding, never flagged. Every rank of
    the mesh takes part in the group's exchanges, so each rank passes its
    own group, of the same shape, at the same point.
    """

    mesh: DeviceMesh
    first: int
    members: int
    lanes: int

    def position(self) -> int:
        """This rank's place among the group's members."""
        return self.mesh.get_local_rank() - self.first

    def offset(self, local_lanes: int) -> int:
        """Tile position of this rank's first lane."""
        return self.position() * local_lanes

    def counts(self, x: torch.Tensor) -> list[int]:
        """The group members' integer ``x`` (a 0-d tensor) in rank order:
        one collective over the whole mesh (every rank calls this at the
        same point) and one host read."""
        every = all_gather_rows(x.to(torch.int64).reshape(()), self.mesh).tolist()
        return every[self.first:self.first + self.members]
