"""Batched apeGLM MAP LFC shrinkage (heavy-tailed Cauchy prior).

Port of ``pydeseq2_tpu/ops/shrink.py``: the apeGLM objective, its exact
gradient and Hessian, the damped batched Newton MAP fit and the 2-D grid
for the lanes where Newton fails (reference pydeseq2/utils.py:990-1207 and
pydeseq2/grid_search.py:224-320), expression for expression.

Kernels: ``csrc/shrink.cu`` replaces ``nbinom_glm_batch`` (shrink.py:101),
whose masked ``while_loop`` advances every gene until the slowest freezes;
one warp per gene runs its own Newton loop, polish and inverse Hessian and
leaves at its own freeze, which is the JAX iterate lane for lane; in
float32 with P <= 3, after t = 1 a step's backtracking candidates are
evaluated three at a time in one read of the row, the least improving one
kept (:func:`_shrink_round`).
``csrc/grid.cu``'s ``grid_apeglm`` replaces ``grid_fit_shrink_beta_batch``
(shrink.py:258): a thread-block cluster per selected lane, its blocks
splitting the grid's rows (:func:`_grid_plan`, whose rule ``grid_nb`` shares),
the terms of samples whose design row has a zero computed once per row or
column. On CPU tensors the
wrappers run the plain versions (the masked loop reads its condition from
the host once per outer step); on CUDA tensors they launch the kernels or
raise. The adaptive prior variance the fit's scale comes from
(:func:`_apeglm_prior_variance`) is a bisection on the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops.dispersion import first_argmin
from pydeseq2_tpu_torch.ops.irls import grid_axes
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv, sym_solve, weighted_gram


def _masks(P: int, shrink_index: int, dtype, device):
    shrink_mask = torch.zeros(P, dtype=dtype, device=device)
    shrink_mask[shrink_index] = 1.0
    return shrink_mask, 1.0 - shrink_mask


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor on the device of ``like`` (a Python scalar divisor on
    the card would be applied as a product with its reciprocal)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp``: max + log1p(exp(-|a - b|)), a + b where a - b is NaN."""
    delta = a - b
    out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), a + b, out)


def nbinom_fn_batch(beta, design_matrix, counts, size, offset, prior_no_shrink_scale, prior_scale,
                    shrink_index: int):
    """apeGLM objective: Cauchy + normal prior minus NB log-likelihood.

    beta (G, P); counts (G, N); size (G,); offset (N,). Port of
    ``pydeseq2_tpu/ops/shrink.py:23``.
    """
    P = design_matrix.shape[1]
    _, no_shrink_mask = _masks(P, shrink_index, beta.dtype, beta.device)
    pns = _scalar(prior_no_shrink_scale, beta)
    ps = _scalar(prior_scale, beta)
    xbeta = beta @ design_matrix.T
    beta_s = beta[:, shrink_index]
    prior = ((beta * no_shrink_mask) ** 2).sum(-1) / (2.0 * pns**2) + torch.log1p((beta_s / ps) ** 2)
    log_size = torch.log(size)[:, None]
    ll = (counts * xbeta - (counts + size[:, None]) * _logaddexp(xbeta + offset[None, :], log_size)).sum(-1)
    return prior - ll


def _grad(beta, X, counts, size, offset, pns, ps, shrink_index):
    """Exact gradient. Port of ``pydeseq2_tpu/ops/shrink.py:56``."""
    shrink_mask, no_shrink_mask = _masks(X.shape[1], shrink_index, beta.dtype, beta.device)
    pns, ps = _scalar(pns, beta), _scalar(ps, beta)
    xbeta = beta @ X.T
    beta_s = beta[:, shrink_index]
    d_neg_prior = beta * no_shrink_mask[None, :] / pns**2 + (
        2.0 * beta * shrink_mask[None, :]
    ) / (ps**2 + beta_s**2)[:, None]
    d_nll = (counts - (counts + size[:, None]) / (1.0 + size[:, None] * torch.exp(-xbeta - offset[None, :]))) @ X
    return d_neg_prior - d_nll


def _hess(beta, X, counts, size, offset, pns, ps, shrink_index):
    """Exact Hessian. Port of ``pydeseq2_tpu/ops/shrink.py:73``. ``frac``
    keeps the JAX expression: it is 0 in float32 where (s + e)^2 overflows."""
    shrink_mask, no_shrink_mask = _masks(X.shape[1], shrink_index, beta.dtype, beta.device)
    pns, ps = _scalar(pns, beta), _scalar(ps, beta)
    xbeta = beta @ X.T
    exp_xbeta_off = torch.exp(xbeta + offset[None, :])
    frac = (counts + size[:, None]) * size[:, None] * exp_xbeta_off / (size[:, None] + exp_xbeta_off) ** 2
    beta_s = beta[:, shrink_index]
    h11 = 1.0 / pns**2
    h22 = 2.0 * (ps**2 - beta_s**2) / (ps**2 + beta_s**2) ** 2
    diag = no_shrink_mask[None, :] * h11 + shrink_mask[None, :] * h22[:, None]
    return weighted_gram(X, frac) + _diag_embed(diag)


def _diag_embed(d: torch.Tensor) -> torch.Tensor:
    """(G, P) -> (G, P, P) diagonal matrices."""
    P = d.shape[-1]
    return d[..., None] * torch.eye(P, dtype=d.dtype, device=d.device)[None]


def _ftol(dtype) -> float:
    """The freeze tolerance, 10 eps of the dtype (shrink.py:172)."""
    return 10.0 * torch.finfo(dtype).eps


def _nbinom_glm_plain(X, counts, size, offset, pns, ps, shrink_index, maxiter):
    G = counts.shape[0]
    P = X.shape[1]
    dtype = counts.dtype
    dev = counts.device
    eye = torch.eye(P, dtype=dtype, device=dev)
    args = (X, counts, size, offset, pns, ps, shrink_index)

    beta_init = (0.1 * (-1.0) ** torch.arange(P, dtype=dtype, device=dev)).expand(G, P).clone()
    beta_init[:, 0] = torch.log(torch.clamp((counts * torch.exp(-offset)[None, :]).mean(-1), min=0.1))
    zeros = torch.zeros((G, P), dtype=dtype, device=dev)
    cnst = torch.clamp(nbinom_fn_batch(zeros, X, counts, size, offset, pns, ps, shrink_index), min=1.0)

    def f(beta):
        return nbinom_fn_batch(beta, X, counts, size, offset, pns, ps, shrink_index) / cnst

    ftol = _ftol(dtype)
    beta, f_val = beta_init, f(beta_init)
    done = torch.zeros(G, dtype=torch.bool, device=dev)
    prev_small = torch.zeros(G, dtype=torch.bool, device=dev)
    i = 0
    # Host-evaluated while_loop condition (shrink.py:174-176).
    while i < maxiter and not bool(done.all()):
        g = _grad(beta, *args) / cnst[:, None]
        H = _hess(beta, *args) / cnst[:, None, None]
        step = sym_solve(H + 1e-10 * eye, g)
        t = torch.ones(G, dtype=dtype, device=dev)
        best_beta, best_f = beta, f_val
        captured = torch.zeros(G, dtype=torch.bool, device=dev)
        for _ in range(16):
            cand = beta - t[:, None] * step
            f_cand = f(cand)
            improve = (f_cand < best_f) & ~captured
            best_beta = torch.where(improve[:, None], cand, best_beta)
            best_f = torch.where(improve, f_cand, best_f)
            captured = captured | improve
            t = t * 0.5
        beta_new = torch.where(done[:, None], beta, best_beta)
        f_new = torch.where(done, f_val, best_f)
        small = (f_val - f_new) < ftol * (torch.abs(f_new) + 1.0)
        done = done | ~captured | (small & prev_small)
        beta, f_val, prev_small = beta_new, f_new, small
        i += 1

    # Gradient-gated Newton polish (shrink.py:225-247).
    g_s = _grad(beta, *args) / cnst[:, None]
    for _ in range(2):
        H_s = _hess(beta, *args) / cnst[:, None, None] + 1e-10 * eye
        cand = beta - sym_solve(H_s, g_s)
        g_c = _grad(cand, *args) / cnst[:, None]
        better = (
            torch.isfinite(cand).all(dim=1)
            & (torch.abs(cand) <= 30.0).all(dim=1)
            & (torch.abs(g_c).amax(dim=1) < torch.abs(g_s).amax(dim=1))
        )
        beta = torch.where(better[:, None], cand, beta)
        g_s = torch.where(better[:, None], g_c, g_s)
    converged = torch.isfinite(beta).all(dim=1) & (torch.abs(g_s).amax(dim=1) < 1e-6)
    return beta, sym_inv(_hess(beta, *args)), converged


def _shrink_round(dtype, P: int) -> int:
    """The candidates a backtracking round of the ``shrink`` kernel
    evaluates in one read of the row after t = 1 alone: 3 in float32 with
    P <= 3, else 1 (a pass a candidate). On the H100 rounds of 3 took less
    than one candidate a pass in float32 at 100 and 1000 samples, and every
    other round size measured took more (PERF.md section 6); the kernel
    builds rounds of 3 for P <= 3 only."""
    return 3 if dtype == torch.float32 and P <= 3 else 1


def _nbinom_glm_cuda(X, counts, size, offset, pns, ps, shrink_index, maxiter, cands=None):
    """Launch the ``shrink`` kernel: ``(beta, inv_hessian, converged,
    Newton steps, passes, evaluations, reads of the row)``, the last four
    per gene: the passes over the row that the JAX order needs (one
    candidate a read), the evaluations made (every candidate of a round),
    the reads. ``cands`` overrides :func:`_shrink_round`."""
    G, N = counts.shape
    P = X.shape[1]
    dtype = counts.dtype
    dev = counts.device
    cands = _shrink_round(dtype, P) if cands is None else cands
    beta = torch.empty((G, P), dtype=dtype, device=dev)
    ih = torch.empty((G, P, P), dtype=dtype, device=dev)
    conv = torch.empty(G, dtype=torch.uint8, device=dev)
    trips = torch.empty(G, dtype=torch.int32, device=dev)
    passes = torch.empty(G, dtype=torch.int32, device=dev)
    evals = torch.empty(G, dtype=torch.int32, device=dev)
    rounds = torch.empty(G, dtype=torch.int32, device=dev)
    ops = [t.contiguous() for t in (counts, size, offset, X)]
    kernels.check_cuda_operands("shrink", *ops)
    kernels.check_p("shrink", P)
    if not 0 <= shrink_index < P:
        raise ValueError(f"shrink: shrink_index={shrink_index} outside [0, {P})")
    if cands != 1 and (cands != 3 or P > 3):
        raise ValueError(f"shrink: {cands} candidates a round at P={P}; the kernel takes 1, or 3 where P <= 3")
    kernels.launch(
        "shrink",
        [int(dtype == torch.float64), P, G, N, *(t.data_ptr() for t in ops),
         float(_scalar(pns, counts)), float(_scalar(ps, counts)), shrink_index, maxiter, _ftol(dtype), cands,
         beta.data_ptr(), ih.data_ptr(), conv.data_ptr(), trips.data_ptr(), passes.data_ptr(), evals.data_ptr(),
         rounds.data_ptr()],
        dev,
    )
    return beta, ih, conv.bool(), trips, passes, evals, rounds


def nbinom_glm_batch(
    design_matrix: torch.Tensor,
    counts: torch.Tensor,
    size: torch.Tensor,
    offset: torch.Tensor,
    prior_no_shrink_scale,
    prior_scale,
    shrink_index: int = 1,
    maxiter: int = 60,
):
    """Batched apeGLM MAP fit: ``(beta (G, P), inv_hessian (G, P, P) of the
    UNscaled objective, converged (G,))``. CUDA tensors launch the
    ``shrink`` kernel. Contract: ``pydeseq2_tpu/ops/shrink.py:101``."""
    args = (design_matrix, counts, size, offset, prior_no_shrink_scale, prior_scale, shrink_index, maxiter)
    if counts.is_cuda:
        return _nbinom_glm_cuda(*args)[:3]
    return _nbinom_glm_plain(*args)


def _grid_shrink_plain(counts, offset, X, size, pns, ps, scale_cnst, shrink_index, grid_length, min_beta,
                       max_beta):
    dtype = counts.dtype
    dev = counts.device
    G = counts.shape[0]

    def eval_row(x_val_g, y_grid_g):
        K = y_grid_g.shape[1]
        betas = torch.stack([x_val_g[:, None].expand(G, K), y_grid_g], dim=-1).reshape(G * K, 2)
        obj = nbinom_fn_batch(betas, X, counts.repeat_interleave(K, dim=0), size.repeat_interleave(K), offset,
                              pns, ps, shrink_index)
        return obj.reshape(G, K) / scale_cnst[:, None]

    def search(x_grid_g, y_grid_g):
        best_f = torch.full((G,), float("inf"), dtype=dtype, device=dev)
        best_x = torch.zeros(G, dtype=dtype, device=dev)
        best_y = torch.zeros(G, dtype=dtype, device=dev)
        for k in range(x_grid_g.shape[1]):
            fvals = eval_row(x_grid_g[:, k], y_grid_g)
            j = first_argmin(fvals.T)[:, None]
            f_row = fvals.gather(1, j)[:, 0]
            better = f_row < best_f
            best_f = torch.where(better, f_row, best_f)
            best_x = torch.where(better, x_grid_g[:, k], best_x)
            best_y = torch.where(better, y_grid_g.gather(1, j)[:, 0], best_y)
        return best_x, best_y

    base, offs = grid_axes(min_beta, max_beta, grid_length, dtype, dev)
    base_g = base.expand(G, grid_length)
    bx, by = search(base_g, base_g)
    fx, fy = search(bx[:, None] + offs[None, :], by[:, None] + offs[None, :])
    return torch.stack([fx, fy], dim=1)


class GridPlan(NamedTuple):
    """Launch plan of the grid kernels (``grid_apeglm``, ``grid_nb``):
    clusters of ``K`` blocks a selected lane, block rank q taking the grid
    rows :func:`_grid_rows` ``(L, K, q)`` of both passes, and ``chunk``
    samples (a multiple of 256) staged at a time."""

    K: int
    chunk: int


_GRID_THREADS = 256  # threads of a grid block
_GRID_WARPS = _GRID_THREADS // 32
# Values a sample each kernel stages (x0, x1 and its objective's own).
_GRID_ARRAYS = {"grid_apeglm": 5, "grid_nb": 8}
# Blocks an H100 SM holds by registers, from the build's ptxas report
# (grid_apeglm: 64 registers a thread in float32, 80 in float64): the
# plan's default where no card is asked (the wrappers ask the occupancy API).
_GRID_REG_BLOCKS = {("grid_apeglm", 4): 4, ("grid_apeglm", 8): 3, ("grid_nb", 4): 4, ("grid_nb", 8): 3}
_GRID_SMEM_SM = 233_472  # shared memory of an H100 SM, bytes
_GRID_MAX_V = 4  # samples a thread classifies a chunk, at most
# The share of a lane's work that every block of its cluster repeats
# whatever K (staging the chunk, the column totals, the cluster's joins),
# and the share of an SM's resident blocks below which a round of blocks
# runs no faster (too few warps to hide the latency of a term's chain);
# both fitted to a sweep of K on the H100 (PERF.md section 6).
_GRID_BLOCK_FIXED = 1 / 32
_GRID_LATENCY_SHARE = 3 / 4


def _grid_rows(L: int, K: int, q: int) -> range:
    """The grid rows of block rank q of K (the kernel's ``row0``)."""
    return range(q * L // K, (q + 1) * L // K)


def _grid_smem_bytes(L: int, K: int, chunk: int, itemsize: int, arrays: int = 5) -> int:
    """Dynamic shared memory of one grid block (the kernel's
    ``grid_smem_bytes``): float64 totals of its points, rows and columns and
    the slice partials, the class counts, the candidates, the staged chunk
    (``arrays`` values a sample)."""
    R = -(-L // K)
    return (8 * (R * L + R + L + 3 * _GRID_THREADS) + kernels.align16(4 * (3 * _GRID_WARPS + 2))
            + 16 * (2 + _GRID_WARPS) + arrays * chunk * itemsize)


def _grid_reg_per_sm(itemsize: int, smem: int, kernel: str = "grid_apeglm") -> int:
    """The blocks an H100 SM holds by the ptxas registers (_GRID_REG_BLOCKS)
    and by shared memory (1 KB reserved a block)."""
    return max(1, min(_GRID_REG_BLOCKS[kernel, itemsize], _GRID_SMEM_SM // (smem + 1024)))


@functools.lru_cache(maxsize=None)
def _grid_card_per_sm(device: torch.device, itemsize: int, smem: int, kernel: str = "grid_apeglm") -> int:
    """The blocks of ``kernel`` an SM of ``device`` holds, by the occupancy
    API for this build (no launch)."""
    out = ctypes.c_int(0)
    kernels.call_helper(f"{kernel}_per_sm", [int(itemsize == 8), smem, ctypes.addressof(out)], device)
    return max(1, out.value)


def _grid_cost(lanes: int, K: int, sms: int, per_sm: int) -> float:
    """The wave rule's time of ``lanes`` selected lanes on clusters of K, in
    units of one lane's work on one block: an SM runs n = ceil(lanes K /
    sms) blocks in rounds of the ``per_sm`` it holds, each block 1/K of a
    lane plus the fixed share every block repeats, and a round of fewer
    blocks runs no faster than 3/4 of a full one would."""
    n = -(-lanes * K // sms)
    full, rest = divmod(n, per_sm)
    blocks = full * per_sm + (max(rest, _GRID_LATENCY_SHARE * per_sm) if rest else 0)
    return blocks * (1.0 / K + _GRID_BLOCK_FIXED)


def _grid_plan(lanes: int, N: int, L: int, itemsize: int, sms: int = 132, per_sm=None,
               kernel: str = "grid_apeglm") -> GridPlan:
    """The plan of ``kernel`` for ``lanes`` selected lanes of N samples on an
    L x L grid, on a card with ``sms`` SMs that each hold ``per_sm(smem)``
    blocks of ``smem`` bytes at once (default :func:`_grid_reg_per_sm`; the
    wrappers ask the occupancy API).

    K: the power of two, at most 16 and at most L (every block holds a row),
    whose blocks fit their shared memory and take the least time by
    :func:`_grid_cost` (ties to the smaller K): 1-16 lanes take 16, 64
    lanes 8, 256 and 937 lanes 2, 494 lanes 1 (float32, 4 blocks an SM;
    in float64, 3 an SM, 64 and 494 lanes 4, 256 lanes 1, 937 lanes 2).
    grid_nb's wrapper counts only the selected lanes, from its caller's one
    host read; grid_apeglm's counts the tile. chunk: 256 x ceil(N / 256)
    samples, at most 1024.
    """
    if L < 1:
        raise ValueError(f"{kernel}: grid_length={L}")
    if per_sm is None:
        per_sm = functools.partial(_grid_reg_per_sm, itemsize, kernel=kernel)
    chunk = _GRID_THREADS * min(_GRID_MAX_V, max(1, -(-N // _GRID_THREADS)))
    k_max = min(kernels.MAX_CLUSTER, 1 << (L.bit_length() - 1))
    best = None
    K = 1
    while K <= k_max:
        smem = _grid_smem_bytes(L, K, chunk, itemsize, _GRID_ARRAYS[kernel])
        if smem <= kernels.SMEM_BLOCK_MAX:
            cost = _grid_cost(max(1, lanes), K, sms, per_sm(smem))
            if best is None or cost < best[0]:
                best = (cost, K)
        K *= 2
    if best is None:
        raise ValueError(f"{kernel}: a {L} x {L} grid does not fit {kernels.MAX_CLUSTER} blocks' shared memory")
    return GridPlan(best[1], chunk)


def _grid_device_plan(lanes: int, N: int, L: int, dtype, device, kernel: str = "grid_apeglm") -> GridPlan:
    """The plan the wrapper picks on ``device``: :func:`_grid_plan` with the
    card's SMs and its occupancy for this build of ``kernel``."""
    isz = torch.empty((), dtype=dtype).element_size()
    dev = torch.device(device)
    return _grid_plan(lanes, N, L, isz, kernels.sm_count(dev),
                      functools.partial(_grid_card_per_sm, dev, isz, kernel=kernel), kernel)


def _grid_shrink_cuda(counts, offset, X, size, pns, ps, scale_cnst, shrink_index, grid_length, min_beta,
                      max_beta, sel=None, plan=None):
    """Launch the ``grid_apeglm`` kernel (a cluster per selected lane; NaN
    in the lanes not selected); ``plan`` (a :class:`GridPlan`) overrides
    :func:`_grid_plan`."""
    K, N = counts.shape
    dev = counts.device
    if plan is None:
        plan = _grid_device_plan(K, N, grid_length, counts.dtype, dev)
    base, offs = grid_axes(min_beta, max_beta, grid_length, counts.dtype, dev)
    beta = torch.empty((K, 2), dtype=counts.dtype, device=dev)
    ops = [t.contiguous() for t in (counts, offset, X, size, scale_cnst, base, offs)]
    kernels.check_cuda_operands("grid_apeglm", *ops)
    kernels.check_p2("grid_apeglm", X.shape[1])
    sel8 = kernels.check_sel("grid_apeglm", sel, K)
    if shrink_index not in (0, 1):
        raise ValueError(f"grid_apeglm: shrink_index={shrink_index} outside [0, 2)")
    counts, offset, X, size, scale_cnst, base, offs = ops
    kernels.launch(
        "grid_apeglm",
        [int(counts.dtype == torch.float64), K, N, counts.data_ptr(), offset.data_ptr(), X.data_ptr(),
         size.data_ptr(), scale_cnst.data_ptr(), kernels.ptr(sel8), base.data_ptr(), offs.data_ptr(),
         grid_length, float(_scalar(pns, counts)), float(_scalar(ps, counts)), shrink_index, plan.K, plan.chunk,
         beta.data_ptr()],
        dev,
    )
    return beta


def grid_fit_shrink_beta_batch(
    counts: torch.Tensor,
    offset: torch.Tensor,
    design_matrix: torch.Tensor,
    size: torch.Tensor,
    prior_no_shrink_scale,
    prior_scale,
    scale_cnst: torch.Tensor,
    shrink_index: int = 1,
    grid_length: int = 60,
    min_beta: float = -30.0,
    max_beta: float = 30.0,
    sel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Coarse then fine 2-D grid of the apeGLM objective for P == 2
    designs, (K, 2). Port of ``pydeseq2_tpu/ops/shrink.py:258``.

    ``sel`` (K,) bool marks the lanes whose result the caller uses: the
    ``grid_apeglm`` kernel (CUDA tensors) searches only those and returns
    NaN for the others; the plain version ignores it.
    """
    args = (counts, offset, design_matrix, size, prior_no_shrink_scale, prior_scale, scale_cnst, shrink_index,
            grid_length, min_beta, max_beta)
    if counts.is_cuda:
        return _grid_shrink_cuda(*args, sel)
    return _grid_shrink_plain(*args)


def _apeglm_prior_variance(
    mle_lfc: np.ndarray,
    se: np.ndarray,
    lo: float = 1e-6,
    hi: float = 400.0,
    iters: int = 80,
) -> float:
    """apeGLM adaptive prior variance (reference pydeseq2/ds.py:552-588).

    Solves g(a) = sum_i w_i(a) (S_i - D_i) / sum_i w_i(a) - a = 0 with
    w_i = (a + D_i)^-2, where S = squared MLE LFCs and D = squared SEs, by
    bisection on [lo, hi] (g is continuous; g(lo) < 0 short-circuits to lo as
    in the reference). ~80 halvings reach ~1e-15 relative width. Port of
    ``pydeseq2_tpu/models/stats.py:110``.
    """
    ok = ~np.isnan(mle_lfc)
    S = np.square(mle_lfc[ok])
    D = np.square(se[ok])

    def resid(a: float) -> float:
        w = 1.0 / np.square(a + D)
        return float((w * (S - D)).sum() / w.sum()) - a

    if resid(lo) < 0:
        return lo
    a_lo, a_hi = lo, hi
    for _ in range(iters):
        mid = 0.5 * (a_lo + a_hi)
        if resid(mid) > 0:
            a_lo = mid
        else:
            a_hi = mid
    return 0.5 * (a_lo + a_hi)
