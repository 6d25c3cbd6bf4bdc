"""Batched apeGLM MAP LFC shrinkage (heavy-tailed Cauchy prior).

Port of ``pydeseq2_tpu/ops/shrink.py``: the apeGLM objective, its exact
gradient and Hessian, the damped batched Newton MAP fit and the 2-D grid
for the lanes where Newton fails (reference pydeseq2/utils.py:990-1207 and
pydeseq2/grid_search.py:224-320), expression for expression.

Kernels: ``csrc/shrink.cu`` replaces ``nbinom_glm_batch`` (shrink.py:101),
whose masked ``while_loop`` advances every gene until the slowest freezes;
one warp per gene runs its own Newton loop, polish and inverse Hessian and
leaves at its own freeze, which is the JAX iterate lane for lane.
``csrc/grid.cu``'s ``grid_apeglm`` replaces ``grid_fit_shrink_beta_batch``
(shrink.py:258), one block per selected lane. On CPU tensors the wrappers
run the plain versions (the masked loop reads its condition from the host
once per outer step); on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

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


def _nbinom_glm_cuda(X, counts, size, offset, pns, ps, shrink_index, maxiter):
    """Launch the ``shrink`` kernel: ``(beta, inv_hessian, converged,
    Newton steps per gene, passes over the row per gene)``."""
    G, N = counts.shape
    P = X.shape[1]
    dtype = counts.dtype
    dev = counts.device
    beta = torch.empty((G, P), dtype=dtype, device=dev)
    ih = torch.empty((G, P, P), dtype=dtype, device=dev)
    conv = torch.empty(G, dtype=torch.uint8, device=dev)
    trips = torch.empty(G, dtype=torch.int32, device=dev)
    passes = torch.empty(G, dtype=torch.int32, device=dev)
    ops = [t.contiguous() for t in (counts, size, offset, X)]
    kernels.check_cuda_operands("shrink", *ops)
    kernels.check_p("shrink", P)
    if not 0 <= shrink_index < P:
        raise ValueError(f"shrink: shrink_index={shrink_index} outside [0, {P})")
    kernels.launch(
        "shrink",
        [int(dtype == torch.float64), P, G, N, *(t.data_ptr() for t in ops),
         float(_scalar(pns, counts)), float(_scalar(ps, counts)), shrink_index, maxiter, _ftol(dtype),
         beta.data_ptr(), ih.data_ptr(), conv.data_ptr(), trips.data_ptr(), passes.data_ptr()],
        dev,
    )
    return beta, ih, conv.bool(), trips, passes


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


def _grid_shrink_cuda(counts, offset, X, size, pns, ps, scale_cnst, shrink_index, grid_length, min_beta,
                      max_beta, sel=None):
    """Launch the ``grid_apeglm`` kernel (one block per selected lane; NaN
    in the lanes not selected)."""
    K, N = counts.shape
    dev = counts.device
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
         grid_length, float(_scalar(pns, counts)), float(_scalar(ps, counts)), shrink_index, beta.data_ptr()],
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
