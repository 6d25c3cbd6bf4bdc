"""Batched NB-GLM coefficient fitting: masked IRLS, rescue tiers, hat
diagonals.

Port of ``pydeseq2_tpu/ops/irls.py``. The update W = mu/(1 + mu alpha),
z = log(mu/sf) + (y - mu)/mu, beta = (X^T W X + 1e-6 I)^-1 X^T W z and the
deviance stop |dev - dev_old|/(|dev| + 0.1) < beta_tol mirror the reference
(pydeseq2/utils.py:359-421); ``step_tol`` adds the f32 stop after two
consecutive sub-tolerance steps, and an f32 Newton polish gated on the
gradient sup-norm follows the loop.

Kernel (``csrc/irls.cu``): replaces ``irls_core`` (pydeseq2_tpu/ops/
irls.py:45), a masked ``lax.while_loop`` that advances every lane until the
slowest is done. A group of lanes (:func:`_irls_plan`: 4, 8 or 32 lanes a
gene, or a block at atlas widths) runs one gene's loop and leaves it when the
gene stops, so a lane's trip count while it is active equals the JAX
loop's ``it`` and the result is the same lane for lane. Each trip is one
pass over the gene's row: mu from the new coefficients, the mu-part of the
deviance, and the Gram X^T W X and X^T W z for the next trip, reduced
together over the group's lanes; the P x P solve is scalar work in
registers. The kernel first computes every gene's deviance constant
(``nll_const``, float64 sums rounded once) in a phase of its own, so the
CUDA route runs no (G, N) pass in PyTorch. The grid is persistent: a group
whose gene stopped takes the next from a global counter. On the H100 it is bound by the
issue rate of each sample's exp, log1p and divisions and by the tail of
slow genes.

The plain version (CPU tensors only) is the masked loop of the JAX package.

The rescue tiers have kernels too: ``csrc/newton_box.cu`` (the projected
Newton box solver, a block a selected lane with its row staged in shared
memory, :func:`_box_plan`: a block-wide gradient and Hessian pass and the 13
backtracking candidates in one pass, a warp each, so a step costs two
serial passes over the row) and ``csrc/grid.cu``'s ``grid_nb`` (the 2-D
grid, one block per selected lane). Both take ``sel``, the lanes of the
compacted tile whose result the caller uses, and do no work for the
others. :func:`hat_diagonals` on CUDA tensors launches the hat-only entry
of ``csrc/hat_wald.cu`` (``hat``, the class API's ``TorchInference.irls``);
its plain version is the hat half of ``ops/wald.py:hat_wald``'s.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from pydeseq2_tpu_torch import kernels, tracing
from pydeseq2_tpu_torch.ops.dispersion import first_argmin
from pydeseq2_tpu_torch.ops.nb import nb_nll
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv, sym_solve, weighted_gram


def _mu_from_xb(beta, X, size_factors, log_sf, min_mu, log_min_mu):
    """mu = max(sf e^{Xb}, min_mu) plus log(mu) and log(mu/sf) from the
    linear predictor (only min_mu-clamped entries need the constants)."""
    xb = beta @ X.T
    raw = size_factors[None, :] * torch.exp(xb)
    clamped = raw < min_mu
    mu = torch.where(clamped, min_mu, raw)
    log_mu = torch.where(clamped, log_min_mu, xb + log_sf)
    log_mu_sf = torch.where(clamped, log_min_mu - log_sf, xb)
    return mu, log_mu, log_mu_sf


def _mu_part(counts, y_plus_r, r, mu, log_mu):
    ylogmu = torch.where(counts > 0, counts * log_mu, torch.zeros_like(log_mu))
    return (y_plus_r * torch.log1p(mu / r) - ylogmu).sum(-1)


def _ridged_grad(b, counts, X, size_factors, disp, min_mu):
    mu = torch.clamp(size_factors[None, :] * torch.exp(b @ X.T), min=min_mu)
    inv_disp = (1.0 / disp)[:, None]
    t = (inv_disp + counts) * mu / (inv_disp + mu)
    return (t - counts) @ X + 1e-6 * b, mu


def _irls_plain(counts, size_factors, X, disp, beta_init, nll_const, log_sf, min_mu,
                log_min_mu, beta_tol, max_beta, maxiter, step_tol, polish_iters):
    G = counts.shape[0]
    P = X.shape[1]
    dtype = beta_init.dtype
    dev = counts.device
    ridge = 1e-6 * torch.eye(P, dtype=dtype, device=dev)
    r = 1.0 / disp[:, None]
    y_plus_r = counts + r

    beta = beta_init
    mu, _, log_mu_sf = _mu_from_xb(beta, X, size_factors, log_sf, min_mu, log_min_mu)
    dev_ = torch.full((G,), 1000.0, dtype=dtype, device=dev)
    active = torch.ones(G, dtype=torch.bool, device=dev)
    needs_fb = torch.zeros(G, dtype=torch.bool, device=dev)
    prev_small = torch.zeros(G, dtype=torch.bool, device=dev)
    it = 0
    # Host-evaluated while_loop condition (irls.py:175-177).
    while it < maxiter and bool(active.any()):
        W = mu / (1.0 + mu * disp[:, None])
        z = log_mu_sf + (counts - mu) / mu
        M = weighted_gram(X, W) + ridge
        rhs = (W * z) @ X
        beta_hat = sym_solve(M, rhs)

        it += 1
        diverged = (torch.abs(beta_hat) > max_beta).any(dim=1)
        new_fb = active & (diverged | (it >= maxiter))
        step_ok = active & ~new_fb

        new_beta = torch.where(step_ok[:, None], beta_hat, beta)
        new_mu, new_log_mu, new_log_mu_sf = _mu_from_xb(
            new_beta, X, size_factors, log_sf, min_mu, log_min_mu
        )
        new_dev = -2.0 * (nll_const + _mu_part(counts, y_plus_r, r, new_mu, new_log_mu))
        dev_ratio = torch.abs(new_dev - dev_) / (torch.abs(new_dev) + 0.1)
        still_active = step_ok & (dev_ratio > beta_tol)
        step_small = torch.zeros(G, dtype=torch.bool, device=dev)
        if step_tol > 0.0:
            step_small = torch.abs(beta_hat - beta).amax(dim=1) <= step_tol
            still_active = still_active & ~(step_small & prev_small)

        dev_ = torch.where(step_ok, new_dev, dev_)
        beta, mu, log_mu_sf = new_beta, new_mu, new_log_mu_sf
        active, needs_fb, prev_small = still_active, needs_fb | new_fb, step_small
    needs_fb = needs_fb | active
    n_iter = torch.tensor(it, dtype=torch.int32, device=dev)

    if step_tol > 0.0 and polish_iters > 0:
        polish_cap = 100.0 * step_tol
        b = beta
        for _ in range(polish_iters):
            g, mu = _ridged_grad(b, counts, X, size_factors, disp, min_mu)
            w = mu * (1.0 + disp[:, None] * counts) / (1.0 + disp[:, None] * mu) ** 2
            H = weighted_gram(X, w) + ridge
            cand = b - sym_solve(H, g)
            ok = (
                torch.isfinite(cand).all(dim=1)
                & (torch.abs(cand) <= max_beta).all(dim=1)
                & (torch.abs(cand - b).amax(dim=1) <= polish_cap)
            )
            b = torch.where(ok[:, None], cand, b)
        g_new = torch.abs(_ridged_grad(b, counts, X, size_factors, disp, min_mu)[0]).amax(dim=1)
        g_old = torch.abs(_ridged_grad(beta, counts, X, size_factors, disp, min_mu)[0]).amax(dim=1)
        beta = torch.where((g_new < g_old)[:, None], b, beta)
    return beta, needs_fb, n_iter


class IrlsPlan(NamedTuple):
    """A launch of the ``irls`` kernel: ``lanes`` a gene (4, 8, 32, or 256:
    a block)."""

    lanes: int


_IRLS_THREADS = 256  # a block (csrc/irls.cu)
_IRLS_BLOCK = 256  # lanes of a block a gene
_IRLS_BLOCK_MIN_N = 2_048  # samples from which a gene takes a block
_IRLS_LANE_SAMPLES = 16  # samples a lane per pass, at most, for fewer than 32 lanes
_IRLS_PER_SM = 4  # blocks an SM holds without the card to ask (ptxas: ~64 registers a thread)


def _irls_lane_choices(P: int) -> tuple[int, ...]:
    """The group sizes below a block built for a design of P columns
    (csrc/irls.cu)."""
    return (4, 8, 32) if P <= 3 else (8, 32)


def _irls_plan(G: int, N: int, P: int, sms: int = 132,
               per_sm: Callable[[int], int] = lambda lanes: _IRLS_PER_SM) -> IrlsPlan:
    """The plan for G genes of N samples and P coefficients; ``per_sm(lanes)``
    is the blocks of that group size an SM holds (the wrapper asks the
    occupancy API, as the launch does).

    A block a gene from 2048 samples; below, the fewest lanes (4, 8) with
    at most 16 samples a lane a pass whose groups fill the card, G x lanes
    >= ``sms`` x the lanes an SM holds; else 32. P > 3 builds no 4. A
    ``kernel_bench --detail`` sweep on an H100 chose these (f32, P = 2,
    ``maxiter=8``): 12 x 60000 4 lanes 0.093 ms against 0.113 with 8; 100 x
    60000 8 lanes 0.381 (4: 0.387, 32: 0.392); 200 x 60000 32 lanes 0.625
    (8: 0.682); 1000 x 60000 32 lanes 2.53 (8: 3.38, a block 3.48); the
    atlas refit block, 5000 x 10000, a block 2.60 (32: 4.04). 16 lanes won
    no shape. The phase-2 tile's 937 genes cannot fill the card: a block a
    gene read 0.030 ms against 32 lanes' 0.038, but moved the slowest lane
    of the P = 5 tile 4 trips from the plain loop's, so short gene lists
    keep 32.
    """
    if N >= _IRLS_BLOCK_MIN_N:
        return IrlsPlan(_IRLS_BLOCK)
    fills = [s for s in _irls_lane_choices(P)
             if s < 32 and -(-N // s) <= _IRLS_LANE_SAMPLES and G * s >= sms * per_sm(s) * _IRLS_THREADS]
    return IrlsPlan(fills[0] if fills else 32)


@functools.lru_cache(maxsize=None)
def _irls_card_per_sm(device: torch.device, itemsize: int, P: int, lanes: int) -> int:
    """The blocks of the ``irls`` kernel of ``lanes`` a gene that an SM of
    ``device`` holds, by the occupancy API for this build (no launch)."""
    out = ctypes.c_int(0)
    kernels.call_helper("irls_per_sm", [int(itemsize == 8), P, lanes, ctypes.addressof(out)], device)
    return max(1, out.value)


def _irls_device_plan(G: int, N: int, P: int, dtype, device) -> IrlsPlan:
    """:func:`_irls_plan` with the card's SMs and its occupancy."""
    isz = torch.empty((), dtype=dtype).element_size()
    dev = torch.device(device)
    return _irls_plan(G, N, P, kernels.sm_count(dev), functools.partial(_irls_card_per_sm, dev, isz, P))


def _irls_cuda(counts, size_factors, X, disp, beta_init, log_sf, min_mu, beta_tol, max_beta, maxiter, step_tol,
               polish_iters, plan: IrlsPlan | None = None):
    """Launch the ``irls`` kernel: ``(beta, needs_fb, trips per lane)``.
    The kernel computes each gene's deviance constant itself; ``plan``
    overrides :func:`_irls_plan`."""
    G, N = counts.shape
    P = X.shape[1]
    dev = counts.device
    if plan is None:
        plan = _irls_device_plan(G, N, P, counts.dtype, dev)
    if plan.lanes not in _irls_lane_choices(P) + (_IRLS_BLOCK,):
        raise ValueError(f"irls: {plan.lanes} lanes a gene are not built for P={P}")
    beta = torch.empty((G, P), dtype=beta_init.dtype, device=dev)
    needs_fb = torch.empty(G, dtype=torch.uint8, device=dev)
    trips = torch.empty(G, dtype=torch.int32, device=dev)
    # genes handed out past each group's first, blocks past the constants' barrier
    counter = torch.zeros(2, dtype=torch.int32, device=dev)
    nll_const = torch.empty(G, dtype=beta_init.dtype, device=dev)  # the kernel's workspace
    ops = [t.contiguous() for t in (counts, size_factors, log_sf, X, disp, beta_init)]
    kernels.check_cuda_operands("irls", *ops, beta)
    kernels.check_p("irls", P)
    kernels.launch(
        "irls",
        [
            int(counts.dtype == torch.float64), P, G, N,
            *(t.data_ptr() for t in ops),
            float(min_mu), float(beta_tol), float(max_beta), float(step_tol),
            maxiter, polish_iters, plan.lanes,
            counter.data_ptr(), nll_const.data_ptr(), beta.data_ptr(), needs_fb.data_ptr(), trips.data_ptr(),
        ],
        dev,
    )
    return beta, needs_fb.bool(), trips


def _irls_core_cuda(counts, size_factors, X, disp, beta_init, min_mu, beta_tol, max_beta, maxiter, step_tol,
                    polish_iters, want_iters=False):
    """``irls_core``'s CUDA route: ``(beta, needs_fb, n_iter)``. The
    slowest lane's trips ``n_iter`` (one reduction launch) are made where
    ``want_iters`` or tracing is on, and recorded in
    ``kernels.STATS.irls_trips`` while tracing is on; else ``n_iter`` is
    None. Nothing of shape (G, N) runs here: the kernel computes the
    deviance constant."""
    log_sf = torch.log(size_factors)
    beta, needs_fb, trips = _irls_cuda(counts, size_factors, X, disp, beta_init, log_sf, min_mu, beta_tol,
                                       max_beta, maxiter, step_tol, polish_iters)
    n_iter = None
    if want_iters or tracing.active():
        n_iter = trips.amax() if trips.numel() else torch.zeros((), dtype=torch.int32, device=counts.device)
        if tracing.active():
            kernels.STATS.irls_trips.append(n_iter)
    return beta, needs_fb, n_iter


def irls_core(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    beta_init: torch.Tensor,
    min_mu: float = 0.5,
    beta_tol: float = 1e-8,
    max_beta: float = 30.0,
    maxiter: int = 250,
    step_tol: float | None = None,
    polish_iters: int = 2,
    return_iters: bool = False,
):
    """Masked-lane batched IRLS: ``(beta, needs_fallback, converged)``, plus
    the trip count of the slowest lane (JAX's ``n_iter``) with
    ``return_iters``. ``step_tol=None`` is 1e-5 in f32 and off in f64.
    CUDA tensors launch the ``irls`` kernel. Contract:
    ``pydeseq2_tpu/ops/irls.py:45``.
    """
    X = design_matrix
    dtype = beta_init.dtype
    if step_tol is None:
        step_tol = 1e-5 if dtype == torch.float32 else 0.0
    if counts.is_cuda:
        beta, needs_fb, n_iter = _irls_core_cuda(counts, size_factors, X, disp, beta_init, min_mu, beta_tol,
                                                 max_beta, maxiter, step_tol, polish_iters, return_iters)
    else:
        # The lgamma part of the deviance is hoisted out of the loop: the
        # stop compares deviance differences, in which it cancels exactly.
        log_sf = torch.log(size_factors)[None, :]
        log_min_mu = torch.log(torch.tensor(min_mu, dtype=dtype, device=counts.device))
        mu0, log_mu0, _ = _mu_from_xb(beta_init, X, size_factors, log_sf, min_mu, log_min_mu)
        r = 1.0 / disp[:, None]
        nll_const = nb_nll(counts, mu0, disp) - _mu_part(counts, counts + r, r, mu0, log_mu0)
        beta, needs_fb, n_iter = _irls_plain(
            counts, size_factors, X, disp, beta_init, nll_const, log_sf, min_mu,
            log_min_mu, beta_tol, max_beta, maxiter, step_tol, polish_iters,
        )
    if return_iters:
        return beta, needs_fb, ~needs_fb, n_iter
    return beta, needs_fb, ~needs_fb


def irls_beta_init(
    counts: torch.Tensor, size_factors: torch.Tensor, design_matrix: torch.Tensor, full_rank: bool = True
) -> torch.Tensor:
    """Initial coefficients: QR least squares of log(y/sf + 0.1) on X for a
    full-rank design; otherwise zeros with a log-mean intercept (reference
    pydeseq2/utils.py:348-357, ``pydeseq2_tpu/ops/irls.py:248``).
    ``full_rank`` is a host-side property of the design."""
    if not full_rank:
        beta = torch.zeros((counts.shape[0], design_matrix.shape[1]), dtype=counts.dtype, device=counts.device)
        beta[:, 0] = torch.log(counts / size_factors[None, :]).mean(dim=1)
        return beta
    y = torch.log(counts / size_factors[None, :] + 0.1)
    Q, R = torch.linalg.qr(design_matrix)
    rhs = y @ Q
    return torch.linalg.solve_triangular(R, rhs.T, upper=True).T


def _newton_box_plain(counts, size_factors, X, disp, beta_init, min_mu, max_beta, maxiter):
    G = counts.shape[0]
    P = X.shape[1]
    dtype = beta_init.dtype
    dev = counts.device
    eye = torch.eye(P, dtype=dtype, device=dev)
    r = (1.0 / disp)[:, None]
    y_plus_r = counts + r
    log_sf = torch.log(size_factors)[None, :]
    log_min_mu = torch.log(torch.tensor(min_mu, dtype=dtype, device=dev))

    def objective(beta):
        mu, log_mu, _ = _mu_from_xb(beta, X, size_factors, log_sf, min_mu, log_min_mu)
        return _mu_part(counts, y_plus_r, r, mu, log_mu) + 0.5 * 1e-6 * (beta**2).sum(-1)

    beta = beta_init
    f_val = objective(beta)
    for _ in range(maxiter):
        g, mu = _ridged_grad(beta, counts, X, size_factors, disp, min_mu)
        w = mu * (1.0 + disp[:, None] * counts) / (1.0 + disp[:, None] * mu) ** 2
        H = weighted_gram(X, w) + 1e-6 * eye
        step = sym_solve(H + 1e-8 * eye, g)
        t = torch.ones(G, dtype=dtype, device=dev)
        best_beta, best_f = beta, f_val
        done = torch.zeros(G, dtype=torch.bool, device=dev)
        for _ in range(13):
            cand = torch.clamp(beta - t[:, None] * step, -max_beta, max_beta)
            f_cand = objective(cand)
            improve = (f_cand < best_f) & ~done
            best_beta = torch.where(improve[:, None], cand, best_beta)
            best_f = torch.where(improve, f_cand, best_f)
            done = done | improve
            t = t * 0.5
        beta, f_val = best_beta, best_f

    g, _ = _ridged_grad(beta, counts, X, size_factors, disp, min_mu)
    at_lo = (beta <= -max_beta + 1e-12) & (g > 0)
    at_hi = (beta >= max_beta - 1e-12) & (g < 0)
    pg = torch.where(at_lo | at_hi, torch.zeros_like(g), g)
    return beta, torch.abs(pg).amax(dim=1) < 1e-5


class BoxPlan(NamedTuple):
    """The ``newton_box`` launch (``csrc/newton_box.cu``): a block of
    ``threads`` a selected lane, the first ``stage`` samples of its row
    staged in shared memory (the rest read from device memory), ``smem``
    bytes of dynamic shared memory a block."""

    threads: int
    stage: int
    smem: int


_BOX_WARPS = 14  # a warp each of the 13 backtracking candidates, one for the start's objective
# A block's staged row at most (y, sf, log sf and X): three blocks an SM
# keep theirs where many lanes are selected at long rows.
_BOX_STAGE_BYTES = 64 * 1024


def _box_smem_bytes(stage: int, P: int, itemsize: int) -> int:
    """Dynamic shared memory of a ``newton_box`` block (the kernel's
    ``smem_bytes``): the block reduction's slots (a value of the gradient
    and the packed Hessian a warp), the candidates' objectives, 15 ints,
    and ``stage`` samples of y, sf, log sf and X."""
    a16 = kernels.align16
    V = P + P * (P + 1) // 2
    return (a16(_BOX_WARPS * V * itemsize) + a16(_BOX_WARPS * itemsize) + a16((_BOX_WARPS + 1) * 4)
            + a16(stage * (3 + P) * itemsize))


def _box_plan(N: int, P: int, itemsize: int) -> BoxPlan:
    """The row's first samples that fit ``_BOX_STAGE_BYTES`` are staged,
    all of them up to ~3300 (float32, P = 2) or ~1600 (float64) samples."""
    stage = min(N, _BOX_STAGE_BYTES // ((3 + P) * itemsize))
    return BoxPlan(32 * _BOX_WARPS, stage, _box_smem_bytes(stage, P, itemsize))


def _newton_box_cuda(counts, size_factors, X, disp, beta_init, min_mu, max_beta, maxiter, sel=None, plan=None):
    """Launch the ``newton_box`` kernel: ``(beta, success, passes)`` per
    lane, passes = serial sweeps over the lane's row (a gradient pass and a
    candidate pass a step, and a final gradient pass where the last step
    improved), 0 where not selected. ``plan`` (a :class:`BoxPlan`)
    overrides :func:`_box_plan`."""
    K, N = counts.shape
    P = X.shape[1]
    dev = counts.device
    beta = torch.empty((K, P), dtype=beta_init.dtype, device=dev)
    ok = torch.empty(K, dtype=torch.bool, device=dev)
    passes = torch.empty(K, dtype=torch.int32, device=dev)
    log_sf = torch.log(size_factors)
    ops = [t.contiguous() for t in (counts, size_factors, log_sf, X, disp, beta_init)]
    kernels.check_cuda_operands("newton_box", *ops)
    kernels.check_p("newton_box", P)
    sel = kernels.check_sel("newton_box", sel, K)
    if plan is None:
        plan = _box_plan(N, P, counts.element_size())
    kernels.launch(
        "newton_box",
        [int(counts.dtype == torch.float64), P, K, N, plan.stage, *(t.data_ptr() for t in ops), kernels.ptr(sel),
         float(min_mu), float(max_beta), maxiter, beta.data_ptr(), ok.data_ptr(), passes.data_ptr()],
        dev,
    )
    return beta, ok, passes


def newton_box_nbglm(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    beta_init: torch.Tensor,
    min_mu: float = 0.5,
    max_beta: float = 30.0,
    maxiter: int = 60,
    sel: torch.Tensor | None = None,
):
    """Projected Newton on the ridged NB NLL in the [-30, 30]^P box with
    13-halving backtracking: ``(beta, success)``, success = projected
    gradient sup-norm < 1e-5. Port of ``pydeseq2_tpu/ops/irls.py:272``.

    ``sel`` (K,) bool marks the lanes whose result the caller uses: the
    ``newton_box`` kernel (CUDA tensors) does no work for the others and
    returns ``beta_init`` and False there (its lanes' serial passes, 0 on
    the others, are kept in ``kernels.STATS.box_passes`` while tracing is
    on); the plain version
    ignores it.
    """
    if counts.is_cuda:
        beta, ok, passes = _newton_box_cuda(counts, size_factors, design_matrix, disp, beta_init, min_mu,
                                            max_beta, maxiter, sel)
        if tracing.active():
            kernels.STATS.box_passes.append(passes)
        return beta, ok
    return _newton_box_plain(counts, size_factors, design_matrix, disp, beta_init, min_mu, max_beta, maxiter)


def _linspace(start, stop, num: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace`` with its rounding: start*(1-s) + stop*s, s = i/(num-1)."""
    div = num - 1
    s = torch.arange(div, dtype=dtype, device=device) / div
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=dtype, device=device)
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def grid_axes(min_beta: float, max_beta: float, num: int, dtype, device):
    """The coarse grid and the fine grid's offsets of the 2-D searches, as
    ``jnp.linspace`` rounds them: ``(base, offs)``, offs spanning one
    coarse step either side."""
    base = _linspace(min_beta, max_beta, num, dtype, device)
    delta = base[1] - base[0]
    return base, _linspace(-delta, delta, num, dtype, device)


def _grid_fit_beta_plain(counts, size_factors, X, disp, min_mu, grid_length, min_beta, max_beta):
    dtype = counts.dtype
    dev = counts.device
    G = counts.shape[0]

    def search(x_grid, y_grid):
        rows = []
        for xv in x_grid:  # one x value per pass bounds memory at (G, K, N)
            betas = torch.stack([xv.expand(y_grid.shape), y_grid], dim=1)
            mu = torch.clamp(size_factors[None, None, :] * torch.exp(betas @ X.T)[None], min=min_mu)
            nll = nb_nll(counts[:, None, :], mu, disp[:, None])
            rows.append(nll + 0.5 * (1e-6 * betas**2).sum(1)[None, :])
        ll = torch.stack(rows, dim=1)  # (G, Kx, Ky)
        flat = first_argmin(ll.reshape(G, -1).T)
        return x_grid[flat // y_grid.shape[0]], y_grid[flat % y_grid.shape[0]]

    base, offs = grid_axes(min_beta, max_beta, grid_length, dtype, dev)
    bx, by = search(base, base)

    best_f = torch.full((G,), float("inf"), dtype=dtype, device=dev)
    best_x, best_y = bx, by
    for i in range(grid_length):
        x_val = bx + offs[i]
        y_vals = by[:, None] + offs[None, :]
        xb = x_val[:, None, None] * X[None, None, :, 0] + y_vals[..., None] * X[None, None, :, 1]
        mu = torch.clamp(size_factors[None, None, :] * torch.exp(xb), min=min_mu)
        nll = nb_nll(counts[:, None, :], mu, disp[:, None])
        f = nll + 0.5e-6 * (x_val[:, None] ** 2 + y_vals**2)
        j = first_argmin(f.T)
        f_best = f.gather(1, j[:, None])[:, 0]
        better = f_best < best_f
        best_f = torch.where(better, f_best, best_f)
        best_x = torch.where(better, x_val, best_x)
        best_y = torch.where(better, y_vals.gather(1, j[:, None])[:, 0], best_y)
    return torch.stack([best_x, best_y], dim=1)


def _grid_fit_beta_cuda(counts, size_factors, X, disp, min_mu, grid_length, min_beta, max_beta, sel=None,
                        n_sel=None, plan=None):
    """Launch the ``grid_nb`` kernel: a cluster of ``plan.K`` blocks per
    selected lane, NaN in the lanes not selected. ``n_sel``, the selected
    count as the caller already read it (at most the tile's lanes; every
    lane where None), sizes the launch and the plan (``ops/shrink.py:
    _grid_plan``) without a host read here: the kernel finds the selected
    lanes itself, so a count off the true one costs time, not results.
    ``plan`` (a ``GridPlan``) overrides the wrapper's."""
    from pydeseq2_tpu_torch.ops.shrink import _grid_device_plan  # ops.shrink imports this module

    K, N = counts.shape
    dev = counts.device
    lanes = K if n_sel is None else min(max(int(n_sel), 1), K)
    if plan is None:
        plan = _grid_device_plan(lanes, N, grid_length, counts.dtype, dev, kernel="grid_nb")
    base, offs = grid_axes(min_beta, max_beta, grid_length, counts.dtype, dev)
    beta = torch.empty((K, 2), dtype=counts.dtype, device=dev)
    ops = [t.contiguous() for t in (counts, size_factors, X, disp, base, offs)]
    kernels.check_cuda_operands("grid_nb", *ops)
    kernels.check_p2("grid_nb", X.shape[1])
    sel8 = kernels.check_sel("grid_nb", sel, K)
    counts, size_factors, X, disp, base, offs = ops
    kernels.launch(
        "grid_nb",
        [int(counts.dtype == torch.float64), K, lanes, N, counts.data_ptr(), size_factors.data_ptr(), X.data_ptr(),
         disp.data_ptr(), kernels.ptr(sel8), base.data_ptr(), offs.data_ptr(), grid_length, float(min_mu), plan.K,
         plan.chunk, beta.data_ptr()],
        dev,
    )
    return beta


def grid_fit_beta_batch(
    counts: torch.Tensor,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    min_mu: float = 0.5,
    grid_length: int = 60,
    min_beta: float = -30.0,
    max_beta: float = 30.0,
    sel: torch.Tensor | None = None,
    n_sel: int | None = None,
) -> torch.Tensor:
    """Coarse then fine 2-D grid search for P == 2 designs. Port of
    ``pydeseq2_tpu/ops/irls.py:375``.

    ``sel`` (K,) bool marks the lanes whose result the caller uses: the
    ``grid_nb`` kernel (CUDA tensors) searches only those and returns NaN
    for the others; the plain version ignores it. ``n_sel``, the number of
    selected lanes where the caller has read it, sizes the kernel's launch.
    """
    args = (counts, size_factors, design_matrix, disp, min_mu, grid_length, min_beta, max_beta)
    if counts.is_cuda:
        return _grid_fit_beta_cuda(*args, sel, n_sel)
    return _grid_fit_beta_plain(*args)


def _hat_plain(size_factors, X, disp, beta, min_mu):
    P = X.shape[1]
    xb = beta @ X.T
    mu_thr = torch.clamp(size_factors[None, :] * torch.exp(xb), min=min_mu)
    W = mu_thr / (1.0 + mu_thr * disp[:, None])
    M = weighted_gram(X, W) + 1e-6 * torch.eye(P, dtype=beta.dtype, device=beta.device)
    Minv = sym_inv(M)
    xmx = torch.einsum("np,gpq,nq->gn", X, Minv, X)
    return W * xmx, size_factors[None, :] * torch.exp(xb)


def _hat_cuda(size_factors, X, disp, beta, min_mu, plan=None):
    """Launch the hat-only entry of ``csrc/hat_wald.cu`` (``hat``);
    ``plan`` overrides ``ops/wald.py:_hat_wald_plan``."""
    from pydeseq2_tpu_torch.ops.wald import _check_plan, _hat_wald_plan  # ops.wald imports this module

    G, P = beta.shape
    N = X.shape[0]
    dev = beta.device
    if plan is None:
        plan = _hat_wald_plan(N, P, beta.element_size())
    _check_plan("hat", plan, N, keeps=True)
    ops = [t.contiguous() for t in (beta, disp, size_factors, X)]
    beta, disp, size_factors, X = ops
    H = torch.empty((G, N), dtype=beta.dtype, device=dev)
    mu = torch.empty_like(H)
    kernels.check_cuda_operands("hat", *ops, H, mu)
    kernels.check_p("hat", P)
    kernels.launch(
        "hat",
        [int(beta.dtype == torch.float64), P, G, N, beta.data_ptr(), disp.data_ptr(), size_factors.data_ptr(),
         X.data_ptr(), float(min_mu), plan.lanes, plan.staged, H.data_ptr(), mu.data_ptr()],
        dev,
    )
    return H, mu


def hat_diagonals(
    counts: torch.Tensor | None,
    size_factors: torch.Tensor,
    design_matrix: torch.Tensor,
    disp: torch.Tensor,
    beta: torch.Tensor,
    min_mu: float = 0.5,
):
    """Hat diagonals W diag(X (X^T W X + 1e-6 I)^-1 X^T) on the min_mu-
    thresholded mu, and the UNthresholded mu, both (G, N). Port of
    ``pydeseq2_tpu/ops/irls.py:444``; ``counts`` is not read. CUDA tensors
    launch the hat-only entry of ``csrc/hat_wald.cu``; CPU tensors take the
    plain version."""
    fn = _hat_cuda if beta.is_cuda else _hat_plain
    return fn(size_factors, design_matrix, disp, beta, min_mu)
