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
slowest is done. One warp per gene runs its own loop and leaves it when the
lane stops, so a lane's trip count while it is active equals the JAX loop's
``it`` and the result is the same lane for lane. Each trip is one pass over
the gene's row: mu from the new coefficients, the mu-part of the deviance,
and the Gram X^T W X and X^T W z for the next trip, reduced by warp shuffle;
the P x P solve is scalar work in registers. On the H100 it is bound by the
transcendentals (exp and log1p per sample and trip) and by the tail: at
100 x 60000 most lanes stop within 6 trips while a few run 20+, and a warp
whose lane is done frees its slot for the next gene instead of idling as a
masked lane would. The lgamma constant of the deviance (``nll_const``) is
computed once in PyTorch and passed in.

The plain version (CPU tensors only) is the masked loop of the JAX package.

The rescue tiers have kernels too: ``csrc/newton_box.cu`` (the projected
Newton box solver, one warp per selected lane) and ``csrc/grid.cu``'s
``grid_nb`` (the 2-D grid, one block per selected lane). Both take ``sel``,
the lanes of the compacted tile whose result the caller uses, and do no work
for the others. :func:`hat_diagonals` on CUDA tensors launches the
hat-only entry of ``csrc/hat_wald.cu`` (``hat``, the class API's
``TorchInference.irls``); its plain version is the hat half of
``ops/wald.py:hat_wald``'s.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch import kernels
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


def _irls_cuda(counts, size_factors, X, disp, beta_init, nll_const, log_sf, min_mu,
               beta_tol, max_beta, maxiter, step_tol, polish_iters):
    """Launch the ``irls`` kernel: ``(beta, needs_fb, trips per lane)``."""
    G, N = counts.shape
    P = X.shape[1]
    beta = torch.empty((G, P), dtype=beta_init.dtype, device=counts.device)
    needs_fb = torch.empty(G, dtype=torch.uint8, device=counts.device)
    trips = torch.empty(G, dtype=torch.int32, device=counts.device)
    ops = [counts, size_factors, log_sf, X, disp, beta_init, nll_const, beta]
    ops = [t.contiguous() for t in ops]
    kernels.check_cuda_operands("irls", *ops)
    kernels.check_p("irls", P)
    counts, size_factors, log_sf, X, disp, beta_init, nll_const, beta = ops
    kernels.launch(
        "irls",
        [
            int(counts.dtype == torch.float64), P, G, N,
            counts.data_ptr(), size_factors.data_ptr(), log_sf.data_ptr(), X.data_ptr(),
            disp.data_ptr(), beta_init.data_ptr(), nll_const.data_ptr(),
            float(min_mu), float(beta_tol), float(max_beta), float(step_tol),
            maxiter, polish_iters,
            beta.data_ptr(), needs_fb.data_ptr(), trips.data_ptr(),
        ],
        counts.device,
    )
    return beta, needs_fb.bool(), trips


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
    # The lgamma part of the deviance is hoisted out of the loop: the stop
    # compares deviance differences, in which it cancels exactly.
    log_sf = torch.log(size_factors)[None, :]
    log_min_mu = torch.log(torch.tensor(min_mu, dtype=dtype, device=counts.device))
    mu0, log_mu0, _ = _mu_from_xb(beta_init, X, size_factors, log_sf, min_mu, log_min_mu)
    r = 1.0 / disp[:, None]
    nll_const = nb_nll(counts, mu0, disp) - _mu_part(counts, counts + r, r, mu0, log_mu0)
    if counts.is_cuda:
        beta, needs_fb, trips = _irls_cuda(
            counts, size_factors, X, disp, beta_init, nll_const, log_sf[0], min_mu,
            beta_tol, max_beta, maxiter, step_tol, polish_iters,
        )
        n_iter = trips.amax() if trips.numel() else torch.zeros((), dtype=torch.int32, device=counts.device)
        kernels.STATS.irls_trips.append(n_iter)
    else:
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


def _newton_box_cuda(counts, size_factors, X, disp, beta_init, min_mu, max_beta, maxiter, sel=None):
    """Launch the ``newton_box`` kernel: ``(beta, success, passes per lane)``,
    passes = evaluations over the lane's row (0 where not selected)."""
    K, N = counts.shape
    P = X.shape[1]
    dev = counts.device
    beta = torch.empty((K, P), dtype=beta_init.dtype, device=dev)
    ok = torch.empty(K, dtype=torch.uint8, device=dev)
    passes = torch.empty(K, dtype=torch.int32, device=dev)
    log_sf = torch.log(size_factors)
    ops = [t.contiguous() for t in (counts, size_factors, log_sf, X, disp, beta_init)]
    kernels.check_cuda_operands("newton_box", *ops)
    kernels.check_p("newton_box", P)
    sel8 = kernels.check_sel("newton_box", sel, K)
    kernels.launch(
        "newton_box",
        [int(counts.dtype == torch.float64), P, K, N, *(t.data_ptr() for t in ops), kernels.ptr(sel8),
         float(min_mu), float(max_beta), maxiter, beta.data_ptr(), ok.data_ptr(), passes.data_ptr()],
        dev,
    )
    return beta, ok.bool(), passes


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
    returns ``beta_init`` and False there; the plain version ignores it.
    """
    if counts.is_cuda:
        return _newton_box_cuda(counts, size_factors, design_matrix, disp, beta_init, min_mu, max_beta,
                                maxiter, sel)[:2]
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


def _grid_fit_beta_cuda(counts, size_factors, X, disp, min_mu, grid_length, min_beta, max_beta, sel=None):
    """Launch the ``grid_nb`` kernel (one block per selected lane; NaN in
    the lanes not selected)."""
    K, N = counts.shape
    dev = counts.device
    base, offs = grid_axes(min_beta, max_beta, grid_length, counts.dtype, dev)
    beta = torch.empty((K, 2), dtype=counts.dtype, device=dev)
    ops = [t.contiguous() for t in (counts, size_factors, X, disp, base, offs)]
    kernels.check_cuda_operands("grid_nb", *ops)
    kernels.check_p2("grid_nb", X.shape[1])
    sel8 = kernels.check_sel("grid_nb", sel, K)
    counts, size_factors, X, disp, base, offs = ops
    kernels.launch(
        "grid_nb",
        [int(counts.dtype == torch.float64), K, N, counts.data_ptr(), size_factors.data_ptr(), X.data_ptr(),
         disp.data_ptr(), kernels.ptr(sel8), base.data_ptr(), offs.data_ptr(), grid_length, float(min_mu),
         beta.data_ptr()],
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
) -> torch.Tensor:
    """Coarse then fine 2-D grid search for P == 2 designs. Port of
    ``pydeseq2_tpu/ops/irls.py:375``.

    ``sel`` (K,) bool marks the lanes whose result the caller uses: the
    ``grid_nb`` kernel (CUDA tensors) searches only those and returns NaN
    for the others; the plain version ignores it.
    """
    args = (counts, size_factors, design_matrix, disp, min_mu, grid_length, min_beta, max_beta)
    if counts.is_cuda:
        return _grid_fit_beta_cuda(*args, sel)
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


def _hat_cuda(size_factors, X, disp, beta, min_mu):
    """Launch the hat-only entry of ``csrc/hat_wald.cu`` (``hat``)."""
    G, P = beta.shape
    N = X.shape[0]
    dev = beta.device
    ops = [t.contiguous() for t in (beta, disp, size_factors, X)]
    beta, disp, size_factors, X = ops
    H = torch.empty((G, N), dtype=beta.dtype, device=dev)
    mu = torch.empty_like(H)
    kernels.check_cuda_operands("hat", *ops, H, mu)
    kernels.check_p("hat", P)
    kernels.launch(
        "hat",
        [int(beta.dtype == torch.float64), P, G, N, beta.data_ptr(), disp.data_ptr(), size_factors.data_ptr(),
         X.data_ptr(), float(min_mu), H.data_ptr(), mu.data_ptr()],
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
