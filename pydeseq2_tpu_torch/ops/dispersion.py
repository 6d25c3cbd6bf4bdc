"""Batched NB dispersion estimation in log-alpha (MLE / MAP).

Port of ``pydeseq2_tpu/ops/dispersion.py:alpha_mle_batch``: for every gene
at once, a coarse scan of the objective (NB NLL + Cox-Reid + optional prior)
over ``grid_length`` static points of [log(min_disp), log(max_disp)], then
``newton_iters`` safeguarded Newton steps from the coarse argmin. The fine
scan of the JAX package (``fine_length > 0``) is not on the Wald path and is
not ported; the polish starts at the coarse argmin as there by default.

Two hand-written CUDA kernels carry the (G, N) work:

``csrc/disp_scan.cu`` replaces ``scan_coarse`` (pydeseq2_tpu/ops/
dispersion.py:196 with ops/nb.py:nb_nll_centered and the Cox-Reid
``sym_logdet``). One warp per gene walks the 32 grid points; its lanes
stride the gene's contiguous row of N samples and reduce the NLL terms and
the P(P+1)/2 Gram entries by warp shuffle; X comes through the read-only
cache. The branch per point is fixed exactly as ``scan_coarse`` fixes it.
On the H100 it is bound by the transcendentals (log1p twice per sample and
point, plus lgamma below r = 8): 32 points x 60000 x 100 is ~2e8 log1p,
while the 48 MB of counts and mu are read from device memory once and then
from L1/L2. The design keeps every intermediate in registers and writes
only the (32, G) objective cache and the argmin.

``csrc/disp_newton.cu`` replaces ``fgh_closed`` + ``newton_body``
(pydeseq2_tpu/ops/dispersion.py:313,361 with ops/nb.py:
nb_nll_centered_fgh). One launch runs the initial (f, g, h) and all Newton
steps per gene, one warp per gene, the three Cox-Reid Grams M, M', M''
reduced beside the NB sums. Bound like the scan by transcendentals (two
log1p per sample and step; lgamma, psi and psi' of y + r below r = 8); the
step logic is per-gene scalar work done redundantly by all 32 lanes, so no
lane waits on shared memory.

The JAX package takes the autodiff (f, g, h) below N = 512 for TPU speed;
the port uses the closed form at every N (both compute the same values,
``test_closed_form_fgh_matches_autodiff`` in the JAX tests).
"""

from __future__ import annotations

import math

import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.ops.nb import _R_SWITCH, nb_nll_centered, nb_nll_centered_fgh
from pydeseq2_tpu_torch.ops.smalllinalg import sym_inv, sym_logdet, weighted_gram


def _alpha_objective(
    la: torch.Tensor,
    counts: torch.Tensor,
    X: torch.Tensor,
    mu: torch.Tensor,
    la_hat: torch.Tensor,
    pdv: torch.Tensor,
    cr_reg: bool,
    prior_reg: bool,
    branch: str = "auto",
) -> torch.Tensor:
    """Per-lane objective: centred NB NLL + Cox-Reid + optional prior."""
    alpha = torch.exp(la)
    obj = nb_nll_centered(counts, mu, alpha, branch=branch)
    if cr_reg:
        W = mu / (1.0 + mu * alpha[:, None])
        obj = obj + 0.5 * sym_logdet(weighted_gram(X, W))
    if prior_reg:
        obj = obj + (la - la_hat) ** 2 / (2.0 * pdv)
    return obj


def _scan_branches(grid_length: int, step1_f: float, lo_f: float) -> tuple[int, int]:
    """[0, bnd_start) stable, [bnd_start, bnd_end) per element, rest plain —
    the chunked regions of the JAX scan (4 points per chunk)."""
    la_threshold = -math.log(_R_SWITCH)
    k_split = int(math.floor((la_threshold - lo_f) / step1_f)) + 1
    k_split = max(0, min(grid_length, k_split))
    kpts = 4 if grid_length % 4 == 0 else 1
    return (k_split // kpts) * kpts, -(-k_split // kpts) * kpts


def scan_coarse_plain(counts, mu, X, la_grid, bnd_start, bnd_end, la_init, cr_reg, prior_reg, la_hat, pdv):
    """Plain version of the coarse scan: (best_la (G,), values (K, G))."""
    G = counts.shape[0]
    best_f = torch.full((G,), float("inf"), dtype=mu.dtype, device=mu.device)
    best_la = torch.full((G,), la_init, dtype=mu.dtype, device=mu.device)
    fs = []
    for k in range(la_grid.shape[0]):
        branch = "stable" if k < bnd_start else ("auto" if k < bnd_end else "plain")
        la = la_grid[k].expand(G)
        f = _alpha_objective(la, counts, X, mu, la_hat, pdv, cr_reg, prior_reg, branch)
        better = f < best_f
        best_f = torch.where(better, f, best_f)
        best_la = torch.where(better, la, best_la)
        fs.append(f)
    return best_la, torch.stack(fs)


def scan_coarse(counts, mu, X, la_grid, bnd_start, bnd_end, la_init, cr_reg, prior_reg, la_hat, pdv):
    """Coarse scan over the static grid ``la_grid``: the first strict
    minimum per gene (``la_init`` where no point is finite) and the
    objective at every point. CUDA tensors launch ``disp_scan``."""
    if not counts.is_cuda:
        return scan_coarse_plain(
            counts, mu, X, la_grid, bnd_start, bnd_end, la_init, cr_reg, prior_reg, la_hat, pdv
        )
    G, N = counts.shape
    P = X.shape[1]
    K = la_grid.shape[0]
    best_la = torch.empty(G, dtype=mu.dtype, device=mu.device)
    coarse = torch.empty((K, G), dtype=mu.dtype, device=mu.device)
    lah = la_hat.contiguous() if prior_reg else None
    pdv = pdv.reshape(()).contiguous()
    kernels.check_cuda_operands("disp_scan", counts, mu, X, la_grid, lah, pdv, best_la, coarse)
    kernels.check_p("disp_scan", P)
    kernels.launch(
        "disp_scan",
        [
            int(mu.dtype == torch.float64), P, G, N,
            counts.data_ptr(), mu.data_ptr(), X.data_ptr(), la_grid.data_ptr(),
            K, bnd_start, bnd_end, float(la_init), int(cr_reg), int(prior_reg),
            kernels.ptr(lah), pdv.data_ptr(),
            best_la.data_ptr(), coarse.data_ptr(),
        ],
        mu.device,
    )
    return best_la, coarse


def fgh_closed(counts, mu, X, la, cr_reg, prior_reg, la_hat, pdv):
    """Objective, gradient and curvature in log-alpha of one point per gene."""
    f, g, h = nb_nll_centered_fgh(counts, mu, la)
    if cr_reg:
        # d logdet M = tr(M^-1 M'); d2 = tr(M^-1 M'') - tr((M^-1 M')^2), with
        # W = mu/(1 + mu a), dW/dla = -a W^2, d2W/dla2 = dW (1 - 2 a W).
        a = torch.exp(la)[:, None]
        W = mu / (1.0 + mu * a)
        Wd1 = -a * W * W
        Wd2 = Wd1 * (1.0 - 2.0 * a * W)
        M = weighted_gram(X, W)
        M1 = weighted_gram(X, Wd1)
        M2 = weighted_gram(X, Wd2)
        Minv = sym_inv(M)
        A = Minv @ M1
        f = f + 0.5 * sym_logdet(M)
        g = g + 0.5 * torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
        h = h + 0.5 * (
            (Minv * M2.transpose(-1, -2)).sum((-2, -1))
            - (A * A.transpose(-1, -2)).sum((-2, -1))
        )
    if prior_reg:
        d = la - la_hat
        f = f + d * d / (2.0 * pdv)
        g = g + d / pdv
        h = h + 1.0 / pdv
    return f, g, h


def newton_polish_plain(counts, mu, X, la, lo_f, hi_f, clip_f, step2_f, iters, cr_reg, prior_reg, la_hat, pdv):
    """Plain version of the safeguarded Newton polish: (la, f, g, h)."""
    lo, hi, clipw, step2 = (
        torch.tensor(v, dtype=mu.dtype, device=mu.device) for v in (lo_f, hi_f, clip_f, step2_f)
    )
    f, g, h = fgh_closed(counts, mu, X, la, cr_reg, prior_reg, la_hat, pdv)
    for _ in range(iters):
        raw = torch.where(h > 0, g / h, torch.sign(g) * step2)
        step = torch.clamp(raw, -clipw, clipw)
        cand = torch.clamp(la - step, lo, hi)
        fc, gc, hc = fgh_closed(counts, mu, X, cand, cr_reg, prior_reg, la_hat, pdv)
        # Gradient-contraction gate for small positive-curvature steps (near
        # the optimum f differences sit below the f32 noise floor), strict
        # descent otherwise — pydeseq2_tpu/ops/dispersion.py:384-387.
        contraction = (h > 0) & (torch.abs(raw) <= clipw) & (torch.abs(gc) <= torch.abs(g))
        better = contraction | (fc < f)
        la = torch.where(better, cand, la)
        f = torch.where(better, fc, f)
        g = torch.where(better, gc, g)
        h = torch.where(better, hc, h)
    return la, f, g, h


def newton_polish(counts, mu, X, la, lo_f, hi_f, clip_f, step2_f, iters, cr_reg, prior_reg, la_hat, pdv):
    """(f, g, h) at ``la`` and ``iters`` safeguarded Newton steps per gene,
    in [lo_f, hi_f] with steps clipped to ``clip_f`` (bounds and steps are
    Python floats, rounded to the working dtype as the JAX package rounds
    them). CUDA tensors launch ``disp_newton`` (one launch for all steps)."""
    if not counts.is_cuda:
        return newton_polish_plain(
            counts, mu, X, la, lo_f, hi_f, clip_f, step2_f, iters, cr_reg, prior_reg, la_hat, pdv
        )
    G, N = counts.shape
    P = X.shape[1]
    la = la.contiguous()
    outs = [torch.empty(G, dtype=mu.dtype, device=mu.device) for _ in range(4)]
    lah = la_hat.contiguous() if prior_reg else None
    pdv = pdv.reshape(()).contiguous()
    kernels.check_cuda_operands("disp_newton", counts, mu, X, la, lah, pdv, *outs)
    kernels.check_p("disp_newton", P)
    kernels.launch(
        "disp_newton",
        [
            int(mu.dtype == torch.float64), P, G, N,
            counts.data_ptr(), mu.data_ptr(), X.data_ptr(), la.data_ptr(),
            kernels.ptr(lah), pdv.data_ptr(), lo_f, hi_f, clip_f, step2_f,
            iters, int(cr_reg), int(prior_reg),
            *(o.data_ptr() for o in outs),
        ],
        mu.device,
    )
    return tuple(outs)


def first_argmin(f: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along axis 0, a NaN counting as the
    minimum — ``jnp.argmin``'s rule (the first NaN wins where there is one)."""
    m = f.amin(0)  # NaN where the column holds one
    hit = (f == m[None]) | (torch.isnan(f) & torch.isnan(m)[None])
    K = f.shape[0]
    idx = torch.arange(K, device=f.device)[:, None].expand_as(f)
    return torch.where(hit, idx, torch.full_like(idx, K)).amin(0)


def alpha_mle_batch(
    counts: torch.Tensor,
    design_matrix: torch.Tensor,
    mu: torch.Tensor,
    alpha_hat: torch.Tensor,
    min_disp: float,
    max_disp: float,
    prior_disp_var: float | torch.Tensor | None = None,
    cr_reg: bool = True,
    prior_reg: bool = False,
    grid_length: int = 32,
    newton_iters: int = 4,
    return_coarse: bool = False,
    coarse_cache: torch.Tensor | None = None,
):
    """Per-gene dispersions by coarse grid + Newton polish.

    Returns ``(alpha, converged)``, plus the (grid_length, G) base objective
    (no prior) at the static grid points when ``return_coarse``. A later
    call on the same counts/mu/design can pass it as ``coarse_cache`` to
    skip its coarse scan (the MAP fit only adds a per-lane prior).
    See ``pydeseq2_tpu/ops/dispersion.py:78`` for the full contract.
    """
    dtype = mu.dtype
    dev = mu.device
    X = design_matrix
    lo_f = math.log(min_disp)
    hi_f = math.log(max_disp)
    lo = torch.tensor(lo_f, dtype=dtype, device=dev)
    hi = torch.tensor(hi_f, dtype=dtype, device=dev)
    la_hat = torch.log(torch.clamp(alpha_hat, min_disp, max_disp)).to(dtype)
    pdv = torch.as_tensor(1.0 if prior_disp_var is None else prior_disp_var, dtype=dtype, device=dev)

    step1_f = (hi_f - lo_f) / (grid_length - 1)
    step2_f = step1_f / 3.5  # the 8-point fine spacing (fine_length = 0)
    step1 = torch.tensor(step1_f, dtype=dtype, device=dev)
    la_grid = lo + torch.arange(grid_length, dtype=dtype, device=dev) * step1
    prior = (la_grid[:, None] - la_hat[None, :]) ** 2 / (2.0 * pdv) if prior_reg else None

    coarse_vals = None
    if coarse_cache is not None:
        f_all = coarse_cache + prior if prior_reg else coarse_cache
        la1 = la_grid[first_argmin(f_all)]
    else:
        bnd_start, bnd_end = _scan_branches(grid_length, step1_f, lo_f)
        la1, emitted = scan_coarse(
            counts, mu, X, la_grid, bnd_start, bnd_end, (lo_f + hi_f) / 2.0,
            cr_reg, prior_reg, la_hat, pdv,
        )
        if return_coarse:
            coarse_vals = emitted - prior if prior_reg else emitted

    la_fit, f_fit, g_fin, h_fin = newton_polish(
        counts, mu, X, la1, lo_f, hi_f, step1_f, step2_f, newton_iters, cr_reg, prior_reg, la_hat, pdv
    )
    step2 = torch.tensor(step2_f, dtype=dtype, device=dev)

    alpha = torch.exp(la_fit)
    # Projected-Newton stationarity flag (pydeseq2_tpu/ops/dispersion.py:410-422).
    zero = torch.zeros_like(g_fin)
    pg = torch.where((la_fit <= lo) & (g_fin > 0), zero, g_fin)
    pg = torch.where((la_fit >= hi) & (pg < 0), zero, pg)
    decrement = torch.where(h_fin > 0, pg * pg / (2.0 * torch.abs(h_fin)), torch.abs(pg) * step2)
    ftol = max(1e3 * torch.finfo(dtype).eps, 1e-9)
    converged = torch.isfinite(f_fit) & (decrement <= ftol * (torch.abs(f_fit) + 1.0))
    if return_coarse:
        return alpha, converged, coarse_vals
    return alpha, converged
