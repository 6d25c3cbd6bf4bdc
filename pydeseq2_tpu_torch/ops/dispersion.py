"""Batched NB dispersion estimation in log-alpha (MLE / MAP).

Port of ``pydeseq2_tpu/ops/dispersion.py:alpha_mle_batch``: for every gene
at once, a coarse scan of the objective (NB NLL + Cox-Reid + optional prior)
over ``grid_length`` static points of [log(min_disp), log(max_disp)], with
``fine_length > 0`` a fine scan of ``fine_length`` points per gene around
its coarse argmin (halfwidth one coarse step), then ``newton_iters``
safeguarded Newton steps from the best point. The pipelines run
``fine_length = 0`` as the JAX package does by default.

Two hand-written CUDA kernels carry the (G, N) work:

``csrc/disp_scan.cu`` replaces ``scan_coarse`` (pydeseq2_tpu/ops/
dispersion.py:196) and, as its per-gene-grid mode ``disp_scan_fine``,
``scan_grid`` (:170-194), both on ops/nb.py:nb_nll_centered and the
Cox-Reid ``sym_logdet``. A block takes 32 genes (a lane each) and its warps
take the grid points, so every thread sums one (gene, point) over the
samples, which the block stages in shared memory once for all its points;
where the tiles alone leave the card short, the rows are split over segments
whose sums the last block of a tile adds (:func:`_scan_segments`). Bound on
the H100 by the transcendentals (two log1p per sample and point, lgamma
below r = 8).

``csrc/disp_newton.cu`` replaces ``fgh_closed`` + ``newton_body``
(pydeseq2_tpu/ops/dispersion.py:313,361 with ops/nb.py:
nb_nll_centered_fgh). One launch runs the initial (f, g, h) and all Newton
steps per gene, L = 4-32 lanes a gene by N and, on short gene lists, by
how many blocks fill the card, the rows staged in shared memory
for all five evaluations where they fit, the three Cox-Reid Grams M, M',
M'' reduced beside the NB sums. Bound like the scan by transcendentals.

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


# csrc/disp_scan.cu: genes per block (a lane each); the fewest samples a
# segment of a split row holds; blocks per SM that count as a full card.
_SCAN_TILE = 32
_SCAN_SEG_MIN = 32
_SCAN_BLOCKS_PER_SM = 4


def _scan_segments(G: int, N: int, sms: int) -> int:
    """Segments per row of the scan kernel: 1 where the gene tiles alone
    give ~4 blocks per SM, else enough to reach that, at least
    ``_SCAN_SEG_MIN`` samples each (on 132 SMs, 5000 genes x 10000 samples:
    157 tiles x 4 segments; 2000 genes x 100 samples: 63 tiles x 3)."""
    tiles = -(-G // _SCAN_TILE)
    target = _SCAN_BLOCKS_PER_SM * sms
    if tiles >= target:
        return 1
    return max(1, min(-(-target // tiles), N // _SCAN_SEG_MIN))


def _scan_launch(name, counts, mu, X, grid_args, K, cr_reg, prior_reg, la_hat, pdv, coarse):
    """Launch ``disp_scan`` or ``disp_scan_fine``: checks, the segment
    split and its scratch (the segments' sums and a counter per tile)."""
    G, N = counts.shape
    P = X.shape[1]
    best_la = torch.empty(G, dtype=mu.dtype, device=mu.device)
    lah = la_hat.contiguous() if prior_reg else None
    pdv = pdv.reshape(()).contiguous()
    S = _scan_segments(G, N, kernels.sm_count(mu.device))
    partial = done = None
    if S > 1:
        tiles = -(-G // _SCAN_TILE)
        partial = torch.empty(tiles * S * K * (1 + P * (P + 1) // 2) * _SCAN_TILE, dtype=torch.float64,
                              device=mu.device)
        done = torch.zeros(tiles, dtype=torch.int32, device=mu.device)
    tensors = [t for t in grid_args if isinstance(t, torch.Tensor)]
    # the float64 scratch is the wrapper's own, outside the one-dtype check
    kernels.check_cuda_operands(name, counts, mu, X, *tensors, lah, pdv, done, best_la, coarse)
    kernels.check_p(name, P)
    args = [int(mu.dtype == torch.float64), P, G, N, counts.data_ptr(), mu.data_ptr(), X.data_ptr()]
    args += [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in grid_args]
    args += [int(cr_reg), int(prior_reg), kernels.ptr(lah), pdv.data_ptr(), S, kernels.ptr(partial),
             kernels.ptr(done), best_la.data_ptr()]
    if coarse is not None:
        args.append(coarse.data_ptr())
    kernels.launch(name, args, mu.device)
    return best_la


def scan_coarse(counts, mu, X, la_grid, bnd_start, bnd_end, la_init, cr_reg, prior_reg, la_hat, pdv):
    """Coarse scan over the static grid ``la_grid``: the first strict
    minimum per gene (``la_init`` where no point is finite) and the
    objective at every point. CUDA tensors launch ``disp_scan``."""
    if not counts.is_cuda:
        return scan_coarse_plain(
            counts, mu, X, la_grid, bnd_start, bnd_end, la_init, cr_reg, prior_reg, la_hat, pdv
        )
    K = la_grid.shape[0]
    coarse = torch.empty((K, counts.shape[0]), dtype=mu.dtype, device=mu.device)
    grid_args = (la_grid, K, bnd_start, bnd_end, float(la_init))
    best_la = _scan_launch("disp_scan", counts, mu, X, grid_args, K, cr_reg, prior_reg, la_hat, pdv, coarse)
    return best_la, coarse


def scan_grid_plain(counts, mu, X, center, halfwidth_f, length, lo_f, hi_f, cr_reg, prior_reg, la_hat, pdv):
    """Plain version of the fine scan: best_la (G,)."""
    dtype, dev = mu.dtype, mu.device
    lo, hi, hw, step = (
        torch.tensor(v, dtype=dtype, device=dev)
        for v in (lo_f, hi_f, halfwidth_f, 2.0 * halfwidth_f / (length - 1))
    )
    ks = torch.arange(length, dtype=dtype, device=dev)
    best_f = torch.full(center.shape, float("inf"), dtype=dtype, device=dev)
    best_la = center.clone()
    for k in range(length):
        la = torch.clamp(center - hw + ks[k] * step, lo, hi)
        f = _alpha_objective(la, counts, X, mu, la_hat, pdv, cr_reg, prior_reg, "auto")
        better = f < best_f
        best_f = torch.where(better, f, best_f)
        best_la = torch.where(better, la, best_la)
    return best_la


def scan_grid(counts, mu, X, center, halfwidth_f, length, lo_f, hi_f, cr_reg, prior_reg, la_hat, pdv):
    """Fine scan: the objective (auto branch per gene and point) at
    ``length`` points ``clip(center - halfwidth + k step, lo, hi)``, step =
    2 halfwidth / (length - 1), and the first strict minimum per gene,
    ``center`` where no point is finite (JAX ``scan_grid``; bounds and steps
    are Python floats, rounded to the working dtype as JAX rounds them).
    CUDA tensors launch ``disp_scan_fine``."""
    if not counts.is_cuda:
        return scan_grid_plain(
            counts, mu, X, center, halfwidth_f, length, lo_f, hi_f, cr_reg, prior_reg, la_hat, pdv
        )
    step_f = 2.0 * halfwidth_f / (length - 1)
    grid_args = (center.contiguous(), halfwidth_f, step_f, lo_f, hi_f, length)
    return _scan_launch("disp_scan_fine", counts, mu, X, grid_args, length, cr_reg, prior_reg, la_hat, pdv, None)


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
    return _newton_polish_cuda(counts, mu, X, la, lo_f, hi_f, clip_f, step2_f, iters, cr_reg, prior_reg, la_hat, pdv)


def _newton_polish_cuda(counts, mu, X, la, lo_f, hi_f, clip_f, step2_f, iters, cr_reg, prior_reg, la_hat, pdv):
    """Launch ``disp_newton``: four outputs. The kernel takes the genes in
    an order grouped by the branch at their start (r = exp(-la) < 8 or
    not), so that the genes of a warp mostly run one form; each gene's
    results land at its own index."""
    G, N = counts.shape
    P = X.shape[1]
    la = la.contiguous()
    outs = [torch.empty(G, dtype=mu.dtype, device=mu.device) for _ in range(4)]
    order = torch.argsort((la > -math.log(_R_SWITCH)).to(torch.uint8), stable=True).to(torch.int32)
    lah = la_hat.contiguous() if prior_reg else None
    pdv = pdv.reshape(()).contiguous()
    kernels.check_cuda_operands("disp_newton", counts, mu, X, la, lah, pdv, order, *outs)
    kernels.check_p("disp_newton", P)
    kernels.launch(
        "disp_newton",
        [
            int(mu.dtype == torch.float64), P, G, N, order.data_ptr(),
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
    fine_length: int = 0,
    newton_iters: int = 4,
    return_coarse: bool = False,
    coarse_cache: torch.Tensor | None = None,
):
    """Per-gene dispersions by coarse grid (+ fine grid) + Newton polish.

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
    # The fine spacing; without the fine scan the 8-point one, so the
    # plateau-lane flag |g| step2 keeps the same resolution.
    step2_f = step1_f / 3.5 if fine_length == 0 else 2.0 * step1_f / (fine_length - 1)
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

    if fine_length == 0:
        la2 = la1
    else:
        la2 = scan_grid(counts, mu, X, la1, step1_f, fine_length, lo_f, hi_f, cr_reg, prior_reg, la_hat, pdv)

    la_fit, f_fit, g_fin, h_fin = newton_polish(
        counts, mu, X, la2, lo_f, hi_f, step1_f, step2_f, newton_iters, cr_reg, prior_reg, la_hat, pdv
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
