"""Dispersion-trend gamma GLM fit (2 parameters, projected Fisher scoring)
and the gene-exclusion rounds around it.

Port of ``pydeseq2_tpu/ops/trend.py:gamma_glm_trend_fit`` (reference
pydeseq2/default_inference.py:200-230): minimise mean(y/mu + log mu) over
the valid genes, mu = a0 + a1 x, coefficients bounded below at 1e-12; and
of the parametric branch of ``pydeseq2_tpu/fused.py:212 fit_fused_trend``,
which refits after dropping genes far off the curve until the coefficients
stop moving.

Kernel (``csrc/trend.cu``): :func:`parametric_trend` on CUDA tensors runs
every exclusion round, Newton step and backtracking trip on one
thread-block cluster of up to 16 blocks of 1024 threads (:func:`_trend_plan`
picks the blocks from G and the itemsize, and keeps each block's lanes in
shared memory where they fit), each loss, gradient and Fisher sum a cluster reduction in
a fixed order, so the host reads no loop condition (the plain version below
reads one per trip). :func:`gamma_glm_trend_fit` on CUDA tensors launches
the same source's ``trend_fit``: one fit on the caller's mask, the same
cluster sums, for the class API, whose exclusion rounds run on the host.
Its work is O(G) per step over 0.54 MB at 60000 genes: it is bound by its
serial chain of reductions, not by bytes. The plain version (CPU tensors
only) is the JAX program's loops as Python loops.

Both versions sum every loss, gradient and Fisher term in float64 and round
the total to the input dtype, and both spell out mu = a0 + a1 x and the
2 x 2 LU solve. In float32 a 60000-term sum taken in another order moves by
more than the stall tolerance 10 eps (|f| + 1), so the kernel and the plain
fit would otherwise stop after different Newton trips, ~1e-2 apart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pydeseq2_tpu_torch import kernels

_LOWER = 1e-12


class TrendPlan(NamedTuple):
    """Launch plan of ``trend`` and ``trend_fit``: one cluster of ``K``
    blocks, each block's lanes in shared memory (``shared``) or read from
    global memory each pass."""

    K: int
    shared: bool


_TREND_WARPS = 32  # warps of a trend block (1024 threads)
# Lanes a block should have before the plan adds blocks, by itemsize: on the
# H100 a float64 lane costs several times a float32 one (division and log in
# float64), so float64 spreads sooner (kernel_bench --detail, PERF.md
# section 6: at 4000 lanes one block is fastest in float32, eight in
# float64; at 60000 sixteen in both).
_TREND_LANES_PER_BLOCK = {4: 4096, 8: 512}


def _trend_smem_bytes(rows: int, itemsize: int, shared: bool) -> int:
    """Dynamic shared memory of one trend block (the kernel's
    ``trend_smem_bytes``): the double-buffered float64 warp sums (5 values)
    and block totals, the 16 blocks' totals gathered, and in the
    shared-memory mode x, the target and the valid byte of each of the
    block's ``rows`` lanes."""
    return 8 * (2 * 5 * _TREND_WARPS + 2 * 5 + kernels.MAX_CLUSTER * 5) + (rows * (2 * itemsize + 1) if shared else 0)


def _trend_plan(G: int, itemsize: int) -> TrendPlan:
    """K, the least power of two that gives no block more than 4096 lanes in
    float32 (512 in float64), at most 16 (one block for a few hundred genes);
    the lanes in shared memory where a block's ceil(G / K) of them fit it,
    else streamed."""
    want = -(-G // _TREND_LANES_PER_BLOCK[itemsize])
    K = min(kernels.MAX_CLUSTER, 1 << max(0, (want - 1).bit_length()))
    return TrendPlan(K, _trend_smem_bytes(-(-G // K), itemsize, True) <= kernels.SMEM_BLOCK_MAX)


def _design(covariates: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.ones_like(covariates), covariates], dim=1)


def _sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over genes, accumulated in float64, rounded to ``v``'s dtype."""
    return v.sum(0, dtype=torch.float64).to(v.dtype)


def _mu(c, x):
    """a0 + a1 x for the design ``x = [1, x]`` (the kernel's expression)."""
    return c[0] + x[:, 1] * c[1]


def trend_loss(c, x, targets, valid, n):
    """mean over valid genes of y/mu + log mu, mu = max(x @ c, 1e-12)."""
    mu_safe = torch.clamp(_mu(c, x), min=_LOWER)
    per = targets / mu_safe + torch.log(mu_safe)
    return _sum(torch.where(valid, per, torch.zeros_like(per))) / n


def trend_grad(c, x, targets, valid, n):
    """Closed-form gradient of :func:`trend_loss`.

    The JAX package takes ``jax.grad`` of the loss, which differentiates
    ``maximum(mu, 1e-12)`` as 1 above the bound, 1/2 at a tie and 0 below;
    this reproduces that factor, so a lane clamped at the bound contributes
    no gradient.
    """
    mu = _mu(c, x)
    mu_safe = torch.clamp(mu, min=_LOWER)
    dper = -targets / (mu_safe * mu_safe) + 1.0 / mu_safe
    one = torch.ones_like(mu)
    dmax = torch.where(mu > _LOWER, one, torch.where(mu == _LOWER, 0.5 * one, 0.0 * one))
    gmu = torch.where(valid, dper * dmax, torch.zeros_like(dper)) / n
    return torch.stack([_sum(gmu), _sum(x[:, 1] * gmu)])


def _fisher(c, x, w, n):
    # Expected information of the gamma GLM with identity link (always PSD),
    # plus the 1e-12 ridge: (F00, F01, F11).
    mu = torch.clamp(_mu(c, x), min=_LOWER)
    wm = w / mu**2
    xw = x[:, 1] * wm
    return _sum(wm) / n + _LOWER, _sum(wm * x[:, 1]) / n, _sum(xw * x[:, 1]) / n + _LOWER


def _solve2(F, r):
    """Solve [[F00, F01], [F01, F11]] s = r by LU with partial pivoting, as
    LAPACK's getrf/getrs do for 2 x 2 (multiplier by the pivot's
    reciprocal)."""
    a, b, d = F
    swap = torch.abs(b) > torch.abs(a)
    p, q = torch.where(swap, b, a), torch.where(swap, d, b)  # pivot row
    o, e = torch.where(swap, a, b), torch.where(swap, b, d)  # other row
    r0, r1 = torch.where(swap, r[1], r[0]), torch.where(swap, r[0], r[1])
    m = o * (1.0 / p)
    s1 = (r1 - m * r0) / (e - m * q)
    return torch.stack([(r0 - s1 * q) / p, s1])


def _trend_fit_plain(covariates, targets, valid, maxiter):
    dtype = targets.dtype
    dev = targets.device
    x = _design(covariates)
    w = valid.to(dtype)
    n = torch.clamp(w.sum(), min=1.0)
    eps = torch.finfo(dtype).eps

    def loss(c):
        return trend_loss(c, x, targets, valid, n)

    def grad(c):
        return trend_grad(c, x, targets, valid, n)

    c = torch.ones(2, dtype=dtype, device=dev)
    f_val = loss(c)
    for _ in range(maxiter):
        step = _solve2(_fisher(c, x, w, n), grad(c))
        t = 1.0
        best_c, best_f = c, f_val
        improved = False
        # Host-evaluated backtracking while_loop (trend.py:71-104).
        for _ in range(20):
            cand = torch.clamp(c - t * step, min=_LOWER)
            f_cand = loss(cand)
            if bool(f_cand < best_f):
                best_c, best_f = cand, f_cand
                improved = True
                break
            t = t * 0.5
        tiny = 10.0 * eps * (torch.abs(f_val) + 1.0)
        stalled = (not improved) or bool(f_val - best_f <= tiny)
        c, f_val = best_c, best_f
        # Host-evaluated outer while_loop condition (trend.py:75-77).
        if stalled:
            break

    predictions = _mu(c, x)
    g_final = grad(c)
    at_bound = (c <= _LOWER * (1 + 1e-9)) & (g_final > 0)
    pg = torch.where(at_bound, torch.zeros_like(g_final), g_final)
    sol = _solve2(_fisher(c, x, w, n), pg)
    decrement = (0.5 * pg[0]) * sol[0] + (0.5 * pg[1]) * sol[1]
    converged = torch.isfinite(f_val) & (decrement <= 1e3 * eps * (torch.abs(f_val) + 1.0))
    return c, predictions, converged


def _trend_fit_cuda(covariates, targets, valid, maxiter, plan=None):
    """Launch ``trend_fit``: the whole fit on one cluster; ``plan`` (a
    :class:`TrendPlan`) overrides :func:`_trend_plan`."""
    G = covariates.shape[0]
    dev = covariates.device
    covariates, targets = covariates.contiguous(), targets.contiguous()
    plan = plan or _trend_plan(G, targets.element_size())
    valid8 = valid.to(torch.uint8).contiguous()
    coeffs = torch.empty(2, dtype=targets.dtype, device=dev)
    predictions = torch.empty_like(targets)
    converged = torch.empty((), dtype=torch.uint8, device=dev)
    kernels.check_cuda_operands("trend_fit", covariates, targets, valid8, coeffs, predictions, converged)
    kernels.launch(
        "trend_fit",
        [int(targets.dtype == torch.float64), G, int(maxiter), plan.K, int(plan.shared), covariates.data_ptr(),
         targets.data_ptr(), valid8.data_ptr(), coeffs.data_ptr(), predictions.data_ptr(), converged.data_ptr()],
        dev,
    )
    return coeffs, predictions, converged.bool()


def gamma_glm_trend_fit(covariates: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor, maxiter: int = 60):
    """Fit (a0, a1) on the ``valid`` lanes: ``(coeffs (2,), predictions
    (G,), converged)``, predictions a0 + a1 x at every lane and converged a
    0-d bool tensor. Port of ``pydeseq2_tpu/ops/trend.py:22``, the fit that
    the class API's exclusion loop calls once a round. CUDA tensors launch
    the ``trend_fit`` kernel (every Fisher step and backtracking trip on the
    card, the host reads only the result); CPU tensors take the plain
    version, which reads a loop condition per trip."""
    fn = _trend_fit_cuda if covariates.is_cuda else _trend_fit_plain
    return fn(covariates, targets, valid, maxiter)


def _trend_inputs(base_mean, genewise_m, non_zero):
    """Covariates 1/base_mean and targets, zeroed outside the initial mask
    of finite non-zero genes (fused.py:251-258), and that mask."""
    covariates = 1.0 / base_mean
    valid = non_zero & torch.isfinite(covariates) & torch.isfinite(genewise_m)
    zero = torch.zeros_like(covariates)
    return torch.where(valid, covariates, zero), torch.where(valid, torch.nan_to_num(genewise_m), zero), valid


def _parametric_trend_plain(base_mean, genewise_m, non_zero, mean_disp, max_rounds):
    covariates, targets, valid = _trend_inputs(base_mean, genewise_m, non_zero)
    coeffs = torch.ones(2, dtype=base_mean.dtype, device=base_mean.device)
    failed = torch.tensor(False, device=base_mean.device)
    rounds = 0
    for _ in range(max_rounds):
        new_coeffs, preds, glm_ok = _trend_fit_plain(covariates, targets, valid, 60)
        failed = ~glm_ok | (new_coeffs <= 1e-10).any()
        drift = torch.sum(torch.log(torch.abs(new_coeffs / coeffs)) ** 2)
        ratio = genewise_m / preds
        valid = valid & (ratio >= 1e-4) & (ratio < 15.0)
        coeffs = new_coeffs
        rounds += 1
        # Host-evaluated while_loop condition (fused.py:264-266).
        if bool(failed) or not bool(drift >= 1e-6):
            break
    fitted = torch.where(failed, mean_disp, coeffs[0] + coeffs[1] / base_mean)
    return fitted, coeffs, failed, torch.tensor(rounds, dtype=torch.int32, device=base_mean.device)


def _parametric_trend_cuda(base_mean, genewise_m, non_zero, mean_disp, max_rounds, maxiter=60, plan=None):
    G = base_mean.shape[0]
    dev = base_mean.device
    ops = [t.contiguous() for t in (base_mean, genewise_m, mean_disp.reshape(1))]
    base_mean, genewise_m, mean_disp = ops
    plan = plan or _trend_plan(G, base_mean.element_size())
    nz = non_zero.to(torch.uint8).contiguous()
    valid = torch.empty(G, dtype=torch.uint8, device=dev)  # the streamed mode's mask
    fitted = torch.empty_like(base_mean)
    coeffs = torch.empty(2, dtype=base_mean.dtype, device=dev)
    failed = torch.empty((), dtype=torch.uint8, device=dev)
    rounds = torch.empty((), dtype=torch.int32, device=dev)
    kernels.check_cuda_operands("trend", *ops, nz, valid, fitted, coeffs, failed, rounds)
    kernels.launch(
        "trend",
        [
            int(base_mean.dtype == torch.float64), G, int(max_rounds), int(maxiter), plan.K, int(plan.shared),
            base_mean.data_ptr(), genewise_m.data_ptr(), nz.data_ptr(), mean_disp.data_ptr(),
            valid.data_ptr(), fitted.data_ptr(), coeffs.data_ptr(), failed.data_ptr(), rounds.data_ptr(),
        ],
        dev,
    )
    return fitted, coeffs, failed.bool(), rounds


def parametric_trend(
    base_mean: torch.Tensor,
    genewise_m: torch.Tensor,
    non_zero: torch.Tensor,
    mean_disp: torch.Tensor,
    max_rounds: int = 20,
):
    """The parametric dispersion trend with gene exclusion:
    ``(fitted (G,), coeffs (2,), failed, rounds)``.

    Rounds of :func:`gamma_glm_trend_fit` of alpha = a0 + a1 / base_mean on
    the finite ``non_zero`` genes, each dropping the genes whose genewise
    dispersion over the fit's prediction leaves [1e-4, 15), until a fit
    fails (not converged, or a coefficient <= 1e-10), the coefficients move
    less than 1e-6 in squared log distance, or ``max_rounds`` is reached
    (``pydeseq2_tpu/fused.py:250-292``). ``fitted`` is ``mean_disp`` (a 0-d
    tensor) where the trend failed, else a0 + a1 / base_mean, for every
    gene. ``rounds`` is a 0-d int32 tensor. CUDA tensors launch the
    ``trend`` kernel; CPU tensors take the plain version.
    """
    fn = _parametric_trend_cuda if base_mean.is_cuda else _parametric_trend_plain
    return fn(base_mean, genewise_m, non_zero, mean_disp, max_rounds)
