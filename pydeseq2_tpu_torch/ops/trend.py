"""Dispersion-trend gamma GLM fit (2 parameters, projected Fisher scoring).

Port of ``pydeseq2_tpu/ops/trend.py:gamma_glm_trend_fit`` (reference
pydeseq2/default_inference.py:200-230): minimise mean(y/mu + log mu) over
the valid genes, mu = a0 + a1 x, coefficients bounded below at 1e-12. The
work is O(G), so it stays plain PyTorch; its two while-loops become Python
loops whose conditions are read on the host.
"""

from __future__ import annotations

import torch

_LOWER = 1e-12


def _design(covariates: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.ones_like(covariates), covariates], dim=1)


def trend_loss(c, x, targets, valid, n):
    """mean over valid genes of y/mu + log mu, mu = max(x @ c, 1e-12)."""
    mu_safe = torch.clamp(x @ c, min=_LOWER)
    per = targets / mu_safe + torch.log(mu_safe)
    return torch.where(valid, per, torch.zeros_like(per)).sum() / n


def trend_grad(c, x, targets, valid, n):
    """Closed-form gradient of :func:`trend_loss`.

    The JAX package takes ``jax.grad`` of the loss, which differentiates
    ``maximum(mu, 1e-12)`` as 1 above the bound, 1/2 at a tie and 0 below;
    this reproduces that factor, so a lane clamped at the bound contributes
    no gradient.
    """
    mu = x @ c
    mu_safe = torch.clamp(mu, min=_LOWER)
    dper = -targets / (mu_safe * mu_safe) + 1.0 / mu_safe
    one = torch.ones_like(mu)
    dmax = torch.where(mu > _LOWER, one, torch.where(mu == _LOWER, 0.5 * one, 0.0 * one))
    gmu = torch.where(valid, dper * dmax, torch.zeros_like(dper)) / n
    return x.T @ gmu


def _fisher(c, x, w, n):
    # Expected information of the gamma GLM with identity link (always PSD).
    mu = torch.clamp(x @ c, min=_LOWER)
    return (x.T * (w / mu**2)) @ x / n


def gamma_glm_trend_fit(covariates: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor, maxiter: int = 60):
    """Fit (a0, a1): ``(coeffs (2,), predictions (G,), converged)``."""
    dtype = targets.dtype
    dev = targets.device
    x = _design(covariates)
    w = valid.to(dtype)
    n = torch.clamp(w.sum(), min=1.0)
    eye = 1e-12 * torch.eye(2, dtype=dtype, device=dev)
    eps = torch.finfo(dtype).eps

    def loss(c):
        return trend_loss(c, x, targets, valid, n)

    def grad(c):
        return trend_grad(c, x, targets, valid, n)

    c = torch.ones(2, dtype=dtype, device=dev)
    f_val = loss(c)
    for _ in range(maxiter):
        step = torch.linalg.solve(_fisher(c, x, w, n) + eye, grad(c))
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

    predictions = x @ c
    g_final = grad(c)
    at_bound = (c <= _LOWER * (1 + 1e-9)) & (g_final > 0)
    pg = torch.where(at_bound, torch.zeros_like(g_final), g_final)
    decrement = 0.5 * pg @ torch.linalg.solve(_fisher(c, x, w, n) + eye, pg)
    converged = torch.isfinite(f_val) & (decrement <= 1e3 * eps * (torch.abs(f_val) + 1.0))
    return c, predictions, converged
