"""Closed-form batched linear algebra for tiny symmetric systems.

Port of ``pydeseq2_tpu/ops/smalllinalg.py``. The design matrix has P <= ~10
columns and the solvers need per-gene (P, P) solves, inverses and
log-determinants for tens of thousands of genes. P in {1, 2, 3} use
adjugate/cofactor closed forms and P <= 8 an unrolled Cholesky, expression
for expression as in the JAX package, so the numerics match; only P > 8
goes to batched ``torch.linalg``. The CUDA kernels carry the same forms in
``csrc/common.cuh``.

All matrices are symmetric positive (semi-)definite Gram matrices
M = X^T W X (+ ridge), batched as (..., P, P).
"""

from __future__ import annotations

import torch

_UNROLL_MAX = 8


def _chol_unrolled(M: torch.Tensor) -> dict:
    """Unrolled Cholesky factors {(i, j): L_ij} (i >= j) of batched M."""
    P = M.shape[-1]
    tiny = torch.finfo(M.dtype).tiny
    L: dict = {}
    for j in range(P):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        L[(j, j)] = torch.sqrt(torch.clamp(s, min=tiny))
        for i in range(j + 1, P):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s / L[(j, j)]
    return L


def _chol_solve_unrolled(L: dict, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b given unrolled factors. b: (..., P)."""
    P = b.shape[-1]
    y = []
    for i in range(P):
        s = b[..., i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y.append(s / L[(i, i)])
    x = [None] * P
    for i in reversed(range(P)):
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return torch.stack(x, dim=-1)


def sym_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for symmetric M, batched. b: (..., P) -> (..., P)."""
    P = M.shape[-1]
    if P == 1:
        return b / M[..., 0, 0:1]
    if P == 2:
        a, c = M[..., 0, 0], M[..., 0, 1]
        d = M[..., 1, 1]
        det = a * d - c * c
        x0 = (d * b[..., 0] - c * b[..., 1]) / det
        x1 = (a * b[..., 1] - c * b[..., 0]) / det
        return torch.stack([x0, x1], dim=-1)
    if P == 3:
        return (sym_inv(M) @ b[..., None])[..., 0]
    if P <= _UNROLL_MAX:
        return _chol_solve_unrolled(_chol_unrolled(M), b)
    return torch.linalg.solve(M, b[..., None])[..., 0]


def sym_inv(M: torch.Tensor) -> torch.Tensor:
    """Inverse of symmetric M, batched (..., P, P)."""
    P = M.shape[-1]
    if P == 1:
        return 1.0 / M
    if P == 2:
        a, c = M[..., 0, 0], M[..., 0, 1]
        d = M[..., 1, 1]
        det = a * d - c * c
        inv = torch.stack(
            [torch.stack([d, -c], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
        )
        return inv / det[..., None, None]
    if P == 3:
        a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e = M[..., 1, 1], M[..., 1, 2]
        f = M[..., 2, 2]
        A = d * f - e * e
        B = c * e - b_ * f
        C = b_ * e - c * d
        D = a * f - c * c
        E = b_ * c - a * e
        F = a * d - b_ * b_
        det = a * A + b_ * B + c * C
        inv = torch.stack(
            [
                torch.stack([A, B, C], dim=-1),
                torch.stack([B, D, E], dim=-1),
                torch.stack([C, E, F], dim=-1),
            ],
            dim=-2,
        )
        return inv / det[..., None, None]
    if P <= _UNROLL_MAX:
        L = _chol_unrolled(M)
        eye = torch.eye(P, dtype=M.dtype, device=M.device)
        cols = [
            _chol_solve_unrolled(L, eye[j].expand(M.shape[:-1])) for j in range(P)
        ]
        return torch.stack(cols, dim=-1)
    return torch.linalg.inv(M)


def sym_logdet(M: torch.Tensor) -> torch.Tensor:
    """log |det M| for symmetric PSD M, batched (..., P, P) -> (...)."""
    P = M.shape[-1]
    tiny = torch.finfo(M.dtype).tiny
    if P == 1:
        return torch.log(torch.clamp(M[..., 0, 0], min=tiny))
    if P == 2:
        a, c = M[..., 0, 0], M[..., 0, 1]
        d = M[..., 1, 1]
        return torch.log(torch.clamp(a * d - c * c, min=tiny))
    if P == 3:
        a, b_, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e = M[..., 1, 1], M[..., 1, 2]
        f = M[..., 2, 2]
        det = a * (d * f - e * e) + b_ * (c * e - b_ * f) + c * (b_ * e - c * d)
        return torch.log(torch.clamp(det, min=tiny))
    if P <= _UNROLL_MAX:
        L = _chol_unrolled(M)
        out = 0.0
        for j in range(P):
            out = out + torch.log(L[(j, j)])
        return 2.0 * out
    return torch.linalg.slogdet(M)[1]


def weighted_gram(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(..., P, P) Gram matrices X^T diag(W) X for weights W of shape (..., N).

    One (..., N) @ (N, P*P) product against the per-sample outer products,
    as the JAX package's ``einsum("gn,np,nq->gpq")`` leaves it to a dot.
    """
    N, P = X.shape
    XX = (X[:, :, None] * X[:, None, :]).reshape(N, P * P)
    return (W @ XX).reshape(W.shape[:-1] + (P, P))
