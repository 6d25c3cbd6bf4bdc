"""Exact order statistics per column — the size-factor medians.

Port of ``pydeseq2_tpu/ops/select.py``. Floats map to integer keys whose
order is the IEEE total order (negative values bit-complemented, NaN with
the sign bit clear above +inf), so the k-th smallest KEY decodes to exactly
the element a sort would put at rank k: ties, +/-inf, signed zeros and
excluded (+inf) entries included. Callers encode excluded entries as +inf
and restrict the ranks to the valid count, as in the JAX package.

Kernel (``csrc/select.cu``): replaces ``order_stats_select``
(pydeseq2_tpu/ops/select.py:65), the MSB-first radix bisection of the JAX
package. One block per column runs an 8-bit radix select over the column's
contiguous keys: 4 passes in f32 (8 in f64), each a shared-memory histogram
of the next digit among the keys that match the resolved prefix, both ranks
of the column in the same pass. On the H100 it is bound by the bytes it
reads (each pass re-reads the column: 4 x 24 MB at 100 x 60000 f32, from
L2 after the first) and by shared-memory atomics where many keys share a
digit; warp-aggregated atomics (``__match_any_sync``) cut the latter to one
add per distinct digit per warp. The result is bit-identical to a sort.

The plain version (CPU tensors only) sorts the keys and gathers the ranks.
"""

from __future__ import annotations

import torch

from pydeseq2_tpu_torch import kernels


def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """Signed integer keys with x < y  <=>  key(x) < key(y) (sign-flip map).

    The map is an involution on the bit patterns, so :func:`_key_to_float`
    applies it again. It orders like the JAX package's unsigned keys (the
    two differ only in the top bit).
    """
    if x.dtype == torch.float32:
        i = x.view(torch.int32)
        return i ^ ((i >> 31) & 0x7FFFFFFF)
    if x.dtype == torch.float64:
        i = x.view(torch.int64)
        return i ^ ((i >> 63) & 0x7FFFFFFFFFFFFFFF)
    raise TypeError(f"unsupported dtype {x.dtype}")


def _key_to_float(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bits = 31 if dtype == torch.float32 else 63
    mask = (1 << bits) - 1
    return (key ^ ((key >> bits) & mask)).view(dtype)


def order_stats_select_plain(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int = 0
) -> tuple[torch.Tensor, ...]:
    """Plain version: sort the keys along ``axis`` and gather each rank."""
    keys = _monotone_key(x).movedim(axis, 0)
    red_shape = keys.shape[1:]
    srt = keys.sort(dim=0).values
    out = []
    for k in ranks:
        k = torch.as_tensor(k, dtype=torch.int64, device=x.device).expand(red_shape)
        out.append(_key_to_float(srt.gather(0, k[None]).squeeze(0), x.dtype))
    return tuple(out)


def _order_stats_select_cuda(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int
) -> tuple[torch.Tensor, ...]:
    if len(ranks) not in (1, 2):
        raise ValueError("the select kernel resolves one or two ranks per column")
    xt = x.movedim(axis, -1)
    red_shape = xt.shape[:-1]
    L = xt.shape[-1]
    rows = xt.reshape(-1, L).contiguous()
    C = rows.shape[0]
    ks = [
        torch.as_tensor(k, dtype=torch.int32, device=x.device)
        .expand(red_shape)
        .reshape(C)
        .contiguous()
        for k in ranks
    ]
    k_hi = ks[-1]
    out_lo = torch.empty(C, dtype=x.dtype, device=x.device)
    out_hi = torch.empty(C, dtype=x.dtype, device=x.device)
    kernels.check_cuda_operands("order_stats_select", rows, out_lo, out_hi)
    kernels.launch(
        "select",
        [
            int(x.dtype == torch.float64),
            rows.data_ptr(),
            C,
            L,
            ks[0].data_ptr(),
            k_hi.data_ptr(),
            out_lo.data_ptr(),
            out_hi.data_ptr(),
        ],
        x.device,
    )
    res = (out_lo.reshape(red_shape), out_hi.reshape(red_shape))
    return res[:1] if len(ranks) == 1 else res


def order_stats_select(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int = 0
) -> tuple[torch.Tensor, ...]:
    """Exact k-th smallest elements of ``x`` along ``axis``, one per rank.

    ``x`` is float32/float64 with excluded entries encoded as +inf; ``ranks``
    are 0-based integer ranks broadcastable to the reduced shape, within the
    valid count. Returns values bit-identical to ``sort(x, axis)[k]``.
    CUDA tensors launch the radix-select kernel; CPU tensors take the plain
    version.
    """
    if x.shape[axis] == 0:
        red = x.movedim(axis, 0).shape[1:]
        return tuple(torch.full(red, float("nan"), dtype=x.dtype, device=x.device) for _ in ranks)
    if x.is_cuda:
        return _order_stats_select_cuda(x, ranks, axis)
    return order_stats_select_plain(x, ranks, axis)


def masked_median_select(
    values: torch.Tensor, n_valid: torch.Tensor, axis: int = 0
) -> torch.Tensor:
    """Median over the valid entries of ``values`` along ``axis``.

    ``values`` holds +inf at excluded entries and ``n_valid`` the per-column
    count of valid ones. Averages the two middle order statistics as
    ``np.median`` does; columns with ``n_valid == 0`` give NaN.
    """
    n_valid = torch.as_tensor(n_valid, dtype=torch.int64, device=values.device)
    k_lo = torch.clamp((n_valid - 1) // 2, min=0)
    k_hi = n_valid // 2
    v_lo, v_hi = order_stats_select(values, (k_lo, k_hi), axis=axis)
    med = (v_lo + v_hi) / 2.0
    return torch.where(n_valid > 0, med, torch.full_like(med, float("nan")))
