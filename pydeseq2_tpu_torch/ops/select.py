"""Exact order statistics per column — the size-factor medians.

Port of ``pydeseq2_tpu/ops/select.py``. Floats map to integer keys whose
order is the IEEE total order (negative values bit-complemented, NaN with
the sign bit clear above +inf), so the k-th smallest KEY decodes to exactly
the element a sort would put at rank k: ties, +/-inf, signed zeros and
excluded (+inf) entries included. Callers encode excluded entries as +inf
and restrict the ranks to the valid count, as in the JAX package.

Kernel (``csrc/select.cu``): replaces ``order_stats_select``
(pydeseq2_tpu/ops/select.py:65), the MSB-first radix bisection of the JAX
package. The wrapper hands the kernel the tile where it lies, with its
strides: no transposed copy. :func:`_select_plan` groups B adjacent
columns (8 bytes of a row) and splits a group's rows over a thread-block
cluster of K blocks, so that the groups' blocks cover the card's SMs and
each block's keys fit its shared memory: one column of 60000 takes a
cluster of 16 blocks, not one block on one SM. A block maps
its values to keys once, into shared memory; each pass histograms the next
8-bit digit of the keys that still match a rank's prefix (compacting them
in place from the second pass), the cluster adds its blocks' integer
histograms over distributed shared memory, and every block picks the same
digit: 4 passes in float32, 8 in float64 (a ``kernel_bench`` sweep of
8-11-bit digits found 8 the fastest at every shape: with the candidates
compacted, a pass costs little, and wider digits pay for the scan and
exchange of their bins). Where the keys do not fit 16 blocks,
each pass streams them from device memory again. The result is
bit-identical to a sort.

The plain version (CPU tensors only) sorts the keys and gathers the ranks.

The gene mesh's median (:func:`sharded_masked_median`) runs the same radix
passes with the keys spread over the ranks: ``select_hist`` counts each
pass's digit of the local keys (a warp a column over staged chunks where
most keys match the prefix, each thread on the keys it loaded where few
do), the ranks all-reduce the counts, and ``select_pick`` resolves the
digit from the totals, one launch a pass, the last decoding the median.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


class SelectPlan(NamedTuple):
    """A launch of the ``select`` kernel: ``B`` adjacent columns a cluster
    (1 or 2), ``K`` blocks a cluster (each a 1/K share of the rows), the
    keys ``staged`` in shared memory (else streamed each pass)."""

    B: int
    K: int
    staged: bool


_SELECT_STATE_BYTES = 512  # the columns' prefixes, ranks, counts and flags (csrc/select.cu)
_SELECT_BINS = 256  # bins of a (column, rank): 8-bit digits
_SELECT_SPAN_BYTES = 8  # a group's share of a row
_SELECT_BLOCK_KEY_BYTES = 65_536  # a block's staged keys, at most, where K allows
_SELECT_MIN_ROWS = 512  # a block's share of the rows, at least (one per thread)


def _select_smem_bytes(B: int, R: int, itemsize: int, staged: bool) -> int:
    """Dynamic shared memory of a block of ``R`` rows: the columns' state,
    three bin arrays (two histogram buffers, the gathered totals) of B x 2
    ranks x 256 counts, and in shared mode the keys, B columns of R | 1."""
    bins = 3 * kernels.align16(B * 2 * _SELECT_BINS * 4)
    keys = kernels.align16(B * (R | 1) * itemsize) if staged else 0
    return _SELECT_STATE_BYTES + bins + keys


def _select_plan(C: int, L: int, itemsize: int, adjacent: bool = True, sms: int = 132,
                 k_max: int = kernels.MAX_CLUSTER) -> SelectPlan:
    """The plan for C columns of L values of ``itemsize`` bytes.

    B: where the columns are adjacent in memory, those in 8 bytes of a row
    (2 float32, 1 float64; fewer where C is smaller), else 1. A
    ``kernel_bench`` sweep on an H100 found 32-byte groups (8 float32
    columns, each row's span one sector) slower, 0.202 against 0.146 ms at
    100 x 60000 and 1.84 against 1.05 at 1000 x 60000: a block's work and
    shared memory grow with B, and the neighbouring groups read the rest of
    each sector from L2. K: the fewest blocks (a power of two, at
    most ``k_max``) whose share of the keys takes at most 64 KB, raised
    until the groups' blocks cover ``sms`` SMs while a block keeps at least
    512 rows: a column of 60000 takes 16. Staged where that share fits a
    block's shared memory, else streamed.
    """
    B = 1
    if adjacent and C > 1:
        while B * 2 <= min(_SELECT_SPAN_BYTES // itemsize, C):
            B *= 2
    groups = -(-C // B)
    k_cover = 1
    while k_cover < k_max and groups * k_cover < sms:
        k_cover *= 2
    k_rows = 1
    while k_rows < k_max and -(-L // (k_rows * 2)) >= _SELECT_MIN_ROWS:
        k_rows *= 2
    k_keys = 1
    while k_keys < k_max and B * -(-L // k_keys) * itemsize > _SELECT_BLOCK_KEY_BYTES:
        k_keys *= 2
    K = max(k_keys, min(k_cover, k_rows))
    staged = _select_smem_bytes(B, -(-L // K), itemsize, True) <= kernels.SMEM_BLOCK_MAX
    return SelectPlan(B, K, staged)


@functools.lru_cache(maxsize=None)
def _select_k_max(device: torch.device, itemsize: int) -> int:
    """16 where the card holds a cluster of 16 blocks of the most shared
    memory a block may have (the occupancy API for this build; no launch),
    else 8."""
    out = ctypes.c_int(0)
    kernels.call_helper("select_max_clusters", [int(itemsize == 8), kernels.MAX_CLUSTER, kernels.SMEM_BLOCK_MAX,
                                                ctypes.addressof(out)], device)
    return kernels.MAX_CLUSTER if out.value >= 1 else 8


def _select_device_plan(C: int, L: int, dtype, device, adjacent: bool = True) -> SelectPlan:
    """:func:`_select_plan` with the card's SMs and its largest cluster."""
    isz = torch.empty((), dtype=dtype).element_size()
    dev = torch.device(device)
    return _select_plan(C, L, isz, adjacent, kernels.sm_count(dev), _select_k_max(dev, isz))


def _order_stats_select_cuda(
    x: torch.Tensor, ranks: tuple[torch.Tensor, ...], axis: int, plan: SelectPlan | None = None
) -> tuple[torch.Tensor, ...]:
    """Launch the ``select`` kernel on ``x`` where it lies (its strides, no
    copy, wherever the reduced axes flatten to one as a view: every 2-D
    ``x``); ``plan`` overrides :func:`_select_device_plan`."""
    if len(ranks) not in (1, 2):
        raise ValueError("the select kernel resolves one or two ranks per column")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"order_stats_select: unsupported dtype {x.dtype}")
    xt = x.movedim(axis, -1)
    red_shape = xt.shape[:-1]
    L = xt.shape[-1]
    cols = xt.reshape(-1, L)  # a view of x for a 2-D x (a copy only for N-d layouts that need one)
    C = cols.shape[0]
    s_col, s_row = cols.stride()
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
    kernels.check_cuda_operands("order_stats_select", out_lo, out_hi)
    kernels.check_cuda_device("order_stats_select", cols)
    if plan is None:
        plan = _select_device_plan(C, L, x.dtype, x.device, adjacent=s_col == 1)
    kernels.launch(
        "select",
        [
            int(x.dtype == torch.float64),
            cols.data_ptr(),
            C,
            L,
            s_col,
            s_row,
            ks[0].data_ptr(),
            k_hi.data_ptr(),
            out_lo.data_ptr(),
            out_hi.data_ptr(),
            plan.B,
            plan.K,
            int(plan.staged),
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
    CUDA tensors launch the radix-select kernel on ``x`` where it lies; CPU
    tensors take the plain version.
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


# ------------------------------------------------------ the sharded median
# A radix select whose keys are spread over the ranks of a gene mesh: each
# pass histograms the next 8-bit digit of the local keys that match the
# prefix resolved so far (the ``select_hist`` kernel, ``csrc/select.cu``),
# the ranks add their integer histograms (an all-reduce), and every rank
# picks the same digit from the same totals (the ``select_pick`` kernel).
# The keys are the unsigned ones of the kernels (a float's bits, the sign
# bit set on non-negatives, every bit flipped on negatives), digits MSB
# first.
_HIST_COLS = 16  # columns a select_hist block (csrc/select.cu)
_HIST_WARPS = 16  # warps a block
_HIST_CHUNK = 256  # rows a staged chunk
_HIST_LOADS = 8  # values a thread stages a chunk
_HIST_MIN_ROWS = 256  # rows a block, at least
_WARP = 32
_HIST_WAVE_SLACK = 1.1  # the plan's waves, at most this over the fewest its row splits allow


class HistPlan(NamedTuple):
    """A ``select_hist`` launch: ``rows`` rows a block (a multiple of 32),
    the keys ``staged`` in shared memory (columns adjacent in memory) or
    read where they lie."""

    rows: int
    staged: bool


def _passes(dtype: torch.dtype) -> int:
    return 4 if dtype == torch.float32 else 8


def _unsigned_key(x: torch.Tensor) -> torch.Tensor:
    """The kernels' unsigned keys as int64 bit patterns (float64: the
    pattern of the 64-bit key; float32: the 32-bit key, zero-extended)."""
    if x.dtype == torch.float32:
        u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    if x.dtype == torch.float64:
        i = x.contiguous().view(torch.int64)
        return torch.where(i < 0, ~i, i ^ torch.iinfo(torch.int64).min)
    raise TypeError(f"unsupported dtype {x.dtype}")


def _prefix_of(digits: torch.Tensor, pass_: int) -> torch.Tensor:
    """(C, 2) int64: the value of the first ``pass_`` digits (MSB first)."""
    p = torch.zeros(digits.shape[:2], dtype=torch.int64, device=digits.device)
    for j in range(pass_):
        p = (p << 8) | digits[..., j].to(torch.int64)
    return p


def _columns(x: torch.Tensor, axis: int) -> torch.Tensor:
    """(C, L): the columns along ``axis`` (a view of a 2-D ``x``)."""
    cols = x.movedim(axis, -1)
    return cols.reshape(-1, cols.shape[-1])


def select_hist_plain(x: torch.Tensor, digits: torch.Tensor, pass_: int, axis: int = 0) -> torch.Tensor:
    """Plain version of ``select_hist``: (C, 2, 256) int32 counts of pass
    ``pass_``'s digit of the keys along ``axis`` that match each (column,
    rank)'s prefix, a ``torch.bincount`` of the masked digits."""
    keys = _unsigned_key(x).movedim(axis, -1)
    keys = keys.reshape(-1, keys.shape[-1])  # (C, L)
    C = keys.shape[0]
    bits = 32 if x.dtype == torch.float32 else 64
    shift = bits - 8 * (pass_ + 1)
    digit = (keys >> shift) & 0xFF
    if pass_:
        top = (keys >> (bits - 8 * pass_)) & ((1 << (8 * pass_)) - 1)
        match = top[:, None, :] == _prefix_of(digits, pass_)[:, :, None]  # (C, 2, L)
    else:
        match = torch.ones((C, 2, keys.shape[1]), dtype=torch.bool, device=x.device)
    bins = (torch.arange(C * 2, device=x.device).reshape(C, 2, 1) * 256 + digit[:, None, :])[match]
    return torch.bincount(bins, minlength=C * 2 * 256).reshape(C, 2, 256).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _hist_plan(C: int, L: int, staged: bool, slots: int = 528) -> HistPlan:
    """The plan for C columns of L values, ``slots`` blocks resident on the
    card at once (the SMs times the blocks an SM holds). Each 16-column
    group's rows split s ways, s the fewest (each block keeping at least 256
    rows) whose waves of blocks, ceil(groups s / slots) / s in units of one
    unsplit block, are within 10% of the fewest any s allows: one wave at
    100 x 60000 (7 groups); three or four splits for 625 groups, where one
    would leave most SMs idle in its second wave. Rows a block round up to
    a warp's 32."""
    groups = -(-C // _HIST_COLS)
    max_splits = max(1, -(-L // _HIST_MIN_ROWS))
    waves = [-(-(groups * s) // slots) / s for s in range(1, max_splits + 1)]
    least = min(waves)
    s = next(i + 1 for i, w in enumerate(waves) if w <= least * _HIST_WAVE_SLACK)
    rows = -(-(-(-L // s)) // _WARP) * _WARP
    return HistPlan(rows, staged)


def _hist_cover(C: int, L: int, plan: HistPlan, vec: bool = True,
                itemsize: int = 4) -> tuple[torch.Tensor, torch.Tensor | None]:
    """How often ``select_hist`` under ``plan`` counts each (column, row) of
    C columns of L values, and in staged mode how often it stages each:
    (C, L) int32 tensors from the kernel's own index arithmetic (its
    blocks, warps, chunks, steps and lanes; ``vec``: the 16-byte loads of
    values of ``itemsize`` bytes where a block is full), for the tests.
    None for the staging of a plan that reads in place. A staged block that
    goes sparse tests each value where it loaded it: the staging's cells."""
    counted = torch.zeros((C, L), dtype=torch.int32)
    staged = torch.zeros((C, L), dtype=torch.int32) if plan.staged else None
    lanes = torch.arange(_WARP)
    tid = torch.arange(_HIST_WARPS * _WARP)
    vw = 16 // itemsize  # values a 16-byte load
    for c0 in range(0, C, _HIST_COLS):
        Bc = min(_HIST_COLS, C - c0)
        S = _HIST_WARPS // Bc
        walks = [(w % Bc, w // Bc) for w in range(S * Bc)]  # (column, share) of each active warp
        if plan.staged:
            if vec and Bc == _HIST_COLS:  # vw adjacent columns of a row a thread
                tpr = _HIST_COLS // vw
                s_col = (tid % tpr)[None, :, None] * vw + torch.arange(vw)[None, None, :]
                s_row = (tid // tpr)[None, :, None] + (tid.numel() // tpr) * torch.arange(_HIST_LOADS // vw)[:, None, None]
                s_col, s_row = torch.broadcast_tensors(s_col, s_row)
            else:  # one column of a row a thread, 16 columns x 32 rows a round
                s_col = (tid % _HIST_COLS)[None, :].expand(_HIST_LOADS, -1)
                s_row = (tid // _HIST_COLS)[None, :] + _WARP * torch.arange(_HIST_LOADS)[:, None]
            s_col, s_row = s_col.reshape(-1), s_row.reshape(-1)
        for r0 in range(0, L, plan.rows):
            Rb = min(plan.rows, L - r0)
            chunks = [(b, min(_HIST_CHUNK, Rb - b)) for b in range(0, Rb, _HIST_CHUNK)] if plan.staged else [(0, Rb)]
            for base, n_rows in chunks:
                if plan.staged:
                    ok = (s_row < n_rows) & (s_col < Bc)
                    staged.index_put_((c0 + s_col[ok], r0 + base + s_row[ok]),
                                      torch.ones(int(ok.sum()), dtype=torch.int32), accumulate=True)
                for col, share in walks:
                    for k in range(share, -(-n_rows // _WARP), S):
                        row = k * _WARP + lanes
                        counted[c0 + col, r0 + base + row[row < n_rows]] += 1
    return counted, staged


@functools.lru_cache(maxsize=None)
def _hist_slots(device: torch.device, is_f64: bool, staged: bool) -> int:
    """The ``select_hist`` blocks the card holds at once: its SMs times the
    blocks an SM holds (the occupancy API for this build; no launch)."""
    out = ctypes.c_int(0)
    kernels.call_helper("select_hist_per_sm", [int(is_f64), int(staged), ctypes.addressof(out)], device)
    return max(1, out.value) * kernels.sm_count(device)


def _hist_device_plan(cols: torch.Tensor) -> HistPlan:
    """:func:`_hist_plan` for the (C, L) columns view ``cols`` on its card:
    staged where the columns are adjacent in memory and there are several."""
    C, L = cols.shape
    staged = C > 1 and cols.stride(0) == 1
    return _hist_plan(C, L, staged, _hist_slots(cols.device, cols.dtype == torch.float64, staged))


def _check_digits(digits: torch.Tensor, C: int, npass: int, name: str) -> None:
    """The kernels read a (column, rank)'s digits by 4-byte words."""
    if (digits.shape != (C, 2, npass) or digits.dtype != torch.uint8 or not digits.is_contiguous()
            or digits.data_ptr() % 4):
        raise ValueError(f"{name}: digits must be a contiguous, 4-byte aligned ({C}, 2, {npass}) uint8 tensor")


def _hist_head(cols: torch.Tensor, digits: torch.Tensor) -> list:
    """The leading ``select_hist`` arguments for the (C, L) view ``cols``:
    its type, address, shape and strides, the digits' address, the passes."""
    C, L = cols.shape
    return [int(cols.dtype == torch.float64), cols.data_ptr(), C, L, *cols.stride(), digits.data_ptr(),
            _passes(cols.dtype)]


def _hist_launch(head: list, pass_: int, out: int, plan: HistPlan, device: torch.device) -> None:
    """One ``select_hist`` launch (``head`` from :func:`_hist_head`) adding
    into the counts at device address ``out``."""
    kernels.launch("select_hist", head + [pass_, plan.rows, int(plan.staged), out], device)


def _select_hist_cuda(x: torch.Tensor, digits: torch.Tensor, pass_: int, axis: int = 0,
                      plan: HistPlan | None = None) -> torch.Tensor:
    """Launch ``select_hist`` on ``x`` where it lies (its strides; a view of
    a 2-D ``x``) into new zeroed counts; ``plan`` overrides
    :func:`_hist_device_plan`."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"select_hist: unsupported dtype {x.dtype}")
    cols = _columns(x, axis)
    C = cols.shape[0]
    _check_digits(digits, C, _passes(x.dtype), "select_hist")
    kernels.check_cuda_device("select_hist", cols, digits)
    out = torch.zeros((C, 2, 256), dtype=torch.int32, device=x.device)
    _hist_launch(_hist_head(cols, digits), pass_, out.data_ptr(), plan or _hist_device_plan(cols), x.device)
    return out


def select_hist(x: torch.Tensor, digits: torch.Tensor, pass_: int, axis: int = 0) -> torch.Tensor:
    """One radix pass over the local keys of ``x`` along ``axis``: (C, 2,
    256) int32 counts of digit ``pass_`` (MSB first) of the keys matching
    each (column, rank)'s prefix, given by the first ``pass_`` of
    ``digits`` (C, 2, passes) uint8. CUDA tensors launch the ``select_hist``
    kernel; CPU tensors take the plain version."""
    if x.is_cuda:
        return _select_hist_cuda(x, digits, pass_, axis)
    return select_hist_plain(x, digits, pass_, axis)


def _decode(digits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The floats whose keys are ``digits`` (..., passes), MSB first."""
    word = torch.int32 if dtype == torch.float32 else torch.int64
    k = digits.flip(-1).contiguous().view(word).squeeze(-1)  # little-endian bytes
    top = torch.iinfo(word).min
    return torch.where(k < 0, k ^ top, ~k).view(dtype)


def radix_pick(hist: torch.Tensor, rank: torch.Tensor, digits: torch.Tensor, pass_: int) -> torch.Tensor:
    """Resolve pass ``pass_``'s digit of each (column, rank) from the
    totals ``hist`` (C, 2, 256) into ``digits``; returns the ranks within
    the chosen bins. The digit is the first bin whose running count passes
    the rank (a rank past the count: the last digit)."""
    cum = hist.to(torch.int64).cumsum(-1)
    d = torch.clamp((cum <= rank[..., None]).sum(-1), max=255)
    before = torch.where(d > 0, cum.gather(-1, (d - 1).clamp(min=0)[..., None]).squeeze(-1), 0)
    digits[..., pass_] = d.to(torch.uint8)
    return rank - before


def _mid_ranks(n: torch.Tensor) -> torch.Tensor:
    """(C, 2) int64: the two middle ranks of each column's ``n`` valid entries."""
    return torch.stack([torch.clamp((n - 1) // 2, min=0), n // 2], dim=-1)


def select_pick_plain(hist: torch.Tensor, n_valid: torch.Tensor, rank: torch.Tensor, digits: torch.Tensor,
                      pass_: int, out: torch.Tensor | None = None) -> None:
    """Plain version of ``select_pick``, in the kernel's terms: each
    (column, rank)'s digit is the first bin of ``hist`` (C, 2, 256) whose
    running count passes the rank (none: 255), written to ``digits[...,
    pass_]``, and the rank less the count before that bin (none: before bin
    255) to ``rank`` (C, 2), in place; the ranks entering the pass come
    from ``rank``, at pass 0 the two middle ranks of ``n_valid`` (C,). With
    ``out`` (C,): the median from the keys the digits spell, NaN where
    ``n_valid`` is 0. ``radix_pick`` and ``_decode`` are the same function
    written as counts and bytes."""
    k = _mid_ranks(n_valid) if pass_ == 0 else rank.to(torch.int64)
    cum = hist.to(torch.int64).cumsum(-1)
    passed = cum > k[..., None]
    d = torch.where(passed.any(-1), passed.to(torch.uint8).argmax(-1), 255)
    before = torch.where(d > 0, cum.gather(-1, (d - 1).clamp(min=0)[..., None]).squeeze(-1), 0)
    digits[..., pass_] = d.to(torch.uint8)
    rank.copy_(k - before)
    if out is None:
        return
    npass = digits.shape[-1]
    bits = 8 * npass
    key = torch.zeros(digits.shape[:2], dtype=torch.int64, device=digits.device)
    for j in range(npass):
        key = key | (digits[..., j].to(torch.int64) << (bits - 8 * (j + 1)))
    if npass == 4:  # the 32-bit key as a signed int32 pattern
        key = torch.where(key >= 1 << 31, key - (1 << 32), key)
    word = torch.int32 if npass == 4 else torch.int64
    key = key.to(word)
    top = torch.iinfo(word).min
    v = torch.where(key < 0, key ^ top, ~key).view(out.dtype)  # the top bit set: a non-negative float
    med = (v[:, 0] + v[:, 1]) / 2.0
    out.copy_(torch.where(n_valid > 0, med, torch.full_like(med, float("nan"))))


def _pick_launch(is_f64: bool, C: int, npass: int, pass_: int, counts: int, n: int, n_stride: int, rank: int,
                 digits: int, out: int | None, device: torch.device) -> None:
    """One ``select_pick`` launch (every operand a device address)."""
    kernels.launch("select_pick", [int(is_f64), C, npass, pass_, counts, n, n_stride, rank, digits, out], device)


def _select_pick_cuda(hist: torch.Tensor, n_valid: torch.Tensor, rank: torch.Tensor, digits: torch.Tensor,
                      pass_: int, out: torch.Tensor | None = None) -> None:
    """Launch ``select_pick`` on CUDA operands (as :func:`select_pick_plain`;
    ``rank`` int32, ``n_valid`` int64 (C,) or one count)."""
    C = hist.shape[0]
    npass = digits.shape[-1]
    _check_digits(digits, C, npass, "select_pick")
    for name, t, shape in (("hist", hist, (C, 2, 256)), ("rank", rank, (C, 2))):
        if t.dtype != torch.int32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"select_pick: {name} must be a contiguous {shape} int32 tensor")
    n = n_valid.to(torch.int64).reshape(-1).contiguous()
    if n.numel() not in (1, C) or (out is not None and (out.shape != (C,) or not out.is_contiguous())):
        raise ValueError("select_pick: n_valid must hold one count or one a column, out (C,)")
    kernels.check_cuda_device("select_pick", hist, n, rank, digits, *([] if out is None else [out]))
    _pick_launch(npass == 8, C, npass, pass_, hist.data_ptr(), n.data_ptr(), int(n.numel() > 1), rank.data_ptr(),
                 digits.data_ptr(), kernels.ptr(out), hist.device)


def select_pick(hist: torch.Tensor, n_valid: torch.Tensor, rank: torch.Tensor, digits: torch.Tensor, pass_: int,
                out: torch.Tensor | None = None) -> None:
    """Resolve pass ``pass_``'s digit of each (column, rank) from the ranks'
    totals ``hist`` (see :func:`select_pick_plain`). CUDA tensors launch the
    ``select_pick`` kernel; CPU tensors take the plain version."""
    if hist.is_cuda:
        _select_pick_cuda(hist, n_valid, rank, digits, pass_, out)
    else:
        select_pick_plain(hist, n_valid.expand(hist.shape[0]) if n_valid.numel() == 1 else n_valid.reshape(-1),
                          rank, digits, pass_, out)


def sharded_masked_median(values: torch.Tensor, n_valid: torch.Tensor, mesh=None, axis: int = 0,
                          plan: HistPlan | None = None) -> torch.Tensor:
    """:func:`masked_median_select` over a reduced axis split over the ranks
    of ``mesh``: each rank holds its rows of ``values`` (+inf at excluded
    entries), and ``n_valid`` is the per-column count of valid entries over
    every rank. Each of the 4 (float32) or 8 (float64) radix passes is one
    ``select_hist`` launch, an all-reduce of its (C, 2, 256) int32 counts
    and one ``select_pick`` launch; the counts of every pass, the ranks and
    the digits share one buffer, zeroed once. The decoded keys are the
    elements a sort of the whole axis puts at the two middle ranks, so the
    median is bit for bit the unsharded one. ``mesh=None`` runs the passes
    on one rank; ``plan`` overrides :func:`_hist_device_plan` on the card."""
    from pydeseq2_tpu_torch.parallel.mesh import all_reduce_sum

    dev = values.device
    cols = _columns(values, axis)
    C = cols.shape[0]
    red_shape = values.movedim(axis, -1).shape[:-1]
    n = torch.as_tensor(n_valid, dtype=torch.int64, device=dev)
    n = n.reshape(1) if n.numel() == 1 else n.expand(red_shape).reshape(C).contiguous()
    npass = _passes(values.dtype)
    n_counts = npass * C * 2 * 256
    work = torch.zeros(n_counts + 2 * C + -(-2 * C * npass // 4), dtype=torch.int32, device=dev)
    counts = work[:n_counts].view(npass, C, 2, 256)
    rank = work[n_counts:n_counts + 2 * C].view(C, 2)
    digits = work[n_counts + 2 * C:].view(torch.uint8)[:2 * C * npass].view(C, 2, npass)
    med = torch.empty(C, dtype=values.dtype, device=dev)
    if not values.is_cuda:
        for p in range(npass):
            counts[p] = select_hist_plain(values, digits, p, axis)
            all_reduce_sum(counts[p], mesh)
            select_pick(counts[p], n, rank, digits, p, med if p == npass - 1 else None)
        return med.reshape(red_shape)
    kernels.check_cuda_device("sharded_masked_median", cols)
    plan = plan or _hist_device_plan(cols)
    head = _hist_head(cols, digits)
    base, pass_bytes = work.data_ptr(), C * 2 * 256 * 4
    for p in range(npass):
        _hist_launch(head, p, base + p * pass_bytes, plan, dev)
        if mesh is not None:
            all_reduce_sum(counts[p], mesh)
        _pick_launch(head[0], C, npass, p, base + p * pass_bytes, n.data_ptr(), int(n.numel() > 1),
                     rank.data_ptr(), head[6], med.data_ptr() if p == npass - 1 else None, dev)
    return med.reshape(red_shape)
