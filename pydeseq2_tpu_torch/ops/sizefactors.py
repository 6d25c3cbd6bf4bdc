"""Iterative (trimmed-likelihood MLE) size factors.

Port of ``pydeseq2_tpu/ops/sizefactors.py``: the fallback normalisation of
zero-inflated data, where median-of-ratios is undefined because every gene
has a zero (reference pydeseq2/dds.py:682-690, 1460-1548). Under an
intercept-only design it alternates a dispersion fit at the current size
factors with :func:`trimmed_sf_newton`, which minimises the summed NB NLL
of the best ``quant`` share of genes over the per-sample log size factors.
With the kept genes fixed that objective separates per sample and is
convex in each log size factor, so every sample takes guarded Newton steps
at once from per-sample column sums.

Kernels (``csrc/sizefactors.cu``) replace ``trimmed_sf_newton``
(``pydeseq2_tpu/ops/sizefactors.py:34``) and its tiled copy in
``iterative_size_factors``' ``gene_block`` path (``:272-372``): ``sf_nll``
(one warp per gene, the per-gene NLL, +inf off the mask) and ``sf_newton``
(the Newton steps of one outer round, each a two-pass fixed-order column
reduction over the kept genes). Neither stores the baseline means: each
cell recomputes them from the gene's OLS coefficient (``mom``'s output),
so neither path holds a (G, N) temporary and ``gene_block`` only tiles the
dispersion fits. Both kernels and their plain versions sum in float64 and
round, so they stop on the same keep sets. The quantile between the
launches takes its two order statistics from the ``select`` kernel, with
the ranks as device tensors (no host read).
"""

from __future__ import annotations

import numpy as np
import torch

from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.convert import resolve_device
from pydeseq2_tpu_torch.fused import dispersion_prior
from pydeseq2_tpu_torch.ops.dispersion import alpha_mle_batch
from pydeseq2_tpu_torch.ops.linreg import mom_and_mu_coef, mu_from_coef, ols_pinv
from pydeseq2_tpu_torch.ops.nb import nb_nll_terms
from pydeseq2_tpu_torch.ops.select import order_stats_select
from pydeseq2_tpu_torch.ops.stats import _fma, trimmed_mean_masked

# The trimmed solve's schedule, shared by the whole-G and gene_block paths:
# outer rounds (a new keep set each) and Newton steps per round.
OUTER_ITERS = 6
NEWTON_ITERS = 8

# The ~4 GB device budget of the streamed pipelines' block sizing: ~20 live
# (block, N) temporaries a cell, of the counts' itemsize.
_BLOCK_BUDGET_BYTES = 4_000_000_000


def pick_sf_gene_block(G: int, N: int, dtype) -> int | None:
    """The ``gene_block`` of :func:`iterative_size_factors` for (G, N)
    counts of ``dtype`` (torch or numpy): None (whole G) up to 1 GB of
    counts, else blocks whose ~20 live (block, N) temporaries fit ~4 GB,
    split evenly and rounded up to 8, as the streamed pipelines' blocks."""
    itemsize = torch.finfo(dtype).bits // 8 if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
    if G * N * itemsize <= 1_000_000_000:
        return None
    raw = int(max(1024, min(G, _BLOCK_BUDGET_BYTES // (20 * itemsize * N))))
    n_blocks = -(-G // raw)
    return ((-(-G // n_blocks) + 7) // 8) * 8


def _row_slices(G: int, gene_block: int | None) -> list[slice]:
    B = G if gene_block is None else max(1, min(int(gene_block), G))
    return [slice(b, b + B) for b in range(0, G, B)]


def _base_mu(coef, sf0, inv_sf0, min_mu):
    """Rows of max(sf0 coef, min_mu) / sf0: the linear mu at the frozen
    outer size factors with the size factors divided back out."""
    return torch.clamp(sf0[None, :] * coef[:, None], min=min_mu) * inv_sf0[None, :]


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _sf_nll_plain(counts, coef, sf0, inv_sf0, s, disp, mask, min_mu, gene_block=None):
    """(G,) NB NLL of each gene at log size factors ``s`` (+inf where
    ``mask`` is False), mu = max(sf0 coef, min_mu) inv_sf0 exp(s), summed in
    float64 and rounded; ``gene_block`` rows at a time."""
    es = torch.exp(s)
    parts = []
    for sl in _row_slices(counts.shape[0], gene_block):
        mu = _base_mu(coef[sl], sf0, inv_sf0, min_mu) * es[None, :]
        parts.append(nb_nll_terms(counts[sl], mu, disp[sl]).sum(-1, dtype=torch.float64).to(counts.dtype))
    nll = torch.cat(parts)
    return torch.where(mask, nll, torch.full_like(nll, float("inf")))


def _sf_nll_cuda(counts, coef, sf0, inv_sf0, s, disp, mask, min_mu, gene_block=None):
    G, N = counts.shape
    nll = torch.empty(G, dtype=counts.dtype, device=counts.device)
    mask8 = mask.to(torch.uint8).contiguous()
    ops = [t.contiguous() for t in (counts, coef, sf0, inv_sf0, s, disp)]
    kernels.check_cuda_operands("sf_nll", *ops, nll, mask8)
    kernels.launch(
        "sf_nll",
        [int(counts.dtype == torch.float64), G, N, *(t.data_ptr() for t in ops), mask8.data_ptr(), float(min_mu),
         nll.data_ptr()],
        counts.device,
    )
    return nll


def _sf_newton_plain(counts, coef, sf0, inv_sf0, s, disp, keep, min_mu, iters, gene_block=None):
    """``iters`` guarded Newton steps on the (N,) log size factors ``s``
    over the genes with ``keep``: per sample g = sum mu w - y and h = sum mu
    r w / (mu + r), w = (y + r) / (mu + r), in float64 then rounded, and s
    -= clip(h > 0 ? g / h : sign(g), -1, 1)."""
    dtype = counts.dtype
    slices = _row_slices(counts.shape[0], gene_block)
    for _ in range(iters):
        es = torch.exp(s)
        g = torch.zeros(s.shape, dtype=torch.float64, device=s.device)
        h = torch.zeros_like(g)
        for sl in slices:
            y = counts[sl]
            k = keep[sl][:, None]
            mu = _base_mu(coef[sl], sf0, inv_sf0, min_mu) * es[None, :]
            r = (1.0 / disp[sl])[:, None]
            w = (y + r) / (mu + r)
            g = g + torch.where(k, mu * w - y, 0.0).sum(0, dtype=torch.float64)
            h = h + torch.where(k, mu * r * w / (mu + r), 0.0).sum(0, dtype=torch.float64)
        g, h = g.to(dtype), h.to(dtype)
        step = torch.where(h > 0, g / h, _sign(g))
        s = s - torch.clamp(step, -1.0, 1.0)
    return s


def _newton_groups(G: int, N: int) -> int:
    """Gene groups of the ``sf_newton`` partial pass: ~1056 blocks (8 of
    256 threads on each of 132 SMs) over ceil(N / 32) sample chunks, at
    least 8 genes a group."""
    chunks = -(-N // 32)
    return int(max(1, min(-(-G // 8), -(-1056 // chunks), 65535)))


def _sf_newton_cuda(counts, coef, sf0, inv_sf0, s, disp, keep, min_mu, iters, gene_block=None):
    G, N = counts.shape
    s = s.clone().contiguous()  # stepped in place by the kernel
    groups = _newton_groups(G, N)
    part = torch.empty((2, groups, N), dtype=torch.float64, device=counts.device)
    keep8 = keep.to(torch.uint8).contiguous()
    ops = [t.contiguous() for t in (counts, coef, sf0, inv_sf0, disp)]
    kernels.check_cuda_operands("sf_newton", *ops, s, keep8)
    kernels.launch(
        "sf_newton",
        [int(counts.dtype == torch.float64), G, N, int(iters), groups, *(t.data_ptr() for t in ops),
         keep8.data_ptr(), float(min_mu), s.data_ptr(), part[0].data_ptr(), part[1].data_ptr()],
        counts.device,
    )
    return s


def trim_quantile(nll: torch.Tensor, mask: torch.Tensor, quant: float) -> torch.Tensor:
    """The ``quant`` quantile (shape (1,)) of ``nll`` over the ``mask``
    lanes: np.quantile's linear interpolation between the order statistics
    at (n_valid - 1) quant (``pydeseq2_tpu/ops/sizefactors.py:75-83``);
    lanes off the mask hold +inf and sort last. XLA contracts the
    interpolation to fma(lo, 1 - frac, hi frac) on the CPU; so does this."""
    h = (mask.sum() - 1).to(nll.dtype) * quant
    lo = torch.floor(h)
    frac = h - lo
    last = nll.shape[0] - 1
    ranks = tuple(torch.clamp(k.to(torch.int64), 0, last) for k in (lo, torch.ceil(h)))
    s_lo, s_hi = order_stats_select(nll[:, None], ranks, axis=0)
    return _fma(s_lo, 1.0 - frac, s_hi * frac)


def keep_mask(nll: torch.Tensor, mask: torch.Tensor, quant: float) -> torch.Tensor:
    """The genes of ``mask`` strictly below :func:`trim_quantile`."""
    return (nll < trim_quantile(nll, mask, quant)) & mask


def _trimmed_sf_newton(counts, coef, disp, log_sf0, mask, quant, min_mu, outer_iters, newton_iters, gene_block,
                       nll_fn, newton_fn):
    sf0 = torch.exp(log_sf0)
    inv_sf0 = torch.exp(-log_sf0)
    s, keep = log_sf0, mask
    for _ in range(outer_iters):
        keep = keep_mask(nll_fn(counts, coef, sf0, inv_sf0, s, disp, mask, min_mu, gene_block), mask, quant)
        s = newton_fn(counts, coef, sf0, inv_sf0, s, disp, keep, min_mu, newton_iters, gene_block)
    return s, keep


def trimmed_sf_newton(
    counts: torch.Tensor,
    coef: torch.Tensor,
    disp: torch.Tensor,
    log_sf0: torch.Tensor,
    quant: float = 0.95,
    mask: torch.Tensor | None = None,
    min_mu: float = 0.5,
    outer_iters: int = OUTER_ITERS,
    newton_iters: int = NEWTON_ITERS,
    gene_block: int | None = None,
):
    """Minimise the trimmed NB NLL over per-sample log size factors.

    counts (G, N) gene-major; coef (G,) the per-gene OLS coefficient under
    the intercept-only design at size factors exp(log_sf0), so that the
    baseline means are max(exp(log_sf0) coef, min_mu) exp(-log_sf0) (the
    ``base_mu`` of ``pydeseq2_tpu/ops/sizefactors.py:34``); disp (G,)
    dispersions; log_sf0 (N,) the starting log size factors; mask (G,)
    bool, the lanes the objective runs over. Each of ``outer_iters`` rounds
    keeps the genes below the ``quant`` quantile of their NLL
    (:func:`keep_mask`), then takes ``newton_iters`` Newton steps. CUDA
    tensors launch ``sf_nll`` and ``sf_newton`` once a round each; CPU
    tensors take their plain versions. Returns ``(log_sf (N,), keep
    (G,))``: the log size factors, not recentred, and the last round's keep
    set. ``gene_block`` tiles the plain versions' rows (the kernels hold no
    (G, N) temporary).
    """
    if mask is None:
        mask = torch.ones(counts.shape[0], dtype=torch.bool, device=counts.device)
    cuda = counts.is_cuda
    return _trimmed_sf_newton(
        counts, coef, disp, log_sf0, mask, quant, min_mu, outer_iters, newton_iters, gene_block,
        _sf_nll_cuda if cuda else _sf_nll_plain, _sf_newton_cuda if cuda else _sf_newton_plain)


def _iteration(counts, log_sf, non_zero, X, pinv, slices, quant, min_disp, max_disp, min_mu, gene_block):
    """One round of ``iterative_size_factors`` (``pydeseq2_tpu/ops/
    sizefactors.py:235-270``): ``(new log_sf, any_informative)``."""
    G, N = counts.shape
    sf = torch.exp(log_sf)
    genewise, coefs = [], []
    for sl in slices:
        c = counts[sl]
        rough, moments, coef, mu_hat = mom_and_mu_coef(c, sf, X, pinv, min_mu)
        mom = torch.clamp(torch.minimum(rough, moments), min_disp, max_disp)
        gw, _ = alpha_mle_batch(c, X, mu_hat, mom, min_disp, max_disp, cr_reg=True)
        genewise.append(torch.clamp(gw, min_disp, max_disp))
        coefs.append(coef[:, 0])
    genewise, coef = torch.cat(genewise), torch.cat(coefs)

    # The constant trend: the 0.001-trimmed mean of the informative genewise
    # dispersions (dds.py:1493); the MAD prior (dds.py:840-884) with
    # trigamma((N - 1) / 2); the 2-sigma shrinkage-outlier rule.
    informative = (genewise > 10.0 * min_disp) & non_zero
    fitted = torch.clamp(trimmed_mean_masked(genewise, informative, 0.001), min=min_disp)
    squared_logres, prior_disp_var = dispersion_prior(genewise, fitted.expand(G), non_zero, min_disp, N, 1)
    outlier = torch.log(genewise) > torch.log(fitted) + 2.0 * torch.sqrt(squared_logres)

    map_disp = []
    for sl in slices:
        c = counts[sl]
        mu_hat = mu_from_coef(coef[sl, None], sf, X, min_mu)
        md, _ = alpha_mle_batch(c, X, mu_hat, fitted.expand(c.shape[0]), min_disp, max_disp,
                                prior_disp_var=prior_disp_var, cr_reg=True, prior_reg=True)
        map_disp.append(md)
    map_disp = torch.clamp(torch.cat(map_disp), min_disp, max_disp)
    disp = torch.where(outlier, genewise, map_disp)
    disp = torch.where(non_zero, disp, torch.ones_like(disp))  # masked lanes: any finite value

    raw, _ = trimmed_sf_newton(counts, coef, disp, log_sf, quant=quant, mask=non_zero, min_mu=min_mu,
                               gene_block=gene_block)
    return raw - raw.mean(), informative.any()


def iterative_size_factors(
    counts: torch.Tensor,
    gene_mask: torch.Tensor | None = None,
    niter: int = 10,
    quant: float = 0.95,
    min_disp: float = 1e-8,
    max_disp: float = 10.0,
    min_mu: float = 0.5,
    gene_block: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, int]:
    """Iterative size factors of (G, N) counts on ``device``:
    ``(size_factors (N,), n_iters)``.

    Port of ``pydeseq2_tpu/ops/sizefactors.py:118``. Each round, under the
    intercept-only design: MoM dispersions and the OLS mu (one ``mom``
    launch), the genewise dispersion MLE, the 0.001-trimmed constant trend,
    the MAD prior, the MAP dispersions with the 2-sigma outlier rule, then
    :func:`trimmed_sf_newton` from the current log size factors, recentred
    to mean zero. It stops once the squared update is below 1e-4 from the
    third round on, when no gene is informative (genewise > 10 min_disp),
    or after ``niter`` rounds. ``gene_mask`` (G,) is False on padding
    lanes. ``gene_block`` runs the dispersion fits over row blocks, so no
    (G, N) temporary is live at once; it changes no value beyond rounding
    (:func:`pick_sf_gene_block` picks it from the counts' size). counts and
    gene_mask are tensors or arrays, moved to ``device`` (default
    ``"cuda"``; raises if CUDA is requested and absent) in the dtype of
    ``counts``.
    """
    dev = resolve_device(device)
    counts = torch.as_tensor(counts, device=dev).contiguous()
    G, N = counts.shape
    dtype = counts.dtype
    gene_mask = (torch.ones(G, dtype=torch.bool, device=dev) if gene_mask is None
                 else torch.as_tensor(gene_mask, dtype=torch.bool, device=dev))
    X = torch.ones((N, 1), dtype=dtype, device=dev)  # intercept-only design (dds.py:1478-1484)
    pinv = ols_pinv(X)
    slices = _row_slices(G, gene_block)
    non_zero = torch.cat([(counts[sl] > 0).any(dim=1) for sl in slices]) & gene_mask
    log_sf = torch.zeros(N, dtype=dtype, device=dev)
    it = 0
    while it < niter:
        new_log_sf, any_informative = _iteration(counts, log_sf, non_zero, X, pinv, slices, quant, min_disp,
                                                 max_disp, min_mu, gene_block)
        delta = ((log_sf - new_log_sf) ** 2).sum()
        done = ~any_informative | ((delta < 1e-4) & (it > 1))
        log_sf = torch.where(any_informative, new_log_sf, log_sf)
        it += 1
        # Host-evaluated while_loop condition (sizefactors.py:377-393).
        if bool(done):
            break
    return torch.exp(log_sf), it
