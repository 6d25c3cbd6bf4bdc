"""Smoke run of pydeseq2_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the four hand-written kernels from ``pydeseq2_tpu_torch/csrc`` with
``nvcc`` for sm_90a, then:

1. prints the card (name and power limit, as nvidia-smi reports them) and
   the build times;
2. holds each kernel against its plain PyTorch version on the card, on the
   inputs the Wald pipeline gives it at 100 samples x 60000 genes in
   float32 (and at 100 x 4000 in float64), with the tolerance stated beside
   each check, and times kernel, plain version and, where one PyTorch call
   computes the same function, that call;
3. runs ``wald_pipeline`` at 100 x 60000 float32 on the card through its
   public entry point: warm wall time, genes/s, IRLS trip counts, rescue
   overflow, share of finite p-values, and the launch count of every kernel
   in one run (each must be > 0);
4. runs the same pipeline in float64 at 100 x 2000 on the card and on the
   CPU (plain versions) and compares the two key by key;
5. prints one JSON line with the kernels' numbers, the card line, and last
   the result line ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result
line. It exits non-zero at once where no CUDA card is visible.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

DEVICE = "cuda"
G_MAIN, N_MAIN = 60_000, 100
G_F64 = 4_000
G_CPU_CMP = 2_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` warm calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def stage_inputs(counts, X, max_disp):
    """The tensors the pipeline hands to each kernel (size factors, MoM,
    linear mu), computed with the port's own stage functions."""
    from pydeseq2_tpu_torch.fused import _size_factors
    from pydeseq2_tpu_torch.ops.linreg import (
        fit_lin_mu_batch,
        fit_moments_dispersions_batch,
        fit_rough_dispersions_batch,
    )

    G = counts.shape[0]
    mask = torch.ones(G, dtype=torch.bool, device=counts.device)
    log_counts = torch.log(counts)
    logmeans = log_counts.mean(dim=1)
    filtered = ~torch.isinf(logmeans) & mask
    log_ratios = torch.where(
        filtered[:, None], log_counts - logmeans[:, None], torch.full_like(log_counts, math.inf)
    )
    n_valid = filtered.sum()
    sf, _ = _size_factors(counts, mask)
    normed = counts / sf[None, :]
    mom = torch.clamp(
        torch.minimum(fit_rough_dispersions_batch(normed, X), fit_moments_dispersions_batch(normed, sf)),
        1e-8, max_disp,
    )
    mu = fit_lin_mu_batch(counts, sf, X, 0.5)
    return log_ratios, n_valid, sf, mom, mu


def kernel_checks(dtype, G, N, reps, timings):
    """Phase 2: every kernel against its plain version on the same inputs.

    Returns {name: max_abs_err} and fills ``timings`` (float32 only)."""
    from pydeseq2_tpu_torch.ops import dispersion as dsp
    from pydeseq2_tpu_torch.ops import irls as irl
    from pydeseq2_tpu_torch.ops import select as sel
    from pydeseq2_tpu_torch.ops.nb import nb_nll
    from pydeseq2_tpu_torch.synthetic import make_data

    f32 = dtype == torch.float32
    name = "f32" if f32 else "f64"
    dev = torch.device(DEVICE)
    counts_np, X_np = make_data(N, G)
    counts = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=dev)
    X = torch.as_tensor(X_np, dtype=dtype, device=dev)
    P = X.shape[1]
    max_disp = float(max(10, N))
    log_ratios, n_valid, sf, mom, mu = stage_inputs(counts, X, max_disp)
    errs = {}

    # -- kernel 1: order statistics (size-factor medians, prior medians) ----
    k_lo = torch.clamp((n_valid - 1) // 2, min=0)
    k_hi = n_valid // 2
    ks = (k_lo, k_hi)
    got = sel.order_stats_select(log_ratios, ks, axis=0)
    want = sel.order_stats_select_plain(log_ratios, ks, axis=0)
    # Exact: the kernel must return the very element a sort puts at each rank.
    for a, b in zip(got, want):
        check(torch.equal(sel._monotone_key(a), sel._monotone_key(b)), f"select {name}: not bit-identical")
    torch.manual_seed(0)
    col = torch.where(torch.rand(G, device=dev) < 0.1, math.inf, torch.randn(G, device=dev, dtype=dtype))
    n_col = torch.isfinite(col).sum()
    ks1 = (torch.clamp((n_col - 1) // 2, min=0), n_col // 2)
    for a, b in zip(sel.order_stats_select(col[:, None], ks1), sel.order_stats_select_plain(col[:, None], ks1)):
        check(torch.equal(sel._monotone_key(a), sel._monotone_key(b)), f"select {name}: 1-column not bit-identical")
    errs["order_stats_select"] = 0.0
    if f32:
        timings["order_stats_select"] = {
            "ms": cuda_ms(lambda: sel.order_stats_select(log_ratios, ks, axis=0), reps),
            "plain_ms": cuda_ms(lambda: sel.order_stats_select_plain(log_ratios, ks, axis=0), reps),
            "library_ms": cuda_ms(lambda: torch.sort(log_ratios, dim=0), reps),
            "bytes": log_ratios.numel() * log_ratios.element_size(),
            # 4 passes x (key map 3 + 2 ranks x (mask, compare, digit) 6) per element
            "ops": 4 * 9 * G * N,
        }
    log(f"  select {name}: bit-identical to the sorted keys at ({G}, {N}) and ({G}, 1)")

    # -- kernel 2: coarse dispersion scan (genewise fit inputs) -----------
    lo_f, hi_f = math.log(1e-8), math.log(max_disp)
    K = 32
    step1_f = (hi_f - lo_f) / (K - 1)
    lo = torch.tensor(lo_f, dtype=dtype, device=dev)
    la_grid = lo + torch.arange(K, dtype=dtype, device=dev) * torch.tensor(step1_f, dtype=dtype, device=dev)
    bnd_start, bnd_end = dsp._scan_branches(K, step1_f, lo_f)
    la_hat = torch.log(torch.clamp(mom, 1e-8, max_disp))
    pdv = torch.tensor(1.0, dtype=dtype, device=dev)
    scan_args = (counts, mu, X, la_grid, bnd_start, bnd_end, (lo_f + hi_f) / 2, True, False, la_hat, pdv)
    la1_k, fk = dsp.scan_coarse(*scan_args)
    la1_p, fp = dsp.scan_coarse_plain(*scan_args)
    # Tolerance: both sum ~N terms of size up to |f| in different orders and
    # take log1p/lgamma from different math libraries: a few ulps of the
    # largest term, so 2e-5 (f32) / 1e-11 (f64) of (1 + |f|).
    rtol = 2e-5 if f32 else 1e-11
    scale = 1.0 + fp.abs()
    err = ((fk - fp).abs() / scale).max().item()
    check(err <= rtol, f"disp_scan {name}: objective rel err {err:.3g} > {rtol}")
    # The argmin may differ only at near ties: the kernel's choice must be
    # within the same tolerance of the plain minimum.
    idx_k = ((la1_k[None, :] - la_grid[:, None]).abs().argmin(0))
    f_at_k = fp.gather(0, idx_k[None])[0]
    tie_err = ((f_at_k - fp.amin(0)) / (1.0 + fp.amin(0).abs())).max().item()
    check(tie_err <= 2 * rtol, f"disp_scan {name}: argmin off a near tie ({tie_err:.3g})")
    errs["disp_scan"] = (fk - fp).abs().max().item()
    if f32:
        n_stable = bnd_start
        n_auto = bnd_end - bnd_start
        n_plain = K - bnd_end
        ntri = P * (P + 1) // 2
        ops_cr = 3 + P + 2 * ntri
        timings["disp_scan"] = {
            "ms": cuda_ms(lambda: dsp.scan_coarse(*scan_args), reps),
            "plain_ms": cuda_ms(lambda: dsp.scan_coarse_plain(*scan_args), max(1, reps // 5)),
            "library_ms": None,
            "bytes": 2 * counts.numel() * counts.element_size() + K * G * counts.element_size(),
            # per element and point: stable form 30, auto/plain forms 38/40
            # (Stirling-8 lgamma 32 + 6), Cox-Reid weight and Gram ops_cr
            "ops": G * N * (30 * n_stable + 38 * n_auto + 40 * n_plain + K * ops_cr),
        }
    log(f"  disp_scan {name}: objective rel err {err:.3g} (tol {rtol}), argmin tie err {tie_err:.3g}")

    # -- kernel 3: dispersion Newton (genewise fit from the scan's argmin) -
    step2_f = step1_f / 3.5
    newton_args = (counts, mu, X, la1_k, lo_f, hi_f, step1_f, step2_f, 4, True, False, la_hat, pdv)
    outk = dsp.newton_polish(*newton_args)
    outp = dsp.newton_polish_plain(*newton_args)
    # Tolerance: the objective at the polished point, 2e-3 (f32) / 1e-10
    # (f64) of (1 + |f|). Below r = 8 the centred f32 objective sums terms
    # of size lgamma(y + r) ~ 1e4 to a total ~1e2, so its rounding noise is
    # ~1e-4 of |f|, and the Newton acceptance (f_cand < f) decides at that
    # noise; on likelihood plateaus that moves la far while f stays flat, so
    # f is held tightly and la only on 99% of lanes.
    ftol = 2e-3 if f32 else 1e-10
    fdiff = (outk[1] - outp[1]).abs() / (1.0 + outp[1].abs())
    ferr = fdiff.max().item()
    check(ferr <= ftol, f"disp_newton {name}: objective rel err {ferr:.3g} > {ftol}")
    ladiff = (outk[0] - outp[0]).abs()
    la_close = (ladiff <= (1e-3 if f32 else 1e-6)).float().mean().item()
    check(la_close >= 0.99, f"disp_newton {name}: only {la_close:.4f} of la agree")
    q = torch.tensor([0.5, 0.99, 0.999], dtype=fdiff.dtype, device=fdiff.device)
    log(f"  disp_newton {name}: f rel diff quantiles (50/99/99.9%) {fdiff.quantile(q).tolist()}, "
        f"la diff {ladiff.quantile(q.to(ladiff.dtype)).tolist()}")
    errs["disp_newton"] = (outk[0] - outp[0]).abs().max().item()
    if f32:
        plain_frac = (torch.exp(-outp[0]) < 8.0).double().mean().item()
        ntri = P * (P + 1) // 2
        ops_cr = 10 + 3 * (2 * ntri) + ntri
        timings["disp_newton"] = {
            "ms": cuda_ms(lambda: dsp.newton_polish(*newton_args), reps),
            "plain_ms": cuda_ms(lambda: dsp.newton_polish_plain(*newton_args), max(1, reps // 5)),
            "library_ms": None,
            "bytes": 2 * counts.numel() * counts.element_size() + 5 * G * counts.element_size(),
            # 5 evaluations per gene; per element: stable fgh 85 ops, plain
            # fgh 127 (Stirling-8 lgamma, psi, psi'), branch from the final
            # la of each gene; Cox-Reid weights and three Grams ops_cr
            "ops": int(5 * G * N * ((1 - plain_frac) * 85 + plain_frac * 127 + ops_cr)),
        }
    log(f"  disp_newton {name}: objective rel err {ferr:.3g} (tol {ftol}), la within tol on {la_close:.4f}")

    # -- kernel 4: IRLS (phase 1 of the LFC fit: every lane, 8 trips) ------
    disp = torch.clamp(torch.exp(outk[0]), 1e-8, max_disp)
    beta_init = irl.irls_beta_init(counts, sf, X)
    beta_tol = 1e-6 if f32 else 1e-8
    step_tol = 1e-5 if f32 else 0.0
    log_sf = torch.log(sf)[None, :]
    log_min_mu = torch.log(torch.tensor(0.5, dtype=dtype, device=dev))
    mu0, log_mu0, _ = irl._mu_from_xb(beta_init, X, sf, log_sf, 0.5, log_min_mu)
    r = 1.0 / disp[:, None]
    nll_const = nb_nll(counts, mu0, disp) - irl._mu_part(counts, counts + r, r, mu0, log_mu0)
    results = {}
    for maxiter in (8, 250):
        bk, fbk, trips = irl._irls_cuda(counts, sf, X, disp, beta_init, nll_const, log_sf[0], 0.5,
                                        beta_tol, 30.0, maxiter, step_tol, 2)
        bp, fbp, it_p = irl._irls_plain(counts, sf, X, disp, beta_init, nll_const, log_sf, 0.5,
                                        log_min_mu, beta_tol, 30.0, maxiter, step_tol, 2)
        # Tolerance: a rounding difference in the deviance ratio can move a
        # lane's stop by one trip, a change of order beta_tol/step_tol in the
        # iterate; 99.9% of lanes must agree to 1e-4 (f32) / 1e-7 (f64) and
        # the fallback flags on 99.9%.
        btol = 1e-4 if f32 else 1e-7
        close = ((bk - bp).abs().amax(1) <= btol).double().mean().item()
        flags = (fbk == fbp).double().mean().item()
        check(close >= 0.999, f"irls {name} maxiter={maxiter}: only {close:.5f} of lanes agree")
        check(flags >= 0.999, f"irls {name} maxiter={maxiter}: flags agree on {flags:.5f}")
        max_trips = int(trips.max())
        # A lane whose stop moved by one trip can move the slowest lane by one.
        check(abs(max_trips - int(it_p)) <= 1, f"irls {name}: slowest lane {max_trips} trips, plain loop {int(it_p)}")
        results[maxiter] = (close, flags, (bk - bp).abs().max().item(), trips)
        log(f"  irls {name} maxiter={maxiter}: lanes within {btol}: {close:.5f}, flags agree {flags:.5f}, "
            f"slowest lane {max_trips} trips (plain loop {int(it_p)})")
    errs["irls"] = results[8][2]
    if f32:
        trips = results[8][3].double()
        ntri = P * (P + 1) // 2
        per_pass = 2 * P + 26 + 2 * ntri + 2 * P
        timings["irls"] = {
            "ms": cuda_ms(lambda: irl._irls_cuda(counts, sf, X, disp, beta_init, nll_const, log_sf[0], 0.5,
                                                 beta_tol, 30.0, 8, step_tol, 2), reps),
            "plain_ms": cuda_ms(lambda: irl._irls_plain(counts, sf, X, disp, beta_init, nll_const, log_sf,
                                                        0.5, log_min_mu, beta_tol, 30.0, 8, step_tol, 2),
                                max(1, reps // 5)),
            "library_ms": None,
            "bytes": counts.numel() * counts.element_size() + 6 * G * counts.element_size(),
            # (trips + 1) IRLS passes per gene at per_pass ops per element,
            # plus 3 polish passes of ~(25 + 2 ntri) ops
            "ops": int(N * ((trips + 1).sum().item() * per_pass + 3 * G * (25 + 2 * ntri))),
            "trips_mean": trips.mean().item(),
        }
    return errs


def psi_check() -> None:
    """The kernels' float64 psi and psi' against torch.digamma/polygamma."""
    from pydeseq2_tpu_torch import kernels

    x = torch.cat([
        torch.logspace(-3, 0, 400, dtype=torch.float64),
        torch.linspace(1.0, 12.0, 400, dtype=torch.float64),
        torch.logspace(1.1, 7, 400, dtype=torch.float64),
    ]).to(DEVICE)
    psi = torch.empty_like(x)
    tri = torch.empty_like(x)
    kernels.call_helper("psi_f64", [x.data_ptr(), x.numel(), psi.data_ptr(), tri.data_ptr()], x.device)
    # Reference: scipy on the host. PyTorch's polygamma(1, .) keeps three
    # Bernoulli terms after six shifts (~1e-9 relative) on CPU and card.
    from scipy.special import digamma, polygamma

    xs = x.cpu().numpy()
    ref_psi = torch.as_tensor(digamma(xs), device=x.device)
    ref_tri = torch.as_tensor(polygamma(1, xs), device=x.device)
    # ~1e-14 relative, absolute near the root of psi (x ~ 1.4616) where any
    # evaluation has unbounded relative error.
    e_psi = ((psi - ref_psi).abs() / torch.clamp(ref_psi.abs(), min=1.0)).max().item()
    e_tri = ((tri - ref_tri).abs() / ref_tri.abs()).max().item()
    check(e_psi <= 2e-14 and e_tri <= 2e-14, f"f64 psi/psi' errors {e_psi:.3g}/{e_tri:.3g}")
    log(f"  f64 psi max err {e_psi:.3g}, psi' max rel err {e_tri:.3g} (tol 2e-14)")


def main_path(reps: int):
    """Phase 3: the public entry point at full width, float32."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_MAIN)
    kw = pt.inputs_from_numpy(
        counts_np.T, X_np, np.array([0.0, 1.0]), 0.0, dtype=torch.float32, device=DEVICE,
        max_disp=float(max(10, N_MAIN)), beta_tol=1e-6,
    )
    out = pt.wald_pipeline(**kw)  # warm-up (allocator, library handles)
    torch.cuda.synchronize()
    walls = []
    launches = None
    trips = None
    for i in range(reps):
        if i == 0:
            kernels.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pt.wald_pipeline(**kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = dict(kernels.STATS.launches)
            trips = [int(t) for t in kernels.STATS.irls_trips]
    res = pt.outputs_to_numpy(out)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    pv = res["p_values"]
    check(pv.shape == (G_MAIN,) and res["lfc"].shape == (G_MAIN, 2), "output shapes")
    finite = float(np.isfinite(pv).mean())
    check(finite > 0.9, f"only {finite:.4f} of p-values are finite")
    check(np.all((pv[np.isfinite(pv)] >= 0) & (pv[np.isfinite(pv)] <= 1)), "p-values outside [0, 1]")
    best = min(walls)
    log(f"  wall (warm) {[round(w, 4) for w in walls]} s, best {best:.4f} s, "
        f"{G_MAIN / best:.1f} genes/s")
    log(f"  launches in one run {launches}; IRLS slowest-lane trips per launch {trips}")
    log(f"  rescue_overflow {int(res['rescue_overflow'])}, finite p-values {finite:.5f}, "
        f"irls_converged {float(res['irls_converged'].mean()):.5f}, "
        f"trend_used_mean {bool(res['trend_used_mean'])}")
    return {"walls_s": walls, "best_s": best, "genes_per_s": G_MAIN / best, "launches": launches,
            "irls_trips": trips, "rescue_overflow": int(res["rescue_overflow"]), "finite_p": finite}


def card_vs_cpu() -> None:
    """Phase 4: the f64 pipeline on the card against the CPU plain path.

    Three cases: the main path's design (P = 2); P = 3 with ``mu_init="irls"``
    and ``alt_hypothesis="greaterAbs"`` (closed-form 3 x 3 solves, the IRLS
    kernel twice); P = 5 (the unrolled-Cholesky solves)."""
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N_MAIN, G_CPU_CMP, seed=1)
    rng = np.random.default_rng(2)
    extra = rng.integers(0, 2, size=(N_MAIN, 3)).astype(float)
    base = {"max_disp": float(max(10, N_MAIN)), "beta_tol": 1e-8}
    cases = [
        ("P=2", X_np, base),
        ("P=3 mu_init=irls greaterAbs", np.column_stack([X_np, extra[:, 0]]),
         dict(base, mu_init="irls", alt_hypothesis="greaterAbs")),
        ("P=5", np.column_stack([X_np, extra]), base),
    ]
    for label, X, static in cases:
        contrast = np.zeros(X.shape[1])
        contrast[1] = 1.0
        args = (counts_np.T, X, contrast, 0.0)
        gpu = pt.outputs_to_numpy(pt.wald_pipeline(**pt.inputs_from_numpy(*args, device=DEVICE, **static)))
        cpu = pt.outputs_to_numpy(pt.wald_pipeline(**pt.inputs_from_numpy(*args, device="cpu", **static)))
        check(gpu.keys() == cpu.keys(), f"{label}: key sets differ")
        # Tolerance: rtol 1e-6 on the fitted quantities, as the CPU plain
        # path is held to the JAX f64 reference; identical NaN masks and flags.
        worst = {}
        for k in gpu:
            a, b = gpu[k], cpu[k]
            check(a.dtype == b.dtype and a.shape == b.shape, f"{label} {k}: dtype/shape")
            if a.dtype.kind == "f":
                check(np.array_equal(np.isnan(a), np.isnan(b)), f"{label} {k}: NaN masks differ")
                m = ~np.isnan(b)
                rel = float(np.max(np.abs(a[m] - b[m]) / np.maximum(np.abs(b[m]), 1e-300), initial=0.0))
                worst[k] = rel
                check(np.allclose(a[m], b[m], rtol=1e-6, atol=1e-12),
                      f"{label} {k}: card and CPU differ beyond rtol 1e-6 (max rel {rel:.3g})")
            else:
                check(np.array_equal(a, b), f"{label} {k}: differs")
        log(f"  {label}: max rel card vs CPU " + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from pydeseq2_tpu_torch import kernels

    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    took = kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source {took}")

    log("phase 2: kernels against their plain versions")
    psi_check()
    timings: dict = {}
    errs32 = kernel_checks(torch.float32, G_MAIN, N_MAIN, reps=20, timings=timings)
    kernel_checks(torch.float64, G_F64, N_MAIN, reps=5, timings={})

    log("phase 3: wald_pipeline, 100 x 60000 float32")
    main = main_path(reps=3)

    log("phase 4: float64 pipeline, card against CPU, 100 x 2000, P = 2, 3, 5")
    card_vs_cpu()

    replaces = {
        "order_stats_select": ("pydeseq2_tpu_torch/csrc/select.cu", "pydeseq2_tpu/ops/select.py:65", "select"),
        "disp_scan": ("pydeseq2_tpu_torch/csrc/disp_scan.cu", "pydeseq2_tpu/ops/dispersion.py:196", "disp_scan"),
        "disp_newton": ("pydeseq2_tpu_torch/csrc/disp_newton.cu", "pydeseq2_tpu/ops/dispersion.py:361", "disp_newton"),
        "irls": ("pydeseq2_tpu_torch/csrc/irls.cu", "pydeseq2_tpu/ops/irls.py:45", "irls"),
    }
    rows = []
    for name, (source, repl, key) in replaces.items():
        t = timings[name]
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["ops"] / F32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": repl,
            "launches": main["launches"][key], "max_abs_err": errs32[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t["library_ms"],
        })
    log("main path: " + json.dumps(main))
    print(json.dumps({"kernels": rows}), flush=True)
    name = torch.cuda.get_device_name(0)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
