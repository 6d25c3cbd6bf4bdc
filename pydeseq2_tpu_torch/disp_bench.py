"""Device time of the dispersion kernels ``disp_scan`` and ``disp_newton``
at the shapes the pipelines give them, for one or more checkouts of this
repository, on a CUDA card.

    python3 -m pydeseq2_tpu_torch.disp_bench [--detail] [TREE ...]

Each TREE (default: this checkout) is the root of a checkout, for example
an earlier commit unpacked with ``git archive`` into an ignored directory.
Each runs in a process of its own that imports ``pydeseq2_tpu_torch`` from
that tree and builds the tree's two dispersion sources there. To compare
two versions in one call, name them parent, change, change, parent.

Shapes (``make_data`` seed 0, linear mu, the 32-point coarse grid, four
Newton steps from the kernel scan's argmin; P > 2 adds indicator columns of
a seeded batch factor to the two-level condition): 100 x 60000 float32 at
P = 2, 3, 5; 100 x 4000 and 100 x 10000 float32 at P = 2; 100 x 2000
float64 at P = 2;
100 x 4000 float64 at P = 2, 5; 100 x 60000 float64 at P = 2;
the atlas dispersion block, 5000 genes x 10000 samples at P = 1, in float32
and float64.

Per tree and shape: the mean ms of 20 warm wrapper calls (5 at the atlas
block) by CUDA events, which on short gene lists include the host's issue
time, and by torch.profiler the device time of the kernel alone and of all
the wrapper runs on the card; the largest differences from the plain version
(scan: best log-alpha, the objective cache relative to 1 + |f|; Newton:
log-alpha, f relative to 1 + |f|), and per kernel instantiation the
registers and spill bytes (stores, loads) of the ``-Xptxas -v`` report the
build keeps. ``--detail`` adds, where the tree has them, the atlas scan with
its rows unsplit (one segment), and the Newton launch on rows ordered by
the final branch (r = exp(-la) < 8 or not) with the share of warps whose
genes end in both branches, in gene order and in the wrapper's order.

Prints the card first and, as the last line, every number as one JSON
object.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__" and "--child" in sys.argv:
    # Run as a file inside a tree: import that tree's package, not the
    # directory of this file.
    sys.path[0] = os.getcwd()

import numpy as np  # noqa: E402
import torch  # noqa: E402

DEVICE = "cuda"
SOURCES = ("disp_scan.cu", "disp_newton.cu")
SHAPES = (
    # label, genes, samples, P, dtype, timed calls
    ("f32 100x60000 P=2", 60_000, 100, 2, torch.float32, 20),
    ("f32 100x60000 P=3", 60_000, 100, 3, torch.float32, 20),
    ("f32 100x60000 P=5", 60_000, 100, 5, torch.float32, 20),
    ("f32 100x4000 P=2", 4_000, 100, 2, torch.float32, 20),
    ("f32 100x10000 P=2", 10_000, 100, 2, torch.float32, 20),
    ("f64 100x2000 P=2", 2_000, 100, 2, torch.float64, 20),
    ("f64 100x4000 P=2", 4_000, 100, 2, torch.float64, 20),
    ("f64 100x4000 P=5", 4_000, 100, 5, torch.float64, 20),
    ("f64 100x60000 P=2", 60_000, 100, 2, torch.float64, 20),
    ("f32 atlas 5000x10000 P=1", 5_000, 10_000, 1, torch.float32, 5),
    ("f64 atlas 5000x10000 P=1", 5_000, 10_000, 1, torch.float64, 5),
)


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


def device_ms(fn, reps: int, name: str) -> tuple[float, float]:
    """Mean device time of ``fn`` over ``reps`` warm calls from
    torch.profiler, which a host slower than the card does not inflate: (the
    kernels whose name holds ``name``, everything ``fn`` runs on the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    own = sum(e.self_device_time_total for e in kern if name in e.key)
    return own / reps / 1e3, sum(e.self_device_time_total for e in kern) / reps / 1e3


def inputs(G: int, N: int, P: int, dtype):
    """(counts, mu, X) on the card: ``make_data``'s counts and design (for
    P = 1 the intercept; for P > 2 besides indicator columns of a seeded
    (P - 1)-level batch), median-of-ratios size factors and the OLS mean,
    clamped at 0.5, as the pipelines' first mu."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts_np, X_np = make_data(N, G)
    X_np = X_np[:, :P]
    if P > 2:
        batch = np.random.default_rng(1).integers(0, P - 1, N)
        X_np = np.column_stack([X_np] + [(batch == b).astype(float) for b in range(1, P - 1)])
    counts = torch.as_tensor(counts_np.T.copy(), dtype=dtype, device=DEVICE)
    X = torch.as_tensor(X_np, dtype=dtype, device=DEVICE)
    logc = torch.log(counts)
    ok = torch.isfinite(logc.mean(1))
    sf = torch.exp(torch.median(logc[ok] - logc[ok].mean(1, keepdim=True), dim=0).values)
    beta = (counts / sf) @ torch.linalg.pinv(X).T
    mu = torch.clamp((beta @ X.T) * sf, min=0.5)
    return counts, mu.contiguous(), X


def ptxas(kernels) -> dict:
    """{source: {"P<p> f32|f64": [registers, spill stores, spill loads]}}."""
    out = {}
    for src in SOURCES:
        text = kernels._lib_path(src).with_suffix(".ptxas.txt").read_text()
        rows = {}
        for m in re.finditer(r"Compiling entry function '([^']+)'(.*?)Used (\d+) registers", text, re.S):
            inst = re.search(r"ILi(\d+)E([fd])E", m.group(1))
            if inst is None:
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", m.group(2))
            key = f"P{inst.group(1)} {'f32' if inst.group(2) == 'f' else 'f64'}"
            rows[key] = [int(m.group(3)), int(sp.group(1)) if sp else 0, int(sp.group(2)) if sp else 0]
        out[src] = rows
    return out


def child(detail: bool) -> dict:
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.ops import dispersion as dsp

    # Build the two dispersion sources only.
    full = kernels.KERNELS, kernels.HELPERS
    kernels.KERNELS = {k: v for k, v in full[0].items() if v[0] in SOURCES}
    kernels.HELPERS = {}
    try:
        kernels.build()
    finally:
        kernels.KERNELS, kernels.HELPERS = full

    res = {"ptxas": ptxas(kernels), "shapes": {}}
    for label, G, N, P, dtype, reps in SHAPES:
        counts, mu, X = inputs(G, N, P, dtype)
        max_disp = float(max(10, N))
        lo_f, hi_f = math.log(1e-8), math.log(max_disp)
        K = 32
        step1_f = (hi_f - lo_f) / (K - 1)
        lo = torch.tensor(lo_f, dtype=dtype, device=DEVICE)
        step1 = torch.tensor(step1_f, dtype=dtype, device=DEVICE)
        la_grid = lo + torch.arange(K, dtype=dtype, device=DEVICE) * step1
        bs, be = dsp._scan_branches(K, step1_f, lo_f)
        la_hat = torch.zeros(G, dtype=dtype, device=DEVICE)
        pdv = torch.tensor(1.0, dtype=dtype, device=DEVICE)
        scan_args = (counts, mu, X, la_grid, bs, be, (lo_f + hi_f) / 2, True, False, la_hat, pdv)
        la1, coarse = dsp.scan_coarse(*scan_args)
        la1_p, coarse_p = dsp.scan_coarse_plain(*scan_args)
        newton_args = (counts, mu, X, la1, lo_f, hi_f, step1_f, step1_f / 3.5, 4, True, False, la_hat, pdv)
        out = dsp.newton_polish(*newton_args)
        out_p = dsp.newton_polish_plain(*newton_args)
        scan_dev = device_ms(lambda: dsp.scan_coarse(*scan_args), reps, "disp_scan")
        newton_dev = device_ms(lambda: dsp.newton_polish(*newton_args), reps, "disp_newton")
        row = {
            "disp_scan_ms": cuda_ms(lambda: dsp.scan_coarse(*scan_args), reps),
            "disp_newton_ms": cuda_ms(lambda: dsp.newton_polish(*newton_args), reps),
            "disp_scan_kernel_ms": scan_dev[0], "disp_scan_device_ms": scan_dev[1],
            "disp_newton_kernel_ms": newton_dev[0], "disp_newton_device_ms": newton_dev[1],
            "scan_la_err": (la1 - la1_p).abs().max().item(),
            "scan_f_err": ((coarse - coarse_p).abs() / (1 + coarse_p.abs())).max().item(),
            "newton_la_err": (out[0] - out_p[0]).abs().max().item(),
            "newton_f_err": ((out[1] - out_p[1]).abs() / (1 + out_p[1].abs())).max().item(),
        }
        if detail and N > 1024 and hasattr(dsp, "_scan_segments"):
            split = dsp._scan_segments
            dsp._scan_segments = lambda G_, N_, sms: 1
            try:
                row["disp_scan_one_segment_ms"] = cuda_ms(lambda: dsp.scan_coarse(*scan_args), reps)
            finally:
                dsp._scan_segments = split
        if detail:
            plain_gene = torch.exp(-out_p[0]) < 8.0
            perm = torch.argsort(plain_gene.to(torch.int8), stable=True)
            sorted_args = (counts[perm].contiguous(), mu[perm].contiguous(), X, la1[perm].contiguous(),
                           *newton_args[4:11], la_hat[perm].contiguous(), pdv)
            row["disp_newton_branch_sorted_ms"] = cuda_ms(lambda: dsp.newton_polish(*sorted_args), reps)
            # 32 / L genes a warp, L the lanes a gene by N (csrc/disp_newton.cu;
            # short gene lists take more)
            L = 4 if N <= 64 else (8 if N <= 128 else (16 if N <= 256 else 32))
            per_warp = 32 // L

            def mixed_share(flags):
                pw = flags[: G - G % per_warp].reshape(-1, per_warp)
                return (pw.any(1) & ~pw.all(1)).double().mean().item()

            start_order = torch.argsort((la1 > -math.log(8.0)).to(torch.uint8), stable=True)
            row["plain_branch_share"] = plain_gene.double().mean().item()
            row["mixed_warps_gene_order"] = mixed_share(plain_gene)
            row["mixed_warps_wrapper_order"] = mixed_share(plain_gene[start_order])
        res["shapes"][label] = row
        print(f"  {label}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del counts, mu, X, coarse, coarse_p, out, out_p
        torch.cuda.empty_cache()
    return res


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv: list[str]) -> int:
    detail = "--detail" in argv
    if "--child" in argv:
        print("RESULT " + json.dumps(child(detail)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("disp_bench: no CUDA device is visible", file=sys.stderr)
        return 1
    trees = [a for a in argv if not a.startswith("--")] or ["."]
    print(f"card: {card_line()}", flush=True)
    runs = []
    for tree in trees:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child"] + (["--detail"] if detail else [])
        proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=1800)
        sys.stderr.write(proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(f"disp_bench: the run in {tree} failed (exit {proc.returncode})", file=sys.stderr)
            return 1
        runs.append({"tree": tree, **json.loads(lines[-1][len("RESULT "):])})
        print(f"{tree}: " + json.dumps({k: {"scan": v["disp_scan_ms"], "newton": v["disp_newton_ms"],
                                            "scan_kernel": v["disp_scan_kernel_ms"],
                                            "newton_kernel": v["disp_newton_kernel_ms"]}
                                        for k, v in runs[-1]["shapes"].items()}), flush=True)
    print(json.dumps({"card": card_line(), "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
