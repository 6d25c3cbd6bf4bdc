"""Where the time of one ``wald_pipeline`` run goes, on a CUDA card.

    python3 -m pydeseq2_tpu_torch.stage_profile [n_samples] [n_genes]

Runs the pipeline on ``make_data(n_samples, n_genes)`` (default 100 x
60000, float32, the benchmark's configuration) once to warm up, then:

1. wall time per stage function of ``fused`` (each call wrapped in a
   synchronise before and after, host clock), and what is left outside
   them, over one run of the real pipeline;
2. one run under ``torch.profiler``: device time per kernel name (top 15),
   the summed device time, and the device's idle share of the wall.

Prints the card (nvidia-smi name and power limit) first and, as the last
line, all the numbers as one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


# The pipeline's stage functions, as ``fused`` calls them (module globals).
STAGES = (
    "_size_factors", "fit_rough_dispersions_batch", "fit_moments_dispersions_batch",
    "fit_lin_mu_batch", "alpha_mle_batch", "fit_fused_trend", "nanmedian",
    "irls_beta_init", "_irls_with_rescue", "hat_diagonals", "wald_test_batch",
)
# Called inside _irls_with_rescue: timed too, and not added to the stages.
SUBSTAGES = ("irls_core", "newton_box_nbglm", "grid_fit_beta_batch")


def timed_run(kw: dict) -> tuple[float, dict]:
    """One ``wald_pipeline`` run with every stage function wrapped in a
    synchronise-timed call: ``(wall_s, {stage: [seconds per call]})``."""
    from pydeseq2_tpu_torch import fused

    times: dict = {name: [] for name in STAGES + SUBSTAGES}
    originals = {name: getattr(fused, name) for name in STAGES + SUBSTAGES}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out

        return timed

    try:
        for name, fn in originals.items():
            setattr(fused, name, wrap(name, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.wald_pipeline(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(fused, name, fn)
    return wall, times


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device is visible", file=sys.stderr)
        return 1
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.synthetic import make_data

    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    n_genes = int(sys.argv[2]) if len(sys.argv) > 2 else 60_000
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    kernels.build()
    counts_np, X_np = make_data(n_samples, n_genes)
    max_disp = float(max(10, n_samples))
    kw = pt.inputs_from_numpy(counts_np.T, X_np, np.array([0.0, 1.0]), 0.0, dtype=torch.float32,
                              device="cuda", max_disp=max_disp, beta_tol=1e-6)
    pt.wald_pipeline(**kw)
    torch.cuda.synchronize()

    wall_s, times = timed_run(kw)
    stage_s = {name: sum(ts) for name, ts in times.items() if ts}
    for name, sec in stage_s.items():
        indent = "    " if name in SUBSTAGES else ""
        print(f"  stage {indent}{name:30s} x{len(times[name])} {sec * 1e3:9.3f} ms", flush=True)
    glue = wall_s - sum(sec for name, sec in stage_s.items() if name in STAGES)
    print(f"  timed wall {wall_s * 1e3:.3f} ms, outside the stage functions {glue * 1e3:.3f} ms", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.wald_pipeline(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # Kernel events only (the aten ops that launched them report the same
    # time again as their own device time).
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in kern)
    n_launch = sum(e.count for e in prof.key_averages() if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    n_sync = sum(e.count for e in prof.key_averages()
                 if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync"))
    top = [{"name": e.key[:80], "device_ms": e.self_device_time_total / 1e3, "count": e.count} for e in events[:15]]
    print(f"  profiled wall {wall * 1e3:.3f} ms, device busy {device_us / 1e3:.3f} ms, "
          f"idle share {1 - device_us / 1e6 / wall:.4f}, kernel launches {n_launch}, "
          f"syncs/copies {n_sync}", flush=True)
    for t in top:
        print(f"    {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}", flush=True)
    out = {"card": card, "shape": [n_samples, n_genes], "timed_wall_ms": wall_s * 1e3,
           "stage_ms": {k: v * 1e3 for k, v in stage_s.items()},
           "profiled_wall_ms": wall * 1e3, "device_busy_ms": device_us / 1e3, "launches": n_launch,
           "syncs_or_copies": n_sync, "top_device": top}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
