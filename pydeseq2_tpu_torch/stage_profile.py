"""Where the time of one ``wald_pipeline``, ``summary_pipeline``,
summary-then-shrink, streamed refit or streamed VST run goes, on a CUDA
card.

    python3 -m pydeseq2_tpu_torch.stage_profile [--summary | --shrink | --stream | --iterative | --vst]
        [n_samples] [n_genes]

Runs the pipeline (with ``--summary``, counts -> padj: the Wald stages,
then the Cook's block and ``device_padj``; with ``--shrink``, that and then
``run_lfc_shrink_streamed`` on its dispersions, size factors, MLE LFCs and
SEs: the host prior fit, the apeGLM Newton fit and the grid; with
``--stream``, ``run_summary_streamed(refit_cooks=True)`` on counts already
on the card with an outlier planted in every 100th gene: size factors,
pass 1, trend + prior, pass 2, the host copy, the gather of the refit tile,
the refit and the merge + padj; with ``--iterative``, the same on counts
with a zero in every gene, so that the run first fits the iterative size
factors; with ``--vst``, ``run_vst_streamed`` on counts on the card: the
log stats, size factors, the genewise pass, the trend, the transform and
the host copy) on ``make_data(n_samples, n_genes)``
(default 100 x 60000, float32, the benchmark's configuration) once to warm
up, then:

1. wall time per stage function of ``fused_stream`` and ``fused`` (each
   call wrapped in a synchronise before and after, host clock), and what
   is left outside them, over one run of the real pipeline, and the peak
   device memory of that run (``torch.cuda.max_memory_allocated``);
2. one run under ``torch.profiler``: device time per kernel name (top 30),
   the summed device time, and the device's idle share of the wall.

Prints the card (nvidia-smi name and power limit) first and, as the last
line, all the numbers as one JSON object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch


# The pipelines' stage functions, by the module that calls them (as module
# globals): ``wald_pipeline`` and ``summary_pipeline`` run the streamed
# passes over one gene block (the summary adds padj), the shrink path then
# ``fused_stream``'s host prior fit and streamed blocks.
STAGES = {
    "fused_stream": ("_log_stats", "_streamed_size_factors", "_genewise_pass", "_trend_and_prior", "_analyse_pass",
                     "_padj_program", "_apeglm_prior_variance", "lfc_shrink_pipeline_streamed"),
}
# Called inside a stage: timed too, and not added to the stages.
SUBSTAGES = {
    "fused_stream": ("mom_and_mu_coef", "alpha_mle_batch", "_shrunk_dispersions", "_irls_with_rescue", "hat_wald",
                     "cooks_outliers", "nbinom_glm_batch", "grid_fit_shrink_beta_batch"),
    "fused": ("irls_core", "newton_box_nbglm", "grid_fit_beta_batch", "fit_fused_trend", "dispersion_prior",
              "device_padj", "parametric_trend", "lowess_pick"),
}
# The streamed refit run (``--stream``): its passes, the host copy, and the
# refit's gather, tile and merge, with the stage functions they call.
STREAM_STAGES = {
    "fused_stream": (
        "_log_stats", "_streamed_size_factors", "_genewise_pass", "_trend_and_prior", "_analyse_pass",
        "_to_host", "_gather_refit_tile", "refit_pipeline_streamed", "_merge_refit", "_padj_program",
    ),
}
STREAM_SUBSTAGES = {
    "fused_stream": ("mom_and_mu_coef", "alpha_mle_batch", "_irls_with_rescue", "hat_wald", "cooks_outliers",
                     "impute_outliers"),
    "fused": ("fit_fused_trend", "dispersion_prior", "device_padj", "parametric_trend", "lowess_pick"),
}


# The zero-inflated run (``--iterative``): the streamed refit's stages plus
# the iterative size factors, with the rounds and the trimmed solve's parts.
ITERATIVE_STAGES = {"fused_stream": STREAM_STAGES["fused_stream"] + ("iterative_size_factors",)}
ITERATIVE_SUBSTAGES = {**STREAM_SUBSTAGES,
                       "ops.sizefactors": ("_iteration", "trimmed_sf_newton", "_sf_nll_cuda", "keep_mask",
                                           "_sf_newton_cuda")}
# The streamed VST (``--vst``).
VST_STAGES = {
    "fused_stream": ("_log_stats", "_streamed_size_factors", "_vst_genewise_pass", "fit_fused_trend",
                     "vst_transform", "_to_host"),
}
VST_SUBSTAGES = {"fused_stream": ("mom_and_mu_coef", "alpha_mle_batch"), "fused": ("parametric_trend",)}


def _flat(table: dict) -> tuple:
    return tuple(name for names in table.values() for name in names)


def timed_run(run, kw: dict, stages: dict, substages: dict) -> tuple[float, dict]:
    """One ``run(**kw)`` of a pipeline with every stage function wrapped in
    a synchronise-timed call: ``(wall_s, {stage: [seconds per call]})``."""
    import importlib

    times: dict = {name: [] for name in _flat(stages) + _flat(substages)}
    originals = {}
    for table in (stages, substages):
        for mod_name, names in table.items():
            mod = importlib.import_module(f"pydeseq2_tpu_torch.{mod_name}")
            for name in names:
                originals[(mod_name, name)] = (mod, name, getattr(mod, name))

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
        for mod, name, fn in originals.values():
            setattr(mod, name, wrap(name, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals.values():
            setattr(mod, name, fn)
    return wall, times


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device is visible", file=sys.stderr)
        return 1
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch import kernels
    from pydeseq2_tpu_torch.synthetic import make_data, plant_outliers, zero_per_gene

    args = sys.argv[1:]
    iterative = "--iterative" in args
    vst = "--vst" in args
    stream = "--stream" in args or iterative
    shrink = "--shrink" in args
    summary = "--summary" in args or shrink
    args = [a for a in args if a not in ("--summary", "--shrink", "--stream", "--iterative", "--vst")]
    n_samples = int(args[0]) if args else 100
    n_genes = int(args[1]) if len(args) > 1 else 60_000
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    kernels.build()
    counts_np, X_np = make_data(n_samples, n_genes)
    static = dict(max_disp=float(max(10, n_samples)), beta_tol=1e-6)
    if summary:
        host = pt.summary_host_inputs(X_np)
        static.update(cooks_cutoff=host["cooks_cutoff"], cohort_ids=host["cohort_ids"],
                      use_for_max=host["use_for_max"])
    run = pt.summary_pipeline if summary else pt.wald_pipeline
    label = run.__name__
    if shrink:
        def run(**kw):
            out = pt.summary_pipeline(**kw)
            return pt.run_lfc_shrink_streamed(
                kw["counts"], kw["design_matrix"], 1, out["dispersions"], out["size_factors"],
                mle_lfc=out["lfc"][:, 1], mle_se=out["se"], dtype=torch.float32, device="cuda",
            )

        label = "summary_pipeline + run_lfc_shrink_streamed"
    stages, substages = STAGES, SUBSTAGES
    if vst:
        counts = torch.as_tensor(counts_np.T, dtype=torch.float32, device="cuda")
        del counts_np
        kw = dict(counts=counts, dtype=torch.float32, device="cuda", max_disp=static["max_disp"])
        run, label = pt.run_vst_streamed, "run_vst_streamed"
        stages, substages = VST_STAGES, VST_SUBSTAGES
    elif stream:
        # Counts on the card once, as an atlas caller holds them.
        host = plant_outliers(counts_np.T)
        if iterative:
            host = zero_per_gene(host)
        counts = torch.as_tensor(host, dtype=torch.float32, device="cuda")
        del counts_np, host
        kw = dict(counts=counts, design_matrix=X_np, contrast=np.array([0.0, 1.0]), dtype=torch.float32,
                  refit_cooks=True, device="cuda", max_disp=static["max_disp"], beta_tol=static["beta_tol"])
        run, label = pt.run_summary_streamed, "run_summary_streamed(refit_cooks=True)"
        stages, substages = STREAM_STAGES, STREAM_SUBSTAGES
        if iterative:
            label += " on zero-inflated counts (iterative size factors)"
            stages, substages = ITERATIVE_STAGES, ITERATIVE_SUBSTAGES
    else:
        kw = pt.inputs_from_numpy(counts_np.T, X_np, np.array([0.0, 1.0]), 0.0, dtype=torch.float32,
                                  device="cuda", **static)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the zero-inflated run's switch to iterative mode
        run(**kw)
    torch.cuda.synchronize()

    kernels.STATS.reset()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wall_s, times = timed_run(run, kw, stages, substages)
    peak_bytes = torch.cuda.max_memory_allocated()
    kernel_launches = dict(kernels.STATS.launches)
    stage_s = {name: sum(ts) for name, ts in times.items() if ts}
    for name, sec in stage_s.items():
        indent = "    " if name in _flat(substages) else ""
        print(f"  stage {indent}{name:30s} x{len(times[name])} {sec * 1e3:9.3f} ms", flush=True)
    glue = wall_s - sum(sec for name, sec in stage_s.items() if name in _flat(stages))
    print(f"  hand-written kernel launches in the run {kernel_launches}", flush=True)
    print(f"  timed wall {wall_s * 1e3:.3f} ms, outside the stage functions {glue * 1e3:.3f} ms, "
          f"peak device memory {peak_bytes / 2**30:.3f} GiB", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # Kernel events only (the aten ops that launched them report the same
    # time again as their own device time).
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in kern)
    # (the cluster kernels launch through cudaLaunchKernelEx)
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    n_sync = sum(e.count for e in prof.key_averages()
                 if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync"))
    top = [{"name": e.key[:80], "device_ms": e.self_device_time_total / 1e3, "count": e.count} for e in events[:30]]
    print(f"  profiled wall {wall * 1e3:.3f} ms, device busy {device_us / 1e3:.3f} ms, "
          f"idle share {1 - device_us / 1e6 / wall:.4f}, kernel launches {n_launch}, "
          f"syncs/copies {n_sync}", flush=True)
    for t in top:
        print(f"    {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}", flush=True)
    out = {"card": card, "pipeline": label, "shape": [n_samples, n_genes], "timed_wall_ms": wall_s * 1e3,
           "peak_memory_bytes": peak_bytes,
           "stage_ms": {k: v * 1e3 for k, v in stage_s.items()}, "kernel_launches": kernel_launches,
           "profiled_wall_ms": wall * 1e3, "device_busy_ms": device_us / 1e3, "launches": n_launch,
           "syncs_or_copies": n_sync, "top_device": top}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
