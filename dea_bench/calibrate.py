"""Readings that a cell's limits are set from (not run by the benchmark).

    python3 -m dea_bench.calibrate --workload <name> --seeds 1,2,3 [--draws K] [--out FILE]

For each seed: the cell's pool drawn as a run draws it, and for each of its
first ``K`` studies (default 1): the program's result (the timed entry at
the cell's size), the plain reference's, and the control: the reference
put in the program's place in the next precision below the configuration's
(float32 for float64; TF32 products for float32, whose products the program
runs in full precision). It prints one JSON line a study: the compared
numbers of the program (the lower readings), of the control (the upper
readings) and of three planted faults, read at the cell's size:

- ``answer``: one gene's LFC moved by 1 (natural log) where it is produced;
- ``half``: the second half of the genes left out, each column's mean over
  the first half in their place;
- ``unchanged``: IRLS returning its initial coefficients unchanged (the
  program run again with ``pydeseq2_tpu_torch.fused.irls_core`` replaced).

Besides, per study: the largest gap of each quantity over the genes above
each of ``FLOORS`` (program and control), the trend stage's reading with
the plain trend fitted in bfloat16 (its control), and the trend's
coefficients as each side fits them (``trend_witness``). With the first
seed, and with each ``--repeat`` seed, it also runs the first study twice
and says whether the two results are bit for bit equal. The walls of the
program, the reference and the control are given beside.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from dea_bench.cell import load_cell
from dea_bench.draw import draw_pool


# Candidate base-mean floors of the expressed genes, read before one is
# chosen (``entries/refit_summary.py``'s ``EXPRESSED``).
FLOORS = (1.0, 2.0, 5.0, 10.0, 20.0)


def _walled(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def altered_answer(res: dict) -> dict:
    out = dict(res)
    lfc = np.array(res["lfc"], dtype=np.float64)
    g = int(np.flatnonzero(np.isfinite(lfc[:, -1]))[0])
    lfc[g, -1] += 1.0
    out["lfc"] = lfc.astype(np.asarray(res["lfc"]).dtype)
    return out


def half_left_out(res: dict) -> dict:
    out = dict(res)
    G = len(res["base_mean"])
    h = G // 2
    for k, v in res.items():
        v = np.asarray(v)
        if v.ndim >= 1 and v.shape[0] == G and v.dtype.kind == "f":
            v = v.copy()
            v[h:] = np.nanmean(v[:h], axis=0)
            out[k] = v
    return out


def unchanged_irls(counts, size_factors, X, disp, beta_init, **kw):
    """``fused.irls_core`` that returns its initial coefficients unchanged."""
    G = beta_init.shape[0]
    return beta_init, torch.zeros(G, dtype=torch.bool, device=beta_init.device), \
        torch.ones(G, dtype=torch.bool, device=beta_init.device)


def irls_unchanged(entry, study, dtype, kn) -> dict:
    import pydeseq2_tpu_torch.fused as fused

    orig = fused.irls_core
    fused.irls_core = unchanged_irls
    try:
        return entry.program(study, dtype, kn)
    finally:
        fused.irls_core = orig


def trend_witness(entry, prog: dict, ref: dict) -> dict:
    """The trend's coefficients (a0, a1) as each side fits them: the
    program's and the reference's own (with whether it fell back to the
    mean), and, with the rounds and whether the fit failed, the program's trend (the
    ``trend`` kernel on a card) and the plain one, in float32 and float64,
    on the reference's trend inputs and on the program's."""
    from dea_bench.reference.deseq2 import parametric_trend as plain
    from pydeseq2_tpu_torch.ops.trend import parametric_trend as kernel

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    out = {"program": np.asarray(prog["trend_coeffs"], np.float64).tolist() + [bool(prog["trend_used_mean"])],
           "reference": np.asarray(ref["trend_coeffs"], np.float64).tolist() + [bool(ref["trend_used_mean"])]}
    for side, res in (("ref_inputs", ref), ("prog_inputs", prog)):
        bm, gw = entry.trend_inputs(res, ref)
        for name, fit, dt in (("kernel", kernel, torch.float32), ("plain", plain, torch.float32),
                              ("plain64", plain, torch.float64)):
            b, g = (torch.as_tensor(x, device=dev).to(dt) for x in (bm, gw))
            nan = torch.tensor(float("nan"), dtype=dt, device=dev)
            _, c, failed, rounds = fit(b, g, torch.isfinite(g), nan, 20)
            out[f"{side}.{name}"] = c.double().cpu().tolist() + [int(rounds), bool(failed)]
    return out


def worst_genes(prog: dict, ref: dict, contrast) -> dict:
    """Where the program's widest gap of each per-gene quantity lies: the
    gene, its base mean and genewise dispersion in the reference, both
    sides' values, and whether the reference refitted it."""
    cols = {"disp_genewise": "genewise_dispersions", "disp_map": "MAP_dispersions", "se": "se",
            "stat": "statistics", "pvalue": "p_values", "lfc": "lfc"}
    out = {}
    for q, col in cols.items():
        a = np.asarray(prog[col], np.float64)
        b = np.asarray(ref[col], np.float64)
        if a.ndim == 2:
            a, b = a @ contrast, b @ contrast
        gap = np.abs(a - b) / (np.abs(b) + 1e-300)
        gap[~(np.isfinite(a) & np.isfinite(b))] = -1
        g = int(np.argmax(gap))
        out[q] = {"gene": g, "base_mean": float(ref["base_mean"][g]),
                  "genewise": float(ref["genewise_dispersions"][g]), "map": float(ref["MAP_dispersions"][g]),
                  "program": float(a[g]), "reference": float(b[g]), "refitted": bool(ref["refitted"][g]),
                  "converged": bool(ref["irls_converged"][g])}
    return out


def _bits_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True) for k in a if k in b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--draws", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeat", default="", help="seeds whose first study also runs twice")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from pydeseq2_tpu_torch import kernels

    kernels.build()
    cfg, mix, entry = cell.config, cell.mix, cell.entry
    dtype = getattr(torch, cfg["dtype"])
    kn = entry.knobs(cfg["n_samples"], dtype)
    sink = open(args.out, "a") if args.out else None
    repeat = {int(x) for x in args.repeat.split(",") if x}
    for si, seed in enumerate(int(s) for s in args.seeds.split(",")):
        pool = draw_pool(seed, cfg, mix, dtype, "cuda")
        for d in range(min(args.draws, len(pool))):
            study = pool[d]
            entry.program(study, dtype, kn)  # warm
            prog, t_prog = _walled(lambda: entry.program(study, dtype, kn))
            row = {"workload": cell.name, "seed": seed, "draw": d, "program_s": t_prog}
            if si == 0 and d == 0 or seed in repeat:
                row["repeat_bit_equal"] = _bits_equal(prog, entry.program(study, dtype, kn))
            ref, row["reference_s"] = _walled(lambda: entry.reference(study, dtype, kn))
            if dtype == torch.float64:
                ctl, row["control_s"] = _walled(lambda: entry.reference(study, torch.float32, kn))
                row["control"] = "float32"
            else:
                ctl, row["control_s"] = _walled(lambda: entry.reference(study, dtype, kn, tf32=True))
                row["control"] = "tf32"
            c = study.contrast
            row["program"] = entry.numbers(prog, ref, c)
            row["control_numbers"] = entry.numbers(ctl, ref, c)
            row["worst_genes"] = worst_genes(prog, ref, c)
            gp, gc = entry.gaps(prog, ref, c), entry.gaps(ctl, ref, c)
            bm = np.asarray(ref["base_mean"], np.float64)
            row["floors"] = {f: {"program": {k: entry.largest(g, bm >= f) for k, g in gp.items() if g.dtype != bool
                                             and k != "size_factors"},
                                 "control": {k: entry.largest(g, bm >= f) for k, g in gc.items() if g.dtype != bool
                                             and k != "size_factors"},
                                 "genes": int(np.sum(bm >= f))}
                             for f in FLOORS}
            st = entry.trend_stage(prog, ref, torch.bfloat16)
            row["control_trend_stage_bf16"] = {"max": entry.largest(st), "median": float(np.nanmedian(st))}
            row["trend_witness"] = trend_witness(entry, prog, ref)
            row["fault_answer"] = entry.numbers(altered_answer(prog), ref, c)
            row["fault_half"] = entry.numbers(half_left_out(prog), ref, c)
            if si == 0 and d == 0:
                row["fault_unchanged"] = entry.numbers(irls_unchanged(entry, study, dtype, kn), ref, c)
            row["replaced"] = int(np.sum(ref["replaced"]))
            row["refitted"] = int(np.sum(ref["refitted"]))
            row["irls_unconverged"] = int(np.sum(~np.asarray(ref["irls_converged"], bool)))
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            del prog, ref, ctl
        del pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
