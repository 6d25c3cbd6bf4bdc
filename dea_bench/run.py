"""Run one cell of the benchmark once.

    python3 -m dea_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; ``dea_bench/cell.py`` finds their
files. A run:

1. set-up (``setup_s``, from the start of the process): imports the
   program, builds its kernels where they are not built yet (into
   ``build/kernels/`` of the checkout; its seconds are given apart as
   ``device.build_s``), draws the mix's pool of studies on the card from
   ``--seed`` and runs its first study once (every study of a pool has one
   shape);
2. with ``--trace 0``, a closed loop of studies, one client sending the
   next study of the pool when the last one returned, for ``--seconds``
   seconds (a study started before the close runs to its end and counts):
   the end-to-end metrics; with ``--trace 1``, the mix's ``skip_studies``
   studies and then its ``studies`` under ``torch.profiler``: the per-layer
   metrics, ``busy_s``, ``window_s`` and ``breakdown``;
3. once the window has closed and the peak memory has been read, the
   mix's ``check`` studies, drawn from the seed among those that ran, each
   compared with the plain reference on the same inputs (``correct``).

It prints the numbers compared beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output.
It exits 2 without a result where no CUDA card (or fewer than the cell
asks for) is visible, and 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from dea_bench.cell import load_cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pydeseq2_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Reservoir:
    """A uniform sample of ``k`` of the studies that ran, drawn from the
    seed as they come (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item


def _metric(value, unit) -> dict:
    return {"value": value, "unit": unit}


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda", log=print) -> dict:
    """One run of ``cell``; returns the result object (see the module
    docstring). ``device="cpu"`` runs the program's plain versions (the
    tests' rehearsal; no card metric is then measured)."""
    import torch

    from dea_bench.draw import draw_pool

    cfg, mix, entry = cell.config, cell.mix, cell.entry
    dtype = {"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]
    on_card = str(device).startswith("cuda")
    phases = {"start": time.perf_counter() - T0}
    import pydeseq2_tpu_torch  # noqa: F401  (the program; its kernels build below)

    phases["import"] = time.perf_counter() - T0
    if on_card:
        from pydeseq2_tpu_torch import kernels

        built = kernels.build()
        if built:
            log(f"built {len(built)} kernel sources in {max(built.values()):.1f} s", file=sys.stderr)
    phases["build"] = time.perf_counter() - T0
    pool = draw_pool(seed, cfg, mix, dtype, device)
    _sync(device)
    phases["draw"] = time.perf_counter() - T0
    pool_bytes = sum(s.counts.numel() * s.counts.element_size() for s in pool)
    kn = entry.knobs(cfg["n_samples"], dtype)
    entry.program(pool[0], dtype, kn)
    _sync(device)
    phases["warm"] = time.perf_counter() - T0
    # The harness's heap (the program's modules, the pool) moves to the
    # collector's permanent generation, so no full collection walks it
    # inside the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T0
    log("set-up, seconds from the process's start: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()),
        file=sys.stderr)

    G = cfg["n_genes"]
    sample = Reservoir(int(mix["check"]["studies"]), seed)
    attempted = failed = 0
    errors = []

    def one(i):
        nonlocal attempted, failed
        attempted += 1
        k = i % len(pool)
        t = time.perf_counter()
        try:
            res = entry.program(pool[k], dtype, kn)
        except Exception as e:  # a study that raises is failed, and the loop goes on
            failed += 1
            errors.append(repr(e)[:300])
            return None
        wall = time.perf_counter() - t
        sample.offer((k, res))
        return wall

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    metrics, dev_extra, breakdown = {}, {}, None
    if not trace:
        walls = []
        start = time.perf_counter()
        deadline = start + seconds
        i = 0
        while time.perf_counter() < deadline:
            w = one(i)
            i += 1
            if w is not None:
                walls.append(w)
        window = time.perf_counter() - start
        values = {
            "genes_per_s": (G * len(walls) / window, "genes/s"),
            "setup_s": (setup_s, "s"),
            "study_p95_s": (float(np.percentile(walls, 95)) if walls else math.nan, "s"),
        }
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        values["peak_device_gib"] = ((peak - pool_bytes) / 2**30, "GiB")
        for m in cell.end_to_end:
            v, unit = values[m["name"]]
            metrics[m["name"]] = _metric(v, m["unit"])
        log(f"window {window:.3f} s, {len(walls)} studies, walls median {np.median(walls) if walls else 0:.4f} s, "
            f"the first {len(pool)} " + " ".join(f"{w:.4f}" for w in walls[:len(pool)]), file=sys.stderr)
    else:
        from dea_bench import trace as tr_mod
        from dea_bench.cell import load_module

        readers = {m["name"]: cell.metric_reader(m["name"]) for m in cell.per_layer}
        spans = {s for r in readers.values() for s in r.SPANS}
        counts = {c: load_module(cell.base / "counts" / f"{c}.py") for r in readers.values() for c in r.COUNTS}
        skip, n = int(mix["trace"]["skip_studies"]), int(mix["trace"]["studies"])
        for i in range(skip):
            one(i)
        wrappers = tr_mod.Wrappers(spans, counts)
        wrappers.install()
        try:
            with tr_mod.profiled(on_card) as prof:
                for i in range(skip, skip + n):
                    one(i)
        finally:
            wrappers.remove()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        peaks = json.loads((cell.base / "peaks.json").read_text()).get(
            torch.cuda.get_device_name(0) if on_card else "", {})
        tr = tr_mod.reduce(prof, n, wrappers, peaks)
        for name, reader in readers.items():
            v = reader.read(tr)
            if v is not None:
                metrics[name] = _metric(v, next(m["unit"] for m in cell.per_layer if m["name"] == name))
        dev_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = tr.breakdown
        log(f"traced {n} studies: window {tr.window_s:.3f} s, busy {tr.busy_s:.3f} s, "
            f"{len(tr.kernels)} kernels ({tr.unmatched_kernels} without their launch), {len(tr.copies)} copies",
            file=sys.stderr)
        del prof, tr, wrappers

    # The window has closed and the peak is read: check the sampled studies.
    checks = {name: {"value": 0.0, "limit": lim} for name, lim in cell.limits["limits"].items()}
    refs = {}
    t_ref = time.perf_counter()
    for k, res in sample.kept:
        if k not in refs:
            refs[k] = entry.reference(pool[k], dtype, kn)
        got = entry.numbers(res, refs[k], pool[k].contrast)
        for name, c in checks.items():
            v, old = got[name], c["value"]
            c["value"] = v if (math.isnan(v) or math.isnan(old)) else max(old, v)
    ref_s = time.perf_counter() - t_ref
    correct = (failed == 0 and len(sample.kept) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    log(f"checked {len(sample.kept)} studies of draws {sorted(refs)} against the reference in {ref_s:.1f} s; "
        f"{attempted} attempted, {failed} failed {errors[:3]}", file=sys.stderr)
    out = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
            "build_s": phases["build"] - phases["import"],
            **dev_extra,
        },
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    if on_card:
        log(f"card: {_card()}", file=sys.stderr)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"dea_bench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"dea_bench: loaded {bad}: the benchmark drives the PyTorch port alone", file=sys.stderr)
        return 3
    print(f"run took {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
