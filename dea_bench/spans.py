"""The program's own spans over a traced stretch: where the card idles, by
the innermost ``deseq2.*`` span, what the host reads cost it, and device
time by stage.

    python3 -m dea_bench.spans --workload <name> --seed <n> [--studies <k>]
    python3 -m dea_bench.spans --workload <name> --seed <n> --window <seconds>

The first form sets a cell up as ``dea_bench.run`` does (the program
imported, its kernels built, the pool drawn on the card, one warm study),
runs the mix's ``skip_studies`` and then ``--studies`` studies (default the
mix's) under ``torch.profiler`` with the program's tracing on
(``pydeseq2_tpu_torch.tracing``), and prints :func:`reduce_spans` of the
stretch as one JSON line. The second runs ``dea_bench.run``'s untraced
window with the program's tracing on, to price it against a run with it
off. A program without the ``tracing`` module records no span, and the
readings that need one are None.

Readings (:func:`reduce_spans`): the idle gaps of the card inside the
stretch, each named by the innermost ``deseq2.*`` span open at its middle
(the one that started last), else ``no span`` and the innermost host
operation there; the share of idle seconds in gaps whose middle lies in
no ``deseq2.*`` span; ``sync_idle_ms``, the idle milliseconds a study in
the gaps that a ``deseq2.read.*`` span overlaps, whole and by site; the
device-to-host copies launched outside every ``deseq2.read.*`` span (each
copy matched to its runtime call by correlation id) with the spans and
host operation they were launched in; ``analyse_ms``, the device
milliseconds a study of the kernels launched inside ``deseq2.analyse`` and
outside ``deseq2.map`` and ``deseq2.refit``; device milliseconds a study
launched inside each stage span; and the program's IRLS rescue lanes a
study (``kernels.STATS.rescue_lanes``).
"""

from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import sys
import time
from collections import Counter, defaultdict

from dea_bench.trace import _DEVICE_KINDS, _LAUNCH_KINDS, STRETCH, _merge, _ns

PREFIX = "deseq2."
READ = "deseq2.read."


class SpanTree:
    """Nested spans of one host thread, queried by time: the chain of spans
    open at ``t``, innermost first."""

    def __init__(self, spans):
        # (start, end, name), the outer of two spans with one start first
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s for s, _, _ in self.spans]
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def open_at(self, t) -> list:
        """Names of the spans that hold ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        out = []
        while i >= 0:
            s, e, name = self.spans[i]
            if e >= t:
                out.append(name)
                i = self.parent[i]
            else:
                # the latest span to start before t has ended: climb to the
                # first enclosing span that still holds t
                j = self.parent[i]
                while j >= 0 and self.spans[j][1] < t:
                    j = self.parent[j]
                i = j
        return out


def reduce_spans(events, studies: int, window: str = STRETCH, lanes: dict | None = None) -> dict:
    """The readings of the module docstring from a Chrome trace's complete
    events (``ph == "X"``); ``window`` names the span of the stretch.
    ``lanes`` is the change of ``kernels.STATS.rescue_lanes`` over it."""
    spans, launch, cpu_ops, device = [], {}, [], []
    w = None
    for e in events:
        kind, name = e.get("cat", ""), e.get("name", "")
        s, t = _ns(e)
        if kind == "user_annotation":
            if name == window:
                w = (s, t)
            elif name.startswith(PREFIX):
                spans.append((s, t, name))
        elif kind in _LAUNCH_KINDS:
            launch[e.get("args", {}).get("correlation")] = s
            cpu_ops.append((s, t, name))
        elif kind == "cpu_op":
            cpu_ops.append((s, t, name))
        elif kind in _DEVICE_KINDS:
            device.append((s, t, name, kind, e.get("args", {}).get("correlation")))
    if w is None:
        raise RuntimeError(f"no {window!r} span in the trace")
    w0, w1 = w
    tree = SpanTree(spans)
    ops = SpanTree(cpu_ops)
    n = max(studies, 1)

    busy, stage_s, analyse_s = [], defaultdict(float), 0.0
    dtoh = htod = 0
    unread = Counter()
    for s, t, name, kind, corr in device:
        if t <= w0 or s >= w1:
            continue
        busy.append((max(s, w0), min(t, w1)))
        at = launch.get(corr)
        chain = tree.open_at(at) if at is not None else []
        if kind == "gpu_memcpy":
            if "DtoH" in name:
                dtoh += 1
                if not any(c.startswith(READ) for c in chain):
                    op = next((o for o in ops.open_at(at) if not o.startswith("cuda")), "python")
                    unread[f"{chain[0] if chain else 'no span'} | {op}"] += 1
            elif "HtoD" in name:
                htod += 1
            continue
        if kind != "kernel":
            continue
        d = (t - s) * 1e-9
        for stage in set(chain):
            if not stage.startswith(READ):
                stage_s[stage] += d
        if "deseq2.analyse" in chain and "deseq2.map" not in chain and "deseq2.refit" not in chain:
            analyse_s += d
    merged = _merge(busy)
    busy_s = sum(t - s for s, t in merged) * 1e-9
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    # read spans do not nest in one another: sorted by start, they end in order
    reads = sorted((s, t, name) for s, t, name in spans if name.startswith(READ) and t > w0 and s < w1)
    read_starts = [s for s, _, _ in reads]
    named, unnamed, idle = defaultdict(float), 0.0, 0.0
    sync, sync_by = 0.0, defaultdict(float)
    for a, b in gaps:
        g = (b - a) * 1e-9
        idle += g
        mid = (a + b) // 2
        chain = tree.open_at(mid)
        if chain:
            named[chain[0]] += g
        else:
            unnamed += g
            named[f"no span | {next(iter(ops.open_at(mid)), 'python')}"] += g
        # the read spans overlapping [a, b]: starting before b, ending after a
        hit = set()
        k = bisect.bisect_left(read_starts, b) - 1
        while k >= 0 and reads[k][1] > a:
            hit.add(reads[k][2])
            k -= 1
        if hit:
            sync += g
            for name in hit:
                sync_by[name.removeprefix(READ)] += g / len(hit)
    read_counts = Counter(name.removeprefix(READ) for _, _, name in reads)
    return {
        "studies": studies,
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "idle_s": idle,
        "spans": len(spans),
        "unnamed_idle_s": unnamed,
        "unnamed_idle_share": unnamed / idle if idle > 0 else None,
        "idle_named": [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])[:16]],
        "sync_idle_ms": 1e3 * sync / n if reads else None,
        "sync_idle_ms_by_site": {k: 1e3 * v / n for k, v in sorted(sync_by.items(), key=lambda kv: -kv[1])},
        "reads_per_study": {k: v / n for k, v in sorted(read_counts.items())},
        "dtoh_per_study": dtoh / n,
        "htod_per_study": htod / n,
        "dtoh_outside_reads": sum(unread.values()) if spans else None,
        "dtoh_outside_reads_at": dict(unread.most_common(12)),
        "analyse_ms": 1e3 * analyse_s / n if spans else None,
        "stage_ms": {k: 1e3 * v / n for k, v in sorted(stage_s.items(), key=lambda kv: -kv[1])},
        "rescue_lanes_per_study": (lanes["phase2"] + lanes["grid"]) / n if lanes is not None else None,
    }


def _tracing():
    """The program's tracing module, or None where it has none."""
    if importlib.util.find_spec("pydeseq2_tpu_torch.tracing") is None:
        return None
    import pydeseq2_tpu_torch.tracing as tracing

    return tracing


def _lanes():
    from pydeseq2_tpu_torch import kernels

    lanes = getattr(kernels.STATS, "rescue_lanes", None)
    return dict(lanes) if lanes is not None else None


def profile_stretch(cell, seed: int, studies: int | None = None, device="cuda", log=print) -> dict:
    """Set ``cell`` up, run its skipped studies, then ``studies`` under the
    profiler with the program's tracing on; :func:`reduce_spans` of them."""
    import contextlib

    import torch

    from dea_bench import trace as tr_mod
    from dea_bench.draw import draw_pool

    t0 = time.perf_counter()
    cfg, mix, entry = cell.config, cell.mix, cell.entry
    dtype = {"float32": torch.float32, "float64": torch.float64}[cfg["dtype"]]
    on_card = str(device).startswith("cuda")
    import pydeseq2_tpu_torch  # noqa: F401

    if on_card:
        from pydeseq2_tpu_torch import kernels

        kernels.build()
    pool = draw_pool(seed, cfg, mix, dtype, device)
    kn = entry.knobs(cfg["n_samples"], dtype)
    entry.program(pool[0], dtype, kn)
    skip = int(mix["trace"]["skip_studies"])
    n = int(studies or mix["trace"]["studies"])
    for i in range(skip):
        entry.program(pool[i % len(pool)], dtype, kn)
    tracing = _tracing()
    before = _lanes()
    log(f"set-up and {skip} skipped studies in {time.perf_counter() - t0:.1f} s; tracing "
        f"{'on' if tracing else 'absent'}", file=sys.stderr)
    with tr_mod.profiled(on_card) as prof, (tracing.enabled() if tracing else contextlib.nullcontext()):
        for i in range(skip, skip + n):
            entry.program(pool[i % len(pool)], dtype, kn)
    after = _lanes()
    lanes = None if before is None else {k: after[k] - before[k] for k in ("phase2", "grid")}
    out = reduce_spans(tr_mod.trace_events(prof), n, lanes=lanes)
    out["card"] = torch.cuda.get_device_name(0) if on_card else "cpu"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--studies", type=int, default=None)
    ap.add_argument("--window", type=float, default=None,
                    help="run dea_bench.run's untraced window for this many seconds, tracing on")
    args = ap.parse_args(argv)
    import torch

    from dea_bench.cell import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("dea_bench.spans: no CUDA card visible", file=sys.stderr)
        return 2
    if args.window is not None:
        from dea_bench.run import run_cell

        tracing = _tracing()
        if tracing is None:
            print("dea_bench.spans: the program has no tracing module", file=sys.stderr)
            return 2
        with tracing.enabled():
            out = run_cell(cell, args.seed, args.window, False)
        out["tracing"] = True
    else:
        out = profile_stretch(cell, args.seed, args.studies)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
