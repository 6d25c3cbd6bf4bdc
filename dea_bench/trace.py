"""The traced stretch: spans from the benchmark's own wrappers, the
profiler's device events, and their reduction to per-layer readings.

In a traced run the harness wraps the program's functions that the cell's
per-layer metrics name (``SPANS`` in ``metrics/<metric>.py``) in
``torch.profiler.record_function``, and the launch wrappers that their
kernel counts name (``WRAP`` in ``counts/<kernel>.py``) in a recorder of
each launch's shapes. Neither adds a synchronise. ``torch.profiler`` then
records a stretch of studies (CPU and CUDA activity); :func:`reduce` reads
its Chrome trace (a temporary file under ``TMPDIR``, removed once read)
into a :class:`Trace`, which the metric readers take.

A kernel belongs to a span when the host call that launched it (its CUDA
runtime or driver event, matched by correlation id) lies inside the span.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import json
import os
import sys
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

STRETCH = "dea_bench.stretch"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """What the readers see of one traced stretch."""

    studies: int
    window_s: float
    busy_s: float
    # (name, device seconds, frozenset of the spans open at its launch)
    kernels: list
    # (name, device seconds) of device memory copies
    copies: list
    # counts name -> (module, [launch records])
    launches: dict
    peaks: dict
    breakdown: dict = field(default_factory=dict)
    unmatched_kernels: int = 0

    def span_device_s(self, include, exclude=()) -> float:
        """Device seconds of the kernels launched inside any span of
        ``include`` and inside none of ``exclude``."""
        inc, exc = set(include), set(exclude)
        return sum(d for _, d, spans in self.kernels if spans & inc and not spans & exc)

    def roofline_pct(self, counts_name: str) -> float | None:
        """100 x the least time the card could take for the recorded
        launches of a kernel (each launch's max(bytes / bandwidth,
        operations / peak of its dtype), summed) over the device time of the
        kernels of that name; None where nothing was launched."""
        mod, recs = self.launches.get(counts_name, (None, []))
        if mod is None or not recs or not self.peaks:
            return None
        label = count_span(counts_name)
        t = sum(d for name, d, spans in self.kernels if mod.KERNEL in name and label in spans)
        if t <= 0:
            return None
        bound = 0.0
        for rec in recs:
            nbytes, ops, dtype = mod.cost(rec)
            bound += max(nbytes / self.peaks["hbm_bytes_per_s"], ops / self.peaks[f"{dtype}_ops_per_s"])
        return 100.0 * bound / t


def count_span(counts_name: str) -> str:
    """The span around each launch that a kernel count records: its
    kernels' device time is the time that the count's bound is held to."""
    return f"dea_bench.count.{counts_name}"


def _resolve(path: str):
    """``"pydeseq2_tpu_torch.fused_stream._genewise_pass"`` -> (module, name)."""
    mod_name, _, fn = path.rpartition(".")
    return importlib.import_module(mod_name), fn


class Wrappers:
    """Installs and removes the span and launch wrappers of a traced run."""

    def __init__(self, spans: set, counts: dict):
        self.spans = sorted(spans)
        self.counts = counts  # counts name -> module
        self.records: dict = {name: [] for name in counts}
        self._saved: list = []

    def _span(self, path, fn):
        label = path.removeprefix("pydeseq2_tpu_torch.")

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return wrapped

    def _recorder(self, name, mod, fn):
        recs = self.records[name]
        label = count_span(name)
        counted = getattr(mod, "counted", lambda args, kwargs: True)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not counted(args, kwargs):
                return fn(*args, **kwargs)
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            recs.append(mod.record(args, kwargs, out))
            return out

        return wrapped

    def install(self) -> None:
        for path in self.spans:
            mod, fn = _resolve(path)
            self._saved.append((mod, fn, getattr(mod, fn)))
            setattr(mod, fn, self._span(path, getattr(mod, fn)))
        for name, cmod in self.counts.items():
            mod, fn = _resolve(cmod.WRAP)
            self._saved.append((mod, fn, getattr(mod, fn)))
            setattr(mod, fn, self._recorder(name, cmod, getattr(mod, fn)))

    def remove(self) -> None:
        for mod, fn, orig in reversed(self._saved):
            setattr(mod, fn, orig)
        self._saved.clear()


@contextmanager
def profiled(on_card: bool = True):
    """A ``torch.profiler`` session over CPU and CUDA activity (CPU alone
    off the card), and a ``STRETCH`` span around the body."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(STRETCH):
            yield prof
        if on_card:
            torch.cuda.synchronize()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list, at most 90 characters."""
    head = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return head.split("(", 1)[0][:90] or name[:90]


def trace_events(prof) -> list:
    """The profiler's complete events (``ph == "X"``) from its Chrome trace,
    written to a temporary file under ``TMPDIR`` and removed once read."""
    fd, path = tempfile.mkstemp(prefix="dea_bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    print(f"trace file {size / 2**20:.1f} MiB, {len(events)} events", file=sys.stderr)
    return [e for e in events if e.get("ph") == "X"]


def _ns(e) -> tuple[int, int]:
    s = round(float(e["ts"]) * 1000)
    return s, s + round(float(e.get("dur", 0)) * 1000)


def reduce(prof, studies: int, wrappers: Wrappers, peaks: dict) -> Trace:
    """The events of ``prof`` as a :class:`Trace`."""
    span_names = {p.removeprefix("pydeseq2_tpu_torch.") for p in wrappers.spans}
    span_names |= {count_span(name) for name in wrappers.counts}
    spans = defaultdict(list)
    launch_at = {}
    device = []
    cpu_ops = []
    window = None
    for e in trace_events(prof):
        kind, name = e.get("cat", ""), e.get("name", "")
        s, t = _ns(e)
        if kind == "user_annotation":
            if name == STRETCH:
                window = (s, t)
            elif name in span_names:
                spans[name].append((s, t))
        elif kind in _LAUNCH_KINDS:
            launch_at[e.get("args", {}).get("correlation")] = s
            cpu_ops.append((s, t, name))
        elif kind == "cpu_op":
            cpu_ops.append((s, t, name))
        elif kind in _DEVICE_KINDS:
            device.append((s, t, name, kind, e.get("args", {}).get("correlation")))
    if window is None:
        raise RuntimeError("the profiler recorded no stretch span")
    w0, w1 = window
    starts = {k: sorted(v) for k, v in spans.items()}
    keys = {k: [s for s, _ in v] for k, v in starts.items()}

    def open_spans(t):
        found = set()
        for k, iv in starts.items():
            i = bisect.bisect_right(keys[k], t) - 1
            if i >= 0 and iv[i][1] >= t:
                found.add(k)
        return frozenset(found)

    kernels, copies, busy, unmatched = [], [], [], 0
    per_name = defaultdict(float)
    for s, e, name, kind, corr in device:
        if e <= w0 or s >= w1:
            continue
        busy.append((max(s, w0), min(e, w1)))
        dur = (e - s) * 1e-9
        if kind == "gpu_memcpy":
            copies.append((name, dur))
            per_name[name] += dur
            continue
        if kind != "kernel":
            per_name[name] += dur
            continue
        t = launch_at.get(corr)
        if t is None:
            unmatched += 1
        kernels.append((name, dur, open_spans(t) if t is not None else frozenset()))
        per_name[_short(name)] += dur
    merged = _merge(busy)
    busy_s = sum(e - s for s, e in merged) * 1e-9
    window_s = (w1 - w0) * 1e-9

    # Idle gaps, named by the innermost span and host operation at their middle.
    cpu_ops.sort()
    op_starts = [s for s, _, _ in cpu_ops]
    idle = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(op_starts, mid)
        # the latest-starting host operation still open at mid is the innermost
        inner = next((cpu_ops[j][2] for j in range(i - 1, max(-1, i - 400), -1) if cpu_ops[j][1] >= mid), "python")
        span = ",".join(sorted(open_spans(mid))) or "no span"
        idle[f"{span} | {inner}"] += (b - a) * 1e-9
    breakdown = {
        "device_ops": [[k, v] for k, v in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
    launches = {name: (wrappers.counts[name], recs) for name, recs in wrappers.records.items()}
    return Trace(studies=studies, window_s=window_s, busy_s=busy_s, kernels=kernels, copies=copies,
                 launches=launches, peaks=peaks, breakdown=breakdown, unmatched_kernels=unmatched)
