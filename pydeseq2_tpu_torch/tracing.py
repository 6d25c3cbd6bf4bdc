"""Spans of the port's stages and host reads, behind a switch that is off
by default.

With tracing on, :func:`span` (and the :func:`traced` decorator) enters
``torch.profiler.record_function(name)``: while a ``torch.profiler``
records, the span is kept as a ``user_annotation`` on the profiler's host
clock, which the profiler aligns with the card's timestamps, so every
device-idle gap lies beside what the host was doing. Spans stay in the
profiler's memory and leave with its trace; nothing here writes a file.
With tracing off a span is one shared ``contextlib.nullcontext()``: no
``record_function`` is entered, and nothing is launched, synchronised,
allocated or kept. Tracing on also records the per-launch counters that
cost a launch or grow a list (``kernels.STATS.irls_trips``, ``box_passes``).

    import torch, pydeseq2_tpu_torch.tracing as tracing
    with torch.profiler.profile() as prof, tracing.enabled():
        run_summary_streamed(...)

Span names (fixed, prefix ``deseq2.``): ``deseq2.study`` around all of
``fused_stream.run_summary_streamed``; the stages inside it,
``deseq2.stage`` (counts cast and padded), ``deseq2.host_inputs``
(``summary_host_inputs``), ``deseq2.size_factors`` (the ratio-defined
check, the log-means and the estimator, iterative too),
``deseq2.genewise``, ``deseq2.trend_prior``, ``deseq2.analyse`` (MAP,
IRLS with rescue, hat + Wald, Cook's), ``deseq2.map``, ``deseq2.irls``,
``deseq2.to_host``, ``deseq2.refit`` and ``deseq2.padj``; and
``deseq2.read.<site>`` around each host read of a device value on the CUDA
route, where the host waits for the stream (:data:`READS`).
"""

from __future__ import annotations

import contextlib
import functools

import torch

# The host reads of the streamed summary's CUDA route, by site.
READS = {
    "sf_defined": "fused_stream.run_summary_streamed: does any gene have no zero (ratio size factors defined)",
    "sf_iter_done": "ops.sizefactors.iterative_size_factors: the rounds' stop",
    "pinv": "ops.linreg.ols_pinv: the SVD's convergence flag (torch.linalg.pinv)",
    "irls_unfinished": "fused._irls_with_rescue: the lanes phase 1 left unfinished",
    "irls_rescue_any": "fused._irls_with_rescue: whether any lane takes the Newton rescue",
    "irls_grid_count": "fused._irls_with_rescue: the lanes the grid tier takes",
    "to_host": "fused_stream._to_host: the results' one device-to-host copy",
    "padj": "fused_stream._apply_streamed_refit: the merged padj's copy",
}

_on = False
_OFF = contextlib.nullcontext()


def active() -> bool:
    """Whether tracing is on."""
    return _on


def enable(flag: bool = True) -> bool:
    """Turn tracing on or off; returns the setting it replaces."""
    global _on
    before, _on = _on, bool(flag)
    return before


@contextlib.contextmanager
def enabled(flag: bool = True):
    """Tracing on (or off) inside the ``with`` block, as it was after."""
    before = enable(flag)
    try:
        yield
    finally:
        enable(before)


def span(name: str):
    """A context manager: ``record_function(name)`` with tracing on, the
    shared no-op context with it off."""
    return torch.profiler.record_function(name) if _on else _OFF


def read(site: str):
    """The span ``deseq2.read.<site>`` of a host read (a site of :data:`READS`)."""
    return torch.profiler.record_function("deseq2.read." + site) if _on else _OFF


def traced(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return call

    return wrap
