"""The rounds of one ``iterative_size_factors`` call, from the program's
``kernels.STATS.sf_rounds`` (the host's own round count: no device read
here).

The name ``fused_stream.iterative_size_factors`` (the one
``run_summary_streamed`` calls) is recorded with the change of the counter
over the call; a program without the counter records None.
"""

WRAP = "pydeseq2_tpu_torch.fused_stream.iterative_size_factors"

_before: list = []


def _rounds() -> int | None:
    from pydeseq2_tpu_torch import kernels

    return getattr(kernels.STATS, "sf_rounds", None)


def counted(args, kwargs) -> bool:
    """Every call is counted; the counter is read as the call starts."""
    _before[:] = [_rounds()]
    return True


def record(args, kwargs, out):
    """The rounds of the call, or None."""
    after = _rounds()
    if after is None or not _before or _before[0] is None:
        return None
    return after - _before[0]
