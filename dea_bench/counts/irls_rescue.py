"""The IRLS rescue's lanes of one ``fused._irls_with_rescue`` call: the
unfinished lanes that the phase-2 continuation takes and the lanes the grid
tier takes, from the program's ``kernels.STATS.rescue_lanes`` (counts that
the host reads anyway: no device read here).

The wrapper ``fused_stream._irls_with_rescue`` (the name the streamed
passes and the refit call) is recorded with the change of the counter over
the call; a program without the counter records None.
"""

WRAP = "pydeseq2_tpu_torch.fused_stream._irls_with_rescue"

_before: dict = {}


def _lanes() -> dict | None:
    from pydeseq2_tpu_torch import kernels

    lanes = getattr(kernels.STATS, "rescue_lanes", None)
    return dict(lanes) if lanes is not None else None


def counted(args, kwargs) -> bool:
    """Every call is counted; the counter is read as the call starts."""
    _before.clear()
    _before.update(_lanes() or {})
    return True


def record(args, kwargs, out):
    """``{"phase2": lanes, "grid": lanes}`` of the call, or None."""
    after = _lanes()
    if after is None:
        return None
    return {k: after[k] - _before.get(k, 0) for k in ("phase2", "grid")}
