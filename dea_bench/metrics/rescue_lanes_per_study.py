"""rescue_lanes_per_study: the IRLS lanes a study hands to the rescue's
phase-2 continuation and grid tier (``counts/irls_rescue.py``, from the
program's ``kernels.STATS.rescue_lanes``), over the traced stretch's
studies; None where the program has no such counter or no card ran."""

SPANS = ()
COUNTS = ("irls_rescue",)


def read(tr):
    _, recs = tr.launches.get("irls_rescue", (None, []))
    if not tr.studies or not tr.kernels or not recs or any(r is None for r in recs):
        return None
    return sum(r["phase2"] + r["grid"] for r in recs) / tr.studies
