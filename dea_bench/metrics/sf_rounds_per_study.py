"""sf_rounds_per_study: the rounds of the iterative size factors a study
(``counts/sf_rounds.py``, from the program's ``kernels.STATS.sf_rounds``),
over the traced stretch's studies; None where the program has no such
counter or no card ran."""

SPANS = ()
COUNTS = ("sf_rounds",)


def read(tr):
    _, recs = tr.launches.get("sf_rounds", (None, []))
    if not tr.studies or not tr.kernels or not recs or any(r is None for r in recs):
        return None
    return sum(recs) / tr.studies
