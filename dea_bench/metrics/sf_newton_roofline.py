"""sf_newton_roofline: the trimmed size-factor solve's Newton kernel's
share of its roofline over the traced stretch (``counts/sf_newton.py``)."""

SPANS = ()
COUNTS = ("sf_newton",)


def read(tr):
    return tr.roofline_pct("sf_newton")
