"""sf_nll_roofline: the trimmed size-factor solve's per-gene NLL kernel's
share of its roofline over the traced stretch (``counts/sf_nll.py``)."""

SPANS = ()
COUNTS = ("sf_nll",)


def read(tr):
    return tr.roofline_pct("sf_nll")
