"""disp_newton_roofline: the dispersion Newton polish's share of its
roofline over the traced stretch (``counts/disp_newton.py``)."""

SPANS = ()
COUNTS = ("disp_newton",)


def read(tr):
    return tr.roofline_pct("disp_newton")
