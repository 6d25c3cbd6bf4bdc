"""disp_scan_roofline: the coarse dispersion scan's share of its
roofline over the traced stretch (``counts/disp_scan.py``)."""

SPANS = ()
COUNTS = ("disp_scan",)


def read(tr):
    return tr.roofline_pct("disp_scan")
