"""dtoh_per_study: device-to-host copies of the traced stretch per study;
each is a point where the host waits for the card."""

SPANS = ()
COUNTS = ()


def read(tr):
    if not tr.studies or not tr.kernels:
        return None
    return sum(1 for name, _ in tr.copies if "DtoH" in name) / tr.studies
