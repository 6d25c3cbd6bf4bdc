"""launches_per_study: device kernels of the traced stretch, the
hand-written ones and PyTorch's, per study."""

SPANS = ()
COUNTS = ()


def read(tr):
    return len(tr.kernels) / tr.studies if tr.studies and tr.kernels else None
