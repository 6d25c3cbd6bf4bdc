"""Operations and bytes of one ``disp_newton`` launch
(``csrc/disp_newton.cu``, the safeguarded Newton polish of the log
dispersions), from its shapes.

A copy of ``newton_cost`` of ``chip_smoke.py``: counts and mu read once, la
read and four outputs written; 5 evaluations a gene, per sample the stable
fgh 85 operations and the plain one 127, by the branch of each gene's final
la (the plain form where r = exp(-la) < 8), and the Cox-Reid weights and
three Grams. The launch wrapper ``ops.dispersion._newton_polish_cuda`` is
recorded with its arguments (counts, mu, X, ...) and its first output, the
final la, whose branch shares are read once the stretch has closed.
"""

import torch

KERNEL = "disp_newton_kernel"
WRAP = "pydeseq2_tpu_torch.ops.dispersion._newton_polish_cuda"


def newton_cost(G: int, N: int, P: int, plain_frac: float, isz: int) -> tuple[int, int]:
    """(bytes, operations) of one Newton polish."""
    ntri = P * (P + 1) // 2
    ops_cr = 10 + 3 * (2 * ntri) + ntri
    return (2 * G * N * isz + 5 * G * isz,
            int(5 * G * N * ((1 - plain_frac) * 85 + plain_frac * 127 + ops_cr)))


def record(args, kwargs, out):
    counts, mu, X = args[:3]
    G, N = counts.shape
    return dict(G=G, N=N, P=X.shape[1], isz=counts.element_size(), la=out[0])


def cost(rec) -> tuple[int, int, str]:
    """(bytes, operations, dtype) of a recorded launch; reads its final la
    from the device."""
    plain_frac = float((torch.exp(-rec["la"]) < 8.0).double().mean())
    nbytes, ops = newton_cost(rec["G"], rec["N"], rec["P"], plain_frac, rec["isz"])
    return nbytes, ops, "float64" if rec["isz"] == 8 else "float32"
