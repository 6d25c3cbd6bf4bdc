"""Operations and bytes of one ``sf_nll`` launch (``csrc/sizefactors.cu``,
the per-gene NB NLL of a round of the trimmed size-factor solve), from its
shapes.

A copy of ``chip_smoke.py``'s model of the kernel: counts, coef, disp, the
mask and the three per-sample factors read once, the NLL written; per cell
of a gene on the mask mu 4 and the float64 add 2, then by the cell's class
a zero count's short form, 4 (r = 1 / disp < 8) or 3, or any other count's
log mu 3 and the plain form 14 (r < 8) or the Stirling-difference form 25.
Which cells hold a zero is known only from the counts, which are not read
here: every cell counts at its class's cheapest form, the zero's, so the
operations are never overstated. The launch wrapper
``ops.sizefactors._sf_nll_cuda`` is recorded with references to its
dispersions and mask, whose classes are counted once the stretch has closed.
"""

import torch

KERNEL = "sf_nll_kernel"
WRAP = "pydeseq2_tpu_torch.ops.sizefactors._sf_nll_cuda"


def nll_cost(G: int, N: int, plain_rows: int, stirling_rows: int, isz: int) -> tuple[int, int]:
    """(bytes, operations) of one launch over G genes, of which
    ``plain_rows`` on the mask take the plain form (r < 8) and
    ``stirling_rows`` the Stirling-difference form, every cell at its
    cheapest (the zero count's) form."""
    return (isz * (G * N + 3 * G + 3 * N) + G,
            N * (plain_rows * (6 + 4) + stirling_rows * (6 + 3)))


def record(args, kwargs, out):
    counts, disp, mask = args[0], args[5], args[6]
    G, N = counts.shape
    return dict(G=G, N=N, isz=counts.element_size(), disp=disp, mask=mask)


def cost(rec) -> tuple[int, int, str]:
    """(bytes, operations, dtype) of a recorded launch; reads its
    dispersions and mask from the device."""
    mask = rec["mask"].bool()
    plain = mask & (1.0 / rec["disp"] < 8.0)
    n_plain, n_on = int(plain.sum()), int(mask.sum())
    nbytes, ops = nll_cost(rec["G"], rec["N"], n_plain, n_on - n_plain, rec["isz"])
    return nbytes, ops, "float64" if rec["isz"] == 8 else "float32"
