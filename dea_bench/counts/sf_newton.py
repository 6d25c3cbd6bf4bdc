"""Operations and bytes of one ``sf_newton`` launch (``csrc/sizefactors.cu``,
all the guarded Newton steps of one round of the trimmed size-factor
solve), from its shapes.

A copy of ``chip_smoke.py``'s model of the kernel: counts, coef, disp and
the keep set read once, the four per-sample vectors read and s written; per
step and cell of a kept gene 19 operations (1 / disp, mu 5, w 3, g 4 and h 6
with their float64 converts and adds). The launch wrapper
``ops.sizefactors._sf_newton_cuda`` is recorded with its steps and a
reference to its keep set, which is counted once the stretch has closed.
"""

KERNEL = "sf_newton_kernel"
WRAP = "pydeseq2_tpu_torch.ops.sizefactors._sf_newton_cuda"


def newton_cost(G: int, N: int, n_keep: int, iters: int, isz: int) -> tuple[int, int]:
    """(bytes, operations) of one launch of ``iters`` steps over ``n_keep``
    kept genes of G."""
    return isz * (G * N + 2 * G + 4 * N) + G, iters * N * n_keep * 19


def record(args, kwargs, out):
    counts, keep, iters = args[0], args[6], args[8]
    G, N = counts.shape
    return dict(G=G, N=N, isz=counts.element_size(), keep=keep, iters=int(iters))


def cost(rec) -> tuple[int, int, str]:
    """(bytes, operations, dtype) of a recorded launch; reads its keep set
    from the device."""
    nbytes, ops = newton_cost(rec["G"], rec["N"], int(rec["keep"].sum()), rec["iters"], rec["isz"])
    return nbytes, ops, "float64" if rec["isz"] == 8 else "float32"
