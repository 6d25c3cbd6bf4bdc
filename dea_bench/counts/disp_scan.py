"""Operations and bytes of one ``disp_scan`` launch (``csrc/disp_scan.cu``,
the coarse dispersion scan), from its shapes.

A copy of ``scan_cost`` of ``chip_smoke.py``: counts and mu read once, the
(K, G) objective cache written; per sample and grid point the stable form
30 operations, the auto and plain forms 38 and 40 (a Stirling-8 lgamma of
32 and 6 more), and the Cox-Reid weight and Gram 3 + P + P (P + 1). The
launch wrapper ``ops.dispersion._scan_launch`` is recorded, where
``counted``, with its arguments (name, counts, mu, X, grid_args, K, ...), grid_args = (la_grid,
K, bnd_start, bnd_end, la_init): grid points [0, bnd_start) take the
stable form, [bnd_start, bnd_end) the auto form, the rest the plain one.
"""

KERNEL = "disp_scan_kernel"
WRAP = "pydeseq2_tpu_torch.ops.dispersion._scan_launch"


def scan_cost(G: int, N: int, P: int, K: int, bnd_start: int, bnd_end: int, isz: int) -> tuple[int, int]:
    """(bytes, operations) of one coarse scan."""
    n_stable, n_auto, n_plain = bnd_start, bnd_end - bnd_start, K - bnd_end
    ops_cr = 3 + P + P * (P + 1)
    return (2 * G * N * isz + K * G * isz,
            G * N * (30 * n_stable + 38 * n_auto + 40 * n_plain + K * ops_cr))


def counted(args, kwargs) -> bool:
    """Whether a launch is the coarse scan's: the fine scan's launches go
    through the same wrapper and the same kernel template, and are neither
    timed nor counted here."""
    return args[0] == "disp_scan"


def record(args, kwargs, out):
    """The shapes of one coarse scan's launch."""
    name, counts, mu, X, grid_args, K = args[:6]
    G, N = counts.shape
    _, _, bnd_start, bnd_end, _ = grid_args
    return dict(G=G, N=N, P=X.shape[1], K=int(K), bnd_start=int(bnd_start), bnd_end=int(bnd_end),
                isz=counts.element_size())


def cost(rec) -> tuple[int, int, str]:
    """(bytes, operations, dtype) of a recorded launch."""
    nbytes, ops = scan_cost(rec["G"], rec["N"], rec["P"], rec["K"], rec["bnd_start"], rec["bnd_end"], rec["isz"])
    return nbytes, ops, "float64" if rec["isz"] == 8 else "float32"
