"""Build, bind and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) and loaded with ``ctypes``. Libraries go to
``build/kernels/`` at the root of the checkout, named by a hash of the
sources, the shared header and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. :func:`build` compiles every
missing library at once, one ``nvcc`` process per source, all started
together. A failed build raises; nothing falls back to PyTorch.

Every exported C function returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises if it is not 0 and otherwise adds one to the kernel's
launch count in :data:`STATS`. Kernels run on PyTorch's current stream and
allocate nothing: the ``ops`` wrappers allocate outputs with ``torch.empty``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
HEADERS = ("common.cuh", "trimmed.cuh")

# kernel name -> (source file, exported C function)
KERNELS = {
    "select": ("select.cu", "order_stats_select_launch"),
    # one radix pass of a select whose keys lie on several ranks (the sharded size-factor median),
    # and the digit pick from the ranks' summed counts
    "select_hist": ("select.cu", "select_hist_launch"),
    "select_pick": ("select.cu", "select_pick_launch"),
    "disp_scan": ("disp_scan.cu", "disp_scan_launch"),
    "disp_scan_fine": ("disp_scan.cu", "disp_scan_fine_launch"),
    # the fine scan's gene order, grouped by centre
    "disp_scan_group": ("disp_scan.cu", "disp_scan_group_launch"),
    "disp_newton": ("disp_newton.cu", "disp_newton_launch"),
    "irls": ("irls.cu", "irls_launch"),
    "hat_wald": ("hat_wald.cu", "hat_wald_launch"),
    "hat": ("hat_wald.cu", "hat_launch"),
    "wald": ("hat_wald.cu", "wald_launch"),
    "cooks": ("cooks.cu", "cooks_launch"),
    # the rejection counts of every cutoff row, and the adjusted values of one row (or every row)
    "bh_count": ("bh.cu", "bh_count_launch"),
    "bh_adjust": ("bh.cu", "bh_adjust_launch"),
    "newton_box": ("newton_box.cu", "newton_box_launch"),
    "grid_nb": ("grid.cu", "grid_nb_launch"),
    "shrink": ("shrink.cu", "shrink_launch"),
    "grid_apeglm": ("grid.cu", "grid_apeglm_launch"),
    "mom": ("mom.cu", "mom_launch"),
    "trend": ("trend.cu", "trend_launch"),
    "trend_fit": ("trend.cu", "trend_fit_launch"),
    "lowess": ("lowess.cu", "lowess_launch"),
    "impute": ("impute.cu", "impute_launch"),
    "sf_nll": ("sizefactors.cu", "sf_nll_launch"),
    "sf_newton": ("sizefactors.cu", "sf_newton_launch"),
    "vst": ("vst.cu", "vst_launch"),
    "trimmed_var": ("trimmed.cu", "trimmed_var_launch"),
    "dnb_nll": ("dnb_nll.cu", "dnb_nll_launch"),
    # sf_nll's table of lgamma(y + 1), built once per device and type
    "lgamma_table": ("sizefactors.cu", "lgamma_table_launch"),
}

# Exported helpers that are not kernels of the pipeline (a check, an
# occupancy query); they are not counted.
HELPERS = {"psi_f64": ("disp_newton.cu", "psi_f64_launch"),
           # the blocks of each grid kernel an SM holds (the occupancy API; no launch)
           "grid_apeglm_per_sm": ("grid.cu", "grid_apeglm_per_sm"),
           "grid_nb_per_sm": ("grid.cu", "grid_nb_per_sm"),
           # the clusters of 16 select blocks the card holds (the occupancy API; no launch)
           "select_max_clusters": ("select.cu", "select_max_clusters"),
           # the select_hist blocks an SM holds (the occupancy API; no launch)
           "select_hist_per_sm": ("select.cu", "select_hist_per_sm"),
           # the blocks of an irls group size an SM holds (the occupancy API; no launch)
           "irls_per_sm": ("irls.cu", "irls_per_sm")}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # No FMA contraction: the kernels reproduce the JAX expressions with
    # their rounding, term by term, like the plain PyTorch versions.
    "--fmad=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong

# argtypes of each exported function, without the trailing stream pointer
# (see the extern "C" launchers in csrc/*.cu).
_ARGTYPES = {
    "order_stats_select_launch": [_I, _P, _I, _I, _L, _L, _P, _P, _P, _P, _I, _I, _I],
    "select_hist_launch": [_I, _P, _I, _I, _L, _L, _P, _I, _I, _I, _I, _P],
    "select_pick_launch": [_I, _I, _I, _I, _P, _P, _L, _P, _P, _P],
    "disp_scan_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _D, _I, _I,
                         _P, _P, _I, _P, _P, _P, _P],
    "disp_scan_fine_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _D, _D, _D, _D, _I, _P, _I, _I,
                              _P, _P, _I, _P, _P, _P],
    "disp_scan_group_launch": [_I, _I, _P, _D, _D, _I, _P, _P],
    "disp_newton_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _D, _D, _D, _D,
                           _I, _I, _I, _P, _P, _P, _P],
    "irls_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _D, _D, _D, _D,
                    _I, _I, _I, _P, _P, _P, _P, _P],
    "hat_wald_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _D, _I, _I, _I, _P, _P, _P, _P, _P],
    "hat_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _D, _I, _I, _P, _P],
    "wald_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "cooks_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "bh_count_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _D, _P, _P, _P, _P],
    "bh_adjust_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "newton_box_launch": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _D, _D, _I, _P, _P, _P],
    "grid_nb_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _D, _I, _I, _P],
    "shrink_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _D, _D, _I, _I, _D, _I, _P, _P, _P, _P, _P, _P, _P],
    "grid_apeglm_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _D, _D, _I, _I, _I, _P],
    "mom_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _D, _I, _I, _I, _P, _P, _P, _P],
    "trend_launch": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "trend_fit_launch": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "lowess_launch": [_I, _I, _I, _I, _P, _P, _P, _P],
    "impute_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "sf_nll_launch": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _D, _P, _I, _P],
    "sf_newton_launch": [_I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _D, _P],
    "vst_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I],
    "trimmed_var_launch": [_I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dnb_nll_launch": [_I, _I, _I, _I, _P, _P, _P, _I, _D, _P],
    "psi_f64_launch": [_P, _I, _P, _P],
    "lgamma_table_launch": [_I, _I, _P],
    "grid_apeglm_per_sm": [_I, _I, _P],
    "grid_nb_per_sm": [_I, _I, _P],
    "select_max_clusters": [_I, _I, _I, _P],
    "select_hist_per_sm": [_I, _I, _P],
    "irls_per_sm": [_I, _I, _I, _P],
}

# What one block of a thread-block cluster may hold on the H100: dynamic
# shared memory (227 KB), and the blocks of one cluster (16, with the
# non-portable cluster size allowed); the L2 that the streamed modes keep
# their working set within (half of its 50 MB).
SMEM_BLOCK_MAX = 232_448
MAX_CLUSTER = 16
L2_BYTES = 50_000_000


def align16(nbytes: int) -> int:
    """``nbytes`` rounded up to 16, as the cluster kernels lay out shared
    memory."""
    return (nbytes + 15) // 16 * 16


# The kernels are templated on P = 1..8 (closed forms for P <= 3, unrolled
# Cholesky above), as the JAX package's small solves are.
MAX_P = 8


class KernelStats:
    """Launch counts per kernel, the IRLS rescue's lanes, the iterative size
    factors' rounds, and, while tracing is on
    (:mod:`~pydeseq2_tpu_torch.tracing`), the IRLS trip counts and the box
    rescue's passes of each launch.

    A count rises by one where a wrapper launches its kernel and nowhere
    else. ``rescue_lanes`` sums, over ``fused._irls_with_rescue`` calls, the
    unfinished lanes that the phase-2 continuation takes (``"phase2"``) and
    the lanes the grid tier takes (``"grid"``), from counts the host reads
    anyway. ``sf_rounds`` sums the rounds that
    ``ops.sizefactors.iterative_size_factors`` ran, the host's own count.
    With tracing on, ``irls_trips`` holds, per IRLS launch, a 0-d device
    tensor with the largest per-lane trip count; ``box_passes``, per
    ``newton_box`` launch, the (K,) int32 device tensor of its lanes' serial
    passes, 0 on a lane not selected (read them after a synchronise). With
    tracing off they stay empty, and the trip count is not reduced.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
        self.rescue_lanes: dict[str, int] = {"phase2": 0, "grid": 0}
        self.sf_rounds: int = 0
        self.irls_trips: list[torch.Tensor] = []
        self.box_passes: list[torch.Tensor] = []


STATS = KernelStats()

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, float]:
    """Compile every missing kernel library, all sources in parallel.

    Returns {source: seconds} for the sources compiled now (empty when all
    libraries were already built). The ``-Xptxas -v`` report of each build
    (registers, spills) is kept beside its library as ``<lib>.ptxas.txt``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted({src for src, _ in list(KERNELS.values()) + list(HELPERS.values())})
    procs = {}
    t0 = time.perf_counter()
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    took = {}
    failures = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[src] = time.perf_counter() - t0
        out.with_suffix(".ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return took


def _function(fn_name: str, source: str):
    """The bound C function, its argument types set once (a launch's host
    time is the wrappers' to spend)."""
    fn = _fns.get(fn_name)
    if fn is not None:
        return fn
    lib = _libs.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        _libs[source] = lib
    fn = getattr(lib, fn_name)
    fn.argtypes = _ARGTYPES[fn_name] + [_P]
    fn.restype = ctypes.c_int
    _fns[fn_name] = fn
    return fn


def _call(source: str, fn_name: str, args, device: torch.device) -> None:
    fn = _function(fn_name, source)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {fn_name} failed with error {rc}")


def launch(name: str, args, device: torch.device) -> None:
    """Launch kernel ``name`` on ``device``'s current stream and count it."""
    source, fn_name = KERNELS[name]
    _call(source, fn_name, args, device)
    STATS.launches[name] += 1


def call_helper(name: str, args, device: torch.device) -> None:
    """Launch an uncounted check helper (see :data:`HELPERS`)."""
    source, fn_name = HELPERS[name]
    _call(source, fn_name, args, device)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the scan's split rule)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def check_cuda_operands(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise unless every operand is a contiguous f32/f64 CUDA tensor of one
    dtype (int32/uint8 operands are checked by their wrappers)."""
    dtype = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: operand on {t.device}, expected CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand is not contiguous")
        if t.dtype in (torch.float32, torch.float64):
            if dtype is not None and t.dtype != dtype:
                raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
            dtype = t.dtype


def check_cuda_device(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every operand lies on a CUDA device (any layout: for
    kernels that take their operand's strides)."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: operand on {t.device}, expected CUDA")


def check_p(name: str, P: int) -> None:
    """Raise unless the design width is one the kernels are built for."""
    if not 1 <= P <= MAX_P:
        raise ValueError(f"{name}: design width P={P}; the CUDA kernels take 1 <= P <= {MAX_P}")


def check_p2(name: str, P: int) -> None:
    """Raise unless the design has two columns (the 2-D grid searches)."""
    if P != 2:
        raise ValueError(f"{name}: design width P={P}; the grid kernels take P == 2 only")


def check_sel(name: str, sel: torch.Tensor | None, K: int) -> torch.Tensor | None:
    """The lane selection of a rescue kernel as a contiguous (K,) bool CUDA
    tensor, whose bytes (0 or 1) the kernels read, or None (every lane)."""
    if sel is None:
        return None
    if not sel.is_cuda or sel.shape != (K,) or sel.dtype != torch.bool:
        raise ValueError(f"{name}: sel must be a ({K},) bool CUDA tensor")
    return sel.contiguous()
