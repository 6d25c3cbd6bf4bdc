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
HEADERS = ("common.cuh",)

# kernel name -> (source file, exported C function)
KERNELS = {
    "select": ("select.cu", "order_stats_select_launch"),
    "disp_scan": ("disp_scan.cu", "disp_scan_launch"),
    "disp_newton": ("disp_newton.cu", "disp_newton_launch"),
    "irls": ("irls.cu", "irls_launch"),
}

# Exported helpers that are not kernels of the pipeline (checks only);
# they are not counted.
HELPERS = {"psi_f64": ("disp_newton.cu", "psi_f64_launch")}

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

# argtypes of each exported function, without the trailing stream pointer
# (see the extern "C" launchers in csrc/*.cu).
_ARGTYPES = {
    "order_stats_select_launch": [_I, _P, _I, _I, _P, _P, _P, _P],
    "disp_scan_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _D, _I, _I,
                         _P, _P, _P, _P],
    "disp_newton_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _D, _D, _D, _D,
                           _I, _I, _I, _P, _P, _P, _P],
    "irls_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _D, _D, _D, _D,
                    _I, _I, _P, _P, _P],
    "psi_f64_launch": [_P, _I, _P, _P],
}

# The kernels are templated on P = 1..8 (closed forms for P <= 3, unrolled
# Cholesky above), as the JAX package's small solves are.
MAX_P = 8


class KernelStats:
    """Launch counts per kernel, plus the IRLS trip counts of each launch.

    A count rises by one where a wrapper launches its kernel and nowhere
    else. ``irls_trips`` holds, per IRLS launch, a 0-d device tensor with
    the largest per-lane trip count (read it after a synchronise).
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
        self.irls_trips: list[torch.Tensor] = []


STATS = KernelStats()

_libs: dict[str, ctypes.CDLL] = {}


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


def check_p(name: str, P: int) -> None:
    """Raise unless the design width is one the kernels are built for."""
    if not 1 <= P <= MAX_P:
        raise ValueError(f"{name}: design width P={P}; the CUDA kernels take 1 <= P <= {MAX_P}")
