"""pydeseq2_tpu_torch — the DESeq2 Wald pipeline in PyTorch, with CUDA kernels.

A port of the JAX package ``pydeseq2_tpu`` (which stays the reference) to
PyTorch on an NVIDIA Hopper card. Plain tensor code is PyTorch; the four
per-gene device programs of the main path (size-factor order statistics,
the dispersion coarse scan, the dispersion Newton polish and IRLS) are CUDA
kernels written by hand for ``sm_90a`` under ``csrc/``, built with ``nvcc``
at first use (see :mod:`pydeseq2_tpu_torch.kernels`).

Device rule: entry points take ``device`` (default ``"cuda"``) and raise if
CUDA is requested and absent; they never carry on on the CPU by themselves.
On a CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the kernel or raises.

This package imports neither ``jax`` nor anything of ``pydeseq2_tpu``.
"""

import torch

# Full-precision float32 products everywhere. Counterpart of the JAX
# package's ``jax_default_matmul_precision="highest"`` pin: reduced-precision
# dots (TF32 keeps ~3 decimal digits) sit above the IRLS and dispersion
# stopping tolerances — on the TPU the bf16 equivalent left ~37% of IRLS
# lanes unconverged.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from pydeseq2_tpu_torch.convert import (  # noqa: E402
    inputs_from_numpy,
    outputs_to_numpy,
    resolve_device,
)
from pydeseq2_tpu_torch.fused import wald_pipeline  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "wald_pipeline",
    "inputs_from_numpy",
    "outputs_to_numpy",
    "resolve_device",
    "__version__",
]
