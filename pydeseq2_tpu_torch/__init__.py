"""pydeseq2_tpu_torch — the one-call ``run_deseq2`` entry point, the DESeq2
Wald and summary pipelines, the
gene-streamed summary with Cook's outlier replacement and refit (and the
iterative size factors of zero-inflated counts), apeGLM LFC shrinkage, the
blind variance-stabilising transform and the ``DeseqDataSet`` /
``DeseqStats`` class API over a device-resident ``TorchInference`` with
its save/load (:mod:`pydeseq2_tpu_torch.io`), in PyTorch, with CUDA
kernels.

A port of the JAX package ``pydeseq2_tpu`` (which stays the reference) to
PyTorch on an NVIDIA Hopper card. Plain tensor code is PyTorch; the
per-gene device programs (size-factor order statistics, the MoM
dispersions with the OLS mu init, the dispersion coarse scan, the
dispersion Newton polish, the dispersion trend, IRLS and its two rescue
tiers, hat diagonals + Wald, Cook's distances, the batched BH sweep and
the lowess pick of independent filtering, the Cook's refit imputation, the
apeGLM Newton fit and grid, the trimmed size-factor NLL and Newton steps,
the VST transform, and for the class API the standalone trend fit, the
trimmed (cell) variances and the hat-only and Wald-only halves of hat +
Wald) are twenty-two CUDA kernels written by hand for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use (see
:mod:`pydeseq2_tpu_torch.kernels`).

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
from pydeseq2_tpu_torch.fused import device_padj, summary_host_inputs  # noqa: E402
from pydeseq2_tpu_torch.fused_stream import (  # noqa: E402
    lfc_shrink_pipeline_streamed,
    refit_pipeline_streamed,
    run_lfc_shrink_streamed,
    run_summary_streamed,
    run_vst_streamed,
    summary_pipeline,
    summary_pipeline_streamed,
    vst_pipeline,
    vst_pipeline_streamed,
    wald_pipeline,
)
from pydeseq2_tpu_torch.ops.sizefactors import iterative_size_factors  # noqa: E402
from pydeseq2_tpu_torch.container import DeseqDataContainer  # noqa: E402
from pydeseq2_tpu_torch.inference import Inference  # noqa: E402
from pydeseq2_tpu_torch.torch_inference import TorchInference  # noqa: E402
from pydeseq2_tpu_torch.default_inference import DefaultInference  # noqa: E402
from pydeseq2_tpu_torch.models.dataset import DeseqDataSet  # noqa: E402
from pydeseq2_tpu_torch.models.stats import DeseqStats  # noqa: E402
from pydeseq2_tpu_torch.preprocessing import (  # noqa: E402
    deseq2_norm,
    deseq2_norm_fit,
    deseq2_norm_transform,
)
from pydeseq2_tpu_torch.api import run_deseq2  # noqa: E402
from pydeseq2_tpu_torch import io  # noqa: E402,F401

__version__ = "0.1.0"

__all__ = [
    "run_deseq2",
    "wald_pipeline",
    "summary_pipeline",
    "summary_host_inputs",
    "device_padj",
    "run_summary_streamed",
    "summary_pipeline_streamed",
    "refit_pipeline_streamed",
    "run_lfc_shrink_streamed",
    "lfc_shrink_pipeline_streamed",
    "vst_pipeline",
    "run_vst_streamed",
    "vst_pipeline_streamed",
    "iterative_size_factors",
    "DeseqDataSet",
    "DeseqStats",
    "DeseqDataContainer",
    "Inference",
    "TorchInference",
    "DefaultInference",
    "deseq2_norm",
    "deseq2_norm_fit",
    "deseq2_norm_transform",
    "inputs_from_numpy",
    "outputs_to_numpy",
    "resolve_device",
    "__version__",
]
