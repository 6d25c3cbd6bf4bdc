"""The PyTorch port stands apart from JAX and from the JAX package, and never
moves to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pydeseq2_tpu_torch as pt
from pydeseq2_tpu_torch import kernels
from pydeseq2_tpu_torch.synthetic import make_data

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pydeseq2_tpu", "reference_baseline", "benchmarks")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    return sorted((REPO / "pydeseq2_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import sys; before = set(sys.modules); import pydeseq2_tpu_torch, pydeseq2_tpu_torch.fused; "
        "import pydeseq2_tpu_torch.synthetic, pydeseq2_tpu_torch.kernels, pydeseq2_tpu_torch.fused_stream; "
        "import pydeseq2_tpu_torch.ops.shrink, pydeseq2_tpu_torch.models.stats, pydeseq2_tpu_torch.stage_profile; "
        "import pydeseq2_tpu_torch.kernel_bench; "
        "import pydeseq2_tpu_torch.ops.refit, pydeseq2_tpu_torch.ops.linreg, pydeseq2_tpu_torch.ops.trend; "
        "import pydeseq2_tpu_torch.ops.stats, pydeseq2_tpu_torch.ops.cooks; "
        "import pydeseq2_tpu_torch.ops.sizefactors, pydeseq2_tpu_torch.ops.vst; "
        "import pydeseq2_tpu_torch.utils, pydeseq2_tpu_torch.utils.plots, pydeseq2_tpu_torch.container; "
        "import pydeseq2_tpu_torch.formula, pydeseq2_tpu_torch.preprocessing, pydeseq2_tpu_torch.inference; "
        "import pydeseq2_tpu_torch.torch_inference, pydeseq2_tpu_torch.default_inference; "
        "import pydeseq2_tpu_torch.models.dataset, pydeseq2_tpu_torch.models.stats; "
        "import pydeseq2_tpu_torch.api, pydeseq2_tpu_torch.io, pydeseq2_tpu_torch.parallel.mesh; "
        f"bad = [m for m in set(sys.modules) - before if m.split('.')[0] in {FORBIDDEN!r}]; "
        "print(sorted(bad)); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path.name}:{node.lineno} imports {name}"


def test_import_needs_no_nvcc_triton_or_matplotlib():
    """Importing every module builds nothing and loads neither triton nor
    matplotlib, with no nvcc on the PATH and CUDA_HOME pointing nowhere."""
    code = (
        "import sys, pathlib; import pydeseq2_tpu_torch as pt, pydeseq2_tpu_torch.utils.plots; "
        "import pydeseq2_tpu_torch.models.dataset, pydeseq2_tpu_torch.torch_inference; "
        "bad = [m for m in ('triton', 'matplotlib', 'anndata') if m in sys.modules]; "
        "built = pt.kernels.BUILD_DIR.exists() and any(pt.kernels.BUILD_DIR.glob('*.tmp')); "
        "print(bad, built); sys.exit(1 if bad or built else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    counts, X = make_data(6, 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.wald_pipeline(counts.T, X, np.array([0.0, 1.0]), 0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.inputs_from_numpy(counts.T, X, np.array([0.0, 1.0]), 0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.summary_pipeline(counts.T, X, np.array([0.0, 1.0]), 0.0, 5.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.run_summary_streamed(counts.T, X, np.array([0.0, 1.0]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.vst_pipeline(counts.T)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.run_vst_streamed(counts.T)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.iterative_size_factors(counts.T)
    for backend in (pt.TorchInference, pt.DefaultInference):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            backend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.deseq2_norm(counts)


def test_public_surface():
    for name in ("run_deseq2", "wald_pipeline", "summary_pipeline", "summary_host_inputs", "device_padj",
                 "run_lfc_shrink_streamed", "lfc_shrink_pipeline_streamed", "inputs_from_numpy",
                 "outputs_to_numpy", "run_summary_streamed", "summary_pipeline_streamed",
                 "refit_pipeline_streamed", "vst_pipeline", "run_vst_streamed", "vst_pipeline_streamed",
                 "iterative_size_factors", "DeseqDataSet", "DeseqStats", "DeseqDataContainer", "Inference",
                 "TorchInference", "DefaultInference", "deseq2_norm", "deseq2_norm_fit", "deseq2_norm_transform"):
        assert callable(getattr(pt, name)), name
    assert issubclass(pt.DefaultInference, pt.TorchInference) and issubclass(pt.TorchInference, pt.Inference)
    counts, X = make_data(6, 20)
    kw = pt.inputs_from_numpy(counts.T, X, np.array([0.0, 1.0]), 0.0, cooks_cutoff=5.0, dtype=torch.float32,
                              device="cpu", alpha=0.1)
    assert kw["cooks_cutoff"].dtype == torch.float32 and kw["alpha"] == 0.1


def test_argtypes_match_the_c_launchers():
    """The ctypes argtypes of every exported launcher follow its C
    signature (int, long long, double or pointer, then the stream pointer):
    nvcc is not here, so this is where a mismatch shows before the card."""
    import ctypes
    import re

    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "double": ctypes.c_double}
    for name, (source, fn) in {**kernels.KERNELS, **kernels.HELPERS}.items():
        text = (kernels.CSRC / source).read_text()
        sig = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert sig, name
        params = [" ".join(p.split()[:-1]) for p in sig.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else kinds[p] for p in params]
        assert kernels._ARGTYPES[fn] + [ctypes.c_void_p] == want, name


def test_precision_pins():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernels_refuse_wide_designs_and_cpu_operands():
    with pytest.raises(ValueError):
        kernels.check_p("irls", kernels.MAX_P + 1)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.check_cuda_operands("irls", torch.zeros(3))
    with pytest.raises(ValueError, match="P == 2"):
        kernels.check_p2("grid_nb", 3)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.check_cuda_operands("impute", torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="bool CUDA tensor"):
        kernels.check_sel("newton_box", torch.ones(4, dtype=torch.bool), 4)
    assert kernels.check_sel("newton_box", None, 4) is None


def test_every_kernel_is_counted():
    """Twenty-nine kernels (the class API's trend_fit, trimmed_var and the
    hat-only and Wald-only entries of hat_wald.cu, dnb_nll and the fine
    scan's disp_scan_fine with its gene grouping disp_scan_group beside the
    pipelines' nineteen, sf_nll's lgamma table, the gene mesh's select_hist
    and its digit pick select_pick; BH as two, the rejection counts and one
    adjusted row), each with a launch count that starts at 0."""
    kernels.STATS.reset()
    assert len(kernels.KERNELS) == 29
    assert kernels.STATS.launches == dict.fromkeys(kernels.KERNELS, 0)
