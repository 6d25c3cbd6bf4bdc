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
        "import pydeseq2_tpu_torch.synthetic, pydeseq2_tpu_torch.kernels; "
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


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device is valid")
    counts, X = make_data(6, 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.wald_pipeline(counts.T, X, np.array([0.0, 1.0]), 0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.inputs_from_numpy(counts.T, X, np.array([0.0, 1.0]), 0.0)


def test_precision_pins():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernels_refuse_wide_designs_and_cpu_operands():
    with pytest.raises(ValueError):
        kernels.check_p("irls", kernels.MAX_P + 1)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.check_cuda_operands("irls", torch.zeros(3))
