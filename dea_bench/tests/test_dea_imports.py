"""What the harness and the reference load: never JAX nor the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and for the reference nothing of the port either."""

from __future__ import annotations

import json
import subprocess
import sys
import types

from dea_bench.cell import HERE
from dea_bench.run import forbidden_modules

ROOT = HERE.parent

_HARNESS = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from dea_bench.cell import load_cell
from dea_bench.run import run_cell
cell = load_cell("tiny.cell", Path({bench!r}), base=Path({base!r}))
for trace in (False, True):
    out = run_cell(cell, 3, 0.3, trace, device="cpu", log=lambda *a, **k: None)
    assert out["correct"], out
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = r"""
import json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from dea_bench.draw import draw_pool
from dea_bench.reference.deseq2 import refit_summary
from dea_bench.tests.conftest import TINY_CONFIG, TINY_MIX
s = draw_pool(1, TINY_CONFIG, TINY_MIX, torch.float64, "cpu")[0]
res = refit_summary(s.counts, s.design, s.contrast, max_disp=24.0)
assert np.isfinite(res["padj"]).any()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax(tiny_tree):
    bench, base = tiny_tree
    names = _loaded(_HARNESS.format(root=str(ROOT), bench=str(bench), base=str(base)))
    assert "pydeseq2_tpu_torch" in names and "dea_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "pydeseq2_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _loaded(_REFERENCE.format(root=str(ROOT)))
    assert "dea_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "pydeseq2_tpu", "pydeseq2_tpu_torch"}


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pydeseq2_tpu_torch_like", types.ModuleType("pydeseq2_tpu_torch_like"))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "pydeseq2_tpu", raising=False)
    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert forbidden_modules() == sorted(set(before) | {"jax"})
