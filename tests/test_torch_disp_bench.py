"""``pydeseq2_tpu_torch.disp_bench`` on the CPU: its report of registers and
spills, and one tree's run at small shapes with the plain versions standing
in for the kernels (the kernels themselves need a card)."""

import time

import pytest
import torch

from pydeseq2_tpu_torch import disp_bench, kernels

torch.set_num_threads(1)  # xdist runs several workers on a few cores

PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116disp_scan_kernelILi2EdEEviiPKT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116disp_scan_kernelILi2EdEEviiPKT0_
    72 bytes stack frame, 132 bytes spill stores, 160 bytes spill loads
ptxas info    : Used 64 registers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116disp_scan_kernelILi1EfEEviiPKT0_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116disp_scan_kernelILi1EfEEviiPKT0_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 560 bytes cmem[0]
ptxas info    : Compiling entry function 'psi_f64_launch_helper' for 'sm_90a'
ptxas info    : Used 30 registers, 380 bytes cmem[0]
"""


def test_ptxas_rows_per_instantiation(tmp_path, monkeypatch):
    """Registers and spill bytes by template P and type; entries that are
    not an instantiation of a P template are left out."""
    monkeypatch.setattr(kernels, "_lib_path", lambda src: tmp_path / (src + ".so"))
    for src in disp_bench.SOURCES:
        (tmp_path / (src + ".ptxas.txt")).write_text(PTXAS)
    got = disp_bench.ptxas(kernels)
    assert got == {src: {"P2 f64": [64, 132, 160], "P1 f32": [40, 0, 0]} for src in disp_bench.SOURCES}


@pytest.mark.parametrize("detail", [False, True])
def test_child_on_cpu(monkeypatch, detail):
    """One tree's run: every shape has its times, and on the CPU (where the
    wrappers run the plain versions) no difference from them; ``--detail``
    adds the one-segment scan on long rows and the Newton divergence
    readings."""
    monkeypatch.setattr(disp_bench, "DEVICE", "cpu")
    monkeypatch.setattr(disp_bench, "SHAPES", (
        ("f32 P=3", 64, 24, 3, torch.float32, 1),
        ("f64 long P=1", 8, 1100, 1, torch.float64, 1),
    ))
    monkeypatch.setattr(kernels, "build", lambda: {})
    monkeypatch.setattr(disp_bench, "ptxas", lambda k: {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(disp_bench, "cuda_ms", host_ms)
    monkeypatch.setattr(disp_bench, "device_ms", lambda fn, reps, name: (host_ms(fn, reps),) * 2)
    res = disp_bench.child(detail)
    assert set(res["shapes"]) == {"f32 P=3", "f64 long P=1"}
    for label, row in res["shapes"].items():
        assert row["disp_scan_ms"] > 0 and row["disp_newton_ms"] > 0
        for key in ("scan_la_err", "scan_f_err", "newton_la_err", "newton_f_err"):
            assert row[key] == 0.0, (label, key)
        assert ("disp_newton_branch_sorted_ms" in row) == detail
        assert ("disp_scan_one_segment_ms" in row) == (detail and label.startswith("f64 long"))
        if detail:
            assert 0.0 <= row["mixed_warps_wrapper_order"] <= 1.0
