"""``dnb_nll``'s launch plan and wrapper on the CPU: ``ops/nb.py:_dnb_plan``
on each side of its thresholds, ``_dnb_nll_cuda``'s one launch a call with
the launch recorded instead of made (alpha by value or by pointer, the
operands handed over without a copy), the alpha forms against the JAX
package through the plain version, and ``kernel_bench``'s launch floor
(the kernel itself needs a card: ``chip_smoke.py``'s ``dnb_plan_checks``)."""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydeseq2_tpu.ops import nb as j_nb
from pydeseq2_tpu_torch import kernel_bench, kernels
from pydeseq2_tpu_torch.ops import nb

torch.set_num_threads(1)  # xdist runs several workers on a few cores
jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize(
    "N, lanes",
    [(1, 4), (12, 4), (48, 4), (49, 8), (64, 8), (65, 8), (100, 8), (128, 8), (129, 8), (256, 8), (257, 32),
     (1_000, 32), (2_047, 32), (2_048, 32), (4_095, 32), (4_096, 256), (10_000, 256)],
)
def test_dnb_plan_edges(N, lanes, itemsize):
    """4 lanes a row to 48 samples, 8 to 256, 32 below 4096, then a block,
    in both types; a lane group takes at most 32 cells a lane below 257
    samples."""
    assert nb._dnb_plan(N, itemsize) == lanes
    if N <= 256:
        assert -(-N // lanes) <= 32


@pytest.fixture
def launches(monkeypatch):
    """The launches of ``dnb_nll`` recorded instead of made (CPU tensors
    stand in for the card's)."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, args, device: calls.append((name, args)))
    monkeypatch.setattr(kernels, "check_cuda_operands", lambda *a: None)
    return calls


def _args(call) -> dict:
    name, args = call
    assert name == "dnb_nll"
    want = kernels._ARGTYPES[kernels.KERNELS[name][1]]
    assert len(args) == len(want)
    for a, w in zip(args, want):
        if w is ctypes.c_void_p:
            assert a is None or (isinstance(a, int) and not isinstance(a, bool)), a
        else:
            assert isinstance(a, {ctypes.c_int: int, ctypes.c_double: float}[w]) and not isinstance(a, bool), a
    keys = ("is_f64", "R", "N", "lanes", "counts", "mu", "alpha", "alpha_step", "alpha_value", "out")
    return dict(zip(keys, args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_launch_alpha_by_value_no_copy(launches, dtype):
    """A Python float goes by value, a one-value host tensor too; a row
    vector and a one-value tensor of the card's kind by pointer (step 1 and
    0). Counts and mu of mu's dtype and layout go in as they are. Each call
    is one launch in the plan of :func:`_dnb_plan`."""
    G, N = 37, 100
    counts = torch.ones(G, N, dtype=dtype)
    mu = torch.ones(G, N, dtype=dtype)
    alpha = torch.full((G,), 0.25, dtype=dtype)
    cases = [(0.3, None, 0, 0.3), (np.float32(0.5), None, 0, 0.5),
             (torch.tensor(0.7, dtype=torch.float64), None, 0, 0.7), (alpha, alpha.data_ptr(), 1, 0.0)]
    for a, ptr, step, value in cases:
        out = nb._dnb_nll_cuda(counts, mu, a)
        assert len(launches) == 1
        got = _args(launches.pop())
        assert got["is_f64"] == int(dtype == torch.float64) and (got["R"], got["N"]) == (G, N)
        assert got["lanes"] == nb._dnb_plan(N, counts.element_size()) == 8
        assert (got["counts"], got["mu"]) == (counts.data_ptr(), mu.data_ptr())
        assert (got["alpha"], got["alpha_step"], got["alpha_value"]) == (ptr, step, value)
        assert got["out"] == out.data_ptr() and out.shape == (G,) and out.dtype == dtype
    # lanes override
    nb._dnb_nll_cuda(counts, mu, alpha, lanes=256)
    assert _args(launches.pop())["lanes"] == 256


def test_alpha_on_the_card_one_value_by_pointer(launches, monkeypatch):
    """A one-value alpha that lies on the card is read there by every row
    (step 0), with no copy and no host read."""
    G, N = 5, 12
    counts = torch.ones(G, N)
    alpha = torch.tensor([0.4])
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.Tensor, "item", lambda self: pytest.fail("a host read of alpha"))
    monkeypatch.setattr(torch.Tensor, "__float__", lambda self: pytest.fail("a host read of alpha"))
    out = nb._dnb_nll_cuda(counts, counts, alpha)
    got = _args(launches.pop())
    assert (got["alpha"], got["alpha_step"], got["alpha_value"]) == (alpha.data_ptr(), 0, 0.0)
    assert (got["R"], got["N"], got["lanes"]) == (G, N, 4) and out.shape == (G,)


def test_broadcast_and_conversions(launches):
    """One row of counts and mu with a float gives one row and a 0-d
    result; integer counts are converted (a copy), mu's rows are not; a
    leading alpha shape broadcasts the rows."""
    N = 30
    counts = torch.arange(N, dtype=torch.int64)
    mu = torch.ones(N, dtype=torch.float64)
    out = nb._dnb_nll_cuda(counts, mu, 0.2)
    got = _args(launches.pop())
    assert out.shape == () and (got["R"], got["N"], got["lanes"]) == (1, N, 4)
    assert got["counts"] != counts.data_ptr() and got["mu"] == mu.data_ptr()
    alpha = torch.full((3, 4), 0.5, dtype=torch.float64)
    out = nb._dnb_nll_cuda(mu, mu, alpha)
    got = _args(launches.pop())
    assert out.shape == (3, 4) and got["R"] == 12 and got["alpha"] == alpha.data_ptr() and got["alpha_step"] == 1


def test_wrapper_raises_on_what_the_kernel_does_not_take(launches):
    x = torch.ones(4, 10)
    with pytest.raises(ValueError, match="lanes a row"):
        nb._dnb_nll_cuda(x, x, 0.1, lanes=16)
    with pytest.raises(TypeError, match="float32 or float64"):
        nb._dnb_nll_cuda(x.half(), x.half(), 0.1)
    assert launches == []


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_alpha_forms_match_jax(name):
    """A float, a 0-d tensor and a row vector of one value give the same
    bits through the port's plain version, and JAX's value with that
    scalar alpha over every row (f64 rtol 1e-10, the two psi evaluations
    accurate to ~1e-15; f32 held to the summed magnitudes at 1e-6, as
    ``test_dnb_nll_matches_jax`` states)."""
    dt, jt = {"f64": (np.float64, jnp.float64), "f32": (np.float32, jnp.float32)}[name]
    rng = np.random.default_rng(3)
    G, N, a = 12, 20, 0.35
    mu = rng.lognormal(2.0, 1.0, (G, N))
    counts = rng.negative_binomial(1 / a, 1 / (1 + a * mu)).astype(float)
    c_t, m_t = torch.as_tensor(counts.astype(dt)), torch.as_tensor(mu.astype(dt))
    got = nb.dnb_nll(c_t, m_t, a)
    for other in (torch.tensor(a, dtype=m_t.dtype), torch.full((G,), a, dtype=m_t.dtype)):
        assert torch.equal(nb.dnb_nll(c_t, m_t, other), got)
    want = np.asarray(j_nb.dnb_nll(jnp.asarray(counts, jt), jnp.asarray(mu, jt), jt(a)))
    assert want.shape == got.shape == (G,)
    if name == "f64":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
        return
    r = 1.0 / a
    from scipy.special import digamma

    scale = (abs(digamma(r)) + np.abs(digamma(counts + r)) + np.abs(np.log1p(mu * a))
             + np.abs((counts - mu) / (mu + r))).sum(-1) / a**2
    assert np.max(np.abs(got.numpy() - want) / scale) <= 1e-6


def test_launch_floor_row_on_cpu(monkeypatch):
    """``kernel_bench.lgamma_row`` carries the launch floor (``fill_`` of
    one element) beside the table and ``torch.lgamma``."""
    from pydeseq2_tpu_torch.ops import sizefactors as sz

    monkeypatch.setattr(kernel_bench, "DEVICE", "cpu")
    monkeypatch.setattr(sz, "_lgamma_table_cuda", sz._lgamma_table_plain)
    monkeypatch.setattr(kernel_bench, "cuda_ms", lambda fn, reps: (fn(), 1.0)[1])
    names = []

    def device_ms(fn, reps, name):
        fn()
        names.append(name)
        return 0.5, 2.0

    monkeypatch.setattr(kernel_bench, "device_ms", device_ms)
    row = kernel_bench.lgamma_row(torch.float32)
    assert row["launch_floor_ms"] == 2.0 and row["max_abs_diff"] == 0.0
    assert names == ["lgamma_table", "lgamma", ""]
