"""A pool of synthetic studies drawn on the device from the seed.

The recipe is that of ``pydeseq2_tpu_torch/synthetic.py`` (``make_data``
and ``plant_outliers``), drawn with a ``torch.Generator`` on the device in a
few large calls instead of numpy on the host: per gene a lognormal base
mean, a normal natural-log fold change and a lognormal dispersion clipped
to [disp_min, disp_max]; the configuration's cohort sizes with the sample
order shuffled; NB counts as a gamma-Poisson mixture (lambda ~ Gamma(r,
mu / r), r = 1 / dispersion); and one Cook's outlier, the row's maximum
times ``outlier_scale``, at sample (g / every) mod N of every ``every``-th
gene g. Every seed gives the same sizes; the same seed gives the same
counts on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Rows drawn at a time, so the sampler's float32 temporaries stay near
# 4096 x N x 4 bytes a tensor.
_ROWS = 4096


@dataclass
class Study:
    counts: torch.Tensor  # (G, N) gene-major, in the configuration's dtype
    design: np.ndarray  # (N, 2): intercept, the condition
    contrast: np.ndarray  # (2,)


def cohort_sizes(config: dict) -> list[int]:
    """The two cohorts' sizes, the first the condition's level 1."""
    sizes = list(config["cohorts"].values())
    if len(sizes) != 2 or sum(sizes) != config["n_samples"]:
        raise ValueError(f"{config['name']}: two cohorts that add up to n_samples are expected")
    return sizes


def draw_study(gen: torch.Generator, config: dict, recipe: dict, dtype: torch.dtype, device) -> Study:
    """One study of the configuration's shape."""
    G, N = config["n_genes"], config["n_samples"]
    n1, _ = cohort_sizes(config)
    f32 = dict(dtype=torch.float32, device=device)
    base = torch.exp(recipe["base_log_mean"] + recipe["base_log_sd"] * torch.randn(G, generator=gen, **f32))
    lfc = recipe["lfc_sd"] * torch.randn(G, generator=gen, **f32)
    disp = torch.exp(recipe["disp_log_mean"] + recipe["disp_log_sd"] * torch.randn(G, generator=gen, **f32))
    disp = disp.clamp(recipe["disp_min"], recipe["disp_max"])
    cond = (torch.randperm(N, generator=gen, device=device) < n1).to(torch.float32)
    counts = torch.empty((G, N), dtype=dtype, device=device)
    r = 1.0 / disp
    for b in range(0, G, _ROWS):
        sl = slice(b, b + _ROWS)
        mu = base[sl, None] * torch.exp(cond[None, :] * lfc[sl, None])
        shape = r[sl, None].expand(mu.shape).contiguous()
        lam = torch._standard_gamma(shape, generator=gen) * (mu / r[sl, None])
        counts[sl] = torch.poisson(lam, generator=gen).to(dtype)
    every = recipe["outlier_every"]
    genes = torch.arange(0, G, every, device=device)
    samples = (genes // every) % N
    counts[genes, samples] = recipe["outlier_scale"] * counts[genes].amax(dim=1)
    design = np.column_stack([np.ones(N), cond.cpu().numpy().astype(np.float64)])
    return Study(counts, design, np.array([0.0, 1.0]))


def draw_pool(seed: int, config: dict, mix: dict, dtype: torch.dtype, device) -> list[Study]:
    """``mix["pool"]`` studies, drawn in order from one generator seeded
    with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [draw_study(gen, config, mix["recipe"], dtype, device) for _ in range(mix["pool"])]
