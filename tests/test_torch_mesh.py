"""The port's gene mesh (``pydeseq2_tpu_torch.parallel.mesh``) on the CPU.

Gloo ranks are separate processes that run this file as their script (as
``tests/test_multihost.py`` runs ``multihost_worker.py``): each joins a
group on a ``file://`` store in ``tmp_path`` through ``init_distributed``
(timeout 60 s), builds ``make_gene_mesh()``, runs every case on its shard
and pickles what it got. Two module fixtures launch the ranks once, two and
four of them, under a subprocess timeout, so a hang fails instead of
stalling the suite. The tests then hold the ranks' results to the unsharded
port (the sharded size-factor median bit for bit; ``run_deseq2`` at rtol
1e-12 with the same refitted genes) and to the JAX package's
``run_deseq2(mesh=make_gene_mesh(8))`` at rtol 1e-6. JAX is imported only
by the tests, never by the ranks.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import warnings
from datetime import timedelta
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

torch.set_num_threads(1)  # xdist runs several workers on a few cores

REPO = Path(__file__).resolve().parent.parent
CONTRAST = ["condition", "B", "A"]
COLUMNS = ["baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue", "padj"]
RANK_TIMEOUT_S = 150  # a rank group that does not finish in time fails its fixture

# (dtype, mask kind, G) of the sharded median cases; G = 1003 splits
# unevenly (padded with excluded rows), "ties" draws from five values, and
# column 3 of every case has no valid gene (NaN).
MEDIAN_CASES = [(torch.float32, "ratio", 1003), (torch.float64, "ratio", 1003), (torch.float32, "poscounts", 512),
                (torch.float64, "poscounts", 1000), (torch.float32, "ties", 96), (torch.float64, "ties", 97)]
OVERFLOW_G, OVERFLOW_BAD = 1100, 600  # 600 of 1100 lanes diverge: more than the rescue's K = 512
# The single pipeline's IRLS tile where the pad lanes would move K: 38399
# genes pad to 38400 on 2 and 4 ranks, K = 38399 // 64 = 599 (not 600), and
# 700 lanes diverge.
QUOTA_G, QUOTA_BAD = 38_399, 700


# ---------------------------------------------------------------- shared data
def example_data():
    from pydeseq2_tpu_torch.utils import load_example_data

    counts = load_example_data("raw_counts").copy()
    counts.iloc[0, 0] = 1_000_000  # tests/test_api.py:154, an outlier that the refit replaces
    return counts, load_example_data("metadata")


def median_tile(dtype, kind: str, G: int, N: int = 7, seed: int = 3):
    """(values (G, N) with +inf at excluded entries, valid counts (N,)) as the
    size factors' medians see them."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.choice(np.array([-1.5, -0.25, 0.0, 0.25, 2.0]), size=(G, N))
        valid = rng.random((G, N)) > 0.2
    else:
        x = rng.normal(0.0, 1.0, size=(G, N))
        valid = rng.random(G)[:, None] > 0.3 if kind == "ratio" else rng.random((G, N)) > 0.4
        valid = np.broadcast_to(valid, (G, N)).copy()
    valid[:, 3] = False
    x = np.where(valid, x, np.inf)
    return torch.tensor(x, dtype=dtype), torch.tensor(valid.sum(axis=0))


def inference_data(G=64, N=20, seed=0):
    """``tests/test_sharding.py:28``: (counts (N, G), sf, X, disp)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), rng.integers(0, 2, N)]).astype(float)
    sf = np.exp(rng.normal(0, 0.1, N))
    mu = sf[:, None] * np.exp(rng.normal(2, 1, G))[None, :]
    disp = np.abs(rng.normal(0.1, 0.05, G)) + 0.01
    counts = rng.negative_binomial(1 / disp, 1 / (1 + disp * mu)).astype(float)
    return counts, sf, X, disp


def streamed_args():
    """``tests/test_sharding.py:193``: G = 64, N = 16, gene_block = 8, gene 0
    all zero; (counts (G, N), X, host inputs, keyword arguments)."""
    from pydeseq2_tpu_torch.fused import summary_host_inputs

    counts, _, X, _ = inference_data(G=64, N=16, seed=4)
    counts_gm = np.ascontiguousarray(counts.T)
    counts_gm[0, :] = 0
    host = summary_host_inputs(X)
    kw = dict(gene_block=8, cohort_ids=host["cohort_ids"], use_for_max=host["use_for_max"], mu_init=host["mu_init"],
              max_disp=float(max(10, X.shape[0])))
    return counts_gm, X, host, kw


def one_rank_outlier_data():
    """Two 8-sample cohorts, 40 genes, one Cook's outlier planted in gene 37
    (on the last rank's shard whatever the ranks)."""
    from pydeseq2_tpu_torch.synthetic import make_data

    counts, _ = make_data(16, 40, seed=5)
    counts_gm = np.ascontiguousarray(counts.T)
    counts_gm[37, 2] = 50 * counts_gm[37].max() + 1000
    X = np.column_stack([np.ones(16), np.repeat([0.0, 1.0], 8)])
    return counts_gm, X


def overflow_data(N=8, seed=6):
    """A tile where OVERFLOW_BAD lanes have 1e15 times the counts in the
    second condition, so IRLS diverges on them: (counts, sf, X, disp)."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), np.repeat([0.0, 1.0], N // 2)])
    counts = rng.poisson(rng.lognormal(2.0, 1.0, (OVERFLOW_G, 1)), (OVERFLOW_G, N)).astype(float) + 1.0
    counts[:OVERFLOW_BAD, N // 2:] *= 1e15  # a log fold change past the IRLS box of 30
    perm = rng.permutation(OVERFLOW_G)  # the diverging lanes spread over the shards
    counts = counts[perm]
    sf = np.ones(N)
    disp = np.full(OVERFLOW_G, 0.1)
    return counts, sf, X, disp


def quota_data(N=8, seed=6):
    """(counts (QUOTA_G, N), X): QUOTA_BAD genes with 1e15 times the counts
    in the second condition, spread over the gene axis, so the IRLS of both
    the mu init and the LFC overflows its rescue tile."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(N), np.repeat([0.0, 1.0], N // 2)])
    counts = rng.poisson(rng.lognormal(2.0, 1.0, (QUOTA_G, 1)), (QUOTA_G, N)).astype(float) + 1.0
    counts[:QUOTA_BAD, N // 2:] *= 1e15
    return counts[rng.permutation(QUOTA_G)], X


def multihost_data():
    """``tests/test_multihost.py``: G = 16, N = 12, gene 0 all zero."""
    rng = np.random.default_rng(0)
    G, N = 16, 12
    mu = rng.lognormal(3.0, 1.0, size=(G, 1))
    counts = rng.negative_binomial(5, 1 / (1 + 0.2 * mu), size=(G, N)).astype(float)
    counts[0, :] = 0
    design = np.column_stack([np.ones(N), rng.integers(0, 2, N)]).astype(float)
    return counts, design, np.array([0.0, 1.0])


def f64(*arrays):
    return [torch.tensor(a, dtype=torch.float64) for a in arrays]


def overflow_inputs(counts, sf, X, disp, rows=slice(None)):
    from pydeseq2_tpu_torch.ops.irls import irls_beta_init

    c = torch.tensor(counts[rows])
    sf_t, X_t = torch.tensor(sf), torch.tensor(X)
    return c, sf_t, X_t, torch.tensor(disp[rows]), irls_beta_init(c, sf_t, X_t)


# ------------------------------------------------------------- a rank's cases
def _case_median(mesh):
    from pydeseq2_tpu_torch.ops.select import sharded_masked_median
    from pydeseq2_tpu_torch.parallel.mesh import pad_to_multiple, shard_gene_major

    out = []
    for dtype, kind, G in MEDIAN_CASES:
        x, n_valid = median_tile(dtype, kind, G)
        padded, _ = pad_to_multiple(x.numpy(), mesh.size(), fill=np.inf)
        out.append(sharded_masked_median(shard_gene_major(padded, mesh), n_valid, mesh).numpy())
    return out


def _case_inference(mesh):
    from pydeseq2_tpu_torch import TorchInference

    plain, sharded = TorchInference(device="cpu"), TorchInference(mesh=mesh)
    counts, sf, X, disp = inference_data()
    irls = [t.numpy() for t in sharded.irls(counts, sf, X, disp, min_mu=0.5, beta_tol=1e-8)]
    counts, sf, X, disp = inference_data(seed=1)
    mu = plain.lin_reg_mu(counts, sf, X, min_mu=0.5)
    alpha = [t.numpy() for t in sharded.alpha_mle(counts, X, mu, disp, 1e-8, 20.0)]
    return {"irls": irls, "alpha_mle": alpha}


def _case_streamed(mesh):
    from pydeseq2_tpu_torch.fused_stream import summary_pipeline_streamed
    from pydeseq2_tpu_torch.parallel.mesh import gather_gene_dict, shard_gene_major

    counts_gm, X, host, kw = streamed_args()
    out = summary_pipeline_streamed(shard_gene_major(counts_gm, mesh), *f64(X, [0.0, 1.0], 0.0, host["cooks_cutoff"]),
                                    mesh=mesh, **kw)
    keys = ("padj", "p_values", "dispersions", "lfc", "base_mean")
    whole = gather_gene_dict({k: out[k] for k in keys}, mesh)
    return {**{k: v.numpy() for k, v in whole.items()}, "size_factors": out["size_factors"].numpy()}


def _case_api(mesh):
    import pydeseq2_tpu_torch as pt

    counts, metadata = example_data()
    out = {}
    for refit in (True, False):
        res, state = pt.run_deseq2(counts, metadata, contrast=CONTRAST, refit_cooks=refit, return_state=True,
                                   mesh=mesh)
        out[refit] = (res, {k: np.asarray(state[k]) for k in ("refitted", "size_factors") if k in state})
    return out


def _case_one_rank_outlier(mesh):
    import pydeseq2_tpu_torch as pt

    counts_gm, X = one_rank_outlier_data()
    res = pt.run_summary_streamed(counts_gm, X, [0.0, 1.0], dtype=np.float64, refit_cooks=True, max_disp=16.0,
                                  mesh=mesh)
    return {k: res[k] for k in ("replaced", "refitted", "p_values", "padj", "lfc", "dispersions")}


def _case_overflow(mesh):
    from pydeseq2_tpu_torch.fused import _irls_with_rescue
    from pydeseq2_tpu_torch.parallel.mesh import LaneGroup, gather_genes

    R, r = mesh.size(), mesh.get_local_rank()
    S = OVERFLOW_G // R  # OVERFLOW_G is a multiple of 2 and 4
    c, sf, X, d, b0 = overflow_inputs(*overflow_data(), rows=slice(r * S, (r + 1) * S))
    beta, conv, over = _irls_with_rescue(c, sf, X, d, b0, 0.5, 1e-8, group=LaneGroup(mesh, 0, R, OVERFLOW_G))
    whole = gather_genes(torch.cat([beta, conv[:, None].double()], dim=1), mesh)
    total = gather_genes(over.reshape(1), mesh).sum()
    return {"beta": whole[:, :2].numpy(), "converged": whole[:, 2].numpy() > 0, "overflow": int(total)}


def _case_quota(mesh):
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.parallel.mesh import gather_gene_dict, shard_gene_major

    counts, X = quota_data()  # padded as run_deseq2 pads the single pipeline: ones, kept out by the mask
    out = pt.wald_pipeline(shard_gene_major(counts, mesh, fill=1), X, [0.0, 1.0], 0.0,
                           shard_gene_major(np.ones(QUOTA_G, dtype=bool), mesh, fill=False), mu_init="irls",
                           mesh=mesh)
    keys = ("lfc", "p_values", "irls_converged")
    whole = gather_gene_dict({k: out[k] for k in keys}, mesh, n=QUOTA_G)
    return {**{k: v.numpy() for k, v in whole.items()}, "rescue_overflow": int(out["rescue_overflow"])}


def _case_multihost(mesh):
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.parallel.mesh import gather_gene_dict, shard_gene_major

    counts, design, contrast = multihost_data()
    out = pt.wald_pipeline(shard_gene_major(counts, mesh), design, contrast, 0.0, max_disp=float(max(10, 12)),
                           mesh=mesh)
    whole = gather_gene_dict({"lfc": out["lfc"], "p_values": out["p_values"]}, mesh)
    return {**{k: v.numpy() for k, v in whole.items()}, "size_factors": out["size_factors"].numpy()}


def class_api_results(inference):
    """``DeseqDataSet.deseq2()`` then ``DeseqStats.summary()`` on the
    example data with its outlier, through ``inference``."""
    import pydeseq2_tpu_torch as pt

    counts, metadata = example_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # this draw's trend falls back to the mean
        dds = pt.DeseqDataSet(counts=counts, metadata=metadata, design="~condition", quiet=True,
                              inference=inference)
        dds.deseq2()
        ds = pt.DeseqStats(dds, contrast=CONTRAST, quiet=True, inference=inference)
        ds.summary()
    return ds.results_df, dds.var["refitted"].to_numpy()


def _case_class_api(mesh):
    from pydeseq2_tpu_torch import TorchInference

    return class_api_results(TorchInference(mesh=mesh))


CASES = {"median": _case_median, "inference": _case_inference, "streamed": _case_streamed, "api": _case_api,
         "one_rank_outlier": _case_one_rank_outlier, "overflow": _case_overflow, "quota": _case_quota,
         "multihost": _case_multihost, "class_api": _case_class_api}


def _rank_main(rank: int, world: int, store: str, out_dir: str, cases: str) -> None:
    import torch.distributed as dist

    from pydeseq2_tpu_torch.parallel.mesh import init_distributed, make_gene_mesh

    torch.set_num_threads(1)
    init_distributed(device="cpu", init_method=f"file://{store}", rank=rank, world_size=world,
                     timeout=timedelta(seconds=60))
    mesh = make_gene_mesh()
    assert mesh.size() == world and mesh.mesh_dim_names == ("genes",)
    results = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for case in cases.split(","):
            results[case] = CASES[case](mesh)
    dist.barrier()
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


def run_ranks(tmp: Path, world: int, cases: tuple[str, ...]) -> list[dict]:
    """Launch ``world`` gloo ranks of this file on ``cases``; every rank's
    results, in rank order."""
    store = tmp / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(store), str(tmp), ",".join(cases)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n" + (logs[r] if r < len(logs) else "")
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh2"), 2, tuple(CASES))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("mesh4"), 4, ("median", "streamed", "api", "one_rank_outlier",
                                                          "overflow", "quota"))


@pytest.fixture(params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


# ---------------------------------------------------------------- references
@pytest.fixture(scope="module")
def api_plain():
    import pydeseq2_tpu_torch as pt

    counts, metadata = example_data()
    out = {}
    for refit in (True, False):
        res, state = pt.run_deseq2(counts, metadata, contrast=CONTRAST, refit_cooks=refit, return_state=True,
                                   device="cpu")
        out[refit] = (res, {k: np.asarray(state[k]) for k in ("refitted", "size_factors") if k in state})
    return out


@pytest.fixture(scope="module")
def api_jax_mesh():
    import pydeseq2_tpu as jp
    from pydeseq2_tpu.parallel.mesh import make_gene_mesh

    counts, metadata = example_data()
    mesh = make_gene_mesh(8)
    out = {}
    for refit in (True, False):
        res, state = jp.run_deseq2(counts, metadata, contrast=CONTRAST, refit_cooks=refit, return_state=True,
                                   mesh=mesh)
        out[refit] = (res, {k: np.asarray(state[k]) for k in ("refitted",) if k in state})
    return out


def assert_frames_close(got: pd.DataFrame, want: pd.DataFrame, rtol: float):
    assert list(got.columns) == COLUMNS and got.index.equals(want.index)
    for c in COLUMNS:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0.0, equal_nan=True, err_msg=c)


# --------------------------------------------------------------------- tests
def test_pad_to_multiple_matches_jax():
    from pydeseq2_tpu.parallel.mesh import pad_to_multiple as jax_pad

    from pydeseq2_tpu_torch.parallel.mesh import pad_to_multiple

    rng = np.random.default_rng(0)
    for shape, multiple, fill in (((10, 3), 4, 0), ((12, 3), 4, 1), ((7,), 8, np.inf), ((1, 2, 2), 3, -1)):
        a = rng.normal(size=shape)
        (got, g1), (want, g2) = pad_to_multiple(a, multiple, fill), jax_pad(a, multiple, fill)
        assert g1 == g2 and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_mesh_needs_a_process_group_and_a_device_mesh():
    import pydeseq2_tpu_torch as pt
    from pydeseq2_tpu_torch.parallel.mesh import gene_sharding, init_distributed, make_gene_mesh, replicated

    with pytest.raises(RuntimeError, match="init_distributed"):
        make_gene_mesh()
    if not torch.cuda.is_available():  # the card is the default: no silent move to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_distributed(init_method="file:///nonexistent/store", rank=0, world_size=1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.TorchInference(device="cpu", mesh=object())
    assert type(gene_sharding(None)[0]).__name__ == "Shard" and type(replicated(None)[0]).__name__ == "Replicate"


def test_mesh_layout_keeps_each_block_one_tile():
    from pydeseq2_tpu_torch.fused_stream import _mesh_layout

    assert _mesh_layout(60_000, 60_000, 1) == (60_000, 1, 60_000)
    assert _mesh_layout(60_000, 60_000, 2) == (30_000, 2, 30_000)
    assert _mesh_layout(60_000, 30_000, 4) == (15_000, 2, 15_000)  # two blocks, each over two ranks
    assert _mesh_layout(90_000, 30_000, 2) == (30_000, 1, 60_000)  # three blocks: a padding block on rank 1
    assert _mesh_layout(10, 16, 4) == (4, 4, 4)
    assert _mesh_layout(90, 30, 4) == (30, 1, 30)  # three blocks on four ranks: one padding block
    assert _mesh_layout(100, 20, 3) == (20, 1, 40)
    # A block is split only where the split divides it: it never grows, so
    # its rescue's K stays the unsharded block's.
    assert _mesh_layout(20, 20, 3) == (20, 1, 20)
    assert _mesh_layout(30, 30, 4) == (15, 2, 15)
    assert _mesh_layout(50, 25, 4) == (25, 1, 25)


@pytest.mark.parametrize("case", range(len(MEDIAN_CASES)),
                         ids=[f"{str(d)[6:]}-{k}-{g}" for d, k, g in MEDIAN_CASES])
def test_sharded_median_is_the_whole_tile_select(ranks, case):
    from pydeseq2_tpu_torch.ops.select import masked_median_select

    dtype, kind, G = MEDIAN_CASES[case]
    x, n_valid = median_tile(dtype, kind, G)
    want = masked_median_select(x, n_valid, axis=0).numpy()
    assert np.isnan(want[3])
    for got in ranks:
        np.testing.assert_array_equal(got["median"][case].view(f"u{x.element_size()}"),
                                      want.view(f"u{x.element_size()}"))


def test_sharded_median_one_rank_is_select():
    from pydeseq2_tpu_torch.ops.select import masked_median_select, select_hist_plain, sharded_masked_median

    for dtype, kind, G in MEDIAN_CASES:
        x, n_valid = median_tile(dtype, kind, G)
        want = masked_median_select(x, n_valid, axis=0).numpy()
        got = sharded_masked_median(x, n_valid).numpy()
        np.testing.assert_array_equal(got.view(f"u{x.element_size()}"), want.view(f"u{x.element_size()}"))
    x, _ = median_tile(torch.float64, "ratio", 200)
    h = select_hist_plain(x, torch.zeros((7, 2, 8), dtype=torch.uint8), 0)
    assert h.dtype == torch.int32 and h.shape == (7, 2, 256) and int(h[0, 0].sum()) == 200


@pytest.mark.parametrize("method", ["irls", "alpha_mle"])
def test_inference_mesh_matches_unsharded(ranks2, method):
    """``tests/test_sharding.py:38-58``: two ranks equal one at rtol 1e-10."""
    from pydeseq2_tpu_torch import TorchInference

    plain = TorchInference(device="cpu")
    if method == "irls":
        counts, sf, X, disp = inference_data()
        want = [t.numpy() for t in plain.irls(counts, sf, X, disp, min_mu=0.5, beta_tol=1e-8)]
    else:
        counts, sf, X, disp = inference_data(seed=1)
        mu = plain.lin_reg_mu(counts, sf, X, min_mu=0.5)
        want = [t.numpy() for t in plain.alpha_mle(counts, X, mu, disp, 1e-8, 20.0)]
    for rank in ranks2:
        for g, w in zip(rank["inference"][method], want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-10)


def test_streamed_pipeline_mesh_matches_unsharded(ranks):
    """``tests/test_sharding.py:193-243``: the pod shape, gene-sharded over
    the ranks and streamed in blocks of 8 within each."""
    from pydeseq2_tpu_torch.fused_stream import summary_pipeline_streamed

    counts_gm, X, host, kw = streamed_args()
    want = summary_pipeline_streamed(torch.tensor(counts_gm), *f64(X, [0.0, 1.0], 0.0, host["cooks_cutoff"]), **kw)
    for rank in ranks:
        got = rank["streamed"]
        np.testing.assert_array_equal(got["size_factors"], want["size_factors"].numpy())
        for key in ("padj", "p_values", "dispersions", "lfc", "base_mean"):
            np.testing.assert_allclose(got[key], want[key].numpy(), rtol=1e-12, equal_nan=True, err_msg=key)


@pytest.mark.parametrize("refit", [True, False], ids=["refit route", "single pipeline"])
def test_run_deseq2_mesh_matches_unsharded(ranks, api_plain, refit):
    """``tests/test_api.py:154`` on a mesh: each rank's whole results equal
    the unsharded port's at rtol 1e-12, with the same refitted genes."""
    want_res, want_state = api_plain[refit]
    for rank in ranks:
        res, state = rank["api"][refit]
        assert_frames_close(res, want_res, 1e-12)
        np.testing.assert_array_equal(state["size_factors"], want_state["size_factors"])
        if refit:
            assert state["refitted"].any()
            np.testing.assert_array_equal(state["refitted"], want_state["refitted"])


@pytest.mark.parametrize("refit", [True, False], ids=["refit route", "single pipeline"])
def test_run_deseq2_mesh_matches_jax_mesh(ranks, api_jax_mesh, refit):
    """Against the JAX package's ``run_deseq2(mesh=make_gene_mesh(8))`` at
    rtol 1e-6, the same refitted genes."""
    want_res, want_state = api_jax_mesh[refit]
    for rank in ranks:
        res, state = rank["api"][refit]
        assert_frames_close(res, want_res, 1e-6)
        if refit:
            np.testing.assert_array_equal(state["refitted"], want_state["refitted"])


def test_outlier_on_one_rank_refits_without_a_hang(ranks):
    """Only the last rank holds a Cook's outlier: every rank still reaches
    every collective, gathers the one-gene refit tile and returns the
    unsharded result."""
    import pydeseq2_tpu_torch as pt

    counts_gm, X = one_rank_outlier_data()
    want = pt.run_summary_streamed(counts_gm, X, [0.0, 1.0], dtype=np.float64, refit_cooks=True, max_disp=16.0,
                                   device="cpu")
    assert want["replaced"][37] and want["replaced"].sum() == 1 and want["refitted"][37]
    for rank in ranks:
        got = rank["one_rank_outlier"]
        np.testing.assert_array_equal(got["replaced"], want["replaced"])
        np.testing.assert_array_equal(got["refitted"], want["refitted"])
        for key in ("p_values", "padj", "lfc", "dispersions"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12, equal_nan=True, err_msg=key)


def test_rescue_overflow_selects_the_same_lanes(ranks):
    """More lanes diverge than the rescue tile takes: the ranks' shared
    quota rescues the unsharded run's lanes (the first K flagged in lane
    order) and counts the same overflow."""
    from pydeseq2_tpu_torch.fused import _irls_with_rescue

    beta, conv, over = _irls_with_rescue(*overflow_inputs(*overflow_data()), 0.5, 1e-8)
    assert int(over) == OVERFLOW_BAD - 512
    for rank in ranks:
        got = rank["overflow"]
        assert got["overflow"] == int(over)
        np.testing.assert_array_equal(got["converged"], conv.numpy())
        np.testing.assert_allclose(got["beta"], beta.numpy(), rtol=1e-12)


def test_wald_pipeline_mesh_rescue_quota_counts_the_real_genes(ranks):
    """The single pipeline on a mesh whose pad lanes would move the
    rescue's K (38400 // 64 = 600 against 38399 // 64 = 599): the tile's
    lanes end at the last gene of the mask, so the mu init's and the LFC's
    IRLS rescue the unsharded run's lanes and count its overflow."""
    import pydeseq2_tpu_torch as pt

    counts, X = quota_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = pt.wald_pipeline(counts, X, [0.0, 1.0], 0.0, mu_init="irls", device="cpu")
    assert int(want["rescue_overflow"]) == 2 * (QUOTA_BAD - QUOTA_G // 64)
    for rank in ranks:
        got = rank["quota"]
        assert got["rescue_overflow"] == int(want["rescue_overflow"])
        np.testing.assert_array_equal(got["irls_converged"], want["irls_converged"].numpy())
        for key in ("lfc", "p_values"):
            np.testing.assert_allclose(got[key], want[key].numpy(), rtol=1e-12, equal_nan=True, err_msg=key)


def test_class_api_over_a_mesh_inference(ranks2):
    """``TorchInference(mesh=)`` under the unchanged dataset classes: each
    rank's ``results_df`` equals a one-process run's at rtol 1e-10, with
    the same refitted genes."""
    from pydeseq2_tpu_torch import TorchInference

    want, want_refit = class_api_results(TorchInference(device="cpu"))
    assert want_refit.any()
    for rank in ranks2:
        got, refit = rank["class_api"]
        np.testing.assert_array_equal(refit, want_refit)
        assert_frames_close(got, want, 1e-10)


def test_two_rank_wald_pipeline_through_init_distributed(ranks2):
    """``tests/test_multihost.py``: two processes joined by
    ``init_distributed``, the Wald pipeline on a gene-sharded mesh equal to
    one process's."""
    import pydeseq2_tpu_torch as pt

    counts, design, contrast = multihost_data()
    want = pt.wald_pipeline(counts, design, contrast, 0.0, max_disp=12.0, device="cpu")
    for rank in ranks2:
        got = rank["multihost"]
        np.testing.assert_array_equal(got["size_factors"], want["size_factors"].numpy())
        np.testing.assert_allclose(got["lfc"], want["lfc"].numpy(), rtol=1e-12, equal_nan=True)
        np.testing.assert_allclose(got["p_values"], want["p_values"].numpy(), rtol=1e-12, equal_nan=True)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
