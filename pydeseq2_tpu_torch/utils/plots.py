"""Matplotlib plotting helpers (host-side; not performance relevant).

A copy of ``pydeseq2_tpu/utils/plots.py``; matplotlib is imported inside
each function.

Parity targets (reference, owkin/PyDESeq2): pydeseq2/utils.py:1230-1370
(``make_scatter`` dispersion plot, ``make_MA_plot``).
"""

from __future__ import annotations

from typing import Literal


def make_scatter(
    disps: list,
    legend_labels: list,
    x_val,
    log: bool = True,
    save_path: str | None = None,
    **kwargs,
) -> None:
    """Dispersion scatter plot. Parity: reference pydeseq2/utils.py:1230-1297."""
    from matplotlib import pyplot as plt

    colors = "kbr" if len(disps) == 3 else "kbrcmyg"
    plt.rcParams.update({"font.size": 10})
    fig, ax = plt.subplots(dpi=600)
    if log:
        plt.yscale("log")
        plt.xscale("log")
    ax.set_adjustable("datalim")
    kwargs.setdefault("alpha", 0.5)
    kwargs.setdefault("s", 0.6)
    for disp, color in zip(disps, colors):
        plt.scatter(x=x_val, y=disp, c=color, **kwargs)
    plt.legend(legend_labels, loc="best")
    plt.xlabel("mean of normalized counts")
    plt.ylabel("dispersion")
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, bbox_inches="tight")
    plt.show()


def make_MA_plot(
    results_df,
    padj_thresh: float = 0.05,
    log: bool = True,
    save_path: str | None = None,
    lfc_null: float = 0,
    alt_hypothesis: Literal["greaterAbs", "lessAbs", "greater", "less"] | None = None,
    **kwargs,
) -> None:
    """MA plot colored by padj threshold. Parity: reference
    pydeseq2/utils.py:1300-1369."""
    from matplotlib import pyplot as plt

    colors = results_df["padj"].apply(
        lambda x: "darkred" if x < padj_thresh else "gray"
    )
    fig, ax = plt.subplots(dpi=600)
    kwargs.setdefault("alpha", 0.5)
    kwargs.setdefault("s", 0.2)
    plt.scatter(
        x=results_df["baseMean"],
        y=results_df["log2FoldChange"],
        c=colors,
        **kwargs,
    )
    ax.set_adjustable("datalim")
    if log:
        plt.xscale("log")
    plt.xlabel("mean of normalized counts")
    plt.ylabel("log2 fold change")
    plt.axhline(lfc_null, color="red", alpha=0.5, linestyle="--", zorder=3)
    if alt_hypothesis and alt_hypothesis in ["greaterAbs", "lessAbs"]:
        plt.axhline(-lfc_null, color="red", alpha=0.5, linestyle="--", zorder=3)
    plt.tight_layout()
    if save_path is not None:
        plt.savefig(save_path, bbox_inches="tight")
