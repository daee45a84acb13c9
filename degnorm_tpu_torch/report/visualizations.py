"""Plotting: before/after coverage figures and DI-score summary graphics.

API mirrors reference ``visualizations.py`` (SURVEY.md §2.1 #12):
``plot_gene_coverage``, ``check_for_files``, ``load_di_scores``,
``get_di_heatmap``, ``get_di_correlation``, ``get_di_boxplots``.
"""
from __future__ import annotations

import os
import threading
from typing import Sequence, Union

import matplotlib
matplotlib.use("agg")
import matplotlib.pyplot as plt
from matplotlib import gridspec
from matplotlib.figure import Figure
from matplotlib.patches import Rectangle
import numpy as np
import pandas as pd
import seaborn as sns

plt.rcParams.update({"figure.max_open_warning": 0})

# Figure/axes CONSTRUCTION mutates process-global state (seaborn style
# contexts swap rcParams; axes creation reads them) — serialize it.  The
# expensive parts (line drawing, layout, Agg rasterization, PNG encode)
# operate on private Figure objects and run outside the lock, which is
# what makes the threaded renderers below (report phase, --plot-genes)
# safe: every figure is an OO-API matplotlib.figure.Figure, never routed
# through the thread-unsafe pyplot figure manager.
_FIG_LOCK = threading.RLock()


def union_exons(x: np.ndarray) -> np.ndarray:
    """Merge intersecting [start, end] exon rows into their unions
    (reference get_exon_unions, visualizations.py:14-59)."""
    x = np.asarray(x)
    if x.shape[0] <= 1:
        return x
    x = x[np.argsort(x[:, 0])]
    out = [list(x[0])]
    for s, e in x[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def plot_gene_coverage(ke, f, x_exon, gene, chrom, sample_ids=None,
                       save_dir=None, **kwargs):
    """2x2 before/after coverage figure with an exon-junction track
    (reference visualizations.py:62-193).  Returns the Figure, or the saved
    path save_dir/<chrom>/<gene>_coverage.png when save_dir is given."""
    ke, f = np.asarray(ke), np.asarray(f)
    if ke.shape != f.shape:
        raise ValueError("estimated and raw coverage shapes differ")
    p = f.shape[0]
    if sample_ids and len(sample_ids) != p:
        raise ValueError("len(sample_ids) != number of coverage rows")
    sample_ids = sample_ids or [f"sample_{i + 1}" for i in range(p)]

    x_exon = union_exons(np.asarray(x_exon))
    start, end = int(x_exon.min()), int(x_exon.max())

    # construction under the lock (global rc state); everything after —
    # line drawing, layout, rasterize, PNG encode — is per-figure
    with _FIG_LOCK, sns.axes_style("darkgrid"):
        fig = Figure(**kwargs)
        gs = gridspec.GridSpec(2, 2, width_ratios=[1, 1],
                               height_ratios=[20, 1])
        ax_raw = fig.add_subplot(gs[0])
        ax_est = fig.add_subplot(gs[1])
        track_axes = [fig.add_subplot(gs[2]), fig.add_subplot(gs[3])]
    fig.suptitle(f"Gene {gene} coverage -- chromosome {chrom}")
    for i in range(p):
        ax_raw.plot(f[i], label=sample_ids[i])
        ax_est.plot(ke[i], label=sample_ids[i])
    ax_raw.set_title("Original")
    ax_est.set_title("Normalized")
    handles, labels = ax_est.get_legend_handles_labels()
    for ax in (ax_raw, ax_est):
        ax.margins(x=0)

    # exon-junction tracks under each curve panel
    for ax in track_axes:
        ax.set_xlim(start, end)
        ax.add_patch(Rectangle((start, 0), width=end - start, height=1,
                               fill=True, facecolor="red", lw=1))
        ax.get_yaxis().set_visible(False)
        ax.set_xticks([start, end])
        ax.set_xticklabels([str(start), str(end)])
        for j in range(x_exon.shape[0] - 1):
            ax.axvline(x=x_exon[j, 1], ymin=0, ymax=1, color="w", lw=2)

    ncol = len(labels) if len(labels) < 6 else 1
    fig.legend(handles, labels, title="Sample", ncol=ncol,
               loc="upper right" if ncol == 1 else "lower center")
    fig.tight_layout(rect=[0, 0.07, 1, 0.95])

    if not save_dir:
        return fig
    cdir = os.path.join(save_dir, str(chrom))
    os.makedirs(cdir, exist_ok=True)
    path = os.path.abspath(os.path.join(cdir, f"{gene}_coverage.png"))
    # no bbox_inches="tight": it re-renders the whole figure a second
    # time just to measure it; tight_layout above
    # already handles spacing
    fig.savefig(path, dpi=150)
    return path


def check_for_files(data_dir: str, file_names: Union[str, Sequence[str]]):
    """Assert required run-directory files exist (visualizations.py:196-212)."""
    if isinstance(file_names, str):
        file_names = [file_names]
    for f in file_names:
        p = os.path.join(data_dir, f)
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f"{p} not found — is {data_dir} a DegNorm output directory?")


def load_di_scores(data_dir: str, drop_chroms: bool = True,
                   order: bool = False) -> pd.DataFrame:
    """DI scores indexed by gene, alphabetically ordered; optionally with
    samples ordered by ascending mean DI (visualizations.py:215-255)."""
    check_for_files(data_dir, "degradation_index_scores.csv")
    df = pd.read_csv(os.path.join(data_dir, "degradation_index_scores.csv"),
                     index_col="gene", low_memory=False)
    df = df.sort_index()
    sample_ids = df.columns.tolist()[1:]
    cols = (df[sample_ids].mean().sort_values().index.tolist()
            if order else sample_ids)
    if drop_chroms:
        return df[cols]
    return df[["chr"] + cols]


def _save_or_return(fig, save_dir, fname):
    if save_dir:
        path = os.path.abspath(os.path.join(save_dir, fname))
        fig.savefig(path, dpi=200)
        return path
    return fig


def _new_fig_ax(figsize, style=None):
    ctx = sns.axes_style(style) if style else _NullCtx()
    with _FIG_LOCK, ctx:
        fig = Figure(figsize=figsize)
        ax = fig.add_subplot(1, 1, 1)
    return fig, ax


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def di_frame(rho, genes, sample_ids, order=True) -> pd.DataFrame:
    """Build the load_di_scores(order=...) frame directly from in-memory
    arrays (gene-indexed, alphabetical; samples by ascending mean DI) —
    lets the pipeline render DI figures without re-reading the CSV it
    just wrote (and therefore concurrently with writing it)."""
    df = pd.DataFrame(np.asarray(rho), index=list(genes),
                      columns=list(sample_ids)).sort_index()
    if order:
        df = df[df.mean().sort_values().index.tolist()]
    return df


def get_di_heatmap(data_dir, save_dir=None, figsize=(10, 8), rho_df=None):
    """Genes x samples DI heatmap (visualizations.py:258-293)."""
    if rho_df is None:
        rho_df = load_di_scores(data_dir, order=True)
    fig, ax = _new_fig_ax(figsize)
    fig.suptitle("DI score heatmap")
    sns.heatmap(rho_df, cmap="RdBu", cbar_kws={"shrink": 0.5}, ax=ax)
    ax.set_xticklabels(ax.get_xticklabels(), rotation=45)
    fig.tight_layout(rect=[0, 0, 1, 0.95])
    return _save_or_return(fig, save_dir, "di_heatmap.png")


def get_di_correlation(data_dir, save_dir=None, figsize=(8, 6),
                       rho_df=None):
    """Sample-wise DI correlation heatmap (visualizations.py:296-330)."""
    if rho_df is None:
        rho_df = load_di_scores(data_dir, order=True)
    fig, ax = _new_fig_ax(figsize)
    fig.suptitle("DI score correlation")
    corr = rho_df.corr()
    sns.heatmap(corr, xticklabels=corr.columns.values,
                yticklabels=corr.columns.values, cmap="YlGnBu",
                cbar_kws={"shrink": 0.5}, ax=ax)
    fig.tight_layout(rect=[0, 0, 1, 0.95])
    return _save_or_return(fig, save_dir, "di_correlation.png")


def get_di_boxplots(data_dir, save_dir=None, figsize=(12, 8), rho_df=None):
    """Per-sample DI boxplots (visualizations.py:333-372)."""
    if rho_df is None:
        rho_df = load_di_scores(data_dir, order=True)
    long_df = rho_df.melt(var_name="sample ID", value_name="DI score")
    fig, ax = _new_fig_ax(figsize, style="darkgrid")
    fig.suptitle("DI scores")
    sns.boxplot(x="sample ID", y="DI score", data=long_df, ax=ax)
    ax.set_xticklabels(ax.get_xticklabels(), rotation=30)
    ax.set_xlabel("")
    fig.tight_layout(rect=[0, 0, 1, 0.95])
    return _save_or_return(fig, save_dir, "di_boxplots.png")
