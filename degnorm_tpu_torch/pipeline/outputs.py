"""Output-directory contract writers.

File names and layout mirror the reference exactly
(``docs/howtos/run_the_pipeline.md:173-214``, ``nmf.py:603-711``,
``__main__.py:199-209``) so the reference's post-hoc tooling semantics — and
this package's report/ layer — work off either engine's run directory:

    degradation_index_scores.csv     ran_baseline_selection.csv
    gene_exon_metadata.csv           read_counts.csv
    adjusted_read_counts.csv
    <chrom>/coverage_matrices_<chrom>.pkl
    <chrom>/estimated_coverage_matrices_<chrom>.pkl
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Mapping, Sequence

import numpy as np
import pandas as pd


def save_coverage_matrices(output_dir: str, gene_chrom: Mapping[str, str],
                           cov: Mapping[str, np.ndarray],
                           prefix: str = "coverage_matrices") -> None:
    """Per-chromosome {gene: matrix} pickles (reads_coverage_merge.py:439-452
    for raw, nmf.py:662-671 for estimates)."""
    by_chrom: Dict[str, Dict[str, np.ndarray]] = {}
    for gene, mat in cov.items():
        by_chrom.setdefault(gene_chrom[gene], {})[gene] = mat
    for chrom, d in by_chrom.items():
        cdir = os.path.join(output_dir, str(chrom))
        os.makedirs(cdir, exist_ok=True)
        with open(os.path.join(cdir, f"{prefix}_{chrom}.pkl"), "wb") as f:
            pickle.dump(d, f)


def _indexed_frame(genes: Sequence[str], gene_chrom: Mapping[str, str],
                   mat: np.ndarray, columns: Sequence[str]) -> pd.DataFrame:
    df = pd.DataFrame(mat, columns=list(columns))
    df.insert(0, "gene", list(genes))
    df.insert(0, "chr", [gene_chrom[g] for g in genes])
    return df


def save_results(output_dir: str, genes: Sequence[str],
                 gene_chrom: Mapping[str, str],
                 rho: np.ndarray, x_adj: np.ndarray,
                 ran_baseline_selection: np.ndarray,
                 estimates: Mapping[str, np.ndarray],
                 sample_ids: Sequence[str]) -> None:
    """DI scores, adjusted counts, baseline-selection tracker, estimated
    coverage pickles (reference GeneNMFOA.save_results, nmf.py:603-711)."""
    os.makedirs(output_dir, exist_ok=True)
    _indexed_frame(genes, gene_chrom, rho, sample_ids).to_csv(
        os.path.join(output_dir, "degradation_index_scores.csv"), index=False)
    _indexed_frame(genes, gene_chrom, x_adj, sample_ids).to_csv(
        os.path.join(output_dir, "adjusted_read_counts.csv"), index=False)
    iters = [f"iter_{i}" for i in range(ran_baseline_selection.shape[1])]
    _indexed_frame(genes, gene_chrom, ran_baseline_selection, iters).to_csv(
        os.path.join(output_dir, "ran_baseline_selection.csv"), index=False)
    save_coverage_matrices(output_dir, gene_chrom, estimates,
                           prefix="estimated_coverage_matrices")
