"""Warm start: resume from a previous run's parsed coverage/counts.

Re-implementation of reference ``warm_start.py:10-106``: load a finished
run's gene_exon_metadata.csv, read_counts.csv and per-chromosome
coverage_matrices pickles, copy them into the new output directory, and
return the intersected, coverage-ordered gene set.
"""
from __future__ import annotations

import os
import pickle
import shutil
from collections import OrderedDict
from typing import Dict

import numpy as np
import pandas as pd


def load_from_previous(degnorm_dir: str, new_dir: str,
                       copy_artifacts: bool = True) -> Dict:
    """``copy_artifacts=False`` loads without copying files into
    ``new_dir`` (the workers of a multi-process run: the coordinator owns
    every write into the output directory)."""
    if not os.path.isdir(new_dir):
        raise IOError(f"new DegNorm output directory {new_dir} not found")

    exon_file = os.path.join(degnorm_dir, "gene_exon_metadata.csv")
    count_file = os.path.join(degnorm_dir, "read_counts.csv")
    if copy_artifacts:
        shutil.copy(exon_file,
                    os.path.join(new_dir, "gene_exon_metadata.csv"))
        shutil.copy(count_file, os.path.join(new_dir, "read_counts.csv"))
    exon_df = pd.read_csv(exon_file, low_memory=False)
    read_count_df = pd.read_csv(count_file, low_memory=False)

    genes_df = (exon_df[["chr", "gene", "gene_start", "gene_end"]]
                .drop_duplicates().reset_index(drop=True))

    keep = np.intersect1d(genes_df.gene, read_count_df.gene)
    genes_df = genes_df[genes_df.gene.isin(keep)]
    read_count_df = read_count_df[read_count_df.gene.isin(keep)]
    sample_ids = read_count_df.columns.tolist()[2:]

    gene_cov: "OrderedDict[str, np.ndarray]" = OrderedDict()
    keep_set = set(keep)
    for chrom in genes_df.chr.unique().tolist():
        cov_file = os.path.join(degnorm_dir, str(chrom),
                                f"coverage_matrices_{chrom}.pkl")
        if copy_artifacts:
            os.makedirs(os.path.join(new_dir, str(chrom)), exist_ok=True)
            shutil.copy(cov_file, os.path.join(
                new_dir, str(chrom), f"coverage_matrices_{chrom}.pkl"))
        with open(cov_file, "rb") as f:
            cov_dat = pickle.load(f)
        for gene, mat in cov_dat.items():
            if gene in keep_set:
                gene_cov[gene] = mat

    genes = list(gene_cov.keys())
    genes_df = (genes_df.set_index("gene").loc[genes].reset_index())
    read_count_df = (read_count_df.set_index("gene").loc[genes].reset_index())

    return {"gene_cov_dict": gene_cov, "read_count_df": read_count_df,
            "genes_df": genes_df, "sample_ids": sample_ids,
            "exon_df": exon_df}
