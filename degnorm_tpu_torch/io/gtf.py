"""GTF genome-annotation parsing.

Replaces the reference's GeneAnnotationLoader + GeneAnnotationProcessor
(``degnorm/loaders.py:73-168``, ``degnorm/gene_processing.py:8-123``) with a
vectorized pandas pipeline.  Output contract is identical: an exon DataFrame
with columns [chr, start, end, gene, gene_start, gene_end], where

* only ``feature == 'exon'`` rows are kept (loaders.py:143);
* the gene label prefers ``gene_name`` over ``gene_id`` (loaders.py:151-152);
* genes spanning multiple chromosomes are dropped (gene_processing.py:53-64);
* (gene_start, gene_end) is the min-start/max-end outline over the gene's
  exons (gene_processing.py:66-87);
* coordinates stay 1-indexed with inclusive ends, exactly as in the file
  (SURVEY.md §0 invariants).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import pandas as pd

GTF_COLUMNS = ["chr", "source", "feature", "start", "end", "score",
               "strand", "frame", "attribute"]

_GENE_NAME_RE = r'gene_name\s+"?([^";]+)"?'
_GENE_ID_RE = r'gene_id\s+"?([^";]+)"?'


def load_exons(gtf_file: str,
               chroms: Optional[Union[str, Sequence[str]]] = None
               ) -> pd.DataFrame:
    """Parse a .gtf into a bed-like exon DataFrame [chr, start, end, gene]."""
    if not str(gtf_file).endswith((".gtf", ".gff")):
        raise ValueError(f"{gtf_file}: expected a .gtf/.gff file")
    try:
        df = pd.read_csv(gtf_file, sep="\t", header=None, comment="#",
                         usecols=list(range(9)), low_memory=False)
    except ValueError as e:
        raise ValueError(
            f"{gtf_file} must have the 9 mandatory .gtf columns") from e
    df.columns = GTF_COLUMNS

    df = df[df.feature.str.lower() == "exon"]
    if df.empty:
        raise ValueError(f"no exon records found in {gtf_file}")

    gene = df.attribute.str.extract(_GENE_NAME_RE, expand=False)
    fallback = df.attribute.str.extract(_GENE_ID_RE, expand=False)
    gene = gene.fillna(fallback)
    if gene.isna().any():
        raise ValueError(
            "found .gtf exon records whose attributes lack both gene_name "
            "and gene_id tags")
    df = df.assign(gene=gene.str.strip())

    df = (df[["chr", "start", "end", "gene"]]
          .drop_duplicates()
          .reset_index(drop=True)
          .astype({"chr": str, "start": int, "end": int, "gene": str}))

    if chroms is not None:
        if isinstance(chroms, str):
            chroms = [chroms]
        df = df[df.chr.isin(list(chroms))].reset_index(drop=True)
        if df.empty:
            raise ValueError(
                f"chromosome subset {chroms} left no exon records")
    return df


def remove_multichrom_genes(exon_df: pd.DataFrame) -> pd.DataFrame:
    """Drop genes whose exons appear on more than one chromosome
    (gene_processing.py:53-64)."""
    n_chroms = exon_df.groupby("gene").chr.nunique()
    bad = n_chroms[n_chroms > 1].index
    return exon_df[~exon_df.gene.isin(bad)]


def gene_outline(exon_df: pd.DataFrame) -> pd.DataFrame:
    """Per-(chr, gene) min(start) / max(end) outline
    (gene_processing.py:66-87)."""
    g = exon_df.groupby(["chr", "gene"], as_index=False).agg(
        gene_start=("start", "min"), gene_end=("end", "max"))
    return g


def process_annotation(gtf_file: str,
                       chroms: Optional[Union[str, Sequence[str]]] = None
                       ) -> pd.DataFrame:
    """Full annotation pipeline (gene_processing.py:89-123): exon DataFrame
    with gene outlines merged on."""
    exon_df = load_exons(gtf_file, chroms=chroms)
    exon_df = remove_multichrom_genes(exon_df).drop_duplicates()
    gene_df = gene_outline(exon_df)
    exon_df = exon_df.merge(gene_df, on=["chr", "gene"]).drop_duplicates()
    return exon_df.reset_index(drop=True)


def exon_union_from_arrays(starts1, ends1) -> np.ndarray:
    """0-indexed sorted unique base positions of one gene's exon union —
    the coverage-matrix column space (reference reads.py:575-577), from
    1-indexed inclusive [start, end] arrays.  The single home of this
    load-bearing convention (io/merge.py and io/coverage_native.py build
    the same arrays from factorized annotation passes)."""
    if len(starts1) == 0:
        return np.empty(0, np.int64)
    pos = [np.arange(s - 1, e) for s, e in zip(starts1, ends1)]
    return np.unique(np.concatenate(pos))


def exon_union_positions(exon_df_gene: pd.DataFrame) -> np.ndarray:
    """DataFrame form of ``exon_union_from_arrays`` (rows = one gene's
    exons)."""
    return exon_union_from_arrays(exon_df_gene.start.values,
                                  exon_df_gene.end.values)
