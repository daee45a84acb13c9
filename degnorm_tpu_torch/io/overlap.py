"""Gene-overlap structure: which genes share chromosome territory.

Replaces the reference's HTSeq GenomicArrayOfSets interval stabbing +
networkx BFS (``gene_processing.py:126-231``) with an O(n log n)
sorted-endpoint sweep.  For intervals, the connected components of the
overlap graph are exactly the maximal merged spans, so a single
sort + running-max pass recovers the same grouping the reference builds
from its adjacency matrix.

Overlap convention matches the reference: genes are compared as 0-indexed
half-open intervals [gene_start - 1, gene_end) (gene_processing.py:172),
so two genes overlap iff they share at least one base; merely touching
endpoints in 1-indexed inclusive terms (end_a == start_b) DOES count, since
base start_b belongs to both.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd


def overlap_structure(gene_df: pd.DataFrame) -> Dict[str, list]:
    """Split one chromosome's genes into overlap groups and isolated genes.

    Args:
      gene_df: columns [gene, gene_start, gene_end] (1-indexed inclusive).

    Returns:
      {'overlap_genes': [[genes...], ...], 'isolated_genes': [genes...]}
      with groups in genomic order and genes within a group ordered by
      (start, end, name) — the reference's ordering is BFS-discovery order
      (gene_processing.py:205-228), which downstream code never relies on
      beyond set membership.
    """
    genes = gene_df.gene.values
    starts = gene_df.gene_start.values.astype(np.int64) - 1   # 0-indexed
    ends = gene_df.gene_end.values.astype(np.int64)           # exclusive
    n = len(genes)
    if n == 0:
        return {"overlap_genes": [], "isolated_genes": []}

    order = np.lexsort((ends, starts))
    s, e = starts[order], ends[order]
    # new component whenever the next interval starts at/after the running
    # maximum end of the current merged span
    run_end = np.maximum.accumulate(e)
    new_comp = np.ones(n, dtype=bool)
    new_comp[1:] = s[1:] >= run_end[:-1]
    comp_id = np.cumsum(new_comp) - 1

    overlap_groups: List[List[str]] = []
    isolated: List[str] = []
    for c in range(comp_id[-1] + 1):
        members = order[comp_id == c]
        if members.size == 1:
            isolated.append(genes[members[0]])
        else:
            overlap_groups.append([genes[m] for m in members])
    return {"overlap_genes": overlap_groups, "isolated_genes": isolated}
