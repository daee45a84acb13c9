"""Per-(sample, chromosome) coverage + read counting, fully vectorized.

Re-design of the reference ETL hot loop
(``reads.py:314-818``, SURVEY.md §3.4): the reference walks reads in pure
Python, regex-parsing each CIGAR and filling chromosome-length indicator
vectors per read.  Here the columnar arrays from io/bam.py flow through
numpy primitives end-to-end — flattened-CIGAR cumulative sums for segment
bounds, reduceat for per-pair extrema, prefix sums for exon-membership
tests, repeat/cumsum expansion for coverage fills, and key-dedup bincounts
for the fancy-assignment increment semantics.  No per-read Python loop
remains.

Two CIGAR conventions are supported (``compat``):

* "reference" (default): replicates the reference parser's behavior in
  which EVERY cigar op consumes reference bases (reads.py:9-66 advances
  ``start`` for I/S/H too) and paired-mate disjoint-ification can emit
  1-base phantom segments (reads.py:463-467).  The reference's own unit
  tests pin this behavior (tests/test_reads.py:151-189); coverage parity
  requires it.
* "strict": SAM-spec semantics (M/=/X consume query+reference and count as
  match; D/N consume reference only; I/S/H consume none) and true interval-
  union mate merging.

Further reference quirks preserved in compat mode (flagged here per
SURVEY.md §7.2 so they're deliberate, not accidental):
  * overlap-gene coverage positions are shifted by -1 relative to the gene
    start, index -1 wrapping to the vector end (reads.py:615-617);
  * a read's exonic containment test for overlap genes allows the segment
    end to exceed the exon end by one base (reads.py:575-576,299);
  * the isolated-gene span test checks one base past the read's end
    (reads.py:697) using an end position that includes ALL cigar ops
    (reads.py:404-405);
  * duplicate positions within one read's fill increment coverage once
    (fancy-index assignment semantics, reads.py:617,773).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from degnorm_tpu_torch.io.bam import (MATCH_OP, REF_CONSUMING, ReadColumns)
from degnorm_tpu_torch.io.native.build import native_disabled


@dataclasses.dataclass
class ChromCoverage:
    """One (sample, chromosome)'s ETL output."""
    chrom: str
    isolated_coverage: Optional[np.ndarray]      # (chrom_len,) int or None
    overlap_coverage: Dict[str, np.ndarray]      # gene -> exon-union vector
    read_counts: Dict[str, int]                  # gene -> count


@dataclasses.dataclass
class _Units:
    """Flat segment representation of counting units (reads or merged
    pairs).  Segments of unit i live at rows [offsets[i], offsets[i+1])."""
    seg_start: np.ndarray
    seg_end: np.ndarray
    seg_unit: np.ndarray
    offsets: np.ndarray
    pos: np.ndarray          # unit anchor position (kept read's pos)
    end_pos: np.ndarray
    # True where the unit's segments may contain duplicate positions
    # (compat-mode mate clipping); such units take the dedup path.
    dirty: np.ndarray

    @property
    def n(self) -> int:
        return len(self.pos)

    def subset(self, unit_mask: np.ndarray) -> "_Units":
        seg_keep = unit_mask[self.seg_unit]
        counts = np.diff(self.offsets)[unit_mask]
        new_unit = np.repeat(np.arange(int(unit_mask.sum())), counts)
        return _Units(
            seg_start=self.seg_start[seg_keep],
            seg_end=self.seg_end[seg_keep],
            seg_unit=new_unit,
            offsets=np.concatenate([[0], np.cumsum(counts)]),
            pos=self.pos[unit_mask], end_pos=self.end_pos[unit_mask],
            dirty=self.dirty[unit_mask])


# ---------------------------------------------------------------------------
# segment extraction
# ---------------------------------------------------------------------------

def read_match_segments(cols: ReadColumns, compat: str = "reference"
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Vectorized CIGAR walk over all reads at once.

    Returns (seg_read, seg_start, seg_end, end_pos):
      seg_read: read index per match segment,
      seg_start/seg_end: 0-based inclusive reference bounds per segment
        (reference cigar_segment_bounds, reads.py:9-66),
      end_pos: per-read 'end' as the reference computes it — pos + the sum
        of ALL cigar run lengths (reads.py:404-405) in compat mode, pos +
        reference-consumed length in strict mode.
    """
    n_reads = len(cols)
    ops = cols.cigar_ops.astype(np.int64)
    lens = cols.cigar_lens.astype(np.int64)
    counts = np.diff(cols.cigar_offsets)
    op_read = np.repeat(np.arange(n_reads), counts)

    if compat == "reference":
        consumed = lens                              # every op advances
        is_match = ops == 0                          # only literal 'M'
        end_adv = lens
    else:
        consumed = lens * REF_CONSUMING[ops]
        is_match = MATCH_OP[ops].astype(bool)
        end_adv = consumed

    # within-read exclusive prefix of consumed lengths, via boundary gathers
    cum0 = np.concatenate([[0], np.cumsum(consumed)])
    read_start_cum = cum0[cols.cigar_offsets[:-1]]   # total before each read
    within = cum0[:-1] - read_start_cum[op_read]

    seg_read = op_read[is_match]
    seg_start = cols.pos.astype(np.int64)[seg_read] + within[is_match]
    seg_end = seg_start + lens[is_match] - 1         # inclusive

    adv0 = np.concatenate([[0], np.cumsum(end_adv)])
    totals = adv0[cols.cigar_offsets[1:]] - adv0[cols.cigar_offsets[:-1]]
    end_pos = cols.pos.astype(np.int64) + totals
    return seg_read, seg_start, seg_end, end_pos


def check_compat_match_regions(cols: ReadColumns) -> None:
    """Reference parity: a CIGAR with no literal 'M' op raises
    (reads.py:62-64 — cigar_segment_bounds errors per read, crashing the
    reference's ETL).  Called by both the numpy and native compat paths
    BEFORE unit building, which indexes each read's first/last segment and
    must never see a zero-segment read."""
    # int32 cumsum directly over the boolean mask: an int64 cast, a
    # default cumsum and a concatenate would move several times the bytes
    match = cols.cigar_ops == 0
    cs = np.empty(len(match) + 1, np.int32)
    cs[0] = 0
    np.cumsum(match, dtype=np.int32, out=cs[1:])
    per_read = cs[cols.cigar_offsets[1:]] - cs[cols.cigar_offsets[:-1]]
    bad = np.flatnonzero(per_read == 0)
    if len(bad):
        raise ValueError(
            f"CIGAR string has no matching region (read index {bad[0]}, "
            f"{len(bad)} total) — reference-compat mode counts only "
            "literal 'M' ops; aligners emitting '='/'X' need "
            "cigar_compat='strict'")


def unpaired_qnames(qnames: np.ndarray) -> np.ndarray:
    """Strip the trailing '.1'/'.2' mate token (reads.py:258),
    vectorized through pandas string kernels."""
    if len(qnames) == 0:
        return np.array([], dtype=object)
    s = pd.Series(np.asarray(qnames, dtype=object), dtype=object)
    return s.str.rpartition(".")[0].to_numpy(dtype=object)


def _gather_read_segments(seg_start, seg_end, offsets, reads):
    """Flat (starts, ends, owner_index) for the given read ids, in order."""
    counts = (offsets[reads + 1] - offsets[reads]).astype(np.int64)
    total = int(counts.sum())
    owner = np.repeat(np.arange(len(reads)), counts)
    base = np.repeat(offsets[reads], counts)
    within = np.arange(total) - np.repeat(
        np.cumsum(counts) - counts, counts)
    rows = base + within
    return seg_start[rows], seg_end[rows], owner, counts


def build_units(cols: ReadColumns, seg_read, seg_start, seg_end, end_pos,
                keep: np.ndarray, paired: bool,
                uq_codes: Optional[np.ndarray], compat: str) -> _Units:
    """Assemble counting units from kept reads, merging mate bounds for
    pairs (reference reads.py:450-523, fully vectorized).

    ``uq_codes``: factorized unpaired-qname codes; pairs are grouped by
    code with a stable sort — pairing is identical to the reference's
    lexicographic sort (groups are independent, within-group order is file
    order either way)."""
    n_reads = len(cols)
    counts_all = np.bincount(seg_read, minlength=n_reads).astype(np.int64)
    offsets_all = np.concatenate([[0], np.cumsum(counts_all)])

    if not paired:
        reads = np.flatnonzero(keep)
        s, e, owner, counts = _gather_read_segments(
            seg_start, seg_end, offsets_all, reads)
        return _Units(seg_start=s, seg_end=e, seg_unit=owner,
                      offsets=np.concatenate([[0], np.cumsum(counts)]),
                      pos=cols.pos[reads].astype(np.int64),
                      end_pos=end_pos[reads],
                      dirty=np.zeros(len(reads), bool))

    live = np.flatnonzero(keep)
    order = live[np.argsort(uq_codes[live], kind="stable")]
    r1, r2 = order[0::2], order[1::2]
    n_pairs = len(r2)
    if n_pairs == 0:
        return _Units(*(np.empty(0, np.int64),) * 3,
                      offsets=np.array([0], np.int64),
                      pos=np.empty(0, np.int64),
                      end_pos=np.empty(0, np.int64),
                      dirty=np.empty(0, bool))

    # mate extrema: cigar segments ascend, so min/max are the flat ends
    min1 = seg_start[offsets_all[r1]]
    max1 = seg_end[offsets_all[r1 + 1] - 1]

    s1, e1, own1, cnt1 = _gather_read_segments(
        seg_start, seg_end, offsets_all, r1)
    s2, e2, own2, cnt2 = _gather_read_segments(
        seg_start, seg_end, offsets_all, r2)

    if compat == "reference":
        # clip-to-scalar disjointification (reads.py:459-467), applied to
        # the flat [s,e,s,e,...] endpoint list of mate 2
        max2 = seg_end[offsets_all[r2 + 1] - 1]
        fwd = max2 >= max1                      # per pair
        fwd_s = fwd[own2]
        lo1_s = min1[own2]
        hi1_s = max1[own2]
        vs = np.where(fwd_s, np.where(s2 <= hi1_s, hi1_s + 1, s2),
                      np.where(s2 >= lo1_s, lo1_s - 1, s2))
        ve = np.where(fwd_s, np.where(e2 <= hi1_s, hi1_s + 1, e2),
                      np.where(e2 >= lo1_s, lo1_s - 1, e2))
        seg_clipped = (vs != s2) | (ve != e2)
        pair_dirty = np.bincount(own2[seg_clipped],
                                 minlength=n_pairs).astype(bool)
        # backward case: the reference sorts the flat endpoint list and
        # re-pairs consecutive values (reads.py:466-467)
        if (~fwd).any():
            bwd_seg = ~fwd_s
            flat_pair = np.repeat(own2[bwd_seg], 2)
            flat_val = np.empty(2 * int(bwd_seg.sum()), np.int64)
            flat_val[0::2] = vs[bwd_seg]
            flat_val[1::2] = ve[bwd_seg]
            srt = np.lexsort((flat_val, flat_pair))
            flat_sorted = flat_val[srt]
            vs = vs.copy()
            ve = ve.copy()
            vs[bwd_seg] = flat_sorted[0::2]
            ve[bwd_seg] = flat_sorted[1::2]
        s2, e2 = vs, ve
    else:
        # true interval union of both mates, per pair
        sa = np.concatenate([s1, s2])
        ea = np.concatenate([e1, e2])
        pa = np.concatenate([own1, own2])
        srt = np.lexsort((sa, pa))
        sa, ea, pa = sa[srt], ea[srt], pa[srt]
        new_run = np.ones(len(sa), bool)
        # running max end WITHIN each pair: rows are pair-major, so a pair
        # offset above every coordinate keeps one pair's ends from leaking
        # into the next pair's run test
        shift = pa.astype(np.int64) << 32
        run_end = np.maximum.accumulate(ea + shift) - shift
        new_run[1:] = (pa[1:] != pa[:-1]) | (sa[1:] > run_end[:-1] + 1)
        ms = sa[new_run]
        # per-run max end via reduceat
        run_starts = np.flatnonzero(new_run)
        me = np.maximum.reduceat(ea, run_starts)
        mp = pa[new_run]
        cnt = np.bincount(mp, minlength=n_pairs)
        return _Units(seg_start=ms, seg_end=me, seg_unit=mp,
                      offsets=np.concatenate([[0], np.cumsum(cnt)]),
                      pos=cols.pos[r2].astype(np.int64),
                      end_pos=end_pos[r2],
                      dirty=np.zeros(n_pairs, bool))

    # merged = mate1 segments then transformed mate2 segments, per pair
    s = np.concatenate([s1, s2])
    e = np.concatenate([e1, e2])
    owner = np.concatenate([own1, own2])
    mate2 = np.concatenate([np.zeros(len(s1), bool), np.ones(len(s2), bool)])
    srt = np.lexsort((mate2, owner))     # pair-major, mate1 first (stable)
    s, e, owner = s[srt], e[srt], owner[srt]
    cnt = cnt1 + cnt2
    return _Units(seg_start=s, seg_end=e, seg_unit=owner,
                  offsets=np.concatenate([[0], np.cumsum(cnt)]),
                  pos=cols.pos[r2].astype(np.int64),
                  end_pos=end_pos[r2], dirty=pair_dirty)


# ---------------------------------------------------------------------------
# membership tests (prefix sums replace per-read indicator vectors)
# ---------------------------------------------------------------------------

def interval_indicator_prefix(chrom_len: int, starts0: np.ndarray,
                              ends_excl: np.ndarray) -> np.ndarray:
    """Prefix-sum P of a 0/1 "inside some interval" vector: bases in
    [start0, end_excl) are inside.  P has length chrom_len+1;
    count inside [a, b] inclusive = P[b+1] - P[a]."""
    diff = np.zeros(chrom_len + 1, dtype=np.int64)
    np.add.at(diff, np.clip(starts0, 0, chrom_len), 1)
    np.add.at(diff, np.clip(ends_excl, 0, chrom_len), -1)
    ind = np.cumsum(diff)[:-1] > 0
    return np.concatenate([[0], np.cumsum(ind)])


def segments_fully_inside(P: np.ndarray, seg_start: np.ndarray,
                          seg_end: np.ndarray) -> np.ndarray:
    """True per segment iff every base of [start, end] lies inside."""
    seg_start = np.clip(seg_start, 0, len(P) - 2)
    seg_end = np.clip(seg_end, seg_start, len(P) - 2)
    covered = P[seg_end + 1] - P[seg_start]
    return covered == (seg_end - seg_start + 1)


def units_fully_inside(units: _Units, P: np.ndarray) -> np.ndarray:
    """Per-unit AND of segment containment."""
    seg_ok = segments_fully_inside(P, units.seg_start, units.seg_end)
    out = np.ones(units.n, bool)
    np.logical_and.at(out, units.seg_unit, seg_ok)
    return out


# ---------------------------------------------------------------------------
# per-gene containment for overlap groups
# ---------------------------------------------------------------------------

def gene_exon_containment(exon_starts0: np.ndarray, exon_ends: np.ndarray,
                          seg_start: np.ndarray, seg_end: np.ndarray,
                          compat: str = "reference") -> np.ndarray:
    """Per segment: is [start, end] inside some single exon of this gene?

    In compat mode, exon bounds follow the reference convention
    (reads.py:575-576): starts 0-indexed, ends left 1-indexed — i.e. one
    base beyond the true 0-indexed inclusive end — and the containment
    test is start >= e_start and end <= e_end (reads.py:299), so a read
    may overhang an exon's true end by one base.  Note the reference also
    pairs separately-sorted starts and ends; sorting + a running end max
    reproduces that exactly.  Strict mode uses true inclusive ends.
    """
    if compat != "reference":
        exon_ends = exon_ends - 1
    order = np.argsort(exon_starts0, kind="stable")
    s = exon_starts0[order]
    e_cummax = np.maximum.accumulate(exon_ends[order])
    idx = np.searchsorted(s, seg_start, side="right") - 1
    ok = idx >= 0
    ok &= e_cummax[np.clip(idx, 0, len(s) - 1)] >= seg_end
    return ok


def expand_segments(starts: np.ndarray, ends: np.ndarray,
                    owner: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized fill: all positions of inclusive [start, end] segments.

    Returns (positions, owner_per_position)."""
    lens = (ends - starts + 1).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    base = np.repeat(starts, lens)
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    return base + within, np.repeat(owner, lens)


def coverage_increment(cov: np.ndarray, positions: np.ndarray,
                       owner: np.ndarray, modulus: int,
                       owner_dirty: Optional[np.ndarray] = None) -> None:
    """cov[positions] += 1 per owner with fancy-assignment dedup semantics:
    duplicate positions within one owner count once (reads.py:617,773).
    ``positions`` may contain negative indices (compat -1 wrap).

    Units flagged dirty in ``owner_dirty`` go through a sort-based dedup;
    the rest (segments provably disjoint) take a plain bincount."""
    wrapped = np.where(positions < 0, positions + modulus, positions)
    if owner_dirty is not None and owner_dirty.any():
        is_dirty = owner_dirty[owner]
        wd = wrapped[is_dirty]
        # drop positions past the vector end — same semantics as the clean
        # path's [:modulus] truncation and the C++ kernel's bounds check
        # (a % wrap here would add coverage at wrong positions)
        ok = wd < modulus
        key = owner[is_dirty][ok].astype(np.int64) * modulus + wd[ok]
        uniq = np.unique(key)
        np.add.at(cov, (uniq % modulus).astype(np.int64), 1)
        wrapped = wrapped[~is_dirty]
    if len(wrapped):
        cov += np.bincount(wrapped, minlength=modulus)[:modulus].astype(
            cov.dtype)


# ---------------------------------------------------------------------------
# the full per-(sample, chromosome) pipeline
# ---------------------------------------------------------------------------

def chromosome_coverage_read_counts(
    cols: ReadColumns,
    chrom: str,
    chrom_len: int,
    chrom_gene_df: pd.DataFrame,
    chrom_exon_df: pd.DataFrame,
    overlap_dat: Dict[str, list],
    *,
    paired: bool,
    unique_alignment: bool = True,
    compat: str = "reference",
    native: Optional[bool] = None,
    n_threads: int = 1,
) -> ChromCoverage:
    """Coverage + read counts for one sample on one chromosome
    (reference reads.py:314-818; see module docstring for conventions).

    Routes through the C++ kernel (io/native/coverage_kernel.cpp) where it
    applies (compat mode, pairing hashes present); a failed build of it
    raises.  ``native=False`` or DEGNORM_TPU_TORCH_NO_NATIVE=1 takes this
    numpy path.
    """
    if native is None:
        native = not native_disabled() and compat == "reference"
    if native and compat == "reference" and len(cols) and len(chrom_gene_df):
        from degnorm_tpu_torch.io.coverage_native import chromosome_coverage_native
        out = chromosome_coverage_native(
            cols, chrom, chrom_len, chrom_gene_df, chrom_exon_df,
            overlap_dat, paired=paired, unique_alignment=unique_alignment,
            n_threads=n_threads)
        if out is not None:
            return out

    genes = chrom_gene_df.gene.values
    gene_start0 = chrom_gene_df.gene_start.values.astype(np.int64) - 1
    gene_end0 = chrom_gene_df.gene_end.values.astype(np.int64) - 1
    read_counts: Dict[str, int] = {g: 0 for g in genes}

    if len(cols) == 0 or len(genes) == 0:
        iso = (np.zeros(chrom_len, np.int64)
               if overlap_dat.get("isolated_genes") else None)
        return ChromCoverage(chrom=chrom, isolated_coverage=iso,
                             overlap_coverage={}, read_counts=read_counts)

    # ---- step 0: alignment-level filters (reads.py:225-242) ----
    keep = np.ones(len(cols), dtype=bool)
    if unique_alignment:
        keep &= ~(cols.nh > 1)
    if paired:
        keep &= cols.rnext != -1

    # ---- step 1: match segments, span filter (reads.py:404-420) ----
    seg_read, seg_start, seg_end, end_pos = read_match_segments(
        cols, compat=compat)
    if compat == "reference":
        check_compat_match_regions(cols)
    else:
        # strict mode: a read whose CIGAR consumes no matched reference
        # bases (pure S/I/H) covers nothing — drop it (unit building
        # indexes each read's first/last segment)
        seg_counts = np.bincount(seg_read, minlength=len(cols.pos))
        keep &= seg_counts > 0
    keep &= ((cols.pos >= gene_start0.min())
             & (end_pos <= gene_end0.max()))

    uq_codes = None
    if paired:
        if cols.pair_hash is not None:
            # native reader precomputed the pairing hash — integer
            # factorization only
            _, uq_codes = np.unique(cols.pair_hash, return_inverse=True)
        else:
            uq = unpaired_qnames(cols.qnames)
            uq_codes, _ = pd.factorize(uq)       # hash-based, O(n)
        cnts = np.bincount(uq_codes[keep], minlength=int(uq_codes.max()) + 1)
        keep &= cnts[uq_codes] == 2

    units = build_units(cols, seg_read, seg_start, seg_end, end_pos,
                        keep, paired, uq_codes, compat)

    # ---- step 2: exon-union membership (reads.py:425-511) ----
    P_exon = interval_indicator_prefix(
        chrom_len,
        chrom_exon_df.start.values.astype(np.int64) - 1,
        chrom_exon_df.end.values.astype(np.int64))
    units = units.subset(units_fully_inside(units, P_exon))
    active = np.ones(units.n, dtype=bool)

    # ---- step 3: overlap gene groups (reads.py:543-656) ----
    overlap_cov: Dict[str, np.ndarray] = {}
    for ol_genes in overlap_dat.get("overlap_genes", []):
        gsel = chrom_gene_df[chrom_gene_df.gene.isin(ol_genes)]
        grp_start0 = gsel.gene_start.min() - 1
        grp_end0 = gsel.gene_end.max() - 1

        gene_info = []
        for g in ol_genes:
            gex = chrom_exon_df[chrom_exon_df.gene == g]
            gstart0 = int(gex.gene_start.iloc[0]) - 1
            gend0 = int(gex.gene_end.iloc[0]) - 1
            e_starts0 = np.sort(gex.start.values.astype(np.int64)) - 1
            e_ends = np.sort(gex.end.values.astype(np.int64))
            tx_idx = np.unique(expand_segments(
                e_starts0, e_ends - 1, np.zeros(len(e_starts0), np.int64))[0])
            gene_info.append((g, gstart0, gend0, e_starts0, e_ends, tx_idx))
            overlap_cov[g] = np.zeros(gend0 - gstart0 + 1, dtype=np.int64)

        in_grp = active & (units.pos >= grp_start0) & (units.end_pos <= grp_end0)
        if in_grp.any():
            seg_in_grp = in_grp[units.seg_unit]
            gs = units.seg_start[seg_in_grp]
            ge = units.seg_end[seg_in_grp]
            gu = units.seg_unit[seg_in_grp]

            n_caught = np.zeros(units.n, dtype=np.int64)
            caught_gene = np.full(units.n, -1, dtype=np.int64)
            for gi, (g, gstart0, gend0, es0, ee, tx) in enumerate(gene_info):
                seg_in = gene_exon_containment(es0, ee, gs, ge, compat=compat)
                unit_in = in_grp.copy()
                np.logical_and.at(unit_in, gu, seg_in)
                n_caught += unit_in
                caught_gene = np.where(unit_in & (n_caught == 1),
                                       gi, caught_gene)
            single = in_grp & (n_caught == 1)

            # coverage + counts for singly-caught units: one expansion for
            # the whole group, then per-gene slices
            if single.any():
                shift = 1 if compat == "reference" else 0
                seg_single = single[units.seg_unit]
                pos_fill, own_fill = expand_segments(
                    units.seg_start[seg_single], units.seg_end[seg_single],
                    units.seg_unit[seg_single])
                gene_of_pos = caught_gene[own_fill]
                for gi, (g, gstart0, gend0, es0, ee, tx) in enumerate(
                        gene_info):
                    m = gene_of_pos == gi
                    if not m.any():
                        continue
                    coverage_increment(overlap_cov[g],
                                       pos_fill[m] - gstart0 - shift,
                                       own_fill[m], len(overlap_cov[g]),
                                       owner_dirty=units.dirty)
                    read_counts[g] += int((single
                                           & (caught_gene == gi)).sum())

            active &= ~(single | (in_grp & (n_caught >= 2)))

        for g, gstart0, gend0, es0, ee, tx in gene_info:
            overlap_cov[g] = overlap_cov[g][tx - gstart0]

    # ---- step 4: isolated genes (reads.py:669-797) ----
    isolated = overlap_dat.get("isolated_genes", [])
    iso_cov = None
    if isolated:
        isel = chrom_gene_df[chrom_gene_df.gene.isin(isolated)]
        iso_start0 = isel.gene_start.values.astype(np.int64) - 1
        iso_end1 = isel.gene_end.values.astype(np.int64)   # end-exclusive 0idx
        iso_genes = isel.gene.values

        P_iso = interval_indicator_prefix(chrom_len, iso_start0, iso_end1)
        # read must lie fully in isolated-gene territory, checking one base
        # past its end (reads.py:697): [pos, end_pos] inclusive.
        u_ok = active & segments_fully_inside(
            P_iso, units.pos, np.minimum(units.end_pos, chrom_len - 1))

        iso_cov = np.zeros(chrom_len, dtype=np.int64)
        if u_ok.any():
            so = np.argsort(iso_start0, kind="stable")
            st_sorted = iso_start0[so]
            en_sorted = (iso_end1 - 1)[so]
            gn_sorted = iso_genes[so]
            upos = units.pos[u_ok]
            gi = np.searchsorted(st_sorted, upos, side="right") - 1
            valid = (gi >= 0) & (upos <= en_sorted[np.clip(gi, 0, None)])
            live = np.flatnonzero(u_ok)[valid]
            gi = gi[valid]

            live_mask = np.zeros(units.n, bool)
            live_mask[live] = True
            seg_live = live_mask[units.seg_unit]
            pos_all, own_all = expand_segments(
                units.seg_start[seg_live], units.seg_end[seg_live],
                units.seg_unit[seg_live])
            coverage_increment(iso_cov, pos_all, own_all, chrom_len,
                               owner_dirty=units.dirty)

            per_gene = np.bincount(gi, minlength=len(gn_sorted))
            for j, g in enumerate(gn_sorted):
                read_counts[g] += int(per_gene[j])

    return ChromCoverage(chrom=chrom, isolated_coverage=iso_cov,
                         overlap_coverage=overlap_cov,
                         read_counts=read_counts)
