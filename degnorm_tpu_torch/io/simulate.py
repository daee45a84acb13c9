"""Synthetic dataset generation: GTF annotations and aligned BAM files.

The reference ships small test BAMs that are stripped from this snapshot
(SURVEY.md §4), so tests and benchmarks synthesize their own inputs —
genes with multi-exon structure, spliced/paired reads with degradation
bias, and writes through io/bam.py (and io/cram.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from degnorm_tpu_torch.io import bam as bamio


@dataclasses.dataclass
class SimGene:
    name: str
    chrom: str
    exons: List[Tuple[int, int]]   # 1-indexed inclusive


def make_genes(rng, chrom: str = "chr1", n_genes: int = 8,
               start: int = 1000, spacing: int = 3000,
               overlap_fraction: float = 0.2,
               name_prefix: str = "") -> List[SimGene]:
    genes = []
    pos = start
    for i in range(n_genes):
        n_ex = int(rng.integers(1, 4))
        exons = []
        p = pos
        for _ in range(n_ex):
            length = int(rng.integers(150, 600))
            exons.append((p, p + length - 1))
            p += length + int(rng.integers(100, 400))
        genes.append(SimGene(f"{name_prefix}gene{i:03d}", chrom, exons))
        if rng.random() < overlap_fraction and exons:
            pos = exons[-1][0] - int(rng.integers(0, 100))  # overlap next
            pos = max(pos, exons[0][0] + 10)
        else:
            pos = p + spacing
    return genes


def write_gtf(path: str, genes: Sequence[SimGene]) -> None:
    with open(path, "w") as f:
        for g in genes:
            for s, e in g.exons:
                attr = f'gene_id "{g.name}"; gene_name "{g.name}"; ' \
                       f'transcript_id "{g.name}.t1";'
                f.write(f"{g.chrom}\tsim\texon\t{s}\t{e}\t.\t+\t.\t{attr}\n")


def simulate_sample(rng, genes: Sequence[SimGene], chrom_len: int,
                    mean_reads_per_gene: int = 150, read_len: int = 50,
                    paired: bool = False, degradation: float = 0.0
                    ) -> List[Tuple]:
    """Generate reference-style BAM records.  ``degradation`` in [0, 1)
    biases reads toward the 3' end (exponential thinning toward 5')."""
    recs = []
    rid = 0
    for g in genes:
        tx = np.concatenate([np.arange(s - 1, e) for s, e in g.exons])
        L = len(tx)
        if L <= read_len:
            continue
        n_reads = max(1, int(rng.poisson(mean_reads_per_gene)))
        for _ in range(n_reads):
            u = rng.random()
            if degradation > 0:
                # 3' bias: exponent < 1 pushes u toward 1, so read starts
                # pile up at the transcript END (the 1/(1-d) form used
                # previously concentrated u near 0 — a 5' bias, inverted
                # vs. what poly-A-selected degradation produces)
                u = u ** max(1e-6, 1.0 - degradation)
            k = int(u * (L - read_len))
            span = tx[k:k + read_len]
            # emit cigar with N gaps across introns
            brk = np.flatnonzero(np.diff(span) > 1)
            cigar = ""
            prev = 0
            for b in brk:
                cigar += f"{b - prev + 1}M{span[b + 1] - span[b] - 1}N"
                prev = b + 1
            cigar += f"{read_len - prev}M"
            pos0 = int(span[0])
            nh = 2 if rng.random() < 0.03 else 1
            if paired:
                gap = int(rng.integers(5, 60))
                k2 = min(k + read_len + gap, L - read_len)
                pos2 = int(tx[k2])
                recs.append((f"SIM.{rid}.1", 0, pos0, 0x1, cigar, 0, nh))
                recs.append((f"SIM.{rid}.2", 0, pos2, 0x1,
                             f"{read_len}M", 0, nh))
            else:
                recs.append((f"SIM.{rid}", 0, pos0, 0x0, cigar, -1, nh))
            rid += 1
    recs.sort(key=lambda r: r[2])
    return recs


def write_sample_bam(path: str, genes: Sequence[SimGene], chrom_len: int,
                     seed: int = 0, **kwargs) -> None:
    rng = np.random.default_rng(seed)
    chrom = genes[0].chrom
    recs = simulate_sample(rng, genes, chrom_len, **kwargs)
    bamio.write_bam(path, [chrom], [chrom_len], recs)


def write_multichrom_bam(path: str, genes_by_chrom, chrom_lens,
                         seed: int = 0, **kwargs) -> None:
    """Multi-chromosome BAM: genes_by_chrom is {chrom: [SimGene...]},
    chrom_lens {chrom: length}; records are emitted per chromosome in
    header order (coordinate-sorted within each)."""
    rng = np.random.default_rng(seed)
    chroms = list(genes_by_chrom.keys())
    recs = []
    for tid, chrom in enumerate(chroms):
        sub = simulate_sample(rng, genes_by_chrom[chrom],
                              chrom_lens[chrom], **kwargs)
        # qname collisions across chromosomes are harmless: pairing is
        # resolved within a chromosome's read set
        for r in sub:
            recs.append((r[0], tid, *r[2:]))
    bamio.write_bam(path, chroms, [chrom_lens[c] for c in chroms], recs)


def write_sample_cram(path: str, genes: Sequence[SimGene], chrom_len: int,
                      seed: int = 0, compression: str = "rans",
                      **kwargs) -> None:
    """CRAM twin of write_sample_bam — identical record stream through
    io/cram.py (same seed => same reads as the .bam form)."""
    from degnorm_tpu_torch.io import cram as cramio
    rng = np.random.default_rng(seed)
    chrom = genes[0].chrom
    recs = simulate_sample(rng, genes, chrom_len, **kwargs)
    cramio.write_cram(path, [chrom], [chrom_len], recs,
                      compression=compression)
