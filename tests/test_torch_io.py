"""PyTorch port, host layer: the port's io/ copies against the JAX package's.

Same inputs (``io/simulate.py`` fixtures made from a seed, or columns built
with numpy) go through both packages; every output must be equal — bytes for
the writers, arrays for the readers and the coverage.  Also: the port's host
library builds race-free under concurrent processes, and its two repaired
native paths (per-thread decode error flags, the wrap cell of an overlap
gene) give the serial result at any thread count.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from degnorm_tpu.io import bai as jbai
from degnorm_tpu.io import bam as jbam
from degnorm_tpu.io import bgzf as jbgzf
from degnorm_tpu.io import coverage as jcov
from degnorm_tpu.io import gtf as jgtf
from degnorm_tpu.io import merge as jmerge
from degnorm_tpu.io import overlap as jov
from degnorm_tpu.io import simulate as jsim
from degnorm_tpu_torch.io import bai as tbai
from degnorm_tpu_torch.io import bam as tbam
from degnorm_tpu_torch.io import bgzf as tbgzf
from degnorm_tpu_torch.io import coverage as tcov
from degnorm_tpu_torch.io import gtf as tgtf
from degnorm_tpu_torch.io import merge as tmerge
from degnorm_tpu_torch.io import overlap as tov
from degnorm_tpu_torch.io import simulate as tsim
from degnorm_tpu_torch.io.native import build as tbuild
from degnorm_tpu_torch.pipeline.sample import BamSampleProcessor as TSample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHROM_LEN = 60_000
COLUMNS = ("tid", "pos", "flag", "rnext", "nh", "cigar_ops", "cigar_lens",
           "cigar_offsets")


@pytest.fixture(scope="module", autouse=True)
def _jax_host_layer_on_numpy():
    """The JAX package's host layer takes its numpy paths in these tests:
    its native build is not safe across processes (ROADMAP Queue 3), and
    what is compared here is the port against its results, not its build."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEGNORM_TPU_NO_NATIVE", "1")
        yield


def _genes(seed=11, n=12, chrom="chr1", prefix=""):
    return tsim.make_genes(np.random.default_rng(seed), chrom=chrom,
                           n_genes=n, overlap_fraction=0.35,
                           name_prefix=prefix)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Single-end and paired BAMs of one gene set, written by the port, and
    the GTF; the JAX package writes the same records beside them."""
    d = tmp_path_factory.mktemp("tio")
    genes = _genes()
    out = {"genes": genes, "dir": d, "gtf": str(d / "sim.gtf")}
    tsim.write_gtf(out["gtf"], genes)
    for paired in (False, True):
        for pkg, sim in (("t", tsim), ("j", jsim)):
            path = str(d / f"{pkg}_{int(paired)}.bam")
            sim.write_sample_bam(path, genes, CHROM_LEN, seed=5,
                                 mean_reads_per_gene=150, paired=paired,
                                 degradation=0.3)
            out[(pkg, paired)] = path
    return out


def _assert_columns_equal(a, b):
    assert list(a.qnames) == list(b.qnames)
    for f in COLUMNS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _assert_chrom_coverage_equal(a, b):
    assert a.read_counts == b.read_counts
    if a.isolated_coverage is None:
        assert b.isolated_coverage is None
    else:
        np.testing.assert_array_equal(a.isolated_coverage,
                                      b.isolated_coverage)
    assert list(a.overlap_coverage) == list(b.overlap_coverage)
    for g in a.overlap_coverage:
        np.testing.assert_array_equal(a.overlap_coverage[g],
                                      b.overlap_coverage[g])


# ---------------------------------------------------------------------------
# host library build
# ---------------------------------------------------------------------------

_BUILD_CHILD = (
    "import sys\n"
    "from degnorm_tpu_torch.io.native.build import open_library\n"
    "lib = open_library(sys.argv[1])\n"
    "assert lib.dn_chrom_coverage is not None\n"
    "print('loaded')\n")


def test_native_build_is_process_safe(tmp_path):
    """Six processes build into one fresh directory at once: every one
    loads the library, and one library (no temporary file) remains."""
    target = str(tmp_path / "build")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, target],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=280) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "loaded"
    names = sorted(os.listdir(target))
    libs = [n for n in names if n.endswith(".so")]
    assert len(libs) == 1, names
    assert not [n for n in names if n.endswith(".tmp")], names


def test_native_build_removes_older_revision_under_lock(tmp_path):
    target = tmp_path / "build"
    target.mkdir()
    stale = target / f"{tbuild._PREFIX}000000000000.so"
    stale.write_bytes(b"not a library")
    tbuild.open_library(str(target))
    names = os.listdir(target)
    assert stale.name not in names
    assert sum(n.endswith(".so") for n in names) == 1


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a build that fails raises."""
    monkeypatch.setattr(tbuild, "_FLAGS", tbuild._FLAGS + ["-no-such-flag"])
    with pytest.raises(RuntimeError, match="host library build failed"):
        tbuild.open_library(str(tmp_path / "bad"))


# ---------------------------------------------------------------------------
# BGZF, BAM, BAI: bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1000, 200_000])
def test_bgzf_bytes_equal(size):
    data = np.random.default_rng(size).integers(
        0, 7, size, dtype=np.uint8).tobytes()
    ct, tt = tbgzf.compress_with_table(data)
    cj, tj = jbgzf.compress_with_table(data)
    assert ct == cj and tt == tj
    assert tbgzf.decompress(ct) == data == jbgzf.decompress(cj)
    assert tbgzf.decompress_with_table(ct) == jbgzf.decompress_with_table(cj)


@pytest.mark.parametrize("paired", [False, True])
def test_bam_and_bai_bytes_equal(files, tmp_path, paired):
    """Both writers, and the index built from an existing file, give the
    same bytes."""
    t, j = files[("t", paired)], files[("j", paired)]
    with open(t, "rb") as a, open(j, "rb") as b:
        assert a.read() == b.read()
    rng = np.random.default_rng(3)
    recs = jsim.simulate_sample(rng, files["genes"], CHROM_LEN,
                                mean_reads_per_gene=40, paired=paired)
    out = {}
    for pkg, mod in (("t", tbam), ("j", jbam)):
        path = str(tmp_path / f"{pkg}.bam")
        mod.write_bam(path, ["chr1"], [CHROM_LEN], recs,
                      index_path=path + ".bai")
        with open(path, "rb") as f, open(path + ".bai", "rb") as g:
            out[pkg] = (f.read(), g.read())
    assert out["t"] == out["j"]
    tb, jb = tbai.index_bam(t), jbai.index_bam(j, j + ".jbai")
    with open(tb, "rb") as a, open(jb, "rb") as b:
        assert a.read() == b.read()


# ---------------------------------------------------------------------------
# read columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_read_columns_equal(files, paired, native):
    path = files[("t", paired)]
    ht, ct = tbam.read_bam(path, native=native)
    hj, cj = jbam.read_bam(path, native=False)
    assert ht.ref_names == hj.ref_names == ["chr1"]
    assert ht.ref_lengths == hj.ref_lengths
    _assert_columns_equal(ct, cj)
    assert (ct.pair_hash is not None) == native
    assert tbam.read_head_qnames(path, 50) == jbam.read_head_qnames(path, 50)
    h1, h2 = tbam.read_header(path), jbam.read_header(path)
    assert (h1.text, h1.ref_names, h1.ref_lengths) == \
        (h2.text, h2.ref_names, h2.ref_lengths)


def test_region_reads_equal(files, monkeypatch):
    path = files[("t", True)]
    bai_path = tbai.index_bam(path)
    for native in ("0", "1"):
        monkeypatch.setenv("DEGNORM_TPU_TORCH_NO_NATIVE", native)
        for beg, end in ((0, 1 << 29), (5_000, 30_000)):
            _, ct = tbam.read_bam_region(path, bai_path, 0, beg, end)
            _, cj = jbam.read_bam_region(path, bai_path, 0, beg, end)
            _assert_columns_equal(ct, cj)


def _parse_threads(blob, n_threads):
    lib = tbuild.load_library()
    data = tbuild.DnBamData()
    rc = lib.dn_parse_records(blob, len(blob), -1, 1, -(1 << 62), 1 << 62,
                              ctypes.byref(data), n_threads)
    if rc != 0:
        err = data.error.decode()
        lib.dn_free_bam(ctypes.byref(data))
        raise ValueError(err)
    return tbam._cols_from_native(data, lib)


def test_threaded_decode_equals_serial(tmp_path):
    """The threaded record decode (per-thread error flags) equals the serial
    decode and the Python decoder on a blob large enough to be split, and a
    truncated blob raises at any thread count."""
    rng = np.random.default_rng(8)
    genes = _genes(seed=8, n=40)
    recs = jsim.simulate_sample(rng, genes, 200_000,
                                mean_reads_per_gene=1100, paired=True)
    path = str(tmp_path / "big.bam")
    tbam.write_bam(path, ["chr1"], [200_000], recs)
    with open(path, "rb") as f:
        buf = tbgzf.decompress(f.read())
    _, off = tbam._parse_header(buf)
    blob = buf[off:]
    assert len(blob) >= 1 << 22          # the threaded decode's threshold
    one, eight = _parse_threads(blob, 1), _parse_threads(blob, 8)
    _assert_columns_equal(one, eight)
    np.testing.assert_array_equal(one.pair_hash, eight.pair_hash)
    _assert_columns_equal(one, jbam._parse_records(blob))
    for nt in (1, 8):
        with pytest.raises(ValueError, match="truncated"):
            _parse_threads(blob[:-5], nt)


# ---------------------------------------------------------------------------
# annotation, overlap, coverage, merge
# ---------------------------------------------------------------------------

def test_gtf_and_overlap_equal(files):
    et = tgtf.process_annotation(files["gtf"])
    ej = jgtf.process_annotation(files["gtf"])
    pd.testing.assert_frame_equal(et, ej)
    gdf = et[["chr", "gene", "gene_start", "gene_end"]].drop_duplicates()
    ot, oj = tov.overlap_structure(gdf), jov.overlap_structure(gdf)
    assert ot == oj
    assert ot["overlap_genes"] and ot["isolated_genes"]


def _annotation(gtf):
    exon_df = jgtf.process_annotation(gtf)
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    return exon_df, gene_df, jov.overlap_structure(gene_df)


@pytest.mark.parametrize("paired,compat", [
    (False, "reference"), (True, "reference"), (False, "strict")])
@pytest.mark.parametrize("reader_native", [True, False])
def test_chromosome_coverage_equal(files, paired, compat, reader_native):
    """Per-chromosome coverage and counts: the port's default path (the
    native kernel where it applies) and its numpy path equal the JAX
    package's numpy path on the same read columns, from either reader.
    Strict paired mode: test_strict_paired_union_is_per_pair."""
    exon_df, gene_df, ov = _annotation(files["gtf"])
    _, cols = tbam.read_bam(files[("t", paired)], native=reader_native)
    kw = dict(paired=paired, compat=compat)
    args = ("chr1", CHROM_LEN, gene_df, exon_df, ov)
    want = jcov.chromosome_coverage_read_counts(cols, *args, native=False,
                                                **kw)
    assert sum(want.read_counts.values()) > 0
    for native in (None, False):
        got = tcov.chromosome_coverage_read_counts(cols, *args, native=native,
                                                   n_threads=4, **kw)
        _assert_chrom_coverage_equal(got, want)


def _union_per_pair(starts, ends, pairs):
    """Plain loop: the union of each pair's segments, pair by pair."""
    out = []
    for p in np.unique(pairs):
        segs = sorted(zip(starts[pairs == p], ends[pairs == p]))
        cur = list(segs[0])
        for s, e in segs[1:]:
            if s > cur[1] + 1:
                out.append((p, *cur))
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        out.append((p, *cur))
    return out


def test_strict_paired_union_is_per_pair(files):
    """Strict mode merges each pair's mates into the union of their
    segments.  The port computes the union pair by pair, so its coverage
    does not depend on the order of the pairs (the pairing codes of the
    native reader's hash and of the Python reader's names order them
    differently).  The JAX package's running maximum crosses from one pair
    into the next (degnorm_tpu/io/coverage.py:262): its units and coverage
    change with that order, and this test records that they differ from the
    per-pair union."""
    exon_df, gene_df, ov = _annotation(files["gtf"])
    path = files[("t", True)]
    by_reader = {}
    for reader_native in (True, False):
        _, cols = tbam.read_bam(path, native=reader_native)
        seg_read, s, e, end_pos = tcov.read_match_segments(cols, "strict")
        keep = np.ones(len(cols), bool)
        if cols.pair_hash is not None:
            _, codes = np.unique(cols.pair_hash, return_inverse=True)
        else:
            codes, _ = pd.factorize(tcov.unpaired_qnames(cols.qnames))
        units = tcov.build_units(cols, seg_read, s, e, end_pos, keep, True,
                                 codes, "strict")
        # the plain loop on the same mates: pair k is (r1, r2) in units order
        live = np.argsort(codes, kind="stable")
        r1, r2 = live[0::2], live[1::2]
        rows = np.concatenate([r1, r2])
        owner = np.concatenate([np.arange(len(r1))] * 2)
        seg_of = [np.flatnonzero(seg_read == r) for r in rows]
        st = np.concatenate([s[i] for i in seg_of])
        en = np.concatenate([e[i] for i in seg_of])
        ow = np.concatenate([np.full(len(i), o) for i, o in zip(seg_of,
                                                               owner)])
        want = _union_per_pair(st, en, ow)
        got = list(zip(units.seg_unit, units.seg_start, units.seg_end))
        assert [tuple(map(int, g)) for g in got] == \
            [tuple(map(int, w)) for w in want]
        jun = jcov.build_units(cols, seg_read, s, e, end_pos, keep, True,
                               codes, "strict")
        assert len(jun.seg_start) < len(units.seg_start)
        by_reader[reader_native] = tcov.chromosome_coverage_read_counts(
            cols, "chr1", CHROM_LEN, gene_df, exon_df, ov, paired=True,
            compat="strict")
    _assert_chrom_coverage_equal(by_reader[True], by_reader[False])


def _single_end_columns(starts, lengths):
    """Single-end reads, one ``<length>M`` CIGAR each, in anchor order."""
    order = np.argsort(starts, kind="stable")
    starts, lengths = np.asarray(starts)[order], np.asarray(lengths)[order]
    n = len(starts)
    return tbam.ReadColumns(
        qnames=np.array([f"r{i}" for i in range(n)], dtype=object),
        tid=np.zeros(n, np.int32), pos=starts.astype(np.int32),
        flag=np.zeros(n, np.uint16), rnext=np.full(n, -1, np.int32),
        nh=np.ones(n, np.int32), cigar_ops=np.zeros(n, np.int8),
        cigar_lens=lengths.astype(np.int32),
        cigar_offsets=np.arange(n + 1, dtype=np.int64))


def test_coverage_kernel_wrap_cell_threads_bit_identical():
    """An overlap gene's last cell is written from two positions: its first
    base (index -1, wrapped) and the base after its last.  The reads are laid
    out so that at 8 threads the first thread's reads all start on gene A's
    first base and the last thread's all end one past A's last, so both
    would write that cell at once.  The kernel gives the serial result, and
    equals the numpy paths of both packages."""
    # gene A [10001, 12000] (1-based) overlaps gene B [11001, 12500], whose
    # exons [11001, 11100] and [12001, 12500] leave A's last read positions
    # to A alone; C is isolated further on
    rows = [("chr1", 10001, 12000, "A", 10001, 12000),
            ("chr1", 11001, 11100, "B", 11001, 12500),
            ("chr1", 12001, 12500, "B", 11001, 12500),
            ("chr1", 20001, 22000, "C", 20001, 22000)]
    exon_df = pd.DataFrame(rows, columns=["chr", "start", "end", "gene",
                                          "gene_start", "gene_end"])
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    ov = jov.overlap_structure(gene_df)
    assert ov["overlap_genes"] == [["A", "B"]]
    rng = np.random.default_rng(0)
    k = 6_000                                   # reads a thread at 8 threads
    tail_len = rng.integers(41, 102, k)         # end on 0-based 12000
    cols = _single_end_columns(
        np.concatenate([np.full(k, 10000), rng.integers(10100, 11800, 6 * k),
                        12001 - tail_len]),
        np.concatenate([np.full(7 * k, 40), tail_len]))
    args = ("chr1", 30_000, gene_df, exon_df, ov)
    kw = dict(paired=False, compat="reference")
    serial = tcov.chromosome_coverage_read_counts(cols, *args, native=True,
                                                  n_threads=1, **kw)
    want = jcov.chromosome_coverage_read_counts(cols, *args, native=False,
                                                **kw)
    _assert_chrom_coverage_equal(serial, want)
    _assert_chrom_coverage_equal(
        tcov.chromosome_coverage_read_counts(cols, *args, native=False, **kw),
        want)
    # the wrap cell holds every read of the first and the last thread
    assert serial.overlap_coverage["A"][-1] == 2 * k
    for _ in range(5):
        threaded = tcov.chromosome_coverage_read_counts(
            cols, *args, native=True, n_threads=8, **kw)
        _assert_chrom_coverage_equal(threaded, serial)


@pytest.mark.parametrize("paired", [False, True])
def test_sample_and_merge_equal(files, tmp_path, paired):
    """BamSampleProcessor, merge_read_counts and merge_coverage over a
    two-chromosome pair of samples."""
    from degnorm_tpu.pipeline.sample import BamSampleProcessor as JSample
    g1 = _genes(seed=21, n=6, chrom="chr1", prefix="a.")
    g2 = _genes(seed=22, n=5, chrom="chr2", prefix="b.")
    gtf = str(tmp_path / "mc.gtf")
    tsim.write_gtf(gtf, g1 + g2)
    lens = {"chr1": 40_000, "chr2": 40_000}
    bams = []
    for i in range(2):
        b = str(tmp_path / f"mc{i}.bam")
        tsim.write_multichrom_bam(b, {"chr1": g1, "chr2": g2}, lens,
                                  seed=40 + i, mean_reads_per_gene=80,
                                  paired=paired)
        bams.append(b)
    exon_df, gene_df, _ = _annotation(gtf)
    ov = {c: jov.overlap_structure(gene_df[gene_df.chr == c])
          for c in ("chr1", "chr2")}
    res_t, res_j = {}, {}
    for b in bams:
        st, sj = TSample(b, stream=False), JSample(b, stream=False)
        assert st.paired == sj.paired == paired
        res_t[st.sample_id] = st.coverage_read_counts(ov, gene_df, exon_df,
                                                      n_jobs=2)
        res_j[sj.sample_id] = sj.coverage_read_counts(ov, gene_df, exon_df)
    sids = list(res_t)
    for sid in sids:
        for c in ("chr1", "chr2"):
            _assert_chrom_coverage_equal(res_t[sid][c], res_j[sid][c])
    pd.testing.assert_frame_equal(
        tmerge.merge_read_counts(res_t, sids, ["chr1", "chr2"]),
        jmerge.merge_read_counts(res_j, sids, ["chr1", "chr2"]))
    ct = tmerge.merge_coverage(res_t, sids, exon_df)
    cj = jmerge.merge_coverage(res_j, sids, exon_df)
    assert list(ct) == list(cj)
    for g in ct:
        np.testing.assert_array_equal(ct[g], cj[g])


def test_cram_input_raises_not_implemented(tmp_path):
    """Once a refusal of .cram input, now its acceptance: the port's
    command on .cram files (CPU) leaves the JAX command's output directory
    (read counts and metadata byte-equal, coverage exactly equal, the fit
    within the command tests' tolerances), and the coverage of the .bam of
    the same reads."""
    from degnorm_tpu import cli as jcli
    from degnorm_tpu_torch import cli as tcli
    from tests.test_torch_pipeline import (FIT, _assert_fit_files_close,
                                           _pickle)
    from tests.torch_port_util import run_command, write_sim_dataset
    data = {}
    for fmt in ("bam", "cram"):
        (tmp_path / fmt).mkdir()
        data[fmt] = write_sim_dataset(tmp_path / fmt, fmt=fmt)
    runs = {}
    for name, main, fmt, extra in (("port", tcli.main, "cram",
                                    ["--device", "cpu"]),
                                   ("jax", jcli.main, "cram", []),
                                   ("port_bam", tcli.main, "bam",
                                    ["--device", "cpu"])):
        base = str(tmp_path / "out" / name)
        runs[name] = run_command(main, base, [
            "--bam-files", *data[fmt]["bams"], "-g", data[fmt]["gtf"],
            "-o", base, *FIT, *extra])
    port, jax = runs["port"], runs["jax"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax))
    for name in ("read_counts.csv", "gene_exon_metadata.csv"):
        for other in (jax, runs["port_bam"]):
            with open(os.path.join(port, name), "rb") as f, \
                    open(os.path.join(other, name), "rb") as g:
                assert f.read() == g.read(), name
    ct = _pickle(port, "chr1", "coverage_matrices")
    for other in (jax, runs["port_bam"]):
        co = _pickle(other, "chr1", "coverage_matrices")
        assert list(ct) == list(co)
        for g in ct:
            np.testing.assert_array_equal(ct[g], co[g])
    _assert_fit_files_close(port, jax)
