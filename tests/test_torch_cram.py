"""PyTorch port, CRAM input: ``degnorm_tpu_torch/io/rans.py``,
``io/cram.py``, ``io/cram_fast.py`` and the host library's
``rans_kernel.cpp`` against the JAX package's copies, on records made with
numpy from a seed.  Tolerance: exact equality throughout (payload and file
bytes, decoded columns, coverage).

The JAX side runs on its Python paths (DEGNORM_TPU_NO_NATIVE=1: the Python
rANS decoder and the per-record slice decoder), so that its host-library
build, which is not safe across processes (ROADMAP Queue 3), cannot move
these tests.  The port is held on both its native paths (the rANS kernel,
the vectorized slice decoder over dn_itf8_scan) and its Python ones.
The unusual files are the forged ones of tests/test_cram_adversarial.py.
"""
import numpy as np
import pytest

from degnorm_tpu.io import cram as jcram
from degnorm_tpu.io import rans as jrans
from degnorm_tpu_torch.io import bam as tbam
from degnorm_tpu_torch.io import cram as tcram
from degnorm_tpu_torch.io import cram_fast as tfast
from degnorm_tpu_torch.io import rans as trans
from degnorm_tpu_torch.io import simulate as tsim
from tests import test_cram_adversarial as forge
from tests.test_cram import _RECS, _REFS, _LENS, _random_records

COLUMNS = ("tid", "pos", "flag", "rnext", "nh", "cigar_ops", "cigar_lens",
           "cigar_offsets")
CHROM_LEN = 80_000


@pytest.fixture(scope="module", autouse=True)
def _jax_on_python_paths():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEGNORM_TPU_NO_NATIVE", "1")
        yield


def _assert_columns_equal(got, want, qnames=True):
    assert len(got) == len(want)
    for f in COLUMNS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    if qnames:
        assert list(np.asarray(got.qnames)) == list(np.asarray(want.qnames))


# ---------------------------------------------------------------------------
# rANS 4x8
# ---------------------------------------------------------------------------

def _rans_payloads():
    rng = np.random.default_rng(0)
    cases = [
        b"", b"x", b"ab", b"abc", b"\x00" * 1000,
        bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
        bytes(rng.integers(65, 68, 9999, dtype=np.uint8)),
        bytes((rng.pareto(0.5, 5000) % 256).astype(np.uint8)),
        bytes(np.arange(256, dtype=np.uint8)) * 3,
        bytes(range(250, 256)) * 11,
    ]
    rare = np.arange(200, dtype=np.uint8)       # rare symbols bumped to 1
    common = rng.integers(200, 256, 16_184, dtype=np.uint8)
    cases.append(bytes(np.concatenate([rare, common])[
        rng.permutation(16_384)]))
    for _ in range(12):
        n, k = int(rng.integers(0, 3000)), int(rng.integers(1, 256))
        cases.append(bytes(rng.integers(0, k, n, dtype=np.uint8)))
    return cases


@pytest.mark.parametrize("order", [0, 1])
def test_rans_roundtrip_native_python_jax(order):
    """Order-0/1 payloads: the port's encoder writes the JAX encoder's
    bytes; the native and the Python decoders of the port and the JAX
    decoder all return the data."""
    for data in _rans_payloads():
        enc = trans.compress(data, order=order)
        assert enc == jrans.compress(data, order=order)
        assert trans.uncompress(enc, native=True) == data
        assert trans.uncompress(enc, native=False) == data
        assert jrans.uncompress(enc, native=False) == data


def test_rans_corruption_same_verdict_native_python():
    """On a corrupted stream the native and the Python decoders agree:
    the same bytes, or both raise."""
    rng = np.random.default_rng(13)

    def run(payload, native):
        try:
            return trans.uncompress(payload, native=native)
        except ValueError:
            return ("ERR",)

    n_bad = 0
    for t in range(30):
        data = bytes(rng.integers(0, int(rng.integers(1, 256)),
                                  int(rng.integers(30, 4000)),
                                  dtype=np.uint8))
        bad = bytearray(trans.compress(data, order=t % 2))
        bad[int(rng.integers(20, len(bad)))] ^= int(rng.integers(1, 256))
        got = run(bytes(bad), True)
        assert got == run(bytes(bad), False)
        n_bad += got == ("ERR",)
    assert n_bad > 0


@pytest.mark.parametrize("native", [True, False])
def test_rans_truncation_detected(native):
    enc = trans.compress(b"hello world" * 50, order=0)
    for cut in (enc[:8], enc[:-10]):
        with pytest.raises(ValueError):
            trans.uncompress(cut, native=native)


# ---------------------------------------------------------------------------
# primitives: varints, encodings, the native ITF8 scan
# ---------------------------------------------------------------------------

ITF8 = [0, 1, 127, 128, 5000, 1 << 13, (1 << 14) - 1, 1 << 14,
        (1 << 21) - 1, 1 << 21, (1 << 28) - 1, 1 << 28, (1 << 31) - 1, -1,
        -2, -(1 << 31), 4_542_278]
LTF8 = [0, 1, 127, 128, (1 << 14) - 1, 1 << 20, 1 << 31, 1 << 40, 1 << 50,
        (1 << 63) - 1, -1]


@pytest.mark.parametrize("kind", ["itf8", "ltf8"])
def test_varints_match_jax(kind):
    vals = ITF8 if kind == "itf8" else LTF8
    for v in vals:
        tb, jb = bytearray(), bytearray()
        getattr(tcram, f"write_{kind}")(tb, v)
        getattr(jcram, f"write_{kind}")(jb, v)
        assert tb == jb, v
        got, off = getattr(tcram, f"read_{kind}")(bytes(tb), 0)
        assert got == v and off == len(tb), v


def test_itf8_scan_matches_python_reader():
    """dn_itf8_scan over a whole block equals read_itf8 value by value; a
    block cut inside a value is refused (the slice is then declined)."""
    buf = bytearray()
    for v in ITF8 * 3:
        tcram.write_itf8(buf, v)
    want, off = [], 0
    while off < len(buf):
        v, off = tcram.read_itf8(bytes(buf), off)
        want.append(v)
    got = tfast._scan_itf8(bytes(buf))
    assert got.tolist() == want
    assert tfast._scan_itf8(bytes(buf[:-1])) is None


def _huffman(p, syms, lens):
    tcram.write_itf8(p, len(syms))
    for s in syms:
        tcram.write_itf8(p, s)
    tcram.write_itf8(p, len(lens))
    for ln in lens:
        tcram.write_itf8(p, ln)


def _encoding_cases():
    """(codec, params, core bits [(value, nbits)], external blocks, reads,
    expected values) of each encoding the reader implements."""
    beta, gamma, const, multi, bal = (bytearray() for _ in range(5))
    tcram.write_itf8(beta, 10)
    tcram.write_itf8(beta, 6)
    tcram.write_itf8(gamma, 0)
    _huffman(const, [-1], [0])
    _huffman(multi, [5, 6, 7], [1, 2, 2])
    lp, vp = bytearray(), bytearray()
    _huffman(lp, [4], [0])
    tcram.write_itf8(vp, 9)
    tcram._write_encoding(bal, tcram.E_HUFFMAN, bytes(lp))
    tcram._write_encoding(bal, tcram.E_EXTERNAL, bytes(vp))
    return {
        "beta": (tcram.E_BETA, beta, [(12, 6), (0, 6), (63, 6)], {}, "int",
                 [2, -10, 53]),
        "gamma": (tcram.E_GAMMA, gamma, [(1, 1), (2, 3), (5, 5)], {}, "int",
                  [1, 2, 5]),
        "huffman_const": (tcram.E_HUFFMAN, const, [], {}, "int",
                          [-1, -1, -1]),
        "huffman": (tcram.E_HUFFMAN, multi,
                    [(0, 1), (2, 2), (3, 2), (0, 1), (3, 2)], {}, "int",
                    [5, 6, 7, 5, 7]),
        "byte_array_len": (tcram.E_BYTE_ARRAY_LEN, bal, [],
                           {9: b"abcdWXYZ"}, "array", [b"abcd", b"WXYZ"]),
    }


@pytest.mark.parametrize("name", sorted(_encoding_cases()))
def test_encodings_match_jax(name):
    codec, params, bits, ext, kind, want = _encoding_cases()[name]
    out = {}
    for pkg in (tcram, jcram):
        enc = pkg.Encoding(codec, bytes(params))
        bw = pkg.BitWriter()
        for v, n in bits:
            bw.write(v, n)
        core = pkg.BitReader(bw.getvalue())
        blocks = {k: pkg._Ext(v) for k, v in ext.items()}
        read = enc.read_int if kind == "int" else enc.read_array
        out[pkg] = [read(core, blocks) for _ in want]
    assert out[tcram] == out[jcram] == want
    with pytest.raises(ValueError, match="GOLOMB"):
        tcram.Encoding(tcram.E_GOLOMB, b"\x00\x00")


# ---------------------------------------------------------------------------
# the writer and the reader on write_cram fixtures
# ---------------------------------------------------------------------------

def _sim_records(seed, paired, n_genes=8):
    genes = tsim.make_genes(np.random.default_rng(seed), n_genes=n_genes,
                            overlap_fraction=0.3)
    return tsim.simulate_sample(np.random.default_rng(seed + 1), genes,
                                CHROM_LEN, paired=paired,
                                mean_reads_per_gene=80, degradation=0.4)


FIXTURES = {
    "table": lambda: (_RECS, {}),
    "table_unnamed": lambda: (_RECS, dict(preserve_names=False)),
    "table_abs_pos": lambda: (_RECS, dict(ap_delta=False)),
    "table_slices": lambda: (_RECS, dict(records_per_slice=2)),
    "table_linked": lambda: (_RECS, dict(link_mates=True)),
    "chains": lambda: ([("c", 0, 100, 0x1, "30M", 1, 1),
                        ("c", 1, 200, 0x1, "30M", 0, 1),
                        ("c", 1, 300, 0x1 | 0x10, "30M", 1, 1),
                        ("pair", 0, 400, 0x1, "20M", 0, 1),
                        ("pair", 0, 480, 0x1 | 0x10, "20M", 0, 1),
                        ("solo", 0, 600, 0x0, "20M", -1, 1)],
                       dict(link_mates=True, preserve_names=False)),
    "random": lambda: (_random_records(np.random.default_rng(99), 300),
                       dict(records_per_slice=37, link_mates=True)),
    "single": lambda: (_sim_records(3, False), {}),
    "paired": lambda: (_sim_records(5, True),
                       dict(records_per_slice=512)),
}


def _write_both(tmp_path, name, compression):
    recs, kw = FIXTURES[name]()
    refs = ["chr1", "chr2"]
    lens = [CHROM_LEN, CHROM_LEN]
    tp, jp = str(tmp_path / "t.cram"), str(tmp_path / "j.cram")
    tcram.write_cram(tp, refs, lens, recs, compression=compression, **kw)
    jcram.write_cram(jp, refs, lens, recs, compression=compression, **kw)
    return recs, tp, jp


@pytest.mark.parametrize("compression", ["raw", "gzip", "rans"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_writer_bytes_and_reader_columns_match_jax(tmp_path, name,
                                                   compression):
    """The port's write_cram writes the JAX writer's bytes; the port's
    read_cram on them (fast and per-record slice decoder, native and
    Python rANS) gives the JAX reader's columns, single and paired, linked
    mates and NF chains included, with unmapped reads kept or dropped."""
    recs, tp, jp = _write_both(tmp_path, name, compression)
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    for drop in (True, False):
        jh, want = jcram.read_cram(jp, drop_unmapped=drop)
        for fast in (True, False):
            th, got = tcram.read_cram(tp, drop_unmapped=drop, fast=fast)
            assert th.text == jh.text and th.ref_names == jh.ref_names
            _assert_columns_equal(got, want)
    assert len(want) == len(recs) and len(want) > 0


def test_python_rans_and_per_record_decoder_under_no_native(tmp_path,
                                                            monkeypatch):
    """DEGNORM_TPU_TORCH_NO_NATIVE=1 takes the Python rANS decoder and
    the per-record slice decoder, with the same columns."""
    _, tp, jp = _write_both(tmp_path, "paired", "rans")
    _, want = jcram.read_cram(jp)
    calls = {"n": 0}
    monkeypatch.setattr(trans, "_uncompress_native",
                        lambda *a: calls.__setitem__("n", 1))
    monkeypatch.setenv("DEGNORM_TPU_TORCH_NO_NATIVE", "1")
    before = tfast.declined
    _, got = tcram.read_cram(tp)
    _assert_columns_equal(got, want)
    assert calls["n"] == 0 and tfast.declined == before
    assert got.pair_hash is None


def test_fast_path_engages_and_fills_pairing_columns(tmp_path):
    """The writer's profile takes the vectorized decoder on every slice
    (the decline counter does not move), and its pairing columns equal the
    native BAM reader's on the same records."""
    recs, _ = FIXTURES["paired"]()
    cp, bp = str(tmp_path / "p.cram"), str(tmp_path / "p.bam")
    tcram.write_cram(cp, ["chr1"], [CHROM_LEN], recs, records_per_slice=300)
    tbam.write_bam(bp, ["chr1"], [CHROM_LEN], recs)
    before = tfast.declined
    _, cc = tcram.read_cram(cp)
    assert tfast.declined == before
    _, bc = tbam.read_bam(bp)
    _assert_columns_equal(cc, bc)
    np.testing.assert_array_equal(cc.pair_hash, bc.pair_hash)
    np.testing.assert_array_equal(cc.mate_code, bc.mate_code)


def test_region_streaming_and_head_qnames_match(tmp_path):
    """read_cram_region equals the whole-file decode filtered to the tid,
    multi-ref boundary slices included; read_cram_head_qnames equals the
    JAX function."""
    recs = sorted(_random_records(np.random.default_rng(17), 150),
                  key=lambda r: (r[1], r[2]))
    cp = str(tmp_path / "mc.cram")
    tcram.write_cram(cp, _REFS, _LENS, recs, records_per_slice=16)
    _, whole = tcram.read_cram(cp, drop_unmapped=False)
    for tid in (0, 1):
        region = tcram.read_cram_region(cp, tid, drop_unmapped=False)
        _assert_columns_equal(region, tcram._filter_columns(
            whole, tid=tid, drop_unmapped=False))
        _assert_columns_equal(region, jcram.read_cram_region(
            cp, tid, drop_unmapped=False))
    for n in (10, 999):
        assert tcram.read_cram_head_qnames(cp, n) == \
            jcram.read_cram_head_qnames(cp, n)
    assert tcram.read_cram_header(cp).text == jcram.read_cram_header(cp).text


# ---------------------------------------------------------------------------
# unusual and bad input: the forged files of tests/test_cram_adversarial.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["core", "embedded_ref", "multislice"])
@pytest.mark.parametrize("fast", [True, False])
def test_forged_files_decode_to_the_jax_columns(variant, fast):
    """Core-bitstream encodings, an embedded reference block and several
    slices a container (uneven) decode to the JAX reader's columns on
    both slice decoders.  The fast decoder declines every forged slice
    (series on the core bit stream; no NF encoding in the multi-slice
    header), and the decline counter counts each."""
    recs = forge._records(n=61, seed=9)
    buf = forge._forge_file(variant, recs)
    _, want = jcram.parse_cram_bytes(buf, fast=False)
    before = tfast.declined
    _, got = tcram.parse_cram_bytes(buf, fast=fast)
    _assert_columns_equal(got, want)
    slices = 3 if variant == "multislice" else 1
    assert tfast.declined - before == (slices if fast else 0)


@pytest.mark.parametrize("variant", ["core", "multislice"])
@pytest.mark.parametrize("fast", [True, False])
def test_corruption_raises(variant, fast):
    """A flipped byte inside the data container raises in the port (CRC32
    or structure), or decodes to the right columns; never to wrong ones."""
    recs = forge._records(n=20)
    buf = forge._forge_file(variant, recs)
    _, want = jcram.parse_cram_bytes(buf, fast=False)
    start = len(forge._sam_header_container(["chr1"], [10_000])) + 20
    stop = len(buf) - len(forge._eof_container())
    rng = np.random.default_rng(0)
    raised = 0
    for pos in rng.choice(np.arange(start, stop), size=30, replace=False):
        mut = bytearray(buf)
        mut[pos] ^= 0xFF
        try:
            _, got = tcram.parse_cram_bytes(bytes(mut), fast=fast)
        except Exception:
            raised += 1
            continue
        _assert_columns_equal(got, want)
    assert raised >= 25


# ---------------------------------------------------------------------------
# the sample processor on .cram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paired", [False, True])
def test_sample_processor_cram_equals_bam(tmp_path, paired):
    """BamSampleProcessor on a .cram (whole-file and container streaming)
    gives the coverage and counts of the same processor on the .bam of
    the same records, and of the JAX processor on the .cram."""
    from degnorm_tpu.pipeline.sample import BamSampleProcessor as JSample
    from degnorm_tpu_torch.io.gtf import process_annotation
    from degnorm_tpu_torch.io.overlap import overlap_structure
    from degnorm_tpu_torch.pipeline.sample import BamSampleProcessor

    genes = tsim.make_genes(np.random.default_rng(5), n_genes=6,
                            overlap_fraction=0.3)
    gtf = str(tmp_path / "g.gtf")
    tsim.write_gtf(gtf, genes)
    bp, cp = str(tmp_path / "s.bam"), str(tmp_path / "s.cram")
    kw = dict(seed=21, paired=paired, mean_reads_per_gene=100,
              degradation=0.3)
    tsim.write_sample_bam(bp, genes, CHROM_LEN, **kw)
    tsim.write_sample_cram(cp, genes, CHROM_LEN, **kw)
    exon_df = process_annotation(gtf)
    gene_df = exon_df[["chr", "gene", "gene_start", "gene_end"]
                      ].drop_duplicates().reset_index(drop=True)
    ov = {"chr1": overlap_structure(gene_df[gene_df.chr == "chr1"])}
    runs = [BamSampleProcessor(bp), BamSampleProcessor(cp),
            BamSampleProcessor(cp, stream=True), JSample(cp)]
    assert [r.paired for r in runs] == [paired] * 4
    assert runs[2].stream and not runs[1].stream
    out = [r.coverage_read_counts(ov, gene_df, exon_df)["chr1"]
           for r in runs]
    want = out[0]
    assert sum(want.read_counts.values()) > 0
    for got in out[1:]:
        assert got.read_counts == want.read_counts
        if want.isolated_coverage is not None:
            np.testing.assert_array_equal(got.isolated_coverage,
                                          want.isolated_coverage)
        assert set(got.overlap_coverage) == set(want.overlap_coverage)
        for g in want.overlap_coverage:
            np.testing.assert_array_equal(got.overlap_coverage[g],
                                          want.overlap_coverage[g])
