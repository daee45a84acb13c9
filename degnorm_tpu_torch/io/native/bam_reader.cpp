// Native BAM reader: BGZF inflate + record decode into columnar arrays.
//
// Replacement for the reference's pysam/htslib dependency
// (reference loaders.py:64-70, reads.py:223-245; SURVEY.md §2.3): the
// data-loader is the one genuinely native component of the DegNorm
// pipeline.  Decompression is parallelized across BGZF blocks (each block
// is an independent raw-deflate member); record decode is a single linear
// pass emitting the same columnar layout io/bam.py::ReadColumns uses, so
// the Python ctypes wrapper (io/bam.py) is a drop-in fast path.
//
// C ABI only — consumed via ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

struct Block {
    size_t comp_off;    // offset of deflate payload in file buffer
    size_t comp_len;
    size_t out_off;     // offset in decompressed stream
    size_t out_len;     // ISIZE
};

bool scan_blocks(const uint8_t* buf, size_t n, std::vector<Block>& blocks,
                 size_t& total_out) {
    size_t off = 0;
    total_out = 0;
    while (off + 18 <= n) {
        if (buf[off] != 0x1f || buf[off + 1] != 0x8b) return false;
        uint16_t xlen;
        memcpy(&xlen, buf + off + 10, 2);
        size_t extra = off + 12;
        int32_t bsize = -1;
        size_t i = 0;
        while (i + 4 <= xlen) {
            uint8_t si1 = buf[extra + i], si2 = buf[extra + i + 1];
            uint16_t slen;
            memcpy(&slen, buf + extra + i + 2, 2);
            if (si1 == 66 && si2 == 67 && slen == 2) {
                uint16_t bs;
                memcpy(&bs, buf + extra + i + 4, 2);
                bsize = (int32_t)bs + 1;
                break;
            }
            i += 4 + slen;
        }
        if (bsize < 0) return false;
        size_t cdata_off = extra + xlen;
        size_t cdata_len = (size_t)bsize - 12 - xlen - 8;
        uint32_t isize;
        memcpy(&isize, buf + off + bsize - 4, 4);
        blocks.push_back({cdata_off, cdata_len, total_out, isize});
        total_out += isize;
        off += bsize;
    }
    return off == n;
}

bool inflate_block(const uint8_t* src, size_t src_len, uint8_t* dst,
                   size_t dst_len) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return false;
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = (uInt)src_len;
    zs.next_out = dst;
    zs.avail_out = (uInt)dst_len;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END && zs.total_out == dst_len;
}

template <typename T>
T rd(const uint8_t* p) {
    T v;
    memcpy(&v, p, sizeof(T));
    return v;
}

// FNV-1a hash of the query name up to (excluding) its last '.', plus a
// mate-suffix code: 1 for ".1", 2 for ".2", 0 otherwise.  Groups paired
// reads without host-side string processing (reference reads.py:258
// groups by the string prefix; a 64-bit hash is collision-safe at any
// realistic read count).
uint64_t pair_hash_and_suffix(const char* q, size_t len, int8_t* suffix) {
    size_t dot = len;
    for (size_t i = len; i > 0; i--) {
        if (q[i - 1] == '.') { dot = i - 1; break; }
    }
    *suffix = 0;
    if (dot + 2 == len) {
        if (q[dot + 1] == '1') *suffix = 1;
        else if (q[dot + 1] == '2') *suffix = 2;
    }
    // no dot: the reference's prefix is the empty string (reads.py:258
    // with str.split) — hash nothing so all dotless names group together
    size_t n = (dot == len) ? 0 : dot;
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; i++) {
        h ^= (uint8_t)q[i];
        h *= 1099511628211ull;
    }
    return h;
}

// scan aux fields for NH:i (any integer subtype); 0 when absent
int32_t parse_nh(const uint8_t* p, const uint8_t* end) {
    while (p + 3 <= end) {
        char t0 = (char)p[0], t1 = (char)p[1];
        uint8_t vt = p[2];
        p += 3;
        int size = 0;
        switch (vt) {
            case 'A': case 'c': case 'C': size = 1; break;
            case 's': case 'S': size = 2; break;
            case 'i': case 'I': case 'f': size = 4; break;
            case 'Z': case 'H': {
                while (p < end && *p) p++;
                p++;
                continue;
            }
            case 'B': {
                if (p + 5 > end) return 0;
                uint8_t sub = p[0];
                uint32_t cnt = rd<uint32_t>(p + 1);
                int esz = (sub == 'c' || sub == 'C') ? 1
                          : (sub == 's' || sub == 'S') ? 2 : 4;
                p += 5 + (size_t)cnt * esz;
                continue;
            }
            default: return 0;
        }
        if (t0 == 'N' && t1 == 'H') {
            switch (vt) {
                case 'c': return (int32_t)rd<int8_t>(p);
                case 'C': return (int32_t)rd<uint8_t>(p);
                case 's': return (int32_t)rd<int16_t>(p);
                case 'S': return (int32_t)rd<uint16_t>(p);
                case 'i': return rd<int32_t>(p);
                case 'I': return (int32_t)rd<uint32_t>(p);
                default: break;
            }
        }
        p += size;
    }
    return 0;
}

}  // namespace

extern "C" {

struct DnBamData {
    // alignment columns
    int64_t n_reads;
    int32_t* tid;
    int32_t* pos;
    uint16_t* flag;
    int32_t* rnext;
    int32_t* nh;
    int8_t* cigar_ops;
    int32_t* cigar_lens;
    int64_t* cigar_offsets;   // n_reads + 1
    char* qnames;             // concatenated, NUL-separated
    int64_t* qname_offsets;   // n_reads + 1
    uint64_t* pair_hash;      // hash of qname sans trailing ".x"
    int8_t* mate_code;        // 1 for ".1", 2 for ".2", 0 otherwise
    // header
    int32_t n_refs;
    char* ref_names;          // concatenated, NUL-separated
    int64_t ref_names_bytes;
    int32_t* ref_lens;
    char* error;              // NULL on success
};

static char* dup_err(const std::string& msg) {
    char* e = (char*)malloc(msg.size() + 1);
    memcpy(e, msg.c_str(), msg.size() + 1);
    return e;
}

int dn_parse_records(const uint8_t* p, int64_t len, int32_t tid_filter,
                     int drop_unmapped, int64_t pos_min, int64_t pos_max,
                     DnBamData* out, int n_threads);

// Batch pairing hash over names stored in one concatenated buffer
// (byte offsets + lengths per name) — lets non-BAM decoders (CRAM) fill
// the pair_hash/mate_code columns without per-name Python work, so the
// native coverage kernel's paired path stays available for them.
void dn_pair_hash(const uint8_t* buf, const int64_t* starts,
                  const int64_t* lens, int64_t n,
                  uint64_t* out_hash, int8_t* out_mate) {
    for (int64_t i = 0; i < n; i++)
        out_hash[i] = pair_hash_and_suffix(
            (const char*)buf + starts[i], (size_t)lens[i], out_mate + i);
}

void dn_free_bam(DnBamData* d) {
    if (!d) return;
    free(d->tid); free(d->pos); free(d->flag); free(d->rnext); free(d->nh);
    free(d->cigar_ops); free(d->cigar_lens); free(d->cigar_offsets);
    free(d->qnames); free(d->qname_offsets);
    free(d->pair_hash); free(d->mate_code);
    free(d->ref_names); free(d->ref_lens);
    free(d->error);
    memset(d, 0, sizeof(*d));
}

// tid_filter: -1 = all reference sequences. drop_unmapped: skip FLAG&4.
int dn_read_bam(const char* path, int32_t tid_filter, int drop_unmapped,
                int n_threads, DnBamData* out) {
    memset(out, 0, sizeof(*out));

    FILE* f = fopen(path, "rb");
    if (!f) { out->error = dup_err("cannot open file"); return 1; }
    fseek(f, 0, SEEK_END);
    long fsize = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> raw((size_t)fsize);
    if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
        fclose(f);
        out->error = dup_err("short read");
        return 1;
    }
    fclose(f);

    // ---- parallel BGZF inflate ----
    std::vector<Block> blocks;
    size_t total_out = 0;
    if (!scan_blocks(raw.data(), raw.size(), blocks, total_out)) {
        out->error = dup_err("malformed BGZF stream");
        return 1;
    }
    std::vector<uint8_t> buf(total_out);
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    nt = std::min<int>(nt, (int)blocks.size() ? (int)blocks.size() : 1);
    std::vector<std::thread> threads;
    std::vector<int> errs(nt, 0);
    for (int t = 0; t < nt; t++) {
        threads.emplace_back([&, t]() {
            for (size_t b = t; b < blocks.size(); b += nt) {
                const Block& blk = blocks[b];
                if (blk.out_len == 0) continue;
                if (!inflate_block(raw.data() + blk.comp_off, blk.comp_len,
                                   buf.data() + blk.out_off, blk.out_len))
                    errs[t] = 1;
            }
        });
    }
    for (auto& th : threads) th.join();
    for (int e : errs)
        if (e) { out->error = dup_err("BGZF inflate failed"); return 1; }
    raw.clear();
    raw.shrink_to_fit();

    // ---- header ----
    const uint8_t* p = buf.data();
    const uint8_t* end = p + buf.size();
    if (buf.size() < 12 || memcmp(p, "BAM\1", 4) != 0) {
        out->error = dup_err("bad BAM magic");
        return 1;
    }
    int32_t l_text = rd<int32_t>(p + 4);
    p += 8 + l_text;
    int32_t n_ref = rd<int32_t>(p);
    p += 4;
    std::string ref_names;
    std::vector<int32_t> ref_lens(n_ref);
    for (int32_t i = 0; i < n_ref; i++) {
        int32_t l_name = rd<int32_t>(p);
        ref_names.append((const char*)(p + 4), (size_t)l_name);  // incl NUL
        ref_lens[i] = rd<int32_t>(p + 4 + l_name);
        p += 8 + l_name;
    }

    int rc = dn_parse_records(p, (int64_t)(end - p), tid_filter,
                              drop_unmapped, INT64_MIN, INT64_MAX, out,
                              n_threads);
    if (rc != 0) return rc;

    out->n_refs = n_ref;
    out->ref_names = (char*)malloc(ref_names.size());
    memcpy(out->ref_names, ref_names.data(), ref_names.size());
    out->ref_names_bytes = (int64_t)ref_names.size();
    out->ref_lens = (int32_t*)malloc(ref_lens.size() * sizeof(int32_t));
    memcpy(out->ref_lens, ref_lens.data(),
           ref_lens.size() * sizeof(int32_t));
    return 0;
}

// Decode a headerless inflated record blob (e.g. a BAI region fetch that
// starts exactly on a record boundary) into the columnar layout.  Record
// columns only — header fields of ``out`` stay zero.  ``pos_min``/
// ``pos_max``: keep records with pos in [pos_min, pos_max).
//
// THREADED, two-pass: a cheap serial boundary scan (block_size
// hops) collects split points; pass A counts each interval's kept
// records/cigar-ops/qname-bytes; outputs are allocated EXACTLY once and
// pass B decodes every interval directly into its final slice.  No
// staging buffers, no merge copy (the decode is memory-bound and staging
// would double the traffic).  Record order is
// preserved, so output is byte-identical at any thread count.
namespace {

// Pass A: sizes only (kept records, cigar ops, qname bytes) — header
// loads only, payload untouched.
struct RangeSizes {
    int64_t n = 0, cig = 0, qn = 0;
    bool error = false;
};

void count_range(const uint8_t* p, const uint8_t* end, int32_t tid_filter,
                 int drop_unmapped, int64_t pos_min, int64_t pos_max,
                 RangeSizes& rs) {
    while (p + 4 <= end) {
        int32_t block_size = rd<int32_t>(p);
        const uint8_t* r = p + 4;
        p = r + block_size;
        if (p > end) { rs.error = true; return; }
        int32_t refID = rd<int32_t>(r);
        int32_t pos = rd<int32_t>(r + 4);
        uint8_t l_read_name = r[8];
        uint16_t n_cigar = rd<uint16_t>(r + 12);
        uint16_t flag = rd<uint16_t>(r + 14);
        if (tid_filter >= 0 && refID != tid_filter) continue;
        if (drop_unmapped && (flag & 0x4)) continue;
        if ((int64_t)pos < pos_min || (int64_t)pos >= pos_max) continue;
        rs.n++;
        rs.cig += n_cigar;
        rs.qn += l_read_name;
    }
}

// Pass B: decode directly into the final output buffers at given bases —
// no staging, no merge copy (the decode is memory-bound; staging doubled
// the traffic).
void decode_range_into(const uint8_t* p, const uint8_t* end,
                       int32_t tid_filter, int drop_unmapped,
                       int64_t pos_min, int64_t pos_max, DnBamData* out,
                       int64_t r0, int64_t c0, int64_t q0, bool* err) {
    int64_t ri = r0, ci = c0, qi = q0;
    while (p + 4 <= end) {
        int32_t block_size = rd<int32_t>(p);
        const uint8_t* r = p + 4;
        p = r + block_size;
        if (p > end) { *err = true; return; }
        int32_t refID = rd<int32_t>(r);
        int32_t pos = rd<int32_t>(r + 4);
        uint8_t l_read_name = r[8];
        uint16_t n_cigar = rd<uint16_t>(r + 12);
        uint16_t flag = rd<uint16_t>(r + 14);
        int32_t l_seq = rd<int32_t>(r + 16);
        int32_t next_refID = rd<int32_t>(r + 20);
        if (tid_filter >= 0 && refID != tid_filter) continue;
        if (drop_unmapped && (flag & 0x4)) continue;
        if ((int64_t)pos < pos_min || (int64_t)pos >= pos_max) continue;

        const uint8_t* q = r + 32;
        memcpy(out->qnames + qi, q, l_read_name);   // includes NUL
        qi += l_read_name;
        out->qname_offsets[ri + 1] = qi;
        int8_t suffix = 0;
        out->pair_hash[ri] = pair_hash_and_suffix(
            (const char*)q, (size_t)l_read_name - 1, &suffix);
        out->mate_code[ri] = suffix;
        q += l_read_name;
        for (uint16_t c = 0; c < n_cigar; c++) {
            uint32_t v = rd<uint32_t>(q + 4ull * c);
            out->cigar_ops[ci + c] = (int8_t)(v & 0xF);
            out->cigar_lens[ci + c] = (int32_t)(v >> 4);
        }
        ci += n_cigar;
        out->cigar_offsets[ri + 1] = ci;
        q += 4ull * n_cigar;
        const uint8_t* aux = q + (l_seq + 1) / 2 + l_seq;
        out->nh[ri] = parse_nh(aux, r + block_size);

        out->tid[ri] = refID;
        out->pos[ri] = pos;
        out->flag[ri] = flag;
        out->rnext[ri] = next_refID;
        ri++;
    }
}

}  // namespace

int dn_parse_records(const uint8_t* p, int64_t len, int32_t tid_filter,
                     int drop_unmapped, int64_t pos_min, int64_t pos_max,
                     DnBamData* out, int n_threads) {
    const uint8_t* end = p + len;
    int nt = n_threads;
    if (nt <= 0) nt = (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (len < (int64_t)(1 << 22)) nt = 1;   // small blobs: skip the scan

    std::vector<const uint8_t*> splits{p};
    if (nt > 1) {   // nt == 1: one interval [p, end), no boundary scan
        // serial boundary scan: record-boundary split points every ~1/64
        // of the blob (block_size hops only — ~1 load per record)
        int64_t stride = len / 64;
        const uint8_t* q = p;
        int64_t next_mark = stride;
        while (q + 4 <= end) {
            int32_t bs = rd<int32_t>(q);
            const uint8_t* r = q + 4 + bs;
            if (r > end) { out->error = dup_err("truncated record"); return 1; }
            if (r - p >= next_mark && r + 4 <= end) {
                splits.push_back(r);
                next_mark = (r - p) + stride;
            }
            q = r;
        }
        nt = std::min<int>(nt, (int)splits.size());
    }
    splits.push_back(end);

    // ---- two-pass threaded decode: pass A counts per interval, outputs
    // are allocated EXACTLY once, pass B writes in place (no staging,
    // no merge copy — the decode is memory-bound) ----
    int n_iv = (int)splits.size() - 1;
    std::vector<RangeSizes> sizes((size_t)nt);
    {
        std::vector<std::thread> ths;
        for (int t = 0; t < nt; t++) {
            int a = n_iv * t / nt, b = n_iv * (t + 1) / nt;
            ths.emplace_back([&, a, b, t]() {
                count_range(splits[a], splits[b], tid_filter,
                            drop_unmapped, pos_min, pos_max, sizes[t]);
            });
        }
        for (auto& th : ths) th.join();
    }
    for (auto& rs : sizes)
        if (rs.error) { out->error = dup_err("truncated record"); return 1; }

    int64_t n_total = 0, cig_total = 0, qn_total = 0;
    std::vector<int64_t> rb(nt), cb(nt), qb(nt);   // per-thread bases
    for (int t = 0; t < nt; t++) {
        rb[t] = n_total; cb[t] = cig_total; qb[t] = qn_total;
        n_total += sizes[t].n;
        cig_total += sizes[t].cig;
        qn_total += sizes[t].qn;
    }
    out->n_reads = n_total;
    out->tid = (int32_t*)malloc((n_total ? n_total : 1) * sizeof(int32_t));
    out->pos = (int32_t*)malloc((n_total ? n_total : 1) * sizeof(int32_t));
    out->flag = (uint16_t*)malloc((n_total ? n_total : 1)
                                  * sizeof(uint16_t));
    out->rnext = (int32_t*)malloc((n_total ? n_total : 1)
                                  * sizeof(int32_t));
    out->nh = (int32_t*)malloc((n_total ? n_total : 1) * sizeof(int32_t));
    out->cigar_ops = (int8_t*)malloc((cig_total ? cig_total : 1)
                                     * sizeof(int8_t));
    out->cigar_lens = (int32_t*)malloc((cig_total ? cig_total : 1)
                                       * sizeof(int32_t));
    out->cigar_offsets = (int64_t*)malloc((n_total + 1) * sizeof(int64_t));
    out->qname_offsets = (int64_t*)malloc((n_total + 1) * sizeof(int64_t));
    out->pair_hash = (uint64_t*)malloc((n_total ? n_total : 1)
                                       * sizeof(uint64_t));
    out->mate_code = (int8_t*)malloc((n_total ? n_total : 1)
                                     * sizeof(int8_t));
    out->qnames = (char*)malloc(qn_total ? qn_total : 1);
    out->cigar_offsets[0] = 0;
    out->qname_offsets[0] = 0;

    // one error flag a thread: no two threads write the same flag
    std::unique_ptr<bool[]> errs(new bool[nt]());
    {
        std::vector<std::thread> ths;
        for (int t = 0; t < nt; t++) {
            int a = n_iv * t / nt, b = n_iv * (t + 1) / nt;
            ths.emplace_back([&, a, b, t]() {
                decode_range_into(splits[a], splits[b], tid_filter,
                                  drop_unmapped, pos_min, pos_max, out,
                                  rb[t], cb[t], qb[t], &errs[t]);
            });
        }
        for (auto& th : ths) th.join();
    }
    for (int t = 0; t < nt; t++)
        if (errs[t]) { out->error = dup_err("truncated record"); return 1; }
    return 0;
}

}  // extern "C"
