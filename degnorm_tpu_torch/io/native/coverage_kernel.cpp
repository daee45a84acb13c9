// Native coverage + read-count kernel: the per-(sample, chromosome) ETL
// hot path (reference reads.py:314-818) in C++.
//
// Mirrors io/coverage.py's reference-compat semantics exactly (every CIGAR
// op consumes reference bases, mate clip-to-scalar disjointification with
// phantom segments, -1 overlap coverage shift with wraparound, one-past
// exon-end containment, per-unit duplicate-position dedup).  The numpy
// implementation remains the source of truth for the "strict" mode and the
// path a caller selects with native=False; this kernel is the fast path.
//
// C ABI via ctypes; all buffers are caller-allocated numpy arrays.
//
// THREADING: build/assign/fill is fused and parallelized over
// reads (or hash-paired pairs, re-sorted by anchor position), with the
// position axis PARTITIONED across threads: each thread plain-writes
// only units fully inside its owned position interval; boundary
// straddlers, and every unit that writes an overlap gene's wrap cell, go
// to a leftover list replayed serially, and read counts
// accumulate per-thread.  No atomics: writes are provably disjoint, and
// the result is BIT-IDENTICAL to
// the serial kernel at any thread count (tests/test_torch_io.py).
// This is what makes single-chromosome datasets (e.g. the reference's
// own chr1-only test data) use the whole host: the reference threads
// per chromosome only (reads.py:840-847).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Unit {
    // flat segment list [s0,e0,s1,e1,...] inclusive 0-based
    std::vector<int64_t> bounds;
    int64_t pos;        // anchor read position
    int64_t end_pos;    // pos + total cigar length
    bool dirty;         // mate clipping may have produced duplicates
    bool active;
};

inline void fill_unit(const Unit& u, int64_t base_shift, int64_t* cov,
                      int64_t cov_len, std::vector<int64_t>& scratch) {
    // cov[p - base_shift] += 1 per unique covered position p (python
    // fancy-assignment semantics: duplicates within a unit count once);
    // negative indices wrap (compat -1 shift, reads.py:615-617).
    if (!u.dirty) {
        for (size_t i = 0; i + 1 < u.bounds.size(); i += 2)
            for (int64_t p = u.bounds[i]; p <= u.bounds[i + 1]; p++) {
                int64_t idx = p - base_shift;
                if (idx < 0) idx += cov_len;
                if (idx >= 0 && idx < cov_len) cov[idx]++;
            }
        return;
    }
    scratch.clear();
    for (size_t i = 0; i + 1 < u.bounds.size(); i += 2)
        for (int64_t p = u.bounds[i]; p <= u.bounds[i + 1]; p++)
            scratch.push_back(p);
    std::sort(scratch.begin(), scratch.end());
    scratch.erase(std::unique(scratch.begin(), scratch.end()),
                  scratch.end());
    for (int64_t p : scratch) {
        int64_t idx = p - base_shift;
        if (idx < 0) idx += cov_len;
        if (idx >= 0 && idx < cov_len) cov[idx]++;
    }
}

// run fn(t) on nt threads (fn(0) inline when nt == 1)
template <typename F>
void run_threads(int nt, F fn) {
    if (nt <= 1) { fn(0); return; }
    std::vector<std::thread> ths;
    ths.reserve(nt);
    for (int t = 0; t < nt; t++) ths.emplace_back(fn, t);
    for (auto& th : ths) th.join();
}

}  // namespace

extern "C" {

// Returns 0 on success.
int dn_chrom_coverage(
    // ---- reads (columnar, post tid-filter) ----
    int64_t n_reads,
    const int32_t* pos,
    const int8_t* cigar_ops,
    const int32_t* cigar_lens,
    const int64_t* cigar_offsets,   // n_reads + 1
    const int32_t* nh,
    const int32_t* rnext,
    const uint64_t* pair_hash,      // may be null when !paired
    int paired,
    int unique_alignment,
    // ---- annotation ----
    int64_t chrom_len,
    int64_t n_genes,
    const int64_t* gene_start0,     // 0-indexed inclusive
    const int64_t* gene_end0,       // 0-indexed inclusive
    const int32_t* gene_group,      // group id per gene; -1 = isolated
    int64_t n_groups,
    const int64_t* exon_offsets,    // n_genes + 1 into exon arrays
    const int64_t* exon_starts0,    // per gene: sorted, 0-indexed
    const int64_t* exon_ends1,      // per gene: sorted, 1-indexed (quirk)
    // ---- exon union (all genes) ----
    int64_t n_union,
    const int64_t* union_starts0,
    const int64_t* union_ends1,
    // ---- outputs (caller-allocated, zeroed) ----
    int64_t* iso_coverage,          // chrom_len (may be null if no isolated)
    int64_t* overlap_cov,           // concatenated per-overlap-gene spans
    const int64_t* overlap_cov_offsets,  // n_genes + 1 (0-width for isolated)
    int64_t* read_counts,           // n_genes
    int n_threads)                  // <= 1: serial (bit-identical result)
{
    if (n_reads == 0 || n_genes == 0) return 0;
    int nt = n_threads;
    if (nt <= 0) nt = (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    nt = (int)std::min<int64_t>(nt, std::max<int64_t>(n_reads / 4096, 1));

    // ---- span bounds + step-0/1 filters (reads.py:225-242,404-420) ----
    int64_t min_gene_start = gene_start0[0], max_gene_end = gene_end0[0];
    for (int64_t g = 1; g < n_genes; g++) {
        min_gene_start = std::min(min_gene_start, gene_start0[g]);
        max_gene_end = std::max(max_gene_end, gene_end0[g]);
    }

    std::vector<uint8_t> keep(n_reads, 1);
    std::vector<int64_t> end_pos(n_reads);
    run_threads(nt, [&](int t) {
        int64_t r0 = n_reads * t / nt, r1 = n_reads * (t + 1) / nt;
        for (int64_t r = r0; r < r1; r++) {
            if (unique_alignment && nh[r] > 1) keep[r] = 0;
            if (paired && rnext[r] == -1) keep[r] = 0;
            int64_t total = 0;
            for (int64_t c = cigar_offsets[r]; c < cigar_offsets[r + 1];
                 c++)
                total += cigar_lens[c];
            end_pos[r] = (int64_t)pos[r] + total;
            if (pos[r] < min_gene_start || end_pos[r] > max_gene_end)
                keep[r] = 0;
        }
    });

    // paired: keep only hashes occurring exactly twice among kept reads
    std::vector<int64_t> order;
    if (paired) {
        order.reserve(n_reads);
        for (int64_t r = 0; r < n_reads; r++)
            if (keep[r]) order.push_back(r);
        std::stable_sort(order.begin(), order.end(),
                         [&](int64_t a, int64_t b) {
                             return pair_hash[a] < pair_hash[b];
                         });
        std::vector<int64_t> filtered;
        for (size_t i = 0; i < order.size();) {
            size_t j = i;
            while (j < order.size()
                   && pair_hash[order[j]] == pair_hash[order[i]]) j++;
            if (j - i == 2) {
                filtered.push_back(order[i]);
                filtered.push_back(order[i + 1]);
            }
            i = j;
        }
        order.swap(filtered);
    }

    // ---- per-read match segments (compat: every op consumes ref) ----
    auto segments_of = [&](int64_t r, std::vector<int64_t>& out) {
        out.clear();
        int64_t cur = pos[r];
        for (int64_t c = cigar_offsets[r]; c < cigar_offsets[r + 1]; c++) {
            if (cigar_ops[c] == 0) {                    // literal 'M'
                out.push_back(cur);
                out.push_back(cur + cigar_lens[c] - 1);
            }
            cur += cigar_lens[c];
        }
    };

    // ---- exon-union bitmap (reads.py:425-435) ----
    std::vector<uint8_t> in_exon(chrom_len, 0);
    for (int64_t i = 0; i < n_union; i++) {
        int64_t a = std::max<int64_t>(union_starts0[i], 0);
        int64_t b = std::min<int64_t>(union_ends1[i], chrom_len);
        if (a < b) memset(in_exon.data() + a, 1, (size_t)(b - a));
    }
    auto seg_in_exons = [&](int64_t s, int64_t e) {
        s = std::max<int64_t>(s, 0);
        e = std::min<int64_t>(e, chrom_len - 1);
        for (int64_t p = s; p <= e; p++)
            if (!in_exon[p]) return false;
        return true;
    };

    // ---- group metadata, hoisted out of the unit loop ----
    std::vector<std::vector<int64_t>> grp_members((size_t)n_groups);
    std::vector<int64_t> grp_start((size_t)n_groups, INT64_MAX);
    std::vector<int64_t> grp_end((size_t)n_groups, INT64_MIN);
    for (int64_t g = 0; g < n_genes; g++) {
        int32_t grp = gene_group[g];
        if (grp < 0 || grp >= n_groups) continue;
        grp_members[grp].push_back(g);
        grp_start[grp] = std::min(grp_start[grp], gene_start0[g]);
        grp_end[grp] = std::max(grp_end[grp], gene_end0[g]);
    }

    // ---- isolated-gene metadata (reads.py:669-797) ----
    std::vector<int64_t> iso_idx;
    for (int64_t g = 0; g < n_genes; g++)
        if (gene_group[g] < 0) iso_idx.push_back(g);
    std::vector<uint8_t> in_iso;
    std::vector<int64_t> iso_starts;
    const bool do_iso = !iso_idx.empty() && iso_coverage;
    if (do_iso) {
        std::sort(iso_idx.begin(), iso_idx.end(),
                  [&](int64_t a, int64_t b) {
                      return gene_start0[a] < gene_start0[b];
                  });
        in_iso.assign((size_t)chrom_len, 0);
        for (int64_t g : iso_idx) {
            int64_t a = std::max<int64_t>(gene_start0[g], 0);
            int64_t b = std::min<int64_t>(gene_end0[g] + 1, chrom_len);
            if (a < b) memset(in_iso.data() + a, 1, (size_t)(b - a));
        }
        for (int64_t g : iso_idx) iso_starts.push_back(gene_start0[g]);
    }

    // Per-unit assignment: checking groups in ASCENDING id order (first
    // capture/kill wins) is exactly the original group-outer loop's
    // semantics, since a unit deactivated by group k was skipped by all
    // groups > k; units are otherwise independent, and all accumulation
    // is commutative integer adds — bit-identical at any thread count.
    // Returns the target gene (or -1) + the coverage slice to fill.
    struct Assign {
        int64_t gene = -1;
        int64_t* cov = nullptr;
        int64_t base_shift = 0;
        int64_t cov_len = 0;
    };
    auto assign_unit = [&](const Unit& u) -> Assign {
        Assign a;
        for (int64_t grp = 0; grp < n_groups; grp++) {
            if (grp_members[grp].empty()) continue;
            if (u.pos < grp_start[grp] || u.end_pos > grp_end[grp])
                continue;
            int n_caught = 0;
            int64_t caught = -1;
            for (int64_t g : grp_members[grp]) {
                bool all_in = true;
                const int64_t* es = exon_starts0 + exon_offsets[g];
                const int64_t* ee = exon_ends1 + exon_offsets[g];
                int64_t n_ex = exon_offsets[g + 1] - exon_offsets[g];
                for (size_t i = 0; all_in && i + 1 < u.bounds.size();
                     i += 2) {
                    int64_t s = u.bounds[i], e = u.bounds[i + 1];
                    // last exon with start <= s; running end max equals
                    // the sorted-ends pairing quirk (reads.py:575-576,299)
                    int64_t lo = 0, hi = n_ex;
                    while (lo < hi) {
                        int64_t mid = (lo + hi) / 2;
                        if (es[mid] <= s) lo = mid + 1; else hi = mid;
                    }
                    all_in = lo > 0 && ee[lo - 1] >= e;
                }
                if (all_in) {
                    n_caught++;
                    if (n_caught == 1) caught = g;
                    if (n_caught >= 2) break;
                }
            }
            if (n_caught == 1) {
                a.gene = caught;
                a.cov = overlap_cov + overlap_cov_offsets[caught];
                a.base_shift = gene_start0[caught] + 1;   // compat -1 shift
                a.cov_len = overlap_cov_offsets[caught + 1]
                            - overlap_cov_offsets[caught];
                return a;
            }
            if (n_caught >= 2) return a;   // ambiguous: dropped
        }
        if (!do_iso) return a;
        // whole [pos, end_pos] inclusive must sit in isolated spans
        int64_t s = std::max<int64_t>(u.pos, 0);
        int64_t e = std::min<int64_t>(u.end_pos, chrom_len - 1);
        for (int64_t p = s; p <= e; p++)
            if (!in_iso[p]) return a;
        // gene by anchor position (spans are disjoint)
        auto it = std::upper_bound(iso_starts.begin(), iso_starts.end(),
                                   u.pos);
        if (it == iso_starts.begin()) return a;
        int64_t g = iso_idx[(it - iso_starts.begin()) - 1];
        if (u.pos > gene_end0[g]) return a;
        a.gene = g;
        a.cov = iso_coverage;
        a.base_shift = 0;
        a.cov_len = chrom_len;
        return a;
    };

    // ---- POSITION-PARTITIONED threading: no atomics anywhere ----
    // Sources (reads / hash-paired pairs) are processed in contiguous
    // ANCHOR-POSITION order; thread t owns the position interval
    // [B_t, B_{t+1}) and plain-writes any unit whose covered positions
    // all fall inside it.  Since a (gene, position) pair maps to exactly
    // one output cell, the owned intervals' plain writes are disjoint by
    // construction.  Units straddling a boundary (a few reads per
    // boundary on coordinate-sorted input) are deferred to a LEFTOVER
    // list replayed serially after the join; read counts accumulate in
    // per-thread arrays.  All adds stay plain +1s on disjoint cells, so
    // the result is bit-identical at any thread count.
    struct Leftover {
        std::vector<int64_t> bounds;
        bool dirty;
        int64_t gene;
        int64_t* cov;
        int64_t base_shift;
        int64_t cov_len;
    };

    // source items in anchor order + partition boundaries
    int64_t n_items;
    std::vector<int64_t> pair_order;   // paired: pair index k -> order slot
    if (paired) {
        int64_t n_pairs = (int64_t)order.size() / 2;
        pair_order.resize(n_pairs);
        for (int64_t k = 0; k < n_pairs; k++) pair_order[k] = k;
        if (nt > 1) {
            // pairs are hash-ordered; re-sort by anchor position so
            // thread ranges cover contiguous genome intervals (pure
            // processing-order change — per-unit results are identical)
            std::sort(pair_order.begin(), pair_order.end(),
                      [&](int64_t a, int64_t b) {
                          int64_t pa = std::min(pos[order[2 * a]],
                                                pos[order[2 * a + 1]]);
                          int64_t pb = std::min(pos[order[2 * b]],
                                                pos[order[2 * b + 1]]);
                          return pa < pb;
                      });
        }
        n_items = n_pairs;
    } else {
        n_items = n_reads;
    }
    auto item_anchor = [&](int64_t i) -> int64_t {
        if (!paired) return pos[i];
        int64_t k = pair_order[i];
        return std::min(pos[order[2 * k]], pos[order[2 * k + 1]]);
    };
    std::vector<int64_t> bound_lo(nt, INT64_MIN), bound_hi(nt, INT64_MAX);
    if (nt > 1) {
        int64_t prev = INT64_MIN;
        for (int t = 1; t < nt; t++) {
            int64_t i0 = n_items * t / nt;
            int64_t b = i0 < n_items ? item_anchor(i0) : INT64_MAX;
            b = std::max(b, prev);   // monotone even on unsorted input
            prev = b;
            bound_lo[t] = b;
            bound_hi[t - 1] = b;
        }
    }

    std::vector<std::vector<Leftover>> leftovers((size_t)nt);
    std::vector<std::vector<int64_t>> counts_t(
        (size_t)nt, std::vector<int64_t>((size_t)n_genes, 0));

    auto handle_unit = [&](const Unit& u, const Assign& a, int t,
                           std::vector<int64_t>& scratch) {
        counts_t[t][a.gene]++;
        int64_t umin = INT64_MAX, umax = INT64_MIN;
        for (size_t i = 0; i + 1 < u.bounds.size(); i += 2) {
            umin = std::min(umin, u.bounds[i]);
            umax = std::max(umax, u.bounds[i + 1]);
        }
        // An overlap gene's last cell is written from two positions: the
        // base before its start (index -1, wrapped) and its last base.
        // Those may fall in the intervals of two threads, so a unit that
        // touches that cell goes to the serial leftover list.
        bool wrap_cell = a.base_shift != 0
                         && (umin - a.base_shift < 0
                             || umax - a.base_shift >= a.cov_len - 1);
        if (!wrap_cell && umin >= bound_lo[t] && umax < bound_hi[t]) {
            fill_unit(u, a.base_shift, a.cov, a.cov_len, scratch);
        } else {
            leftovers[t].push_back({u.bounds, u.dirty, a.gene, a.cov,
                                    a.base_shift, a.cov_len});
        }
    };

    // ---- build + assign + fill, fused and threaded (reads.py:450-523
    // unit semantics; units never materialize as a list) ----
    if (paired) {
        run_threads(nt, [&](int t) {
            std::vector<int64_t> b1, b2, nb2, scratch;
            Unit u;
            int64_t k0 = n_items * t / nt, k1 = n_items * (t + 1) / nt;
            for (int64_t ks = k0; ks < k1; ks++) {
                int64_t k = pair_order[ks];
                int64_t r1 = order[2 * k], r2 = order[2 * k + 1];
                segments_of(r1, b1);
                segments_of(r2, b2);
                u.dirty = false;
                if (!b1.empty() && !b2.empty()) {
                    int64_t min1 = b1.front(), max1 = b1.back();
                    int64_t max2 = b2.back();
                    nb2 = b2;
                    if (max2 >= max1) {
                        for (auto& v : nb2)
                            if (v <= max1) { v = max1 + 1; u.dirty = true; }
                    } else {
                        bool clipped = false;
                        for (auto& v : nb2)
                            if (v >= min1) { v = min1 - 1; clipped = true; }
                        if (clipped) {
                            std::sort(nb2.begin(), nb2.end());
                            u.dirty = true;
                        }
                    }
                    b2.swap(nb2);
                }
                u.bounds = b1;
                u.bounds.insert(u.bounds.end(), b2.begin(), b2.end());
                u.pos = pos[r2];
                u.end_pos = end_pos[r2];
                u.active = true;
                bool ok = true;
                for (size_t i = 0; ok && i + 1 < u.bounds.size(); i += 2)
                    ok = seg_in_exons(u.bounds[i], u.bounds[i + 1]);
                if (!ok) continue;
                Assign a = assign_unit(u);
                if (a.gene >= 0) handle_unit(u, a, t, scratch);
            }
        });
    } else {
        run_threads(nt, [&](int t) {
            std::vector<int64_t> scratch;
            Unit u;
            int64_t r0 = n_items * t / nt, r1 = n_items * (t + 1) / nt;
            for (int64_t r = r0; r < r1; r++) {
                if (!keep[r]) continue;
                segments_of(r, u.bounds);
                u.pos = pos[r];
                u.end_pos = end_pos[r];
                u.dirty = false;
                u.active = true;
                bool ok = true;
                for (size_t i = 0; ok && i + 1 < u.bounds.size(); i += 2)
                    ok = seg_in_exons(u.bounds[i], u.bounds[i + 1]);
                if (!ok) continue;
                Assign a = assign_unit(u);
                if (a.gene >= 0) handle_unit(u, a, t, scratch);
            }
        });
    }

    // boundary-straddling units, replayed serially (few on sorted input)
    {
        Unit u;
        std::vector<int64_t> scratch;
        for (auto& lv : leftovers)
            for (auto& l : lv) {
                u.bounds = std::move(l.bounds);
                u.dirty = l.dirty;
                fill_unit(u, l.base_shift, l.cov, l.cov_len, scratch);
            }
    }
    for (int t = 0; t < nt; t++)
        for (int64_t g = 0; g < n_genes; g++)
            read_counts[g] += counts_t[t][g];
    return 0;
}

}  // extern "C"
