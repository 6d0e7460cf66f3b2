// Copied from longcallr_tpu/native/decode.cpp: the torch port keeps its own copy
// and builds it into longcallr_tpu_torch/native/build/.
//
// Native host decoders for longcallR-TPU.
//
// Implements the per-read hot loops of the host pipeline in C++:
//   * pileup_fill: BAM records → dense per-region pileup tensors, with the
//     exact semantics of the vectorised Python engine in tiles/pileup.py
//     (itself a faithful redesign of longcallR/src/util.rs:621-949): baseq
//     cap 30, ONT end trimming, poly-A/homopolymer window masking against
//     the current column's ref base, D/N/I column counting, ts-tag strand
//     combination, float64 log-qual accumulation in read order.
//   * fragment_cells: candidate-SNP allele extraction per read
//     (fragment.rs:93-194 semantics; p=+1 ref / -1 alt / 0 other).
//   * bgzf_inflate_many: parallel BGZF block inflation (zlib).
//
// All buffers are allocated by the Python caller (numpy) and passed as raw
// pointers; log tables are passed in so float semantics match the Python
// reference implementation bit-for-bit.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <algorithm>
#include <thread>
#include <vector>
#include <zlib.h>
#ifdef USE_LIBDEFLATE
// htslib links libdeflate when available (bgzf.c); so do we. Deflate streams
// differ byte-wise from zlib's but are spec-valid BGZF; each block is an
// independent raw-deflate member so zlib/libdeflate blocks can mix freely.
#include <libdeflate.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

// Inflate n_blocks BGZF blocks; src_off/dst_off give per-block offsets.
// Returns 0 on success.
int bgzf_inflate_many(const uint8_t* src, const int64_t* src_off,
                      const int32_t* src_len, uint8_t* dst,
                      const int64_t* dst_off, const int32_t* dst_len,
                      int64_t n_blocks, int n_threads) {
    std::vector<int> errs(std::max(1, n_threads), 0);
#ifdef USE_LIBDEFLATE
    auto work = [&](int tid) {
        struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
        if (!d) { errs[tid] = 1; return; }
        for (int64_t b = tid; b < n_blocks; b += n_threads) {
            size_t actual = 0;
            enum libdeflate_result r = libdeflate_deflate_decompress(
                d, src + src_off[b], (size_t)src_len[b],
                dst + dst_off[b], (size_t)dst_len[b], &actual);
            if (r != LIBDEFLATE_SUCCESS || actual != (size_t)dst_len[b]) {
                errs[tid] = 2; break;
            }
        }
        libdeflate_free_decompressor(d);
    };
#else
    auto work = [&](int tid) {
        for (int64_t b = tid; b < n_blocks; b += n_threads) {
            z_stream zs;
            std::memset(&zs, 0, sizeof(zs));
            if (inflateInit2(&zs, -15) != Z_OK) { errs[tid] = 1; return; }
            zs.next_in = const_cast<uint8_t*>(src + src_off[b]);
            zs.avail_in = (uInt)src_len[b];
            zs.next_out = dst + dst_off[b];
            zs.avail_out = (uInt)dst_len[b];
            int r = inflate(&zs, Z_FINISH);
            inflateEnd(&zs);
            if (r != Z_STREAM_END) { errs[tid] = 2; return; }
        }
    };
#endif
    if (n_threads <= 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
        for (auto& t : ts) t.join();
    }
    for (int e : errs) if (e) return e;
    return 0;
}

// 1 when the codec below is libdeflate (faster, different — still spec-valid
// — deflate bytes than zlib), 0 for the zlib fallback build.
int bgzf_native_backend() {
#ifdef USE_LIBDEFLATE
    return 1;
#else
    return 0;
#endif
}

// Deflate n_chunks payload chunks (each <= 64KiB) into complete BGZF blocks
// with the same 26-byte header/footer framing as io/bgzf.py::compress_block.
// The zlib build is byte-identical to the Python path (raw deflate, memLevel
// 8, default strategy); the libdeflate build produces different but
// spec-valid deflate bytes (htslib behaves the same way). Chunk b is written
// at dst + b*dst_cap; out_len[b] receives the full block length, or -1 when
// the deflated block would exceed 64KiB (incompressible data — the caller
// falls back to the Python shrink loop for that chunk alone).
int bgzf_deflate_many(const uint8_t* src, const int64_t* src_off,
                      const int32_t* src_len, uint8_t* dst, int64_t dst_cap,
                      int32_t* out_len, int64_t n_chunks, int level,
                      int n_threads) {
    std::vector<int> errs(std::max(1, n_threads), 0);
    auto emit = [&](int64_t b, uint8_t* out, uint32_t clen) {
        uint32_t bsize = clen + 26;
        static const uint8_t head[16] = {
            0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
            0x06, 0x00, 0x42, 0x43, 0x02, 0x00};
        std::memcpy(out, head, 16);
        uint16_t bs16 = (uint16_t)(bsize - 1);
        std::memcpy(out + 16, &bs16, 2);
#ifdef USE_LIBDEFLATE
        uint32_t crc = libdeflate_crc32(0, src + src_off[b],
                                        (size_t)src_len[b]);
#else
        uint32_t crc = (uint32_t)crc32(0L, src + src_off[b],
                                       (uInt)src_len[b]);
#endif
        uint32_t isize = (uint32_t)src_len[b];
        std::memcpy(out + 18 + clen, &crc, 4);
        std::memcpy(out + 22 + clen, &isize, 4);
        out_len[b] = (int32_t)bsize;
    };
#ifdef USE_LIBDEFLATE
    auto work = [&](int tid) {
        struct libdeflate_compressor* c = libdeflate_alloc_compressor(level);
        if (!c) { errs[tid] = 1; return; }
        for (int64_t b = tid; b < n_chunks; b += n_threads) {
            uint8_t* out = dst + b * dst_cap;
            size_t clen = libdeflate_deflate_compress(
                c, src + src_off[b], (size_t)src_len[b],
                out + 18, (size_t)(dst_cap - 26));
            if (clen == 0 || clen + 26 > 65536) {
                out_len[b] = -1;                    // python fallback
                continue;
            }
            emit(b, out, (uint32_t)clen);
        }
        libdeflate_free_compressor(c);
    };
#else
    auto work = [&](int tid) {
        // one deflate state per worker, reset per block (identical output
        // to a fresh init; avoids a ~256KB alloc+setup per block)
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) {
            errs[tid] = 1; return;
        }
        for (int64_t b = tid; b < n_chunks; b += n_threads) {
            uint8_t* out = dst + b * dst_cap;
            deflateReset(&zs);
            zs.next_in = const_cast<uint8_t*>(src + src_off[b]);
            zs.avail_in = (uInt)src_len[b];
            zs.next_out = out + 18;                 // past the BGZF header
            zs.avail_out = (uInt)(dst_cap - 26);
            int r = deflate(&zs, Z_FINISH);
            uint32_t clen = (uint32_t)zs.total_out;
            if (r != Z_STREAM_END || clen + 26 > 65536) {
                out_len[b] = -1;                    // python fallback
                continue;
            }
            emit(b, out, clen);
        }
        deflateEnd(&zs);
    };
#endif
    if (n_threads <= 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < n_threads; ++t) ts.emplace_back(work, t);
        for (auto& t : ts) t.join();
    }
    for (int e : errs) if (e) return e;
    return 0;
}

// ---------------------------------------------------------------------------
// BAM record helpers
// ---------------------------------------------------------------------------

static const char SEQ_NIBBLE[17] = "=ACMGRSVTWYHKDBN";
// 4-bit code → base index (A=0 C=1 G=2 T=3, else -1); the direct form of
// base_index(seq_base(...)) for the hot pileup loop
static const int8_t NIB_IDX[16] = {-1, 0, 1, -1, 2, -1, -1, -1,
                                   3, -1, -1, -1, -1, -1, -1, -1};

struct RecView {
    const uint8_t* rec;   // fixed 32-byte prefix
    int32_t pos;
    uint16_t flag;
    int32_t l_seq;
    int32_t n_cigar;      // real op count (CG:B,I arrays can exceed 65535)
    uint8_t l_read_name;
    const uint32_t* cigar;
    const uint8_t* seq_packed;
    const uint8_t* qual;
    const uint8_t* aux;
    const uint8_t* aux_end;
};

static int aux_sizes(char typ);

// >65,535-op CIGARs: the record holds a kSmN placeholder (k = l_seq) and
// the real cigar lives in a CG:B,I aux array (SAM spec 4.2.2; htslib — the
// reference's rust-htslib substrate — reconstructs transparently). Layout
// offsets were already computed from the raw two-word field; only the
// cigar view is redirected.
static void cg_substitute(RecView& v) {
    const uint8_t* q = v.aux;
    while (q + 4 <= v.aux_end) {
        char a = (char)q[0], b = (char)q[1], typ = (char)q[2];
        q += 3;
        if (typ == 'B') {
            if (q + 5 > v.aux_end) return;  // truncated B header
            char st = (char)q[0];
            int32_t cnt;
            std::memcpy(&cnt, q + 1, 4);
            int sz = aux_sizes(st);
            // corrupt element type or negative count: bail (a negative
            // count would step q backwards and loop forever)
            if (sz < 0 || cnt < 0) return;
            if (a == 'C' && b == 'G' && st == 'I' && cnt > 0 &&
                q + 5 + (int64_t)cnt * 4 <= v.aux_end) {
                v.cigar = reinterpret_cast<const uint32_t*>(q + 5);
                v.n_cigar = cnt;
                return;
            }
            if (q + 5 + (int64_t)cnt * sz > v.aux_end) return;  // truncated
            q += 5 + (int64_t)cnt * sz;
            continue;
        }
        int sz = aux_sizes(typ);
        if (sz > 0) { q += sz; continue; }
        if (typ == 'Z' || typ == 'H') {
            while (q < v.aux_end && *q) ++q;
            ++q;
            continue;
        }
        return;  // unknown type: bail
    }
}

static inline RecView view_record(const uint8_t* data, int64_t off, int64_t end) {
    RecView v;
    v.rec = data + off;
    std::memcpy(&v.pos, v.rec + 4, 4);
    v.l_read_name = v.rec[8];
    uint16_t ncig16;
    std::memcpy(&ncig16, v.rec + 12, 2);
    v.n_cigar = ncig16;
    std::memcpy(&v.flag, v.rec + 14, 2);
    std::memcpy(&v.l_seq, v.rec + 16, 4);
    const uint8_t* p = v.rec + 32 + v.l_read_name;
    v.cigar = reinterpret_cast<const uint32_t*>(p);
    p += 4 * (int64_t)ncig16;
    v.seq_packed = p;
    p += (v.l_seq + 1) / 2;
    v.qual = p;
    p += v.l_seq;
    v.aux = p;
    v.aux_end = data + end;
    if (ncig16 == 2 &&
        v.cigar[0] == (((uint32_t)v.l_seq << 4) | 4) &&   // kS, k == l_seq
        (v.cigar[1] & 0xF) == 3)                          // mN
        cg_substitute(v);
    return v;
}

static inline char seq_base(const RecView& v, int64_t i) {
    uint8_t b = v.seq_packed[i >> 1];
    return SEQ_NIBBLE[(i & 1) ? (b & 0xF) : (b >> 4)];
}

static int aux_sizes(char typ) {
    switch (typ) {
        case 'c': case 'C': case 'A': return 1;
        case 's': case 'S': return 2;
        case 'i': case 'I': case 'f': return 4;
        default: return -1;
    }
}

// find a one-char 'A'-typed tag (e.g. ts); returns 0 if absent
static char aux_char_tag(const RecView& v, char t0, char t1) {
    const uint8_t* q = v.aux;
    while (q + 3 <= v.aux_end) {
        char a = (char)q[0], b = (char)q[1], typ = (char)q[2];
        q += 3;
        if (a == t0 && b == t1 && typ == 'A')
            return q < v.aux_end ? (char)q[0] : 0;
        int sz = aux_sizes(typ);
        if (sz > 0) { q += sz; continue; }
        if (typ == 'Z' || typ == 'H') {
            while (q < v.aux_end && *q) ++q;
            ++q;
            continue;
        }
        if (typ == 'B') {
            if (q + 5 > v.aux_end) return 0;  // truncated B header
            char st = (char)q[0];
            int32_t cnt;
            std::memcpy(&cnt, q + 1, 4);
            int esz = aux_sizes(st);
            if (esz < 0 || cnt < 0) return 0;  // corrupt: bail
            q += 5 + (int64_t)cnt * esz;
            continue;
        }
        return 0;  // unknown type: bail
    }
    return 0;
}

static inline int base_index(char c) {
    switch (c) {
        case 'A': case 'a': return 0;
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return -1;
    }
}

static inline int leading_softclips(const RecView& v) {
    for (int i = 0; i < v.n_cigar; ++i) {
        uint32_t w = v.cigar[i];
        int op = w & 0xF;
        if (op == 5) continue;              // H
        return op == 4 ? (int)(w >> 4) : 0; // S
    }
    return 0;
}

static inline int trailing_softclips(const RecView& v) {
    for (int i = v.n_cigar - 1; i >= 0; --i) {
        uint32_t w = v.cigar[i];
        int op = w & 0xF;
        if (op == 5) continue;
        return op == 4 ? (int)(w >> 4) : 0;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// pileup_fill
// ---------------------------------------------------------------------------

// Uniform-window lookup for the near-read-end poly-A/homopolymer scan.
// The scalar predicate (util.rs:690-720 form) counts, per window start t0,
// how many of the polya_len bases equal 'A'/'T'/'C'/'G' at positions where
// that base differs from ref_base; a count can only reach polya_len when
// EVERY base in the window is that one base. The scan therefore reduces
// exactly to "the window starting at t0 is in-bounds and uniform in X" —
// computed once per read end into a tiny table instead of re-decoding the
// packed sequence 7×5 times per near base (~60% of HiFi pileup time).
struct UniZone {
    int64_t a = 0, b = 0;   // t0 range [a, b); entries 0 = not uniform
    std::vector<char> u;
    std::vector<char> buf;
    void build(const RecView& v, int64_t a_, int64_t b_,
               int64_t polya_len) {
        a = a_;
        b = b_ < a_ ? a_ : b_;
        u.assign(b - a, 0);
        const int64_t seq_len = v.l_seq;
        const int64_t lo = a < 0 ? 0 : a;
        int64_t hi = b + polya_len - 1;
        if (hi > seq_len) hi = seq_len;
        if (hi <= lo) return;
        buf.resize(hi - lo);
        for (int64_t i = lo; i < hi; ++i) buf[i - lo] = seq_base(v, i);
        for (int64_t t0 = lo; t0 < b; ++t0) {
            if (t0 + polya_len - 1 >= seq_len) break;
            const char c = buf[t0 - lo];
            bool uni = true;
            for (int64_t t1 = 1; t1 < polya_len; ++t1)
                if (buf[t0 + t1 - lo] != c) { uni = false; break; }
            if (uni) u[t0 - a] = c;
        }
    }
    inline bool contains(int64_t t0) const { return t0 >= a && t0 < b; }
    inline char get(int64_t t0) const { return u[t0 - a]; }
};

// exact single-window form of the same predicate (fallback for a t0
// outside both precomputed zones — cannot happen for well-formed CIGARs,
// kept so correctness never depends on the zone-bound derivation)
static inline char slow_uniform_window(const RecView& v, int64_t t0,
                                       int64_t polya_len) {
    if (t0 < 0 || t0 + polya_len - 1 >= v.l_seq) return 0;
    const char c = seq_base(v, t0);
    for (int64_t t1 = 1; t1 < polya_len; ++t1)
        if (seq_base(v, t0 + t1) != c) return 0;
    return c;
}

struct PileupOut {
    int32_t* cnt;        // [P*4]
    int32_t* n_intron;   // [P]
    int32_t* n_del;      // [P]
    int32_t* n_ins;      // [P]
    int32_t* fwd;        // [P]
    int32_t* bwd;        // [P]
    int32_t* strands;    // [P*4*2]
    int32_t* ts;         // [P*2]
    double* s_err;       // [P*4]
    double* s_1merr;     // [P*4]
    int32_t* bq_pass;    // [P*4]
};

// Per-read accumulation over a contiguous read range [r0, r1), writing into
// the given output buffers. Shared by the serial and chunked entry points.
static int pileup_fill_range(
        const uint8_t* data, const int64_t* rec_off, const int64_t* rec_end,
        int64_t r0, int64_t r1,
        int64_t start0, int64_t P, const uint8_t* ref_window,
        int is_ont, int64_t dist_end, int64_t polya_len,
        int min_baseq, const double* log_err, const double* log_1merr,
        int32_t* cnt, int32_t* n_intron, int32_t* n_del,
        int32_t* n_ins, int32_t* fwd, int32_t* bwd, int32_t* strands,
        int32_t* ts_out, double* s_err, double* s_1merr,
        int32_t* bq_pass) {
    UniZone uz_head, uz_tail;   // reused across reads (allocation-warm)
    for (int64_t r = r0; r < r1; ++r) {
        RecView v = view_record(data, rec_off[r], rec_end[r]);
        int strand = (v.flag & 0x10) ? 1 : 0;
        bool uni_ready = false;  // zones built on first near-segment base
        char tsc = aux_char_tag(v, 't', 's');
        int ts_col = -1;
        if (tsc == '+') ts_col = (strand == 0) ? 0 : 1;
        else if (tsc == '-') ts_col = (strand == 0) ? 1 : 0;
        int lead_sc = leading_softclips(v);
        int trail_sc = trailing_softclips(v);
        int64_t seq_len = v.l_seq;
        int64_t boundary_end = seq_len - trail_sc;

        int64_t pv = (int64_t)v.pos - start0;  // pos_in_freq_vec
        int64_t pr = lead_sc;                  // pos_in_read
        // hoisted per-read invariants for the hot M loop
        int32_t* fb = strand ? bwd : fwd;
        const int soff = strand;               // strands[o*2 + strand]
        for (int ci = 0; ci < v.n_cigar; ++ci) {
            uint32_t w = v.cigar[ci];
            int op = w & 0xF;
            int64_t ln = w >> 4;
            if (op == 4 || op == 5 || op == 6) continue;  // S,H,P
            if (op == 0 || op == 7 || op == 8) {          // M,=,X
                // Clamp the per-base loop to the window once, then split it
                // into near-read-end segments (trim / poly-A logic) and a
                // tight middle segment with no per-base near test. Identical
                // writes in identical order to the per-base-branch form
                // (util.rs:660-760 semantics; the near predicate
                // |pr-lead_sc| < dist_end || |pr-boundary_end| < dist_end is
                // monotone in pr within one op since pr >= lead_sc and
                // pr < boundary_end for every M base).
                if (pv >= P) continue;         // == immediate break: no writes
                // per-base loop advances pv/pr even while pv < 0 and stops
                // (frozen) when pv reaches P → total advance min(ln, P-pv)
                const int64_t j_lo = pv < 0 ? -pv : 0;
                const int64_t j_hi = (P - pv < ln) ? P - pv : ln;
                const int64_t pv0 = pv, pr0 = pr;
                pv += j_hi;
                pr += j_hi;
                if (j_hi <= j_lo) continue;    // op entirely before window
                // middle zone in j: pr0+j in [lead_sc+dist_end,
                //                              boundary_end-dist_end]
                int64_t jm_lo = lead_sc + dist_end - pr0;
                int64_t jm_hi = boundary_end - dist_end - pr0 + 1;
                if (jm_lo < j_lo) jm_lo = j_lo;
                if (jm_lo > j_hi) jm_lo = j_hi;
                if (jm_hi > j_hi) jm_hi = j_hi;
                if (jm_hi < jm_lo) jm_hi = jm_lo;
                // near segments [j_lo, jm_lo) and [jm_hi, j_hi): ONT trims
                // them outright; HiFi runs the poly-A/homopolymer scan
                auto near_seg = [&](int64_t s_lo, int64_t s_hi) {
                    // A near base is skipped iff some in-bounds window
                    // starting in [cpr-polya_len, cpr+1] is uniform in a
                    // base X with ref_base != X (the counters in the
                    // scalar form only reach polya_len for an all-X
                    // window; the else-if chain contributes each base to
                    // at most one counter, so mixed windows never fire).
                    // Decision-identical to the per-window rescan, via
                    // the per-read UniZone tables.
                    // degenerate configs, exactly as the scalar loop
                    // behaves: for polya_len in {0, -1} the t0 loop runs
                    // and the counters trivially reach the threshold on
                    // the first in-bounds window (every near base
                    // skipped); for polya_len < -1 the t0 loop below is
                    // empty (cpr - polya_len > cpr + 1), so no base is
                    // ever masked and no table is needed
                    if (polya_len == 0 || polya_len == -1) return;
                    if (polya_len >= 1 && s_lo < s_hi && !uni_ready) {
                        uz_head.build(v, lead_sc - polya_len,
                                      lead_sc + dist_end + 1, polya_len);
                        uz_tail.build(v,
                                      boundary_end - dist_end - polya_len + 1,
                                      boundary_end + 1, polya_len);
                        uni_ready = true;
                    }
                    for (int64_t j = s_lo; j < s_hi; ++j) {
                        const int64_t cpv = pv0 + j, cpr = pr0 + j;
                        int bq = v.qual[cpr];
                        if (bq > 30) bq = 30;
                        uint8_t ref_base = ref_window[cpv];
                        bool polya = false, homop = false;
                        for (int64_t t0 = cpr - polya_len; t0 <= cpr + 1; ++t0) {
                            char c;
                            if (uz_head.contains(t0)) c = uz_head.get(t0);
                            else if (uz_tail.contains(t0)) c = uz_tail.get(t0);
                            else c = slow_uniform_window(v, t0, polya_len);
                            if (!c) continue;
                            if ((c == 'A' && ref_base != 'A') ||
                                (c == 'T' && ref_base != 'T')) polya = true;
                            else if ((c == 'C' && ref_base != 'C') ||
                                     (c == 'G' && ref_base != 'G')) homop = true;
                        }
                        if (polya || homop) continue;
                        if (ts_col >= 0) ++ts_out[cpv * 2 + ts_col];
                        int bi = base_index(seq_base(v, cpr));
                        if (bi >= 0) {
                            int64_t o = cpv * 4 + bi;
                            ++cnt[o];
                            ++strands[o * 2 + soff];
                            s_err[o] += log_err[bq];
                            s_1merr[o] += log_1merr[bq];
                            if (bq >= min_baseq) ++bq_pass[o];
                        }
                        ++fb[cpv];
                    }
                };
                if (!is_ont) near_seg(j_lo, jm_lo);
                // tight middle loop: no trim/poly-A possible here
                {
                    for (int64_t j = jm_lo; j < jm_hi; ++j) {
                        const int64_t cpv = pv0 + j, cpr = pr0 + j;
                        int bq = v.qual[cpr];
                        if (bq > 30) bq = 30;
                        if (ts_col >= 0) ++ts_out[cpv * 2 + ts_col];
                        const uint8_t pk = v.seq_packed[cpr >> 1];
                        const int bi =
                            NIB_IDX[(cpr & 1) ? (pk & 0xF) : (pk >> 4)];
                        if (bi >= 0) {
                            int64_t o = cpv * 4 + bi;
                            ++cnt[o];
                            ++strands[o * 2 + soff];
                            s_err[o] += log_err[bq];
                            s_1merr[o] += log_1merr[bq];
                            if (bq >= min_baseq) ++bq_pass[o];
                        }
                        ++fb[cpv];
                    }
                }
                if (!is_ont) near_seg(jm_hi, j_hi);
            } else if (op == 2) {  // D
                for (int64_t j = 0; j < ln; ++j) {
                    if (pv < 0) { ++pv; continue; }
                    if (pv >= P) break;
                    ++n_del[pv];
                    ++pv;
                }
            } else if (op == 1) {  // I
                if (pv < 1) { pr += ln; continue; }
                if (pv >= P) break;
                ++n_ins[pv - 1];
                pr += ln;
            } else if (op == 3) {  // N
                for (int64_t j = 0; j < ln; ++j) {
                    if (pv < 0) { ++pv; continue; }
                    if (pv >= P) break;
                    ++n_intron[pv];
                    ++pv;
                }
            } else {
                return 1;  // unknown cigar op
            }
        }
    }
    return 0;
}

// returns 0 ok (serial; bit-exact read-order f64 accumulation)
int pileup_fill(const uint8_t* data, const int64_t* rec_off,
                const int64_t* rec_end, int64_t n_reads,
                int64_t start0, int64_t P, const uint8_t* ref_window,
                int is_ont, int64_t dist_end, int64_t polya_len,
                int min_baseq, const double* log_err, const double* log_1merr,
                int32_t* cnt, int32_t* n_intron, int32_t* n_del,
                int32_t* n_ins, int32_t* fwd, int32_t* bwd, int32_t* strands,
                int32_t* ts_out, double* s_err, double* s_1merr,
                int32_t* bq_pass) {
    return pileup_fill_range(data, rec_off, rec_end, 0, n_reads, start0, P,
                             ref_window, is_ont, dist_end, polya_len,
                             min_baseq, log_err, log_1merr, cnt, n_intron,
                             n_del, n_ins, fwd, bwd, strands, ts_out,
                             s_err, s_1merr, bq_pass);
}

// Parallel pileup over FIXED 16 read-chunks with in-order reduction: the
// result is identical for every thread count (chunk partials are combined
// in chunk order), deterministic across runs, and differs from the serial
// path only by f64 reassociation at the chunk boundaries (~1 ulp).
// Chunks run in batches of n_threads, each into a private buffer set.
int pileup_fill_mt(const uint8_t* data, const int64_t* rec_off,
                   const int64_t* rec_end, int64_t n_reads,
                   int64_t start0, int64_t P, const uint8_t* ref_window,
                   int is_ont, int64_t dist_end, int64_t polya_len,
                   int min_baseq, const double* log_err,
                   const double* log_1merr,
                   int32_t* cnt, int32_t* n_intron, int32_t* n_del,
                   int32_t* n_ins, int32_t* fwd, int32_t* bwd,
                   int32_t* strands, int32_t* ts_out, double* s_err,
                   double* s_1merr, int32_t* bq_pass, int n_threads) {
    const int C = 16;
    if (n_threads <= 1 || n_reads < 2 * C || P > (1 << 20))
        return pileup_fill_range(data, rec_off, rec_end, 0, n_reads, start0,
                                 P, ref_window, is_ont, dist_end, polya_len,
                                 min_baseq, log_err, log_1merr, cnt,
                                 n_intron, n_del, n_ins, fwd, bwd, strands,
                                 ts_out, s_err, s_1merr, bq_pass);
    int T = std::min(n_threads, C);
    struct Buf {
        std::vector<int32_t> i32;  // cnt(4P) nint(P) ndel(P) nins(P) fwd(P)
                                   // bwd(P) strands(8P) ts(2P) bq(4P)
        std::vector<double> f64;   // s_err(4P) s_1merr(4P)
        int64_t jlo = 0, jhi = 0;  // column span touched by the chunk
    };
    std::vector<Buf> bufs(T);
    for (auto& b : bufs) { b.i32.resize(23 * P); b.f64.resize(8 * P); }
    std::vector<int> errs(T, 0);
    // reads are coordinate-sorted, so each chunk touches only a narrow
    // column window: clear and reduce just that span (every plane group is
    // per-column contiguous — cnt[P,4], strands[P,8], ts[P,2], ...)
    auto chunk_span = [&](int64_t r0, int64_t r1, int64_t& jlo, int64_t& jhi) {
        jlo = P; jhi = 0;
        for (int64_t r = r0; r < r1; ++r) {
            RecView v = view_record(data, rec_off[r], rec_end[r]);
            int64_t ref_len = 0;
            for (int ci = 0; ci < v.n_cigar; ++ci) {
                uint32_t w = v.cigar[ci];
                int op = w & 0xF;
                if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                    ref_len += (int64_t)(w >> 4);
            }
            // ±1 slack: a leading insertion writes n_ins[pv-1] one column
            // BELOW the read start, and n_ins at the read end lands at pv-1
            // past the last M column
            int64_t lo = v.pos - start0 - 1;
            int64_t hi = v.pos - start0 + ref_len + 1;
            jlo = std::min(jlo, std::max<int64_t>(0, lo));
            jhi = std::max(jhi, std::min(P, hi));
        }
        if (jlo > jhi) { jlo = 0; jhi = 0; }
    };
    for (int k0 = 0; k0 < C; k0 += T) {
        int nb = std::min(T, C - k0);
        auto work = [&](int t) {
            int k = k0 + t;
            int64_t r0 = n_reads * k / C, r1 = n_reads * (k + 1) / C;
            Buf& b = bufs[t];
            chunk_span(r0, r1, b.jlo, b.jhi);
            int32_t* p32 = b.i32.data();
            double* p64 = b.f64.data();
            const int64_t jl = b.jlo, n = b.jhi - b.jlo;
            auto clr32 = [&](int64_t base, int w) {
                std::memset(p32 + base + w * jl, 0,
                            sizeof(int32_t) * w * n);
            };
            clr32(0, 4); clr32(4 * P, 1); clr32(5 * P, 1); clr32(6 * P, 1);
            clr32(7 * P, 1); clr32(8 * P, 1); clr32(9 * P, 8);
            clr32(17 * P, 2); clr32(19 * P, 4);
            std::memset(p64 + 4 * jl, 0, sizeof(double) * 4 * n);
            std::memset(p64 + 4 * P + 4 * jl, 0, sizeof(double) * 4 * n);
            int rc = pileup_fill_range(
                data, rec_off, rec_end, r0, r1, start0, P, ref_window,
                is_ont, dist_end, polya_len, min_baseq, log_err, log_1merr,
                p32, p32 + 4 * P, p32 + 5 * P, p32 + 6 * P, p32 + 7 * P,
                p32 + 8 * P, p32 + 9 * P, p32 + 17 * P,
                p64, p64 + 4 * P, p32 + 19 * P);
            if (rc) errs[t] = rc;
        };
        std::vector<std::thread> ts;
        for (int t = 0; t < nb; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
        for (int t = 0; t < nb; ++t) {       // reduce in chunk order
            const int32_t* p32 = bufs[t].i32.data();
            const double* p64 = bufs[t].f64.data();
            const int64_t jl = bufs[t].jlo, jh = bufs[t].jhi;
            for (int64_t j = 4 * jl; j < 4 * jh; ++j) cnt[j] += p32[j];
            for (int64_t j = jl; j < jh; ++j) {
                n_intron[j] += p32[4 * P + j];
                n_del[j] += p32[5 * P + j];
                n_ins[j] += p32[6 * P + j];
                fwd[j] += p32[7 * P + j];
                bwd[j] += p32[8 * P + j];
            }
            for (int64_t j = 8 * jl; j < 8 * jh; ++j)
                strands[j] += p32[9 * P + j];
            for (int64_t j = 2 * jl; j < 2 * jh; ++j)
                ts_out[j] += p32[17 * P + j];
            for (int64_t j = 4 * jl; j < 4 * jh; ++j) {
                bq_pass[j] += p32[19 * P + j];
                s_err[j] += p64[j];
                s_1merr[j] += p64[4 * P + j];
            }
        }
    }
    for (int e : errs) if (e) return e;
    return 0;
}

// ---------------------------------------------------------------------------
// bam_emit_tagged
// ---------------------------------------------------------------------------

// Emit n BAM records into one uncompressed stream: per record a little-endian
// u32 block_size, the raw record bytes [off, end), then optional appended
// aux tags HP:i (when hp != 0) and PS:I (when ps_has). Mirrors the Python
// writer loop of pipeline/caller.py (thread.rs:350-357 push_aux semantics).
// Returns total bytes written, or -1 if out_cap would be exceeded.
int64_t bam_emit_tagged(const uint8_t* data, const int64_t* off,
                        const int64_t* end, int64_t n, const int32_t* hp,
                        const int32_t* ps, const uint8_t* ps_has,
                        uint8_t* out, int64_t out_cap) {
    int64_t w = 0;
    for (int64_t r = 0; r < n; ++r) {
        int64_t len = end[r] - off[r];
        int64_t extra = (hp[r] != 0 ? 7 : 0) + (ps_has[r] ? 7 : 0);
        if (w + 4 + len + extra > out_cap) return -1;
        uint32_t bs = (uint32_t)(len + extra);
        std::memcpy(out + w, &bs, 4); w += 4;
        std::memcpy(out + w, data + off[r], (size_t)len); w += len;
        if (hp[r] != 0) {
            out[w] = 'H'; out[w + 1] = 'P'; out[w + 2] = 'i';
            std::memcpy(out + w + 3, hp + r, 4); w += 7;
        }
        if (ps_has[r]) {
            // reference pushes Aux::U32 -> BAM type 'I' (thread.rs:355)
            out[w] = 'P'; out[w + 1] = 'S'; out[w + 2] = 'I';
            std::memcpy(out + w + 3, ps + r, 4); w += 7;
        }
    }
    return w;
}

// ---------------------------------------------------------------------------
// fragment_cells
// ---------------------------------------------------------------------------

// For each read, emit (cand_idx, p, baseq) triplets at candidate SNPs under
// M ops where p != 0 and the candidate is not dense. Outputs flattened with
// out_counts[r] per read; out buffers sized max_cells.
static int fragment_cells_range(
        const uint8_t* data, const int64_t* rec_off,
        const int64_t* rec_end, int64_t r_begin, int64_t r_end,
        const int64_t* cand_pos, const uint8_t* cand_ref,
        const uint8_t* cand_a1, const uint8_t* cand_a2,
        const uint8_t* not_dense, int64_t n_cand,
        int32_t* out_idx, int8_t* out_p, uint8_t* out_bq,
        int64_t* out_counts, int64_t w_base, int64_t w_limit,
        int64_t* written) {
    int64_t w_ptr = w_base;
    for (int64_t r = r_begin; r < r_end; ++r) {
        RecView v = view_record(data, rec_off[r], rec_end[r]);
        int64_t start_cells = w_ptr;
        int64_t rpos = v.pos;
        int64_t qpos = leading_softclips(v);
        // first candidate at or beyond read start
        int64_t idx = std::lower_bound(cand_pos, cand_pos + n_cand, rpos)
                      - cand_pos;
        for (int ci = 0; ci < v.n_cigar && idx < n_cand; ++ci) {
            uint32_t w = v.cigar[ci];
            int op = w & 0xF;
            int64_t ln = w >> 4;
            if (op == 4 || op == 5 || op == 6) continue;
            if (op == 0 || op == 7 || op == 8) {
                int64_t seg_end = rpos + ln;
                while (idx < n_cand && cand_pos[idx] < seg_end) {
                    int64_t cpos = cand_pos[idx];
                    if (cpos >= rpos) {
                        int64_t qi = qpos + (cpos - rpos);
                        char base = seq_base(v, qi);
                        int bq = v.qual[qi];
                        if (bq > 30) bq = 30;
                        int8_t p = 0;
                        if ((uint8_t)base == cand_ref[idx]) p = 1;
                        else if ((uint8_t)base == cand_a1[idx]
                                 || (uint8_t)base == cand_a2[idx]) p = -1;
                        if (p != 0 && not_dense[idx]) {
                            if (w_ptr >= w_limit) return 2;
                            out_idx[w_ptr] = (int32_t)idx;
                            out_p[w_ptr] = p;
                            out_bq[w_ptr] = (uint8_t)bq;
                            ++w_ptr;
                        }
                    }
                    ++idx;
                }
                rpos = seg_end;
                qpos += ln;
            } else if (op == 1) {
                qpos += ln;
            } else {  // D or N: skip candidates under the gap
                int64_t seg_end = rpos + ln;
                while (idx < n_cand && cand_pos[idx] < seg_end) ++idx;
                rpos = seg_end;
            }
        }
        out_counts[r] = w_ptr - start_cells;
    }
    *written = w_ptr - w_base;
    return 0;
}

int fragment_cells(const uint8_t* data, const int64_t* rec_off,
                   const int64_t* rec_end, int64_t n_reads,
                   const int64_t* cand_pos, const uint8_t* cand_ref,
                   const uint8_t* cand_a1, const uint8_t* cand_a2,
                   const uint8_t* not_dense, int64_t n_cand,
                   int32_t* out_idx, int8_t* out_p, uint8_t* out_bq,
                   int64_t* out_counts, int64_t max_cells) {
    int64_t written = 0;
    return fragment_cells_range(data, rec_off, rec_end, 0, n_reads,
                                cand_pos, cand_ref, cand_a1, cand_a2,
                                not_dense, n_cand, out_idx, out_p, out_bq,
                                out_counts, 0, max_cells, &written);
}

// Chunk-parallel fragment extraction over FIXED 16 read-chunks (the pileup
// MT pattern): chunk c writes into its worst-case slice of the shared out
// buffers (base = first_read * n_cand, so max_cells must be the uncapped
// n_reads * n_cand — the caller checks), then one pack pass moves chunk
// segments down into the packed read-order layout. Outputs are identical
// to the serial walk for every thread count.
int fragment_cells_mt(const uint8_t* data, const int64_t* rec_off,
                      const int64_t* rec_end, int64_t n_reads,
                      const int64_t* cand_pos, const uint8_t* cand_ref,
                      const uint8_t* cand_a1, const uint8_t* cand_a2,
                      const uint8_t* not_dense, int64_t n_cand,
                      int32_t* out_idx, int8_t* out_p, uint8_t* out_bq,
                      int64_t* out_counts, int64_t max_cells,
                      int n_threads) {
    const int C = 16;
    if (n_threads <= 1 || n_reads < 2 * C
        || max_cells < n_reads * n_cand) {
        return fragment_cells(data, rec_off, rec_end, n_reads, cand_pos,
                              cand_ref, cand_a1, cand_a2, not_dense, n_cand,
                              out_idx, out_p, out_bq, out_counts, max_cells);
    }
    int T = std::min(n_threads, C);
    int64_t written[C];
    int errs_c[C];
    for (int c = 0; c < C; ++c) { written[c] = 0; errs_c[c] = 0; }
    auto work = [&](int tid) {
        for (int c = tid; c < C; c += T) {
            int64_t r0 = n_reads * c / C, r1 = n_reads * (c + 1) / C;
            int64_t base = r0 * n_cand;
            int64_t limit = r1 * n_cand;
            errs_c[c] = fragment_cells_range(
                data, rec_off, rec_end, r0, r1, cand_pos, cand_ref,
                cand_a1, cand_a2, not_dense, n_cand, out_idx, out_p,
                out_bq, out_counts, base, limit, &written[c]);
        }
    };
    {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
    for (int c = 0; c < C; ++c) if (errs_c[c]) return errs_c[c];
    // pack chunk segments down (dest <= src always)
    int64_t w = written[0];
    for (int c = 1; c < C; ++c) {
        int64_t r0 = n_reads * c / C;
        int64_t base = r0 * n_cand;
        if (base != w && written[c] > 0) {
            std::memmove(out_idx + w, out_idx + base,
                         sizeof(int32_t) * written[c]);
            std::memmove(out_p + w, out_p + base, (size_t)written[c]);
            std::memmove(out_bq + w, out_bq + base, (size_t)written[c]);
        }
        w += written[c];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// ld_pair_counts
// ---------------------------------------------------------------------------

// LD pair tables via bit-packed popcounts: the per-read pair loop of
// fragment.rs:208-240 restricted to the pairs calculate_ld consumes (both
// columns flagged in ld_cols — ref among the two alleles, not dense).
// P is the [K,I] int8 cell matrix (+1 ref / -1 alt / 0 none, row-major).
// Each kept column's ref/alt cells are packed into K-bit masks; a pair's
// 2x2 (ref/alt)² table is then four AND+popcount reductions over the
// intersection of the two columns' nonzero word spans (reads are
// coordinate-sorted, so a column's covering reads — and hence its set bits —
// form one narrow contiguous range). Pairs with all-zero tables are not
// emitted, matching the dense-GEMM version's nonzero filter.
//
// Outputs, in (i, j) row-major order (identical to the numpy version's
// np.nonzero(triu) order): out_i/out_j column indices and out_cnt 4 ints
// per pair [rr, ra, ar, aa]. Returns the pair count, or -1 when cap would
// overflow (caller falls back).
int64_t ld_pair_counts(const int8_t* P, int64_t K, int64_t I,
                       const uint8_t* ld_cols,
                       int32_t* out_i, int32_t* out_j, int32_t* out_cnt,
                       int64_t cap, int n_threads) {
    const int64_t W = (K + 63) >> 6;
    std::vector<int32_t> cols;
    cols.reserve(I);
    for (int64_t i = 0; i < I; ++i) if (ld_cols[i]) cols.push_back((int32_t)i);
    const int64_t NC = (int64_t)cols.size();
    if (NC == 0 || K == 0) return 0;
    std::vector<uint64_t> rbits((size_t)(NC * W), 0);
    std::vector<uint64_t> abits((size_t)(NC * W), 0);
    std::vector<int32_t> colmap((size_t)I, -1);
    for (int64_t a = 0; a < NC; ++a) colmap[cols[a]] = (int32_t)a;
    for (int64_t k = 0; k < K; ++k) {
        const int8_t* row = P + k * I;
        const uint64_t bit = 1ull << (k & 63);
        const int64_t w = k >> 6;
        for (int64_t i = 0; i < I; ++i) {
            int8_t v = row[i];
            if (!v) continue;
            int32_t a = colmap[i];
            if (a < 0) continue;
            if (v > 0) rbits[(size_t)(a * W + w)] |= bit;
            else       abits[(size_t)(a * W + w)] |= bit;
        }
    }
    std::vector<int32_t> wlo((size_t)NC), whi((size_t)NC);
    for (int64_t a = 0; a < NC; ++a) {
        int64_t lo = W, hi = 0;
        const uint64_t* r = rbits.data() + a * W;
        const uint64_t* q = abits.data() + a * W;
        for (int64_t w = 0; w < W; ++w)
            if (r[w] | q[w]) { if (w < lo) lo = w; hi = w + 1; }
        wlo[a] = (int32_t)lo;
        whi[a] = (int32_t)hi;
    }
    // contiguous 'a' ranges balanced by pair count; per-thread buffers are
    // concatenated in range order so the output order is thread-invariant
    int T = std::max(1, std::min(n_threads, (int)std::min<int64_t>(NC, 64)));
    const double total_pairs = 0.5 * (double)NC * (double)(NC - 1);
    std::vector<int64_t> bounds(T + 1, NC);
    bounds[0] = 0;
    {
        int64_t a = 0;
        for (int t = 1; t < T; ++t) {
            double target = total_pairs * t / T;
            // pairs with first index < a: NC*a - a(a+1)/2
            while (a < NC
                   && ((double)NC * a - 0.5 * (double)a * (a + 1)) < target)
                ++a;
            bounds[t] = a;
        }
    }
    struct Out { std::vector<int32_t> i, j, c; };
    std::vector<Out> outs((size_t)T);
    auto work = [&](int t) {
        Out& o = outs[t];
        for (int64_t a = bounds[t]; a < bounds[t + 1]; ++a) {
            const uint64_t* Ra = rbits.data() + a * W;
            const uint64_t* Aa = abits.data() + a * W;
            const int32_t la = wlo[a], ha = whi[a];
            if (la >= ha) continue;
            for (int64_t b = a + 1; b < NC; ++b) {
                const int32_t lo = std::max(la, wlo[b]);
                const int32_t hi = std::min(ha, whi[b]);
                if (lo >= hi) continue;
                const uint64_t* Rb = rbits.data() + b * W;
                const uint64_t* Ab = abits.data() + b * W;
                uint32_t rr = 0, ra = 0, ar = 0, aa = 0;
                for (int32_t w = lo; w < hi; ++w) {
                    const uint64_t x = Ra[w], y = Aa[w];
                    const uint64_t u = Rb[w], v = Ab[w];
                    rr += (uint32_t)__builtin_popcountll(x & u);
                    ra += (uint32_t)__builtin_popcountll(x & v);
                    ar += (uint32_t)__builtin_popcountll(y & u);
                    aa += (uint32_t)__builtin_popcountll(y & v);
                }
                if (rr | ra | ar | aa) {
                    o.i.push_back(cols[a]);
                    o.j.push_back(cols[b]);
                    o.c.push_back((int32_t)rr);
                    o.c.push_back((int32_t)ra);
                    o.c.push_back((int32_t)ar);
                    o.c.push_back((int32_t)aa);
                }
            }
        }
    };
    if (T <= 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < T; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
    int64_t n = 0;
    for (auto& o : outs) n += (int64_t)o.i.size();
    if (n > cap) return -1;
    int64_t w = 0;
    for (auto& o : outs) {
        std::memcpy(out_i + w, o.i.data(), o.i.size() * 4);
        std::memcpy(out_j + w, o.j.data(), o.j.size() * 4);
        std::memcpy(out_cnt + 4 * w, o.c.data(), o.c.size() * 4);
        w += (int64_t)o.i.size();
    }
    return n;
}

// ---------------------------------------------------------------------------
// assignment-layer cell kernels
// ---------------------------------------------------------------------------

// assign_group_hist: integer cell histograms for the assignment layer's
// masked row-group sums (snpfrags.rs:378-625 semantics; the Python GEMM
// formulation streamed a [K,4I] f64 table per call). Every cell's emission
// value is a function of (sign(p), capped baseq) only, so the per-column
// group sums reduce to counts: H[g][i][s][q] = #cells of column i in
// read-group g with allele sign s (0:+1, 1:-1) and capped baseq q. The
// f64 combination with the log10 tables happens in numpy in one fixed
// order — deterministic and thread-count-invariant by construction.
//
// CSR cell inputs (read-major, as built by get_fragments): off[K+1],
// ci/cp/cq[nnz]. gcode per read: 0xFF = excluded (read_mask false), else
// bits 0-1 sigma group (0: sigma=+1, 1: sigma=-1, 2: sigma=0) and bits 2-3
// assignment group (0: none, 1: assignment==1, 2: assignment==2). Groups
// 0-2 are the sigma split, 3-4 the assignment split, 5 all masked reads.
// H is int32 [6][I][2][n_q], zeroed by the caller. Threads split the read
// range with private histograms merged by addition (order-invariant).
int assign_group_hist(int64_t K, int64_t I,
                      const int64_t* off, const int32_t* ci,
                      const int8_t* cp, const uint8_t* cq,
                      const uint8_t* gcode, int64_t n_q,
                      int32_t* H, int n_threads) {
    const int64_t QB = n_q;
    const int64_t stride_g = I * 2 * QB;
    const int64_t hsize = 6 * stride_g;
    auto accum = [&](int64_t k0, int64_t k1, int32_t* Hb) {
        for (int64_t k = k0; k < k1; ++k) {
            const uint8_t code = gcode[k];
            if (code == 0xFF) continue;
            int32_t* Hs = Hb + (int64_t)(code & 3) * stride_g;
            const int ga = (code >> 2) & 3;
            int32_t* Ha = ga ? Hb + (int64_t)(2 + ga) * stride_g : nullptr;
            int32_t* Hl = Hb + 5 * stride_g;
            const int64_t c1 = off[k + 1];
            for (int64_t c = off[k]; c < c1; ++c) {
                int64_t q = cq[c];
                if (q >= QB) q = QB - 1;
                const int64_t idx =
                    ((int64_t)ci[c] * 2 + (cp[c] > 0 ? 0 : 1)) * QB + q;
                Hs[idx]++;
                if (Ha) Ha[idx]++;
                Hl[idx]++;
            }
        }
    };
    const int64_t nnz = K ? off[K] : 0;
    int T = (int)std::max<int64_t>(1, std::min<int64_t>(
        n_threads, std::min<int64_t>(K, nnz / 65536 + 1)));
    if (T <= 1) {
        accum(0, K, H);
        return 0;
    }
    // split by cell count so skewed coverage balances
    std::vector<int64_t> bounds(T + 1, K);
    bounds[0] = 0;
    {
        int64_t k = 0;
        for (int t = 1; t < T; ++t) {
            const int64_t target = nnz * t / T;
            while (k < K && off[k] < target) ++k;
            bounds[t] = k;
        }
    }
    std::vector<int32_t> priv((size_t)((T - 1) * hsize), 0);
    std::vector<std::thread> ts;
    for (int t = 1; t < T; ++t)
        ts.emplace_back(accum, bounds[t], bounds[t + 1],
                        priv.data() + (int64_t)(t - 1) * hsize);
    accum(bounds[0], bounds[1], H);
    for (auto& th : ts) th.join();
    for (int t = 1; t < T; ++t) {
        const int32_t* src = priv.data() + (int64_t)(t - 1) * hsize;
        for (int64_t x = 0; x < hsize; ++x) H[x] += src[x];
    }
    return 0;
}

// assign_read_sums: per-read masked column sums for assign_reads_haplotype
// (snpfrags.rs:548-625). For each read k over its CSR cells at columns with
// dcode != 0: tp accumulates the emission term of the CURRENT delta sign,
// tm of the flipped sign, ncells the cell count. dcode per column:
// 0 = column not gathered, 1 = delta>0, 2 = delta<0, 3 = delta==0.
// Emission: match(delta, p) ? l1m[q] : lerr[q]; delta==0 contributes
// lerr[q] to both. Accumulation order is CSR order — fixed per region.
int assign_read_sums(int64_t K,
                     const int64_t* off, const int32_t* ci,
                     const int8_t* cp, const uint8_t* cq,
                     const int8_t* dcode, int64_t n_q,
                     const double* l1m, const double* lerr,
                     double* tp, double* tm, int32_t* ncells) {
    const int64_t QB = n_q;
    for (int64_t k = 0; k < K; ++k) {
        double a = 0.0, b = 0.0;
        int32_t n = 0;
        const int64_t c1 = off[k + 1];
        for (int64_t c = off[k]; c < c1; ++c) {
            const int8_t dc = dcode[ci[c]];
            if (!dc) continue;
            int64_t q = cq[c];
            if (q >= QB) q = QB - 1;
            ++n;
            if (dc == 3) {
                a += lerr[q];
                b += lerr[q];
            } else {
                const bool match = (dc == 1) == (cp[c] > 0);
                a += match ? l1m[q] : lerr[q];
                b += match ? lerr[q] : l1m[q];
            }
        }
        tp[k] = a;
        tm[k] = b;
        ncells[k] = n;
    }
    return 0;
}

}  // extern "C"

extern "C" {

// Scan BAM alignment records starting at `start`; fill per-record columns.
// Returns the record count, or -1 on overrun/corruption.
int64_t scan_bam_records(const uint8_t* data, int64_t n, int64_t start,
                         int64_t cap, int64_t* rec_off, int64_t* rec_end,
                         int32_t* ref_id, int64_t* pos, uint16_t* flag,
                         uint8_t* mapq, int32_t* l_seq, int32_t* n_cigar,
                         int32_t* l_read_name, int64_t* ref_end_out,
                         float* de_out) {
    int64_t p = start;
    int64_t k = 0;
    while (p + 4 <= n) {
        int32_t block_size;
        std::memcpy(&block_size, data + p, 4);
        if (block_size < 32 || p + 4 + block_size > n) return -1;
        if (k >= cap) return -1;
        const uint8_t* r = data + p + 4;
        int32_t rid, pos32, lseq;
        std::memcpy(&rid, r, 4);
        std::memcpy(&pos32, r + 4, 4);
        uint8_t lrn = r[8];
        uint8_t mq = r[9];
        uint16_t ncig, fl;
        std::memcpy(&ncig, r + 12, 2);
        std::memcpy(&fl, r + 14, 2);
        std::memcpy(&lseq, r + 16, 4);
        rec_off[k] = p + 4;
        rec_end[k] = p + 4 + block_size;
        ref_id[k] = rid;
        pos[k] = pos32;
        flag[k] = fl;
        mapq[k] = mq;
        l_seq[k] = lseq;
        n_cigar[k] = ncig;
        l_read_name[k] = lrn;
        // reference span from the cigar (ops M/D/N/=/X consume reference)
        {
            const uint32_t* cg = reinterpret_cast<const uint32_t*>(r + 32 + lrn);
            int64_t span = 0;
            for (int c = 0; c < ncig; ++c) {
                int op = cg[c] & 0xF;
                if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
                    span += cg[c] >> 4;
            }
            ref_end_out[k] = (int64_t)pos32 + span;
        }
        // `de` float aux tag (gap-compressed divergence); NaN when absent
        {
            RecView v = view_record(data, p + 4, p + 4 + block_size);
            float de = __builtin_nanf("");
            const uint8_t* q = v.aux;
            while (q + 3 <= v.aux_end) {
                char a = (char)q[0], b2 = (char)q[1], typ = (char)q[2];
                q += 3;
                if (a == 'd' && b2 == 'e' && typ == 'f') {
                    if (q + 4 <= v.aux_end) std::memcpy(&de, q, 4);
                    break;
                }
                int sz = aux_sizes(typ);
                if (sz > 0) { q += sz; continue; }
                if (typ == 'Z' || typ == 'H') {
                    while (q < v.aux_end && *q) ++q;
                    ++q;
                    continue;
                }
                if (typ == 'B') {
                    if (q + 5 > v.aux_end) break;  // truncated B header
                    char st = (char)q[0];
                    int32_t cnt;
                    std::memcpy(&cnt, q + 1, 4);
                    int esz = aux_sizes(st);
                    if (esz < 0 || cnt < 0) break;  // corrupt: bail
                    q += 5 + (int64_t)cnt * esz;
                    continue;
                }
                break;
            }
            de_out[k] = de;
        }
        ++k;
        p += 4 + block_size;
    }
    return k;
}

}  // extern "C"
