// Banded affine-gap DP with traceback for CIGAR emission.
//
// Host-side companion to the TPU score kernels: the device finds
// (score, start, end) for every surviving pair; this routine re-runs the
// DP inside the [start,end] rectangle with a band of width
// |dbLen-qLen|+1 (doubling until the known score is reached) and walks
// the direction matrix to produce M/I/D ops.
//
// Semantics follow the reference implementation banded_sw
// (lib/mmseqs/src/alignment/StripedSmithWaterman.cpp:1348-1599) exactly:
//   * E (query-consuming 'I') prefers open over extend on strict >
//   * F (target-consuming 'D') prefers open over extend on strict >
//   * H prefers the diagonal on ties (temp1 <= temp2 -> diag), otherwise
//     the E direction wins ties against F only when e1 > f1
//   * traceback starts in state H at the rectangle corner and forces a
//     leading M
// Cell scores: sub[q_i][t_j] + compositionBias[i].

#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <type_traits>
#include <vector>

namespace {

inline int band_u(int w, int i, int j) {
    int x = i - w;
    x = x > 0 ? x : 0;
    return j - x + 1;
}

inline long band_d(int w, int i, int j, int p) {
    int x = i - w;
    x = x > 0 ? x : 0;
    return (long)(j - x) * 3 + p;
}

// The scoring modes below are chosen at run time from which tables are
// given; a cell functor (Cell) is chosen at compile time instead, so the
// instantiations of the runtime modes compile to the code they had.
struct RuntimeCell {};

// Structure search: the combined 3Di x amino-acid alphabet scored from its
// two 21x21 tables, int8(m3di[qss_i][tss_j] + bias_i + aa[qaa_i][taa_j]):
// the same int32 sum and narrowing as the entry the (441, L) combined
// profile holds at (tss_j*21 + taa_j, i).  Pointers start at the
// rectangle's first residues.
struct StructCell {
    static constexpr int kAlpha = 21;
    const uint8_t* qss;
    const uint8_t* qaa;
    const int8_t* bias;
    const uint8_t* tss;
    const uint8_t* taa;
    const int32_t* m3di;
    const int32_t* aa;
    int operator()(int i, int j) const {
        return (int8_t)(m3di[qss[i] * kAlpha + tss[j]] + bias[i] +
                        aa[qaa[i] * kAlpha + taa[j]]);
    }
};

}  // namespace

// Returns length of ops written (M/I/D chars into out_ops, max out_cap),
// or -1 on failure (score not reached even at max band), -2 if out_cap
// too small.
//
// Three scoring modes (mirroring banded_sw's SUBSTITUTIONMATRIX,
// PROFILE_SEQ and PROFILE_PROFILE types,
// StripedSmithWaterman.cpp:1461-1478):
//   * mat != NULL: cell score = mat[q[i]*alpha + t[j]] + bias[i]
//   * prof != NULL: cell score = prof[t[j]*prof_qlen + (query_start+i)]
//     (per-position profile, layout [aa][query_pos])
//   * tprof != NULL additionally (PROFILE_PROFILE): t[] and qcons[] are
//     the two CONSENSUS sequences; the cell combines the two profile
//     scores s1 = prof[t[j]][qs+i], s2 = tprof[qcons[i]][ts+j] as
//     ((|mn|+mn)+(|mn|+mx)+1)/2 - |mn| (the reference's rounded mean
//     with negative-score clamp-to-min, StripedSmithWaterman.cpp:1464-1470)
// A Cell other than RuntimeCell replaces all three: cell score =
// (*cell_fn)(i, j), and q, t, mat and prof are not read.
template <typename TT, typename Cell = RuntimeCell>
static int banded_align_impl(const uint8_t* q, const TT* t,
                             const int8_t* bias, int q_len, int t_len,
                             const int8_t* mat, int alpha_size,
                             const int8_t* prof, int prof_qlen,
                             int query_start, int score, int gap_open,
                             int gap_extend, int band_width, char* out_ops,
                             int out_cap,
                             const int8_t* tprof = NULL,
                             int tprof_tlen = 0, int target_start = 0,
                             const uint8_t* qcons = NULL,
                             const Cell* cell_fn = NULL) {
    std::vector<int32_t> h_b, e_b, h_c;
    std::vector<int8_t> direction;
    long width = 0, width_d = 0;
    int max_h = 0;

    for (;;) {
        width = (long)band_width * 2 + 3;
        width_d = (long)band_width * 2 + 1;
        h_b.assign(width + 2, 0);
        e_b.assign(width + 2, 0);
        h_c.assign(width + 2, 0);
        direction.assign(width_d * 3 * (long)q_len, 0);
        max_h = 0;

        for (long j = 1; j < width - 1; ++j) h_b[j] = 0;
        for (int i = 0; i < q_len; ++i) {
            int beg = 0, end = t_len - 1, u = 0;
            if (i - band_width > beg) beg = i - band_width;
            if (i + band_width < end) end = i + band_width;
            int edge = (end + 1 < width - 1) ? end + 1 : (int)(width - 1);
            int f = 0;
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0;
            f = 0;
            int8_t* dline = direction.data() + width_d * 3 * (long)i;

            for (int j = beg; j <= end; ++j) {
                int b, e, d;
                u = band_u(band_width, i, j);
                e = band_u(band_width, i - 1, j);
                b = band_u(band_width, i, j - 1);
                d = band_u(band_width, i - 1, j - 1);
                long de = band_d(band_width, i, j, 0);
                long df = band_d(band_width, i, j, 1);
                long dh = band_d(band_width, i, j, 2);

                int temp1 = (i == 0) ? -gap_open : h_b[e] - gap_open;
                int temp2 = (i == 0) ? -gap_extend : e_b[e] - gap_extend;
                e_b[u] = temp1 > temp2 ? temp1 : temp2;
                dline[de] = temp1 > temp2 ? 3 : 2;

                temp1 = h_c[b] - gap_open;
                temp2 = f - gap_extend;
                f = temp1 > temp2 ? temp1 : temp2;
                dline[df] = temp1 > temp2 ? 5 : 4;

                int f1 = f > 0 ? f : 0;
                int e1 = e_b[u] > 0 ? e_b[u] : 0;
                temp1 = e1 > f1 ? e1 : f1;
                int cell;
                if constexpr (!std::is_same<Cell, RuntimeCell>::value) {
                    cell = (*cell_fn)(i, j);
                } else if (tprof != NULL) {
                    const int s1 =
                        prof[(int)t[j] * prof_qlen + (query_start + i)];
                    const int s2 = tprof[(int)qcons[i] * tprof_tlen +
                                         (target_start + j)];
                    const int mn = s1 < s2 ? s1 : s2;
                    const int mx = s1 < s2 ? s2 : s1;
                    const int amn = mn < 0 ? -mn : mn;
                    cell = (((amn + mn) + (amn + mx) + 1) / 2) - amn;
                } else if (prof != NULL) {
                    cell = prof[(int)t[j] * prof_qlen + (query_start + i)];
                } else {
                    cell = mat[(int)q[i] * alpha_size + (int)t[j]] +
                           (bias ? bias[i] : 0);
                }
                temp2 = h_b[d] + cell;

                h_c[u] = temp1 > temp2 ? temp1 : temp2;
                if (h_c[u] > max_h) max_h = h_c[u];
                if (temp1 <= temp2) dline[dh] = 1;
                else dline[dh] = e1 > f1 ? dline[de] : dline[df];
            }
            for (int j = 1; j <= u; ++j) h_b[j] = h_c[j];
        }
        if (max_h >= score) break;
        if ((long)band_width * 2 > 2L * (q_len + t_len) + 8) return -1;
        band_width *= 2;
    }

    // traceback
    std::vector<char> ops;
    ops.reserve(q_len + t_len);
    int i = q_len - 1, j = t_len - 1;
    int state = 2;  // h
    long line = width_d * 3 * (long)(q_len - 1);
    while (i > 0 || j > 0) {
        long idx = band_d(band_width, i, j, state);
        int8_t dir = direction[line + idx];
        char op;
        switch (dir) {
            case 1: --i; --j; state = 2; line -= width_d * 3; op = 'M'; break;
            case 2: --i; state = 0; line -= width_d * 3; op = 'I'; break;
            case 3: --i; state = 2; line -= width_d * 3; op = 'I'; break;
            case 4: --j; state = 1; op = 'D'; break;
            case 5: --j; state = 2; op = 'D'; break;
            default: return -1;
        }
        ops.push_back(op);
    }
    // the walk stops at (0,0): the final cell is always an M
    ops.push_back('M');

    if ((int)ops.size() > out_cap) return -2;
    // ops were collected end->start; reverse
    for (size_t k = 0; k < ops.size(); ++k) {
        out_ops[k] = ops[ops.size() - 1 - k];
    }
    return (int)ops.size();
}

extern "C" {

int banded_align(const uint8_t* q, const uint8_t* t, const int8_t* bias,
                 int q_len, int t_len, const int8_t* mat, int alpha_size,
                 int score, int gap_open, int gap_extend, int band_width,
                 char* out_ops, int out_cap) {
    return banded_align_impl(q, t, bias, q_len, t_len, mat, alpha_size,
                             NULL, 0, 0, score, gap_open, gap_extend,
                             band_width, out_ops, out_cap);
}

int banded_align_profile(const uint8_t* t, int q_len, int t_len,
                         const int8_t* prof, int prof_qlen, int query_start,
                         int score, int gap_open, int gap_extend,
                         int band_width, char* out_ops, int out_cap) {
    return banded_align_impl(NULL, t, NULL, q_len, t_len, NULL, 0, prof,
                             prof_qlen, query_start, score, gap_open,
                             gap_extend, band_width, out_ops, out_cap);
}

// Batched traceback: one call for all survivors of an alignment stage,
// OpenMP-parallel over pairs (the per-call Python/ctypes overhead and
// serial host time dominate otherwise). Inputs are the full sequence /
// bias arrays plus per-pair rectangle descriptors; CIGARs are written
// into per-pair slices of out_ops (each capped at q_span + t_span + 8).
// n_ident (match-state identity count) and the op length are returned
// per pair so the caller skips the op walk entirely.
int banded_align_batch(const uint8_t* qdata, const int64_t* qoffs,
                       const uint8_t* tdata, const int64_t* toffs,
                       const int8_t* bias_data,
                       const int8_t* mat, int alpha_size,
                       int n, const int32_t* qk, const int32_t* tk,
                       const int32_t* qstart, const int32_t* qend,
                       const int32_t* tstart, const int32_t* tend,
                       const int32_t* score,
                       int gap_open, int gap_extend,
                       const int64_t* out_offs, char* out_ops,
                       int32_t* out_len, int32_t* out_ident,
                       // optional compressed-CIGAR emission
                       // (Matcher::compressAlignment): buffer with
                       // 2*out_offs spacing, NULL = skip
                       char* out_cigar, int32_t* out_clen) {
    int bad = 0;
#pragma omp parallel for schedule(dynamic, 16) reduction(+:bad)
    for (int i = 0; i < n; ++i) {
        const uint8_t* q = qdata + qoffs[qk[i]] + qstart[i];
        const uint8_t* t = tdata + toffs[tk[i]] + tstart[i];
        const int8_t* bias = bias_data + qoffs[qk[i]] + qstart[i];
        const int q_len = qend[i] - qstart[i] + 1;
        const int t_len = tend[i] - tstart[i] + 1;
        const int band = (q_len > t_len ? q_len - t_len : t_len - q_len) + 1;
        char* out = out_ops + out_offs[i];
        const int cap = (int)(out_offs[i + 1] - out_offs[i]);
        int len = banded_align_impl(q, t, bias, q_len, t_len, mat,
                                    alpha_size, NULL, 0, 0, score[i],
                                    gap_open, gap_extend, band, out, cap);
        if (len < 0) { bad++; out_len[i] = -1; continue; }
        out_len[i] = len;
        int ids = 0, qp = 0, tp = 0;
        for (int c = 0; c < len; ++c) {
            if (out[c] == 'M') { ids += (q[qp] == t[tp]); ++qp; ++tp; }
            else if (out[c] == 'I') ++qp;
            else ++tp;
        }
        out_ident[i] = ids;
        if (out_cigar != NULL) {
            // run-length encode in place (the Python-side per-record
            // compress_cigar loop was ~6 s of host time at scale)
            char* cg = out_cigar + 2 * out_offs[i];
            int ci = 0, c = 0;
            while (c < len) {
                int r = c + 1;
                while (r < len && out[r] == out[c]) ++r;
                // format into a local buffer: snprintf's NUL would land
                // one byte past the 2*len slot when the RLE fills it
                char run[16];
                const int w = snprintf(run, sizeof run, "%d%c", r - c,
                                       out[c]);
                memcpy(cg + ci, run, (size_t)w);
                ci += w;
                c = r;
            }
            out_clen[i] = ci;
        }
    }
    return bad;
}

// Batched traceback of the structure search (StructCell): one call for all
// survivors of a stage, OpenMP-parallel over pairs, as banded_align_batch.
// The query and target DBs come as their 3Di and amino-acid arrays over
// one offset table each; bias_data is the query's 3Di composition bias in
// the same layout; m3di and aa_scaled are 21x21.  Writes each pair's
// expanded ops into its slice of out_ops, the op length and the identity
// count (M columns with equal amino acids); no CIGAR.  Returns the number
// of failed pairs (out_len -1).
int banded_align_struct_batch(const uint8_t* qss_data,
                              const uint8_t* qaa_data, const int64_t* qoffs,
                              const int8_t* bias_data,
                              const uint8_t* tss_data,
                              const uint8_t* taa_data, const int64_t* toffs,
                              const int32_t* m3di, const int32_t* aa_scaled,
                              int n, const int32_t* qk, const int32_t* tk,
                              const int32_t* qstart, const int32_t* qend,
                              const int32_t* tstart, const int32_t* tend,
                              const int32_t* score,
                              int gap_open, int gap_extend,
                              const int64_t* out_offs, char* out_ops,
                              int32_t* out_len, int32_t* out_ident) {
    int bad = 0;
#pragma omp parallel for schedule(dynamic, 16) reduction(+:bad)
    for (int i = 0; i < n; ++i) {
        const int64_t qo = qoffs[qk[i]] + qstart[i];
        const int64_t to = toffs[tk[i]] + tstart[i];
        const StructCell cell = {qss_data + qo, qaa_data + qo,
                                 bias_data + qo, tss_data + to,
                                 taa_data + to, m3di, aa_scaled};
        const int q_len = qend[i] - qstart[i] + 1;
        const int t_len = tend[i] - tstart[i] + 1;
        const int band = (q_len > t_len ? q_len - t_len : t_len - q_len) + 1;
        char* out = out_ops + out_offs[i];
        const int cap = (int)(out_offs[i + 1] - out_offs[i]);
        int len = banded_align_impl<uint8_t, StructCell>(
            NULL, NULL, NULL, q_len, t_len, NULL, 0, NULL, 0, 0, score[i],
            gap_open, gap_extend, band, out, cap, NULL, 0, 0, NULL, &cell);
        if (len < 0) { bad++; out_len[i] = -1; continue; }
        out_len[i] = len;
        int ids = 0, qp = 0, tp = 0;
        for (int c = 0; c < len; ++c) {
            if (out[c] == 'M') {
                ids += (cell.qaa[qp] == cell.taa[tp]);
                ++qp; ++tp;
            } else if (out[c] == 'I') ++qp;
            else ++tp;
        }
        out_ident[i] = ids;
    }
    return bad;
}

// PROFILE_PROFILE traceback (StripedSmithWaterman.cpp:1461-1470): both
// inputs are profiles; t = target CONSENSUS residues over the aligned
// rectangle, qcons = query consensus residues.
int banded_align_profile_profile(
    const uint8_t* t, const uint8_t* qcons, int q_len, int t_len,
    const int8_t* qprof, int qprof_qlen, int query_start,
    const int8_t* tprof, int tprof_tlen, int target_start,
    int score, int gap_open, int gap_extend, int band_width,
    char* out_ops, int out_cap) {
    return banded_align_impl(NULL, t, NULL, q_len, t_len, NULL, 0, qprof,
                             qprof_qlen, query_start, score, gap_open,
                             gap_extend, band_width, out_ops, out_cap,
                             tprof, tprof_tlen, target_start, qcons);
}

// 3Di x amino-acid alphabet of the structure-alignment mode (441 symbols:
// symbol = ss*21 + aa).
int banded_align_profile_u16(const uint16_t* t, int q_len, int t_len,
                             const int8_t* prof, int prof_qlen,
                             int query_start, int score, int gap_open,
                             int gap_extend, int band_width, char* out_ops,
                             int out_cap) {
    return banded_align_impl(NULL, t, NULL, q_len, t_len, NULL, 0, prof,
                             prof_qlen, query_start, score, gap_open,
                             gap_extend, band_width, out_ops, out_cap);
}

}  // extern "C"
