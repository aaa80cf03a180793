// Banded nucleotide extension aligner — native equivalent of the
// reference's BandedNucleotideAligner (lib/mmseqs/src/alignment/
// BandedNucleotideAligner.cpp:73-263) built on ksw2-style NW extension
// (lib/mmseqs/lib/ksw2/ksw2.h: gap of length l costs gapo + l*gape,
// band w around the main diagonal, zdrop off-diagonal termination).
//
// Flow (align()): ungapped Kadane segment along the prefilter diagonal
// (DistanceCalculator::computeSubstitutionStartEndDistance semantics,
// DistanceCalculator.h:179-201); full-query perfect-span fast path;
// otherwise a score-only reverse extension from the ungapped end finds
// the start, then a forward extension with traceback emits the CIGAR.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Ungapped {
  int score = 0;
  int start = 0;   // positions relative to the clipped diagonal run
  int end = 0;
};

// computeSubstitutionStartEndDistance (Kadane with the reference's
// exact tie handling)
static Ungapped kadane(const uint8_t* a, const uint8_t* b, int n,
                       const int32_t* mat, int alpha) {
  Ungapped r;
  int minPos = -1, score = 0;
  for (int pos = 0; pos < n; ++pos) {
    score += mat[a[pos] * alpha + b[pos]];
    const bool isMin = score <= 0;
    if (isMin) { score = 0; minPos = pos; }
    if (score > r.score) {
      r.end = pos;
      r.start = minPos + 1;
      r.score = score;
    }
  }
  return r;
}

struct ExtRes {
  int max = 0;      // best extension score
  int max_q = -1;   // query index of the best cell
  int max_t = -1;   // target index of the best cell
};

// NW-like banded extension (scalar ksw_extz): H over (i=query, j=target)
// from origin (0,0) with gap cost gapo + l*gape, band |i-j| <= w, zdrop.
// When `ops` is non-null the M/I/D path from (0,0) to (max_q, max_t) is
// appended (I consumes query, D consumes target, matching the cigar
// decode loop in BandedNucleotideAligner.cpp:231-256).
static ExtRes extend(const uint8_t* q, int qlen, const uint8_t* t, int tlen,
                     const int32_t* mat, int alpha, int gapo, int gape,
                     int w, int zdrop, std::string* ops) {
  const int NEG = -0x40000000;
  ExtRes ez;
  if (qlen <= 0 || tlen <= 0) return ez;
  const int W = 2 * w + 1;
  // band-relative storage: row i covers j in [i-w, i+w]
  std::vector<int> H(W, NEG), E(W, NEG);
  std::vector<uint8_t> tb;     // 2 bits per cell: 0=diag,1=up(I),2=left(D)
  const bool want_tb = ops != nullptr;
  if (want_tb) tb.assign((size_t)(qlen + 1) * W, 0);
  // rows are indexed i = -1..qlen-1 over the query; cell (i, j) lives at
  // band offset k = j - i + w.  Row -1: H(-1,-1) = 0 (at k = w) and
  // H(-1, j) = -(gapo + (j+1)*gape) for j >= 0 (deletion-only prefix).
  std::vector<int> Hprev(W, NEG), Eprev(W, NEG);
  Hprev[w] = 0;
  for (int k = 0; k < W; ++k) {
    int j = k - w - 1;
    if (j >= 0 && j < tlen) Hprev[k] = -(gapo + (j + 1) * gape);
  }
  ez.max = 0; ez.max_q = -1; ez.max_t = -1;
  std::vector<int> F(W, NEG);
  bool zdropped = false;
  for (int i = 0; i < qlen && !zdropped; ++i) {
    std::fill(H.begin(), H.end(), NEG);
    std::fill(E.begin(), E.end(), NEG);
    int jlo = std::max(0, i - w), jhi = std::min(tlen - 1, i + w);
    int rowmax = NEG, rowmax_j = -1;
    for (int j = jlo; j <= jhi; ++j) {
      const int k = j - i + w;
      // diag from (i-1, j-1): same band offset k in the previous row
      int diag = (j == 0 && i == 0) ? 0
               : (j == 0) ? -(gapo + i * gape)          // H(i-1, -1)
               : Hprev[k];
      int sc_diag = (diag <= NEG / 2) ? NEG
                    : diag + mat[q[i] * alpha + t[j]];
      // E: gap in target dimension? Convention: I consumes query ->
      // vertical move from (i-1, j), band offset k+1 in previous row.
      int up_open = (k + 1 < W && Hprev[k + 1] > NEG / 2)
                    ? Hprev[k + 1] - (gapo + gape) : NEG;
      int up_ext = (k + 1 < W && Eprev[k + 1] > NEG / 2)
                   ? Eprev[k + 1] - gape : NEG;
      int e_val = std::max(up_open, up_ext);
      // F: D consumes target -> horizontal from (i, j-1), offset k-1 same row
      int left_open = (k - 1 >= 0 && H[k - 1] > NEG / 2)
                      ? H[k - 1] - (gapo + gape) : NEG;
      int left_ext = (k - 1 >= 0 && F[k - 1] > NEG / 2)
                     ? F[k - 1] - gape : NEG;
      int f_val = std::max(left_open, left_ext);
      int best = sc_diag;
      uint8_t dir = 0;
      if (e_val > best) { best = e_val; dir = 1; }
      if (f_val > best) { best = f_val; dir = 2; }
      H[k] = best;
      E[k] = e_val;
      F[k] = f_val;
      if (want_tb) tb[(size_t)(i + 1) * W + k] = dir;
      if (best > rowmax) { rowmax = best; rowmax_j = j; }
      if (best > ez.max) { ez.max = best; ez.max_q = i; ez.max_t = j; }
    }
    // zdrop check (ksw2: against the global max, with off-diagonal cost)
    if (zdrop >= 0 && ez.max_q >= 0 && rowmax_j >= 0) {
      int di = i - ez.max_q, dj = rowmax_j - ez.max_t;
      int diff = di > dj ? di - dj : dj - di;
      if (ez.max - rowmax > zdrop + diff * gape) zdropped = true;
    }
    std::swap(Hprev, H);
    std::swap(Eprev, E);
    std::fill(F.begin(), F.end(), NEG);
  }
  if (want_tb && ez.max_q >= 0) {
    // walk back from (max_q, max_t) to (0,0)
    std::string rev;
    int i = ez.max_q, j = ez.max_t;
    while (i >= 0 && j >= 0) {
      uint8_t dir = tb[(size_t)(i + 1) * W + (j - i + w)];
      if (dir == 0) { rev.push_back('M'); --i; --j; }
      else if (dir == 1) { rev.push_back('I'); --i; }
      else { rev.push_back('D'); --j; }
    }
    while (i >= 0) { rev.push_back('I'); --i; }
    while (j >= 0) { rev.push_back('D'); --j; }
    ops->assign(rev.rbegin(), rev.rend());
  }
  return ez;
}

}  // namespace

extern "C" {

// Full BandedNucleotideAligner::align flow. q must already be the
// strand-correct query (reverse hits pass the reverse complement).
// out[9]: score, qstart, qend, tstart, tend, n_ident, aln_len,
//         used_fastpath, zdropped(unused)
// Returns cigar length written to cigar_out (expanded M/I/D), or -1 on
// buffer overflow.
int nucl_banded_align(const uint8_t* q, int qlen, const uint8_t* t, int tlen,
                      int diagonal, const int32_t* mat, int alpha,
                      int gapo, int gape, int zdrop, int band,
                      int32_t* out, char* cigar_out, int cigar_cap) {
  // ungapped along the diagonal (computeUngappedAlignment for the
  // already-resolved int diagonal)
  int dist = diagonal >= 0 ? diagonal : -diagonal;
  int qU0, qU1, tU0, tU1, uscore;
  if (diagonal >= 0) {
    int n = std::min(tlen, qlen - dist);
    if (n <= 0) return -2;
    Ungapped u = kadane(q + dist, t, n, mat, alpha);
    uscore = u.score;
    qU0 = u.start + dist; qU1 = u.end + dist;
    tU0 = u.start; tU1 = u.end;
  } else {
    int n = std::min(tlen - dist, qlen);
    if (n <= 0) return -2;
    Ungapped u = kadane(q, t + dist, n, mat, alpha);
    uscore = u.score;
    qU0 = u.start; qU1 = u.end;
    tU0 = u.start + dist; tU1 = u.end + dist;
  }

  // full-query fast path (BandedNucleotideAligner.cpp:132-159)
  if (qU1 - qU0 == qlen - 1 && tU0 == 0 && tU1 == tlen - 1) {
    int ids = 0;
    for (int i = qU0; i <= qU1; ++i)
      ids += (q[i] == t[tU0 + (i - qU0)]) ? 1 : 0;
    out[0] = uscore; out[1] = qU0; out[2] = qU1;
    out[3] = tU0; out[4] = tU1; out[5] = ids; out[6] = qlen;
    out[7] = 1;
    if (qlen > cigar_cap) return -1;
    memset(cigar_out, 'M', qlen);
    return qlen;
  }

  // reverse extension (score only) from the ungapped END to find start
  std::vector<uint8_t> qrev(qlen), trev(tlen);
  for (int i = 0; i < qlen; ++i) qrev[i] = q[qlen - 1 - i];
  for (int i = 0; i < tlen; ++i) trev[i] = t[tlen - 1 - i];
  int qStartRev = (qlen - qU1) - 1;
  int tStartRev = (tlen - tU1) - 1;
  ExtRes ez = extend(qrev.data() + qStartRev, qlen - qStartRev,
                     trev.data() + tStartRev, tlen - tStartRev,
                     mat, alpha, gapo, gape, band, zdrop, nullptr);
  int qStartPos = qlen - (qStartRev + ez.max_q) - 1;
  int tStartPos = tlen - (tStartRev + ez.max_t) - 1;

  // forward extension with traceback from the found start
  std::string ops;
  ExtRes ezAlign = extend(q + qStartPos, qlen - qStartPos,
                          t + tStartPos, tlen - tStartPos,
                          mat, alpha, gapo, gape, band, zdrop, &ops);
  int finalQStart = qStartPos, finalTStart = tStartPos;
  if (ez.max_q > ezAlign.max_q && ez.max_t > ezAlign.max_t) {
    // the reverse extension reached further: redo with traceback on the
    // reversed sequences and reverse the cigar
    std::string rops;
    ezAlign = extend(qrev.data() + qStartRev, qlen - qStartRev,
                     trev.data() + tStartRev, tlen - tStartRev,
                     mat, alpha, gapo, gape, band, zdrop, &rops);
    ops.assign(rops.rbegin(), rops.rend());
    finalQStart = qlen - (qStartRev + ezAlign.max_q) - 1;
    finalTStart = tlen - (tStartRev + ezAlign.max_t) - 1;
  }
  int ids = 0, qp = finalQStart, tp = finalTStart;
  for (char c : ops) {
    if (c == 'M') { ids += (q[qp] == t[tp]); ++qp; ++tp; }
    else if (c == 'I') ++qp;
    else ++tp;
  }
  out[0] = (int)ezAlign.max;
  out[1] = finalQStart;
  out[2] = finalQStart + ezAlign.max_q;
  out[3] = finalTStart;
  out[4] = finalTStart + ezAlign.max_t;
  out[5] = ids;
  out[6] = (int)ops.size();
  out[7] = 0;
  if ((int)ops.size() > cigar_cap) return -1;
  memcpy(cigar_out, ops.data(), ops.size());
  return (int)ops.size();
}

}  // extern "C"
