// Native k-mer prefilter match engine (OpenMP over queries).
//
// Exact-semantics port of search/prefilter.py's host engine, which is
// bit-parity-verified against the reference prefilter
// (lib/mmseqs/src/prefiltering/QueryMatcher.cpp:85-346,
//  CacheFriendlyOperations.cpp:193-208, UngappedAlignment.cpp:331-362).
//
// Why native and not a device kernel: the k-mer stage is a random-access
// join against a 64M-entry posting-offset table (measured ~670M lookups
// for the bundled regression).  Measured TPU gather throughput through
// XLA on this hardware is ~50M random gathers/s, so the lookup stage is
// latency-bound, not FLOP-bound — the wrong shape for the MXU/VPU.  The
// TPU owns the DP scoring stages (batched Smith-Waterman in ops/); this
// engine owns the pointer-chasing, mirroring the reference's split
// (SIMD prefilter on CPU cores feeding the alignment stage).
//
// Why the ungapped Kadane rescore also stays host-side (it LOOKS like
// VPU work): measured with SPACEDUST_PREF_PROFILE on the 12-genome
// scale workload, generation+posting lookups are ~74% of the engine's
// CPU time and detection+rescore+emit together only ~26% (of which the
// Kadane loop is a fraction) — batching surviving (target, diagonal)
// segments to a device kernel would add an H2D/D2H round trip to save
// at most a few percent of end-to-end wall.
//
// Layout contract (see native/__init__.py::prefilter_match_batch):
//   seed tables   : sc3/id3 are the (8000, 8000) int16 sorted 3-mer
//                   product tables (ExtendedSubstitutionMatrix).
//   posting index : compact hash (keys/off/cnt) + occupancy bitmap;
//                   post_seq/post_pos int32[N] sorted by (kmer,seq,pos).
//   outputs       : per query <= max_seqs rows of (seq, score, diag).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {
// SPACEDUST_PREF_PROFILE=1: per-phase wall sums to stderr (coarse
// hotspot accounting for the match loop; negligible overhead when off)
inline double prof_now() {
#if defined(_OPENMP)
  return omp_get_wtime();
#else
  return 0.0;
#endif
}
}  // namespace

namespace {

constexpr int kPartPow = 8000;       // 20^3

// Part divide strategy (KmerGenerator::setDivideStrategy reversed,
// KmerGenerator.cpp:41-88): k=6 -> [3,3], k=7 -> [2,2,3], k=8 -> [2,3,3].
struct PartSpec {
  const int16_t* sc;    // sorted score rows
  const int16_t* id;    // matching part-k-mer indices
  int rowsize;          // 8000 (3-mer) or 400 (2-mer)
  int size;             // residues in this part
  int64_t mult;         // 20^(residue offset)
};

inline int make_parts(int kmer_size, const int16_t* sc3, const int16_t* id3,
                      const int16_t* sc2, const int16_t* id2,
                      PartSpec* out) {
  int sizes[4];
  int n = 0;
  const int n3 = kmer_size / 3;
  if (kmer_size % 3 == 0) {
    for (int i = 0; i < n3; ++i) sizes[n++] = 3;
  } else if (kmer_size % 3 == 1) {
    sizes[n++] = 2;
    sizes[n++] = 2;
    for (int i = 0; i < n3 - 1; ++i) sizes[n++] = 3;
  } else {
    sizes[n++] = 2;
    for (int i = 0; i < n3; ++i) sizes[n++] = 3;
  }
  int64_t mult = 1;
  for (int i = 0; i < n; ++i) {
    out[i].size = sizes[i];
    out[i].sc = sizes[i] == 3 ? sc3 : sc2;
    out[i].id = sizes[i] == 3 ? id3 : id2;
    out[i].rowsize = sizes[i] == 3 ? 8000 : 400;
    out[i].mult = mult;
    for (int j = 0; j < sizes[i]; ++j) mult *= 20;
  }
  return n;
}

// generateKmerList for one window with >2 parts (k=7/8): nested product
// in part order with per-level possibleRest pruning — same order as the
// reference's calculateArrayProduct chain.
inline void generate_generic(const PartSpec* parts, int n_parts,
                             const int r[], int thr,
                             std::vector<int32_t>& out,
                             std::vector<std::pair<int32_t, int64_t>>& a,
                             std::vector<std::pair<int32_t, int64_t>>& b) {
  out.clear();
  int rows[4];
  int col = 0;
  for (int p = 0; p < n_parts; ++p) {
    int row = 0, m = 1;
    for (int j = 0; j < parts[p].size; ++j) {
      row += r[col + j] * m;
      m *= 20;
    }
    rows[p] = row;
    col += parts[p].size;
  }
  int rest[5];
  rest[n_parts - 1] = 0;
  for (int p = n_parts - 1; p >= 1; --p)
    rest[p - 1] = rest[p]
        + parts[p].sc[static_cast<int64_t>(rows[p]) * parts[p].rowsize];
  a.clear();
  {
    const PartSpec& P = parts[0];
    const int16_t* sc = P.sc + static_cast<int64_t>(rows[0]) * P.rowsize;
    const int16_t* id = P.id + static_cast<int64_t>(rows[0]) * P.rowsize;
    const int cut = thr - rest[0];
    for (int i = 0; i < P.rowsize && sc[i] >= cut; ++i)
      a.emplace_back(sc[i], static_cast<int64_t>(id[i]) * P.mult);
  }
  for (int lvl = 1; lvl < n_parts; ++lvl) {
    const PartSpec& P = parts[lvl];
    const int16_t* sc = P.sc + static_cast<int64_t>(rows[lvl]) * P.rowsize;
    const int16_t* id = P.id + static_cast<int64_t>(rows[lvl]) * P.rowsize;
    b.clear();
    for (const auto& pr : a) {
      const int cut = thr - pr.first - rest[lvl];
      for (int j = 0; j < P.rowsize && sc[j] >= cut; ++j)
        b.emplace_back(pr.first + sc[j],
                       pr.second + static_cast<int64_t>(id[j]) * P.mult);
    }
    a.swap(b);
  }
  out.reserve(a.size());
  for (const auto& pr : a) out.push_back(static_cast<int32_t>(pr.second));
}

struct Match {
  int32_t seq;
  uint16_t diag;
};

struct Cand {
  int32_t seq;
  uint16_t diag;
  int32_t arrival;   // global match-stream index
  int32_t score;     // clamped (<=255)
  int32_t raw;       // unclamped Kadane score
};

// count of entries >= cutoff in a descending int16 row of kPartPow
inline int count_ge(const int16_t* row, int cutoff) {
  int lo = 0, hi = kPartPow;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (static_cast<int>(row[mid]) >= cutoff) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// SubstitutionMatrix::calcLocalAaBiasCorrection, bit-exact float32 chain
// (lib/mmseqs/src/commons/SubstitutionMatrix.cpp:79-109); mirrors
// stats/submat.py::local_aa_bias_correction step for step.
void local_bias_f32(const uint8_t* seq, int n, const int32_t* sub, int nsym,
                    const double* p_back, float* out) {
  constexpr int kHalf = 20;
  std::vector<int32_t> cnt(nsym, 0);
  int lo = 0, hi = std::min(n, kHalf);   // window [lo, hi) for i = 0
  for (int j = lo; j < hi; ++j) ++cnt[seq[j]];
  for (int i = 0; i < n; ++i) {
    const int nlo = std::max(0, i - kHalf);
    const int nhi = std::min(n, i + kHalf);
    while (lo < nlo) --cnt[seq[lo++]];
    while (hi < nhi) ++cnt[seq[hi++]];
    const int32_t* row = sub + seq[i] * nsym;
    int64_t sum_sub = 0;
    for (int a = 0; a < nsym; ++a)
      sum_sub += static_cast<int64_t>(row[a]) * cnt[a];
    sum_sub -= row[seq[i]];               // exclude own position
    const double win_len = static_cast<double>(nhi - nlo);
    float delta = static_cast<float>(
        static_cast<double>(static_cast<float>(sum_sub)) / (-win_len));
    for (int a = 0; a < nsym; ++a)
      delta = static_cast<float>(static_cast<double>(delta) +
                                 p_back[a] * static_cast<double>(row[a]));
    out[i] = delta;                        // scale == 1.0
  }
}

// Per-thread scratch + the query-local phases shared by the one-shot
// match loop (prefilter_match_batch) and the cached-beam probe loop
// (prefilter_match_beams): double-diagonal detection, ungapped Kadane
// rescore, per-target max, histogram threshold, ordered emit.
struct QueryScratch {
  std::vector<Match> matches;
  std::vector<int32_t> gen_kmers;
  std::vector<int32_t> grp_count;      // size nt, zeroed between queries
  std::vector<int32_t> grp_pos;        // size nt + 1
  std::vector<int32_t> grouped;
  std::vector<Cand> cands;
  std::vector<Cand> sel;
  std::vector<int32_t> profile;        // L x alpha int32
  std::vector<float> bias_buf;
  std::vector<int32_t> touched;
  std::vector<uint16_t> seen_diag;
  // pending posting-range ring for the pipelined lookup loop: ranges
  // wait here (first lines prefetched) before being copied into
  // `matches`, in discovery order
  struct PendRange { int32_t lo, hi, w; };
  static constexpr int kRing = 8;
  PendRange ring[kRing];
  uint32_t rhead = 0, rtail = 0;
};

void detect_round(QueryScratch& S, int32_t arrival_base);

// Copy the oldest pending posting range into S.matches (raw-cursor
// append), applying the bounded-buffer overflow round EXACTLY as the
// scalar loop did: flush-before-copy when this range would overflow.
inline void drain_one(QueryScratch& S, const int32_t* post_seq,
                      const int32_t* post_pos, int64_t match_cap,
                      int64_t& total_raw, int32_t& arrival_base,
                      int& rounds) {
  const QueryScratch::PendRange pr =
      S.ring[S.rtail & (QueryScratch::kRing - 1)];
  ++S.rtail;
  std::vector<Match>& matches = S.matches;
  if (static_cast<int64_t>(matches.size()) + (pr.hi - pr.lo) > match_cap
      && !matches.empty()) {
    const int32_t n_round = static_cast<int32_t>(matches.size());
    total_raw += n_round;
    detect_round(S, arrival_base);
    arrival_base += n_round;
    ++rounds;
  }
  const size_t base = matches.size();
  matches.resize(base + (pr.hi - pr.lo));
  Match* dst = matches.data() + base;
  for (int32_t p = pr.lo; p < pr.hi; ++p)
    *dst++ = {post_seq[p], static_cast<uint16_t>(pr.w - post_pos[p])};
}

// Detection phase for ONE round of the match buffer: arrival-ordered
// double-diagonal detection over S.matches, appending candidates to
// S.cands (arrival = arrival_base + in-round index) and clearing the
// buffer.  Under the reference's bounded-buffer overflow handling
// (QueryMatcher.cpp:280-320) this runs once per partial round; pairs
// straddling a round boundary are not detected and the zero-init quirk
// restarts per round — both faithful to findDuplicates-per-partial.
void detect_round(QueryScratch& S, int32_t arrival_base) {
  std::vector<Match>& matches = S.matches;
  std::vector<int32_t>& grp_count = S.grp_count;
  std::vector<int32_t>& grp_pos = S.grp_pos;
  std::vector<int32_t>& grouped = S.grouped;
  std::vector<Cand>& cands = S.cands;

  const int nm = static_cast<int>(matches.size());
  std::vector<int32_t>& touched = S.touched;
  touched.clear();
  for (int m = 0; m < nm; ++m) {
    if (grp_count[matches[m].seq]++ == 0) touched.push_back(matches[m].seq);
  }
  std::sort(touched.begin(), touched.end());
  {
    int32_t run = 0;
    for (int32_t s : touched) {
      grp_pos[s] = run;
      run += grp_count[s];
    }
  }
  grouped.resize(nm);
  for (int m = 0; m < nm; ++m) grouped[grp_pos[matches[m].seq]++] = m;
  // grp_pos[s] now points one past the end of group s

  std::vector<uint16_t>& seen_diag = S.seen_diag;
  int gstart = 0;
  for (int32_t s : touched) {
    const int gend = grp_pos[s];
    // phase 1: arrival-ordered detection with the zero-init quirk
    // phase 2: drop consecutive same-diag8 detections
    // phase 3: dedup (seq, diag16) within the round, first wins
    seen_diag.clear();
    int prev8 = 0;           // zero-init quirk: first hit on diag8==0 counts
    bool first = true;
    int prev_det8 = -1;
    for (int g = gstart; g < gend; ++g) {
      const Match& mm = matches[grouped[g]];
      const int d8 = mm.diag & 0xFF;
      const bool detected = first ? (d8 == 0) : (d8 == prev8);
      prev8 = d8;
      first = false;
      if (!detected) continue;
      const bool keep = (prev_det8 == -1) || (d8 != prev_det8);
      prev_det8 = d8;
      if (!keep) continue;
      bool dup = false;
      for (uint16_t sd : seen_diag)
        if (sd == mm.diag) { dup = true; break; }
      if (dup) continue;
      seen_diag.push_back(mm.diag);
      cands.push_back({s, mm.diag, arrival_base + grouped[g], 0, 0});
    }
    gstart = gend;
    grp_count[s] = 0;        // reset scratch for next query
  }
  matches.clear();
}

// Everything after detection for one query: cross-round merge
// (stable-by-seq order + (seq, diag) first-occurrence dedup, the
// mergeElements analog), rescore (sequence-query profile from
// ungapped_sub + bias/4, or the profile-query pssm/4 rows when
// qprof != nullptr), selection and emit.  Exact semantics of the
// original inline code (bit-parity tested).
void finish_query(
    QueryScratch& S, const uint8_t* q, int L, const float* bias,
    const int8_t* corr8,   // nullable: precomputed char(bias/4 +/- .5)
    const int16_t* qprof,  // nullable: (L, 20) int16 PSSM rows
    const uint8_t* tdata, const int64_t* toffs, const int32_t* tlens,
    const int32_t* ungapped_sub, int alpha,
    int max_seqs, int min_diag_score, int bin_mask,
    int identity, float cov_thr, int cov_mode, bool multi_round,
    int32_t* oseq, int32_t* osco, int32_t* odia, int32_t* ocnt) {
  std::vector<Cand>& cands = S.cands;
  std::vector<Cand>& sel = S.sel;
  std::vector<int32_t>& profile = S.profile;
  sel.clear();

  if (multi_round && !cands.empty()) {
    // cross-round merge: group per seq in arrival order (rounds are
    // already seq-sorted internally and arrive in time order, so a
    // stable sort by seq restores per-seq arrival order), then dedup
    // (seq, diag) keeping the first occurrence
    std::stable_sort(cands.begin(), cands.end(),
                     [](const Cand& a, const Cand& b) {
                       return a.seq < b.seq;
                     });
    std::vector<uint16_t>& seen_diag = S.seen_diag;
    size_t w = 0;
    size_t i = 0;
    while (i < cands.size()) {
      size_t j = i;
      seen_diag.clear();
      for (; j < cands.size() && cands[j].seq == cands[i].seq; ++j) {
        bool dup = false;
        for (uint16_t sd : seen_diag)
          if (sd == cands[j].diag) { dup = true; break; }
        if (dup) continue;
        seen_diag.push_back(cands[j].diag);
        cands[w++] = cands[j];
      }
      i = j;
    }
    cands.resize(w);
  }

  // ---- ungapped Kadane rescore (UngappedAlignment semantics) ----
  if (!cands.empty()) {
    profile.assign(static_cast<size_t>(L) * alpha, 0);
    if (qprof) {
      // profile query: pssm/4 with C truncation, X column 0
      // (Sequence.cpp:271-280, UngappedAlignment.cpp:399-404)
      for (int i = 0; i < L; ++i) {
        int32_t* dst = &profile[static_cast<size_t>(i) * alpha];
        const int16_t* row = qprof + static_cast<int64_t>(i) * 20;
        for (int a = 0; a < 20; ++a)
          dst[a] = static_cast<int32_t>(row[a] / 4);   // trunc toward 0
      }
    } else {
      for (int i = 0; i < L; ++i) {
        const int32_t* row = ungapped_sub + q[i] * alpha;
        int8_t c8;
        if (corr8) {
          c8 = corr8[i];
        } else {
          double corr = static_cast<double>(bias[i]) / 4.0;
          c8 = static_cast<int8_t>(corr < 0.0 ? corr - 0.5 : corr + 0.5);
        }
        int32_t* dst = &profile[static_cast<size_t>(i) * alpha];
        for (int a = 0; a < alpha; ++a) dst[a] = row[a] + c8;
      }
    }
    for (Cand& c : cands) {
      const uint16_t d16 = c.diag;
      const uint16_t neg = static_cast<uint16_t>(0 - d16);
      const int min_dist = std::min<int>(neg, d16);
      const int tl = tlens[c.seq];
      const bool pos_diag = d16 < 0x8000;
      int seg, q_off, t_off;
      if (pos_diag) {
        seg = (min_dist < L) ? std::min(tl, L - min_dist) : 0;
        q_off = min_dist;
        t_off = 0;
      } else {
        seg = (min_dist < tl) ? std::min(tl - min_dist, L) : 0;
        q_off = 0;
        t_off = min_dist;
      }
      const uint8_t* t = tdata + toffs[c.seq] + t_off;
      int32_t cur = 0, best = 0;
      for (int k = 0; k < seg; ++k) {
        cur += profile[static_cast<size_t>(q_off + k) * alpha + t[k]];
        if (cur < 0) cur = 0;
        if (cur > best) best = cur;
      }
      c.raw = best;
      c.score = best > 255 ? 255 : best;
    }
  }

  // ---- per-target max (keepMaxElement: first max in arrival order) ----
  for (size_t i = 0; i < cands.size();) {
    size_t j = i;
    size_t bi = i;
    for (; j < cands.size() && cands[j].seq == cands[i].seq; ++j)
      if (cands[j].score > cands[bi].score) bi = j;
    sel.push_back(cands[bi]);
    i = j;
  }

  // ---- detection-stream order: (seq & bin_mask, arrival) ----
  std::sort(sel.begin(), sel.end(), [bin_mask](const Cand& a, const Cand& b) {
    const int ba = a.seq & bin_mask, bb = b.seq & bin_mask;
    if (ba != bb) return ba < bb;
    return a.arrival < b.arrival;
  });

  // ---- histogram score threshold (computeScoreThreshold) ----
  int hist[256];
  std::memset(hist, 0, sizeof(hist));
  for (const Cand& c : sel) ++hist[c.score];
  int thr_score = 0, found = 0;
  for (int t = 255; t > 0; --t) {
    found += hist[t];
    if (found >= max_seqs) { thr_score = t; break; }
  }
  if (thr_score < min_diag_score) thr_score = min_diag_score;

  // ---- stable desc sort by clamped score, emit with --max-seqs cap ----
  std::stable_sort(sel.begin(), sel.end(),
                   [](const Cand& a, const Cand& b) {
                     return a.score > b.score;
                   });
  int cnt = 0;
  const float qlen_f = static_cast<float>(L);
  auto cov_ok = [&](int sid) {
    if (cov_thr <= 0.0f ||
        (cov_mode != 0 && cov_mode != 2 && cov_mode != 5))
      return true;
    const float tlen_f = static_cast<float>(tlens[sid]);
    if (cov_mode == 0)
      return qlen_f / tlen_f >= cov_thr && tlen_f / qlen_f >= cov_thr;
    if (cov_mode == 2) return tlen_f / qlen_f >= cov_thr;
    return std::min(tlen_f, qlen_f) / std::max(tlen_f, qlen_f) >= cov_thr;
  };
  int emitted = 0;  // counts toward max_seqs BEFORE the coverage filter
  if (identity >= 0) {
    ++emitted;
    if (cov_ok(identity)) {
      oseq[cnt] = identity;
      osco[cnt] = 65535;
      odia[cnt] = 0;
      ++cnt;
    }
  }
  for (const Cand& c : sel) {
    if (emitted >= max_seqs) break;
    if (c.score < thr_score || c.seq == identity) continue;
    ++emitted;
    if (!cov_ok(c.seq)) continue;
    oseq[cnt] = c.seq;
    osco[cnt] = c.score >= 255 ? c.raw : c.score;
    odia[cnt] = c.diag;
    ++cnt;
  }
  *ocnt = cnt;
}

}  // namespace

extern "C" {

// Batched int8 composition bias for the SW profile
// (StripedSmithWaterman.cpp:1230-1236 rounding over the f32 bias chain).
void comp_bias_batch(const uint8_t* qdata, const int64_t* qoffs,
                     const int32_t* qlens, int nq, const int32_t* sub,
                     int nsym, const double* p_back, int8_t* out) {
#pragma omp parallel
  {
    std::vector<float> buf;
#pragma omp for schedule(dynamic, 16)
    for (int qi = 0; qi < nq; ++qi) {
      const int L = qlens[qi];
      buf.resize(L);
      local_bias_f32(qdata + qoffs[qi], L, sub, nsym, p_back, buf.data());
      int8_t* dst = out + qoffs[qi];
      for (int i = 0; i < L; ++i) {
        const double b = static_cast<double>(buf[i]);
        dst[i] = static_cast<int8_t>(b < 0.0 ? b - 0.5 : b + 0.5);
      }
    }
  }
}

// Returns 0 on success.
int prefilter_match_batch(
    // queries (tokens, concatenated); composition bias computed in-engine
    const uint8_t* qdata, const int64_t* qoffs, const int32_t* qlens, int nq,
    const int32_t* seed_sub, const double* p_back, int nsym, int do_bias,
    // seed tables (sc2/id2: 2-mer tables, required only for k % 3 != 0)
    const int16_t* sc3, const int16_t* id3,
    const int16_t* sc2, const int16_t* id2,
    int kmer_size, const int32_t* pattern,
    // posting index: open-addressing hash over the ~2% occupied k-mers
    // (keys/off/cnt arrays, pow2 capacity) + 64M-bit occupancy bitmap.
    // A dense 20^6 offset table costs 256 MB of fresh page-faults per
    // process — measured at seconds/GB on the target host — while the
    // hash is ~50 MB and more cache-resident for the random probes.
    const int32_t* hkeys, const int32_t* hoff, const int32_t* hcnt,
    int64_t hcap, const uint64_t* occupied,
    const int32_t* post_seq, const int32_t* post_pos,
    // masked target residues (for the ungapped rescore)
    const uint8_t* tdata, const int64_t* toffs, const int32_t* tlens, int nt,
    // ungapped scoring matrix, row-major (alpha x alpha) int32
    const int32_t* ungapped_sub, int alpha, int x_index,
    // parameters; identity_base >= 0 marks a same-DB search whose batch
    // row qi corresponds to target key identity_base + qi (the streaming
    // the streaming loop prefilters contiguous query chunks), -1 = different DBs
    int kmer_thr, int max_seqs, int min_diag_score, int bin_count,
    int identity_base, float cov_thr, int cov_mode,
    // bounded match buffer (QueryMatcher.cpp:280-320): when a posting
    // list would overflow the cap, the current round is detection-
    // processed and the buffer restarts — pairs straddling rounds are
    // lost and the zero-init quirk restarts per round, both faithful
    // to findDuplicates-per-partial.  0 = the reference default
    // 2 * max(1e6, dbSize).
    int64_t match_cap,
    // outputs
    int32_t* out_seq, int32_t* out_score, int32_t* out_diag, int32_t* out_cnt,
    int64_t* total_raw_out) {
  const int bin_mask = bin_count - 1;
  const int span = pattern[kmer_size - 1] + 1;
  if (match_cap <= 0)
    match_cap = 2 * std::max<int64_t>(1000000, nt);
  int64_t total_raw = 0;
  const bool prof_on = getenv("SPACEDUST_PREF_PROFILE") != nullptr;
  // fine mode (=2): split generation from posting probe/copy inside the
  // window loop (adds ~2 timer calls per window; measurement only)
  const bool prof_fine = prof_on && getenv("SPACEDUST_PREF_PROFILE")[0] == '2';
  double t_lookup = 0, t_group = 0, t_rescore = 0, t_emit = 0;

#pragma omp parallel reduction(+ : total_raw) \
    reduction(+ : t_lookup, t_group, t_rescore, t_emit)
  {
    QueryScratch S;
    S.grp_count.assign(nt, 0);
    S.grp_pos.assign(nt + 1, 0);
    std::vector<Match>& matches = S.matches;
    std::vector<int32_t>& gen_kmers = S.gen_kmers;
    std::vector<float>& bias_buf = S.bias_buf;
    PartSpec parts[4];
    const int n_parts = make_parts(kmer_size, sc3, id3, sc2, id2, parts);
    std::vector<std::pair<int32_t, int64_t>> gen_a, gen_b;

#pragma omp for schedule(dynamic, 8)
    for (int qi = 0; qi < nq; ++qi) {
      const uint8_t* q = qdata + qoffs[qi];
      const int L = qlens[qi];
      bias_buf.assign(L, 0.0f);
      if (do_bias)
        local_bias_f32(q, L, seed_sub, nsym, p_back, bias_buf.data());
      const float* bias = bias_buf.data();
      matches.clear();
      S.cands.clear();
      int rounds = 0;
      int32_t arrival_base = 0;

      // ---- per-window similar-k-mer generation + posting lookups ----
      double tp0 = prof_on ? prof_now() : 0;
      const int nw = L - span + 1;
      for (int w = 0; w < nw; ++w) {
        if (prof_fine) tp0 = prof_now();
        // spaced k-mer residues; X excluded (Prefiltering.cpp:530-533)
        int r[8];
        bool ok = true;
        for (int k = 0; k < kmer_size; ++k) {
          r[k] = q[w + pattern[k]];
          if (r[k] == x_index) { ok = false; }
        }
        if (!ok) continue;
        // f32 sequential bias sum, C double +/-0.5 trunc
        // (QueryMatcher.cpp:230-236)
        float b = 0.0f;
        for (int k = 0; k < kmer_size; ++k) b += bias[w + pattern[k]];
        double bd = static_cast<double>(b);
        int16_t biasv =
            static_cast<int16_t>(bd < 0.0 ? bd - 0.5 : bd + 0.5);
        int thr = kmer_thr - biasv;
        if (thr < 0) thr = 0;

        if (kmer_size == 6) {
          // 2x3-mer fast path (the common case; identical semantics to
          // generate_generic, kept unrolled for the hot loop)
          const int part0 = r[0] + 20 * r[1] + 400 * r[2];
          const int part1 = r[3] + 20 * r[4] + 400 * r[5];
          const int16_t* s0 = sc3 + static_cast<int64_t>(part0) * kPartPow;
          const int16_t* s1 = sc3 + static_cast<int64_t>(part1) * kPartPow;
          const int16_t* i0 = id3 + static_cast<int64_t>(part0) * kPartPow;
          const int16_t* i1 = id3 + static_cast<int64_t>(part1) * kPartPow;
          const int best1 = s1[0];
          const int n0 = count_ge(s0, thr - best1);
          if (n0 == 0) continue;

          gen_kmers.clear();
          for (int i = 0; i < n0; ++i) {
            const int cut = thr - s0[i];
            const int n1 = count_ge(s1, cut);
            const int32_t base = i0[i];
            for (int j = 0; j < n1; ++j) {
              gen_kmers.push_back(base
                                  + static_cast<int32_t>(i1[j]) * kPartPow);
            }
          }
        } else {
          generate_generic(parts, n_parts, r, thr, gen_kmers, gen_a, gen_b);
          if (gen_kmers.empty()) continue;
        }
        if (prof_fine) { t_group += prof_now() - tp0; tp0 = prof_now(); }

        // posting lookups: the 8 MB occupancy bitmap screens the ~97%
        // empty k-mers, survivors probe the compact hash (1-2 probes
        // expected at 50% load).  The loop is software-pipelined: the
        // bitmap line is prefetched kAhead iterations out, the hash
        // slot kSlotAhead iterations out, and found posting RANGES park
        // in a small ring (their first lines prefetched) so the
        // dependent loads of probe->range->copy overlap across
        // iterations instead of serializing on each cache miss — this
        // stage is ~50% of the engine's CPU time at scale and is
        // latency-, not compute-, bound.  Copy order (and therefore the
        // bounded-buffer overflow-round semantics, which drain_one
        // checks before each range copy) is IDENTICAL to the scalar
        // loop's.
        const size_t ng = gen_kmers.size();
        const uint64_t hmask = static_cast<uint64_t>(hcap) - 1;
        constexpr size_t kAhead = 16;
        constexpr size_t kSlotAhead = 6;
        for (size_t t = 0; t < ng; ++t) {
          if (t + kAhead < ng)
            __builtin_prefetch(
                &occupied[static_cast<uint32_t>(gen_kmers[t + kAhead]) >> 6]);
          if (t + kSlotAhead < ng) {
            // speculative hash-slot prefetch for a k-mer whose bitmap
            // line is already cached (kSlotAhead < kAhead)
            const int32_t km2 = gen_kmers[t + kSlotAhead];
            if (occupied[static_cast<uint32_t>(km2) >> 6]
                & (1ull << (km2 & 63))) {
              const uint64_t s2 =
                  (static_cast<uint32_t>(km2) * 2654435761u) & hmask;
              __builtin_prefetch(&hkeys[s2]);
              __builtin_prefetch(&hoff[s2]);
              __builtin_prefetch(&hcnt[s2]);
            }
          }
          const int32_t km = gen_kmers[t];
          if (!(occupied[static_cast<uint32_t>(km) >> 6]
                & (1ull << (km & 63))))
            continue;
          uint64_t slot = (static_cast<uint32_t>(km) * 2654435761u) & hmask;
          while (hkeys[slot] != km) {
            if (hkeys[slot] < 0) { slot = hcap; break; }  // stale bitmap
            slot = (slot + 1) & hmask;
          }
          if (slot == static_cast<uint64_t>(hcap)) continue;
          const int32_t lo = hoff[slot];
          const int32_t hi = lo + hcnt[slot];
          __builtin_prefetch(&post_seq[lo]);
          __builtin_prefetch(&post_pos[lo]);
          if (S.rhead - S.rtail == QueryScratch::kRing)
            drain_one(S, post_seq, post_pos, match_cap, total_raw,
                      arrival_base, rounds);
          S.ring[S.rhead & (QueryScratch::kRing - 1)] = {lo, hi, w};
          ++S.rhead;
        }
        if (prof_fine) { t_rescore += prof_now() - tp0; tp0 = prof_now(); }
      }
      while (S.rhead != S.rtail)
        drain_one(S, post_seq, post_pos, match_cap, total_raw,
                  arrival_base, rounds);
      total_raw += static_cast<int64_t>(matches.size());
      if (prof_on) { t_lookup += prof_now() - tp0; tp0 = prof_now(); }

      const int identity = identity_base >= 0 ? identity_base + qi : -1;
      const bool multi_round = rounds > 0;
      detect_round(S, arrival_base);
      finish_query(
          S, q, L, bias, nullptr, nullptr, tdata, toffs, tlens,
          ungapped_sub, alpha,
          max_seqs, min_diag_score, bin_mask, identity, cov_thr, cov_mode,
          multi_round,
          out_seq + static_cast<int64_t>(qi) * max_seqs,
          out_score + static_cast<int64_t>(qi) * max_seqs,
          out_diag + static_cast<int64_t>(qi) * max_seqs, &out_cnt[qi]);
      if (prof_on) t_emit += prof_now() - tp0;
    }
  }
  if (prof_on)
    fprintf(stderr,
            "[pref-profile] lookup %.2fs group %.2fs rescore %.2fs "
            "emit %.2fs (thread-summed)\n",
            t_lookup, t_group, t_rescore, t_emit);
  if (total_raw_out) *total_raw_out = total_raw;
  return 0;
}

// Cached-beam target-split support (the reference's target-split mode
// repeats per-query k-mer generation for EVERY split,
// Prefiltering.cpp:662-723; here the beam is generated ONCE, screened
// against the GLOBAL k-mer occupancy bitmap — 8 MB, trivially
// replicated/all-reduced across hosts — and each target shard is then
// probed with the cached survivors, so per-shard work scales with the
// shard, not with the query beam).
//
// prefilter_generate_beams: per-query (kmer, window) pairs in exact
// generation order (window asc, beam order), optionally screened by a
// global occupancy bitmap.  Output buffers are new[]-allocated and
// returned via out-params; the caller copies and calls
// free_beam_buffers.
int prefilter_generate_beams(
    const uint8_t* qdata, const int64_t* qoffs, const int32_t* qlens, int nq,
    const int32_t* seed_sub, const double* p_back, int nsym, int do_bias,
    const int16_t* sc3, const int16_t* id3,
    const int16_t* sc2, const int16_t* id2,
    int kmer_size, const int32_t* pattern,
    const uint64_t* global_bitmap,       // nullable: no screening
    int x_index, int kmer_thr,
    int32_t** out_kmer, int32_t** out_win, int64_t* out_offs /* nq+1 */,
    int8_t* out_corr8 /* nullable: len(qdata) rescore bias chars */) {
  std::vector<std::vector<int32_t>> bk(nq), bw(nq);
  const int span = pattern[kmer_size - 1] + 1;
#pragma omp parallel
  {
    std::vector<float> bias_buf;
    PartSpec parts[4];
    const int n_parts = make_parts(kmer_size, sc3, id3, sc2, id2, parts);
    std::vector<std::pair<int32_t, int64_t>> gen_a, gen_b;
    std::vector<int32_t> gen_kmers;
#pragma omp for schedule(dynamic, 8)
    for (int qi = 0; qi < nq; ++qi) {
      const uint8_t* q = qdata + qoffs[qi];
      const int L = qlens[qi];
      bias_buf.assign(L, 0.0f);
      if (do_bias)
        local_bias_f32(q, L, seed_sub, nsym, p_back, bias_buf.data());
      const float* bias = bias_buf.data();
      if (out_corr8) {
        // char(bias/4 +/- 0.5) rescore correction, computed once here
        // instead of per shard probe (UngappedAlignment.cpp:392-396)
        int8_t* dst = out_corr8 + qoffs[qi];
        for (int i = 0; i < L; ++i) {
          double corr = static_cast<double>(bias[i]) / 4.0;
          dst[i] = static_cast<int8_t>(corr < 0.0 ? corr - 0.5 : corr + 0.5);
        }
      }
      std::vector<int32_t>& okm = bk[qi];
      std::vector<int32_t>& own = bw[qi];
      const int nw = L - span + 1;
      for (int w = 0; w < nw; ++w) {
        int r[8];
        bool ok = true;
        for (int k = 0; k < kmer_size; ++k) {
          r[k] = q[w + pattern[k]];
          if (r[k] == x_index) { ok = false; }
        }
        if (!ok) continue;
        float b = 0.0f;
        for (int k = 0; k < kmer_size; ++k) b += bias[w + pattern[k]];
        double bd = static_cast<double>(b);
        int16_t biasv =
            static_cast<int16_t>(bd < 0.0 ? bd - 0.5 : bd + 0.5);
        int thr = kmer_thr - biasv;
        if (thr < 0) thr = 0;

        if (kmer_size == 6) {
          const int part0 = r[0] + 20 * r[1] + 400 * r[2];
          const int part1 = r[3] + 20 * r[4] + 400 * r[5];
          const int16_t* s0 = sc3 + static_cast<int64_t>(part0) * kPartPow;
          const int16_t* s1 = sc3 + static_cast<int64_t>(part1) * kPartPow;
          const int16_t* i0 = id3 + static_cast<int64_t>(part0) * kPartPow;
          const int16_t* i1 = id3 + static_cast<int64_t>(part1) * kPartPow;
          const int best1 = s1[0];
          const int n0 = count_ge(s0, thr - best1);
          for (int i = 0; i < n0; ++i) {
            const int cut = thr - s0[i];
            const int n1 = count_ge(s1, cut);
            const int32_t base = i0[i];
            for (int j = 0; j < n1; ++j) {
              const int32_t km = base
                  + static_cast<int32_t>(i1[j]) * kPartPow;
              if (global_bitmap &&
                  !(global_bitmap[static_cast<uint32_t>(km) >> 6]
                    & (1ull << (km & 63))))
                continue;
              okm.push_back(km);
              own.push_back(w);
            }
          }
        } else {
          generate_generic(parts, n_parts, r, thr, gen_kmers, gen_a, gen_b);
          for (int32_t km : gen_kmers) {
            if (global_bitmap &&
                !(global_bitmap[static_cast<uint32_t>(km) >> 6]
                  & (1ull << (km & 63))))
              continue;
            okm.push_back(km);
            own.push_back(w);
          }
        }
      }
    }
  }
  int64_t total = 0;
  out_offs[0] = 0;
  for (int qi = 0; qi < nq; ++qi) {
    total += static_cast<int64_t>(bk[qi].size());
    out_offs[qi + 1] = total;
  }
  int32_t* km = new int32_t[std::max<int64_t>(total, 1)];
  int32_t* wn = new int32_t[std::max<int64_t>(total, 1)];
#pragma omp parallel for schedule(dynamic, 8)
  for (int qi = 0; qi < nq; ++qi) {
    std::memcpy(km + out_offs[qi], bk[qi].data(),
                bk[qi].size() * sizeof(int32_t));
    std::memcpy(wn + out_offs[qi], bw[qi].data(),
                bw[qi].size() * sizeof(int32_t));
  }
  *out_kmer = km;
  *out_win = wn;
  return 0;
}

void free_beam_buffers(int32_t* kmer, int32_t* win) {
  delete[] kmer;
  delete[] win;
}

// prefilter_match_beams: probe a (shard-local) posting index with
// pre-generated beams; identical downstream semantics to
// prefilter_match_batch (the cached beam preserves the exact match
// arrival order: windows ascending, generation order, posting order).
int prefilter_match_beams(
    const uint8_t* qdata, const int64_t* qoffs, const int32_t* qlens, int nq,
    const int32_t* seed_sub, const double* p_back, int nsym, int do_bias,
    const int8_t* corr8,       // nullable: precomputed rescore bias chars
    const int32_t* beam_kmer, const int32_t* beam_win,
    const int64_t* beam_offs,
    const int32_t* hkeys, const int32_t* hoff, const int32_t* hcnt,
    int64_t hcap, const uint64_t* occupied,   // nullable: skip screen
    const int32_t* post_seq, const int32_t* post_pos,
    const uint8_t* tdata, const int64_t* toffs, const int32_t* tlens, int nt,
    const int32_t* ungapped_sub, int alpha,
    int max_seqs, int min_diag_score, int bin_count,
    int identity_base, float cov_thr, int cov_mode,
    int32_t* out_seq, int32_t* out_score, int32_t* out_diag, int32_t* out_cnt,
    int64_t* total_raw_out) {
  const int bin_mask = bin_count - 1;
  int64_t total_raw = 0;
#pragma omp parallel reduction(+ : total_raw)
  {
    QueryScratch S;
    S.grp_count.assign(nt, 0);
    S.grp_pos.assign(nt + 1, 0);
    std::vector<Match>& matches = S.matches;
#pragma omp for schedule(dynamic, 8)
    for (int qi = 0; qi < nq; ++qi) {
      const uint8_t* q = qdata + qoffs[qi];
      const int L = qlens[qi];
      const int8_t* c8 = corr8 ? corr8 + qoffs[qi] : nullptr;
      if (!c8) {
        S.bias_buf.assign(L, 0.0f);
        if (do_bias)
          local_bias_f32(q, L, seed_sub, nsym, p_back, S.bias_buf.data());
      }
      matches.clear();
      S.cands.clear();
      const uint64_t hmask = static_cast<uint64_t>(hcap) - 1;
      const int64_t b0 = beam_offs[qi], b1 = beam_offs[qi + 1];
      for (int64_t t = b0; t < b1; ++t) {
        const int32_t km = beam_kmer[t];
        if (occupied &&
            !(occupied[static_cast<uint32_t>(km) >> 6]
              & (1ull << (km & 63))))
          continue;
        uint64_t slot = (static_cast<uint32_t>(km) * 2654435761u) & hmask;
        while (hkeys[slot] != km) {
          if (hkeys[slot] < 0) { slot = hcap; break; }
          slot = (slot + 1) & hmask;
        }
        if (slot == static_cast<uint64_t>(hcap)) continue;
        const int32_t lo = hoff[slot];
        const int32_t hi = lo + hcnt[slot];
        const int32_t w = beam_win[t];
        for (int32_t p = lo; p < hi; ++p) {
          matches.push_back(
              {post_seq[p], static_cast<uint16_t>(w - post_pos[p])});
        }
      }
      total_raw += static_cast<int64_t>(matches.size());
      const int identity = identity_base >= 0 ? identity_base + qi : -1;
      detect_round(S, 0);
      finish_query(
          S, q, L, c8 ? nullptr : S.bias_buf.data(), c8, nullptr,
          tdata, toffs, tlens,
          ungapped_sub, alpha, max_seqs, min_diag_score, bin_mask, identity,
          cov_thr, cov_mode, false,
          out_seq + static_cast<int64_t>(qi) * max_seqs,
          out_score + static_cast<int64_t>(qi) * max_seqs,
          out_diag + static_cast<int64_t>(qi) * max_seqs, &out_cnt[qi]);
    }
  }
  if (total_raw_out) *total_raw_out = total_raw;
  return 0;
}

// partition_beams: split each query's screened beam into per-shard
// sub-beams by probing every shard's occupancy bitmap (on hardware the
// per-shard 8 MB masks are all-gathered once; a query host then ships
// each target-shard host ONLY the sub-beam it can match — less beam
// traffic than broadcasting, and the shard probe loses both the bitmap
// screen and the miss-probes).  Output layout: one concatenated
// (kmer, win) buffer; segment (s, qi) = [offs[s*nq+qi], offs[s*nq+qi+1]),
// shard-major, so offs[s*nq : s*nq+nq+1] is a valid per-query offset
// vector for shard s.
// build_shard_mask_table: per-k-mer byte whose bit s says "k-mer occurs
// in shard s" (n_shards <= 8 per table), scattered from the shard
// occupancy bitmaps.  ~64 MB, built once per split setup; the partition
// then costs ONE probe per beam survivor instead of n_shards bitmap
// probes.
int build_shard_mask_table(const uint64_t* shard_bitmaps, int n_shards,
                           int64_t words_per_shard, uint8_t* table) {
  const int64_t n_bytes = words_per_shard * 64;
#pragma omp parallel
  {
    // bulk zero in large per-thread stripes (one pass, page-fault
    // friendly), then scatter only into occupied words
#pragma omp for schedule(static)
    for (int64_t c = 0; c < (n_bytes >> 20) + 1; ++c) {
      const int64_t lo = c << 20;
      const int64_t hi = std::min(n_bytes, lo + (int64_t(1) << 20));
      if (lo < hi) std::memset(table + lo, 0, hi - lo);
    }
#pragma omp for schedule(static)
    for (int64_t w = 0; w < words_per_shard; ++w) {
      uint8_t* dst = table + w * 64;
      for (int s = 0; s < n_shards; ++s) {
        uint64_t bits = shard_bitmaps[s * words_per_shard + w];
        while (bits) {
          const int i = __builtin_ctzll(bits);
          dst[i] |= static_cast<uint8_t>(1u << s);
          bits &= bits - 1;
        }
      }
    }
  }
  return 0;
}

int partition_beams(
    const int32_t* beam_kmer, const int32_t* beam_win,
    const int64_t* beam_offs, int nq,
    const uint8_t* mask_table, int n_shards,
    int32_t** out_kmer, int32_t** out_win,
    int64_t* out_offs /* n_shards*nq + 1 */) {
  // pass 1: fetch each survivor's shard mask ONCE (stored for pass 2)
  // and count per (query, shard)
  const int64_t n_beam = beam_offs[nq];
  std::vector<uint8_t> masks(std::max<int64_t>(n_beam, 1));
  std::vector<int64_t> counts(static_cast<size_t>(nq) * n_shards, 0);
#pragma omp parallel for schedule(dynamic, 8)
  for (int qi = 0; qi < nq; ++qi) {
    int64_t* cnt = counts.data() + static_cast<size_t>(qi) * n_shards;
    for (int64_t t = beam_offs[qi]; t < beam_offs[qi + 1]; ++t) {
      const uint8_t m = mask_table[static_cast<uint32_t>(beam_kmer[t])];
      masks[t] = m;
      uint8_t bits = m;
      while (bits) {
        ++cnt[__builtin_ctz(bits)];
        bits &= bits - 1;
      }
    }
  }
  int64_t total = 0;
  out_offs[0] = 0;
  for (int s = 0; s < n_shards; ++s)
    for (int qi = 0; qi < nq; ++qi) {
      total += counts[static_cast<size_t>(qi) * n_shards + s];
      out_offs[static_cast<int64_t>(s) * nq + qi + 1] = total;
    }
  int32_t* km_out = new int32_t[std::max<int64_t>(total, 1)];
  int32_t* wn_out = new int32_t[std::max<int64_t>(total, 1)];
  // pass 2: fill from the stored masks (no table re-probes)
#pragma omp parallel
  {
    std::vector<int64_t> cur(n_shards);
#pragma omp for schedule(dynamic, 8)
    for (int qi = 0; qi < nq; ++qi) {
      for (int s = 0; s < n_shards; ++s)
        cur[s] = out_offs[static_cast<int64_t>(s) * nq + qi];
      for (int64_t t = beam_offs[qi]; t < beam_offs[qi + 1]; ++t) {
        uint8_t bits = masks[t];
        while (bits) {
          const int s = __builtin_ctz(bits);
          bits &= bits - 1;
          km_out[cur[s]] = beam_kmer[t];
          wn_out[cur[s]] = beam_win[t];
          ++cur[s];
        }
      }
    }
  }
  *out_kmer = km_out;
  *out_win = wn_out;
  return 0;
}

// Profile-query batch matcher (VERDICT r3 missing #4): the reference
// runs profile queries through the same OpenMP hot loop as sequences
// (QueryMatcher.cpp:249-253, Sequence::nextProfileKmer) — per query
// position the PSSM row is ranked desc and the k-mer beam is the
// k-level product with per-level possibleRest pruning
// (KmerGenerator.cpp:30-38,104-167).  Rescore uses the pssm/4
// alignment profile (process_query_matches qprof path).  Replaces the
// per-query Python fallback for iterative/profile searches.
int prefilter_match_profile_batch(
    // ranked per-position rows: (Ltot, 20) int16 scores desc + uint8
    // residue indices, plus the raw (Ltot, 20) int16 PSSM rows and the
    // profile's query/consensus residues (X windows are skipped, same
    // as the sequence path)
    const int16_t* rank_s, const uint8_t* rank_i, const int16_t* qprof,
    const uint8_t* qseq, int x_index,
    const int64_t* qoffs /* position offsets, nq+1 */,
    const int32_t* qlens, int nq,
    int kmer_size, const int32_t* pattern,
    const int32_t* hkeys, const int32_t* hoff, const int32_t* hcnt,
    int64_t hcap, const uint64_t* occupied,
    const int32_t* post_seq, const int32_t* post_pos,
    const uint8_t* tdata, const int64_t* toffs, const int32_t* tlens, int nt,
    int alpha,
    int kmer_thr, int max_seqs, int min_diag_score, int bin_count,
    const int32_t* identity_keys /* nullable, per query row, -1 = none */,
    float cov_thr, int cov_mode,
    int32_t* out_seq, int32_t* out_score, int32_t* out_diag, int32_t* out_cnt,
    int64_t* total_raw_out) {
  const int bin_mask = bin_count - 1;
  const int span = pattern[kmer_size - 1] + 1;
  int64_t total_raw = 0;
  int64_t pow20[8];
  pow20[0] = 1;
  for (int k = 1; k < 8; ++k) pow20[k] = pow20[k - 1] * 20;

#pragma omp parallel reduction(+ : total_raw)
  {
    QueryScratch S;
    S.grp_count.assign(nt, 0);
    S.grp_pos.assign(nt + 1, 0);
    std::vector<Match>& matches = S.matches;
    std::vector<int32_t>& gen_kmers = S.gen_kmers;
    std::vector<std::pair<int32_t, int64_t>> gen_a, gen_b;

#pragma omp for schedule(dynamic, 4)
    for (int qi = 0; qi < nq; ++qi) {
      const int64_t po = qoffs[qi];
      const int L = qlens[qi];
      matches.clear();
      S.cands.clear();
      const uint64_t hmask = static_cast<uint64_t>(hcap) - 1;
      const int nw = L - span + 1;
      for (int w = 0; w < nw; ++w) {
        // per-position ranked rows for this window
        const int16_t* rs[8];
        const uint8_t* ri[8];
        int rest[9];
        bool ok = true;
        for (int k = 0; k < kmer_size; ++k) {
          const int64_t pos = po + w + pattern[k];
          if (qseq[pos] == x_index) { ok = false; break; }
          rs[k] = rank_s + pos * 20;
          ri[k] = rank_i + pos * 20;
        }
        if (!ok) continue;
        rest[kmer_size - 1] = 0;
        for (int k = kmer_size - 1; k >= 1; --k)
          rest[k - 1] = rest[k] + rs[k][0];
        // k-level product with per-level pruning, generation order =
        // level-major (Sequence::nextProfileKmer + product chain)
        gen_a.clear();
        gen_a.emplace_back(0, 0);
        bool dead = false;
        for (int lvl = 0; lvl < kmer_size; ++lvl) {
          gen_b.clear();
          for (const auto& pr : gen_a) {
            const int cut = kmer_thr - pr.first - rest[lvl];
            for (int j = 0; j < 20 && rs[lvl][j] >= cut; ++j)
              gen_b.emplace_back(pr.first + rs[lvl][j],
                                 pr.second
                                 + static_cast<int64_t>(ri[lvl][j])
                                 * pow20[lvl]);
          }
          gen_a.swap(gen_b);
          if (gen_a.empty()) { dead = true; break; }
        }
        if (dead) continue;
        for (const auto& pr : gen_a) {
          const int32_t km = static_cast<int32_t>(pr.second);
          if (!(occupied[static_cast<uint32_t>(km) >> 6]
                & (1ull << (km & 63))))
            continue;
          uint64_t slot = (static_cast<uint32_t>(km) * 2654435761u) & hmask;
          while (hkeys[slot] != km) {
            if (hkeys[slot] < 0) { slot = hcap; break; }
            slot = (slot + 1) & hmask;
          }
          if (slot == static_cast<uint64_t>(hcap)) continue;
          const int32_t lo = hoff[slot];
          const int32_t hi = lo + hcnt[slot];
          for (int32_t p = lo; p < hi; ++p) {
            matches.push_back(
                {post_seq[p], static_cast<uint16_t>(w - post_pos[p])});
          }
        }
      }
      total_raw += static_cast<int64_t>(matches.size());
      const int identity = identity_keys ? identity_keys[qi] : -1;
      detect_round(S, 0);
      finish_query(
          S, nullptr, L, nullptr, nullptr, qprof + po * 20,
          tdata, toffs, tlens, nullptr, alpha,
          max_seqs, min_diag_score, bin_mask, identity, cov_thr, cov_mode,
          false,
          out_seq + static_cast<int64_t>(qi) * max_seqs,
          out_score + static_cast<int64_t>(qi) * max_seqs,
          out_diag + static_cast<int64_t>(qi) * max_seqs, &out_cnt[qi]);
    }
  }
  if (total_raw_out) *total_raw_out = total_raw;
  return 0;
}

// Parallel k-mer index build (IndexBuilder::fillDatabase analog,
// lib/mmseqs/src/prefiltering/IndexBuilder.cpp, redone for the columnar
// SetDB layout), every phase on the calling thread's OpenMP team:
//   pass A: each thread takes a contiguous, residue-balanced range of
//           sequences and enumerates their valid spaced k-mers in
//           position order, dedup per sequence (first occurrence wins =
//           min position, IndexTable.h:332-345);
//   pass B: a stable counting scatter on the k-mer's high bits (at most
//           2^kBucketBits buckets, per-thread histograms) writes the
//           streams straight into the outputs, then each bucket is
//           sorted by k-mer.  The streams are in (seq, pos) order and
//           the threads' ranges ascend, so a bucket holds its postings in
//           (seq, pos) order, and the result is the (kmer, seq, pos)
//           order of a full sort, whatever the team size.
// Deliberately NO dense 20^6 count table: two 256 MB scratch tables per
// build cost seconds of first-touch page faults on the target host; the
// match loop probes a compact hash (build_kmer_hash) instead.
int build_kmer_index(
    const uint8_t* tdata, const int64_t* toffs, const int32_t* tlens, int nt,
    const int32_t* diag_scores, int x_index, int kmer_thr,
    int kmer_size, const int32_t* pattern,
    int32_t* out_kmer, int32_t* out_seq, int32_t* out_pos, int64_t* n_out,
    int32_t* threads_out) {
  constexpr int kBucketBits = 12;
  const int span = pattern[kmer_size - 1] + 1;
  int nthreads = 1;
#if defined(_OPENMP)
  nthreads = omp_get_max_threads();
#endif
  if (nthreads < 1) nthreads = 1;

  // residue-balanced contiguous partition of sequences
  std::vector<int> part(nthreads + 1, nt);
  {
    int64_t total = nt ? toffs[nt - 1] + tlens[nt - 1] : 0;
    part[0] = 0;
    int s = 0;
    for (int t = 1; t < nthreads; ++t) {
      const int64_t want = total * t / nthreads;
      while (s < nt && toffs[s] < want) ++s;
      part[t] = s;
    }
    part[nthreads] = nt;
  }

  // buckets: the k-mer's high bits, in k-mer order
  int64_t n_kmers = 1;
  for (int k = 0; k < kmer_size; ++k) n_kmers *= 20;
  int bits = 0;
  while ((int64_t{1} << bits) < n_kmers) ++bits;
  const int shift = bits > kBucketBits ? bits - kBucketBits : 0;
  const int nb = static_cast<int>(((n_kmers - 1) >> shift) + 1);
  // per (thread, bucket): the count, then the thread's first slot in it
  std::vector<int64_t> slot(static_cast<size_t>(nthreads) * nb, 0);
  std::vector<int64_t> bstart(nb + 1, 0);

#pragma omp parallel num_threads(nthreads)
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    // pass A: deduped windows, (kmer, pos) pairs + per-seq counts
    std::vector<int32_t> wk, wp, wcnt;
    {
      // open-addressing seen-set (kmer+1 keys, 0 = empty) with used-slot
      // tracking so the per-sequence reset is O(#inserted)
      uint32_t cap = 1;
      std::vector<int32_t> seen;
      std::vector<uint32_t> used;
      for (int si = part[tid]; si < part[tid + 1]; ++si) {
        const uint8_t* s = tdata + toffs[si];
        const int L = tlens[si];
        const int nw = L - span + 1;
        const size_t before = wk.size();
        if (nw <= 0) { wcnt.push_back(0); continue; }
        uint32_t need = 1;
        while (need < static_cast<uint32_t>(nw) * 2) need <<= 1;
        if (need > cap) {
          cap = need;
          seen.assign(cap, 0);
          used.clear();
        } else {
          for (uint32_t u : used) seen[u] = 0;
          used.clear();
        }
        for (int w = 0; w < nw; ++w) {
          int32_t packed = 0, self = 0;
          bool ok = true;
          int32_t mult = 1;
          for (int k = 0; k < kmer_size; ++k) {
            const int r = s[w + pattern[k]];
            if (r == x_index) { ok = false; break; }
            packed += r * mult;
            mult *= 20;
            self += diag_scores[r];
          }
          if (!ok || (kmer_thr > 0 && self < kmer_thr)) continue;
          // first-occurrence dedup per sequence
          uint32_t h = (static_cast<uint32_t>(packed) * 2654435761u)
                       & (cap - 1);
          bool dup = false;
          while (seen[h] != 0) {
            if (seen[h] == packed + 1) { dup = true; break; }
            h = (h + 1) & (cap - 1);
          }
          if (dup) continue;
          seen[h] = packed + 1;
          used.push_back(h);
          wk.push_back(packed);
          wp.push_back(w);
        }
        wcnt.push_back(static_cast<int32_t>(wk.size() - before));
      }
    }

    // pass B: histogram, prefix over (bucket, thread), stable scatter
    int64_t* my = slot.data() + static_cast<size_t>(tid) * nb;
    for (int32_t km : wk) ++my[km >> shift];
#pragma omp barrier
#pragma omp single
    {
      int64_t at = 0;
      for (int b = 0; b < nb; ++b) {
        bstart[b] = at;
        for (int t = 0; t < nthreads; ++t) {
          int64_t& c = slot[static_cast<size_t>(t) * nb + b];
          const int64_t n = c;
          c = at;
          at += n;
        }
      }
      bstart[nb] = at;
    }
    {
      size_t i = 0;
      for (int si = part[tid]; si < part[tid + 1]; ++si) {
        const int32_t n = wcnt[si - part[tid]];
        for (int32_t j = 0; j < n; ++j, ++i) {
          const int64_t d = my[wk[i] >> shift]++;
          out_kmer[d] = wk[i];
          out_seq[d] = si;
          out_pos[d] = wp[i];
        }
      }
      std::vector<int32_t>().swap(wk);
      std::vector<int32_t>().swap(wp);
    }
#pragma omp barrier
    // each bucket by k-mer; keys (kmer, rank in the bucket) are unique,
    // so the sort keeps the bucket's (seq, pos) order within a k-mer
    std::vector<uint64_t> key;
    std::vector<int32_t> tmp;
#pragma omp for schedule(dynamic, 16)
    for (int b = 0; b < nb; ++b) {
      const int64_t lo = bstart[b];
      const int64_t m = bstart[b + 1] - lo;
      if (m < 2) continue;
      key.resize(m);
      for (int64_t i = 0; i < m; ++i)
        key[i] = (static_cast<uint64_t>(out_kmer[lo + i]) << 32)
                 | static_cast<uint64_t>(i);
      std::sort(key.begin(), key.end());
      tmp.resize(m);
      for (int64_t i = 0; i < m; ++i)
        tmp[i] = out_seq[lo + static_cast<uint32_t>(key[i])];
      std::memcpy(out_seq + lo, tmp.data(), m * sizeof(int32_t));
      for (int64_t i = 0; i < m; ++i)
        tmp[i] = out_pos[lo + static_cast<uint32_t>(key[i])];
      std::memcpy(out_pos + lo, tmp.data(), m * sizeof(int32_t));
      for (int64_t i = 0; i < m; ++i)
        out_kmer[lo + i] = static_cast<int32_t>(key[i] >> 32);
    }
  }
  *n_out = bstart[nb];
  *threads_out = nthreads;
  return 0;
}

// Number of runs of equal k-mers in the sorted posting k-mer column: the
// unique k-mers, which size the range hash.
int64_t count_kmer_runs(const int32_t* post_kmer, int64_t n_post) {
  int64_t runs = 0;
#pragma omp parallel for schedule(static) reduction(+ : runs)
  for (int64_t i = 0; i < n_post; ++i)
    runs += (i == 0 || post_kmer[i] != post_kmer[i - 1]);
  return runs;
}

// Compact open-addressing posting-range hash: keys (-1 empty) -> (range
// start, count) over the sorted posting array; plus the occupancy
// bitmap.  Capacity is the caller-chosen power of two (>= 2x unique).
// The calling thread's team clears both tables in shares, then each
// thread inserts the runs that start in its share of the postings,
// claiming slots with a compare-and-swap: a slot once taken stays
// taken, so linear probing finds every key, though which of two
// colliding keys takes the nearer slot may vary between builds.
int build_kmer_hash(const int32_t* post_kmer, int64_t n_post,
                    int32_t* hkeys, int32_t* hoff, int32_t* hcnt,
                    int64_t hcap, uint64_t* bitmap, int64_t n_bits) {
  const uint64_t hmask = static_cast<uint64_t>(hcap) - 1;
  const int64_t n_words = (n_bits + 63) >> 6;
#pragma omp parallel
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
    const int team = omp_get_num_threads();
#else
    const int tid = 0;
    const int team = 1;
#endif
    const int64_t k0 = hcap * tid / team, k1 = hcap * (tid + 1) / team;
    std::memset(hkeys + k0, 0xFF, (k1 - k0) * sizeof(int32_t));
    const int64_t w0 = n_words * tid / team, w1 = n_words * (tid + 1) / team;
    std::memset(bitmap + w0, 0, (w1 - w0) * sizeof(uint64_t));
#pragma omp barrier
    int64_t i = n_post * tid / team;
    const int64_t end = n_post * (tid + 1) / team;
    // a run that starts in an earlier share is that share's
    while (i > 0 && i < end && post_kmer[i] == post_kmer[i - 1]) ++i;
    int64_t word = -1;
    uint64_t bits = 0;
    while (i < end) {
      const int32_t km = post_kmer[i];
      int64_t j = i + 1;
      while (j < n_post && post_kmer[j] == km) ++j;
      uint64_t s = (static_cast<uint32_t>(km) * 2654435761u) & hmask;
      for (;;) {
        int32_t empty = -1;
        if (hkeys[s] < 0
            && __atomic_compare_exchange_n(&hkeys[s], &empty, km, false,
                                           __ATOMIC_RELAXED,
                                           __ATOMIC_RELAXED))
          break;
        s = (s + 1) & hmask;
      }
      hoff[s] = static_cast<int32_t>(i);
      hcnt[s] = static_cast<int32_t>(j - i);
      // the bitmap's words in k-mer order: one atomic OR a word
      const int64_t w = static_cast<uint32_t>(km) >> 6;
      if (w != word) {
        if (word >= 0) __atomic_fetch_or(&bitmap[word], bits, __ATOMIC_RELAXED);
        word = w;
        bits = 0;
      }
      bits |= 1ull << (km & 63);
      i = j;
    }
    if (word >= 0) __atomic_fetch_or(&bitmap[word], bits, __ATOMIC_RELAXED);
  }
  return 0;
}


}  // extern "C"

// --threads support (Parameters PARAM_THREADS analog): cap the OpenMP
// team for every native engine in this process.
extern "C" int spacedust_set_threads(int n) {
#if defined(_OPENMP)
  // n <= 0 restores the all-cores default (the reference's
  // --threads 0 behavior)
  omp_set_num_threads(n > 0 ? n : omp_get_num_procs());
#endif
  return n;
}
