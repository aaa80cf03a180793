// Host helpers of the profile search that the JAX package runs as Python
// loops: the global composition-bias correction of a PSSM and the
// postings of the target-profile k-mer index.
//
// global_aa_bias_correction: search/profile.py::global_aa_bias_correction
// (SubstitutionMatrix::calcGlobalAaBiasCorrection,
// SubstitutionMatrix.cpp:205-243), the same float32 operations in the
// same order, so the corrected PSSM is bit-equal.
//
// profile_kmer_postings: the postings of the target-profile k-mer index
// (search/profilesearch.py::TargetProfilePrefilter; the reference's
// IndexBuilder.cpp:100-140 over profile targets): for each profile in
// order and each window w of its positions, every k-mer whose PSSM score
// summed over the spaced pattern reaches the threshold, once per
// (k-mer, profile) at its first window.
//
// The reference posts every such k-mer (about 600 a position at the
// profile k-mer threshold of -s 5.7).  A lookup only ever asks for the
// exact k-mers of the query genes, so the caller passes those as a table
// (`want`, one byte per packed k-mer) and only they are posted: the
// lookups return the same postings in the same order, from an index a
// small fraction of the size.
//
// A window's k-mers are enumerated depth first over the pattern's
// positions, each position's 20 scores taken in descending order and cut
// where the best the later positions can add no longer reaches the
// threshold: exactly the k-mers whose sum reaches it, as the JAX
// package's beam enumerates them (the order of enumeration does not
// matter, the postings are sorted).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int kAlpha = 20;
constexpr int kMaxK = 8;

struct Row {
  int16_t sc[kAlpha];  // descending
  int8_t aa[kAlpha];
};

// The postings of one profile: packed k-mer (ascending) and its first
// window, into `out` (cleared first).
void profile_postings(const Row* rows, int64_t L, const int32_t* pattern,
                      int k, int thr, const uint8_t* want,
                      std::vector<uint64_t>& out) {
  out.clear();
  const int span = pattern[k - 1] + 1;
  const int64_t nw = L - span + 1;
  int64_t powers[kMaxK];
  powers[0] = 1;
  for (int p = 1; p < k; ++p) powers[p] = powers[p - 1] * kAlpha;
  for (int64_t w = 0; w < nw; ++w) {
    const Row* r[kMaxK];
    int rest[kMaxK + 1];               // best the positions >= p can add
    rest[k] = 0;
    for (int p = k - 1; p >= 0; --p) {
      r[p] = rows + w + pattern[p];
      rest[p] = rest[p + 1] + r[p]->sc[0];
    }
    if (rest[0] < thr) continue;
    int choice[kMaxK];
    int part[kMaxK + 1];
    int64_t code[kMaxK + 1];
    part[0] = 0;
    code[0] = 0;
    int p = 0;
    choice[0] = -1;
    while (p >= 0) {
      const int j = ++choice[p];
      if (j >= kAlpha ||
          part[p] + r[p]->sc[j] + rest[p + 1] < thr) {
        --p;                           // this position is exhausted
        continue;
      }
      part[p + 1] = part[p] + r[p]->sc[j];
      code[p + 1] = code[p] + r[p]->aa[j] * powers[p];
      if (p + 1 == k) {
        if (want[code[k]])
          out.push_back(static_cast<uint64_t>(code[k]) << 32 |
                        static_cast<uint64_t>(w));
      } else {
        ++p;
        choice[p] = -1;
      }
    }
  }
  std::sort(out.begin(), out.end());
  // first window of each k-mer
  out.erase(std::unique(out.begin(), out.end(),
                        [](uint64_t a, uint64_t b) {
                          return (a >> 32) == (b >> 32);
                        }),
            out.end());
}

std::vector<Row> sorted_rows(const int16_t* pssm, int64_t n) {
  std::vector<Row> rows(n);
  for (int64_t i = 0; i < n; ++i) {
    int8_t idx[kAlpha];
    for (int a = 0; a < kAlpha; ++a) idx[a] = static_cast<int8_t>(a);
    const int16_t* v = pssm + i * kAlpha;
    std::stable_sort(idx, idx + kAlpha,
                     [v](int8_t a, int8_t b) { return v[a] > v[b]; });
    for (int a = 0; a < kAlpha; ++a) {
      rows[i].aa[a] = idx[a];
      rows[i].sc[a] = v[idx[a]];
    }
  }
  return rows;
}

}  // namespace

extern "C" {

// pssm: (L, 20) int8; p_null: (L,) float32, row i's background-weighted
// score sum; out: (L, 20) int8.  Row i is corrected by the mean of
// (score - p_null) over the rows of its window [i - 20, i + 20) but
// itself, accumulated in float32 row after row, the rows before i in
// their corrected form.
void global_aa_bias_correction(const int8_t* pssm, const float* p_null,
                               int64_t L, int8_t* out) {
  constexpr int kHalf = 20;
  std::vector<float> scores(L * kAlpha);
  for (int64_t k = 0; k < L * kAlpha; ++k)
    scores[k] = static_cast<float>(pssm[k]);
  for (int64_t i = 0; i < L; ++i) {
    const int64_t lo = std::max<int64_t>(0, i - kHalf);
    const int64_t hi = std::min<int64_t>(L, i + kHalf);
    float aa_sum[kAlpha] = {};
    for (int64_t j = lo; j < hi; ++j) {
      if (j == i) continue;
      for (int a = 0; a < kAlpha; ++a) {
        const float d = scores[j * kAlpha + a] - p_null[j];
        aa_sum[a] = aa_sum[a] + d;
      }
    }
    const float n = static_cast<float>(hi - lo);
    for (int a = 0; a < kAlpha; ++a) {
      const float q = aa_sum[a] / n;
      const float corrected = scores[i * kAlpha + a] - q;
      const int8_t v = static_cast<int8_t>(static_cast<int32_t>(corrected));
      out[i * kAlpha + a] = v;
      scores[i * kAlpha + a] = static_cast<float>(v);
    }
  }
}

// pssm: (offs[n_prof], 20) int16, profile q's rows from offs[q] on;
// pattern: k positions; want: 20^k bytes.  counts (n_prof): postings per
// profile.  With kmer/pos null only the counts are written; otherwise the
// postings go to kmer/pos (int64 / int32), profile after profile, each
// profile's k-mers ascending, at the offsets the prefix sums of counts
// give.  Returns 0, or -1 on bad arguments.
int profile_kmer_postings(const int16_t* pssm, const int64_t* offs,
                          int n_prof, const int32_t* pattern, int k,
                          int thr, const uint8_t* want, int64_t* counts,
                          int64_t* kmer, int32_t* pos) {
  if (k < 1 || k > kMaxK) return -1;
  const std::vector<Row> rows = sorted_rows(pssm, offs[n_prof]);
  std::vector<int64_t> first(n_prof + 1, 0);
  if (kmer != nullptr) {
    for (int q = 0; q < n_prof; ++q) first[q + 1] = first[q] + counts[q];
  }
#pragma omp parallel
  {
    std::vector<uint64_t> out;
#pragma omp for schedule(dynamic, 4)
    for (int q = 0; q < n_prof; ++q) {
      profile_postings(rows.data() + offs[q], offs[q + 1] - offs[q], pattern,
                       k, thr, want, out);
      if (kmer == nullptr) {
        counts[q] = static_cast<int64_t>(out.size());
      } else {
        int64_t at = first[q];
        for (uint64_t e : out) {
          kmer[at] = static_cast<int64_t>(e >> 32);
          pos[at] = static_cast<int32_t>(e & 0xffffffffu);
          ++at;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
