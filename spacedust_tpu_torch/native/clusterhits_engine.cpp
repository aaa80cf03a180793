// Agglomerative hit clustering: native engine for cluster/clusterhits.py.
//
// Exact port of the (parity-tested) Python merge loop, which itself
// replicates the reference's scan-order semantics
// (src/util/ClusterHits.cpp:363-453): row-major first-maximum argmax,
// from-scratch groupNodes rescoring each iteration, the dmin j==0 reset
// quirk, and uint32-wrapping gap compatibility.  The Python loop is
// O(K^2) score evaluations at init + O(K) per merge, with K from a few
// hundred hits per genome pair to a few thousand between genomes of one
// lineage — the dominant aggregation-tail cost in Python; in C++ the
// init rows run under OpenMP, the merges serially.
//
// Outputs node membership lists (concatenated, in nodes[0..K-1] index
// order with members in merge-concatenation order) plus each surviving
// node's final cluster score so the caller only formats results.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <omp.h>

namespace {

struct Hits {
  const int64_t* qpos;
  const int64_t* tpos;
  const uint8_t* qstrand;
  const uint8_t* tstrand;
};

struct Scratch {
  std::vector<int> members;       // gathered member hit ids
  std::vector<int> order;         // sort permutation by qpos
};

// lookup[i] = logGamma(i) with lookup[0] = +inf; negative indexes wrap
// Python-style (numpy negative indexing) for bug-compatibility.
static inline double lk(const double* lookup, int64_t len, int64_t i) {
  if (i < 0) i += len;
  return lookup[i];
}

static inline double log_cluster_pval(const double* lookup, int64_t len,
                                      int64_t k, int64_t m, double logq0) {
  return 2.0 * lk(lookup, len, m + 1) - 2.0 * lk(lookup, len, m - k + 1)
         - lk(lookup, len, k + 1) + (double)k * logq0;
}

static inline double log_ordering_pval(const double* lookup, int64_t len,
                                       int64_t k, int64_t m) {
  return std::log(1.0 - 1.0 * (double)m / (double)k)
         - (double)m * std::log(2.0) - lk(lookup, len, m + 1);
}

// clusterMatchScore over the hits listed in sc.members (ClusterHits.cpp:120-134)
static double cluster_score(const Hits& h, Scratch& sc, const double* lookup,
                            int64_t len, double logq0) {
  const size_t k = sc.members.size();
  if (k == 0) return 0.0;
  int64_t qmin = INT64_MAX, qmax = INT64_MIN, tmin = INT64_MAX,
          tmax = INT64_MIN;
  for (int n : sc.members) {
    qmin = std::min(qmin, h.qpos[n]); qmax = std::max(qmax, h.qpos[n]);
    tmin = std::min(tmin, h.tpos[n]); tmax = std::max(tmax, h.tpos[n]);
  }
  const int64_t span = std::max(qmax - qmin + 1, tmax - tmin + 1);
  // conserved adjacent pairs after a stable sort by qpos
  sc.order.resize(k);
  for (size_t i = 0; i < k; ++i) sc.order[i] = sc.members[i];
  std::stable_sort(sc.order.begin(), sc.order.end(),
                   [&](int a, int b) { return h.qpos[a] < h.qpos[b]; });
  int64_t m = 0;
  for (size_t l = 0; l + 1 < k; ++l) {
    const int a = sc.order[l], b = sc.order[l + 1];
    const bool same_order = h.tpos[b] > h.tpos[a];
    const bool s1 = h.qstrand[a] == h.tstrand[a];
    const bool s2 = h.qstrand[b] == h.tstrand[b];
    if (s1 == same_order && s2 == same_order) ++m;
  }
  return -0.5 * log_cluster_pval(lookup, len, (int64_t)k, span, logq0)
         - 0.5 * log_ordering_pval(lookup, len, (int64_t)k, m);
}

// isCompatibleCluster with uint32 wrap (ClusterHits.cpp:137-159).
// Per-node position bounding boxes are CACHED and merged in O(1) —
// they are exactly the min/max the reference recomputes by scanning
// members each call, so compatibility decisions are identical while
// the dominant row-rescore loop drops from O(sum cluster sizes) to
// O(K) box tests per merge.
struct Box {
  int64_t imin, imax, jmin, jmax;
};

static inline Box box_union(const Box& a, const Box& b) {
  return {std::min(a.imin, b.imin), std::max(a.imax, b.imax),
          std::min(a.jmin, b.jmin), std::max(a.jmax, b.jmax)};
}

static inline bool compatible(const Box& b1, const Box& b2, uint32_t d) {
  const uint32_t ja = (uint32_t)(b1.jmin - b2.jmax),
                 jb = (uint32_t)(b2.jmin - b1.jmax);
  const uint32_t ia = (uint32_t)(b1.imin - b2.imax),
                 ib = (uint32_t)(b2.imin - b1.imax);
  return std::min(ja, jb) <= d && std::min(ia, ib) <= d;
}

// groupNodes + clusterMatchScore for the (i, j) node pair
static double pair_score(const Hits& h,
                         const std::vector<std::vector<int>>& nodes,
                         const std::vector<Box>& boxes,
                         int i, int j, uint32_t d, Scratch& sc,
                         const double* lookup, int64_t len, double logq0) {
  const auto& n1 = nodes[i];
  const auto& n2 = nodes[j];
  if (n1.empty() || n2.empty()) return 0.0;
  if (!compatible(boxes[i], boxes[j], d)) return 0.0;
  sc.members.clear();
  sc.members.insert(sc.members.end(), n1.begin(), n1.end());
  sc.members.insert(sc.members.end(), n2.begin(), n2.end());
  return cluster_score(h, sc, lookup, len, logq0);
}

}  // namespace

extern "C" {

// Returns the number of nodes (== K); out_members holds all K hit ids
// grouped per node (empty nodes contribute nothing), out_sizes[K] the
// per-node member counts, out_scores[K] each node's final cluster score.
int cluster_hits_engine(const int64_t* qpos, const int64_t* tpos,
                        const uint8_t* qstrand, const uint8_t* tstrand,
                        int K, const double* lookup, int64_t lookup_len,
                        int64_t max_gene_gaps, double s_min, double q0,
                        int32_t* out_members, int32_t* out_sizes,
                        double* out_scores) {
  const Hits h{qpos, tpos, qstrand, tstrand};
  const uint32_t d = (uint32_t)max_gene_gaps;
  const double logq0 = std::log(q0);
  std::vector<std::vector<int>> nodes(K);
  std::vector<Box> boxes(K);
  for (int n = 0; n < K; ++n) {
    nodes[n] = {n};
    boxes[n] = {qpos[n], qpos[n], tpos[n], tpos[n]};
  }
  std::vector<double> dist((size_t)K * K, 0.0);
  std::vector<int> dmin(K, 0);

#pragma omp parallel
  {
    Scratch sc;
#pragma omp for schedule(dynamic, 8)
    for (int i = 0; i < K; ++i) {
      double* row = &dist[(size_t)i * K];
      int best = 0;
      for (int j = 0; j < K; ++j) {
        if (i != j)
          row[j] = pair_score(h, nodes, boxes, i, j, d, sc, lookup,
                              lookup_len, logq0);
        if (row[j] > row[best]) best = j;  // strict >: first max wins
      }
      dmin[i] = best;
    }
  }

  Scratch sc;
  double max_score = 0.0;
  bool first_iter = true;
  while (first_iter || max_score >= s_min) {
    int i1 = 0;
    for (int i = 0; i < K; ++i)
      if (dist[(size_t)i * K + dmin[i]] > dist[(size_t)i1 * K + dmin[i1]])
        i1 = i;
    const int i2 = dmin[i1];
    max_score = dist[(size_t)i1 * K + i2];
    if (max_score != 0.0) first_iter = false;
    else break;

    nodes[i1].insert(nodes[i1].end(), nodes[i2].begin(), nodes[i2].end());
    nodes[i2].clear();
    boxes[i1] = box_union(boxes[i1], boxes[i2]);

    // the merged node's row is rescored serially, in the j-scan that
    // maintains dmin, as the Python loop does: most of a row fails the
    // compatibility box at once, so a parallel region a merge (tens of
    // thousands in a genome collection) would cost more in fork/join
    // than the scores, and several times more on a shared host
    for (int j = 0; j < K; ++j) {
      if (j == i1 || j == i2) {
        dist[(size_t)i1 * K + j] = 0.0;
        dist[(size_t)j * K + i1] = 0.0;
      } else {
        const double s = pair_score(h, nodes, boxes, i1, j, d, sc, lookup,
                                    lookup_len, logq0);
        dist[(size_t)i1 * K + j] = s;
        dist[(size_t)j * K + i1] = s;
      }
      dist[(size_t)i2 * K + j] = 0.0;
      dist[(size_t)j * K + i2] = 0.0;
      // dmin maintenance verbatim (ClusterHits.cpp:438-449)
      if (j != 0) {
        if (dist[(size_t)i1 * K + j] > dist[(size_t)i1 * K + dmin[i1]])
          dmin[i1] = j;
      } else {
        dmin[i1] = j;
      }
      if (j != i1 && j != i2) {
        if (dist[(size_t)j * K + i1] > dist[(size_t)j * K + dmin[j]])
          dmin[j] = i1;
      }
    }
  }

  int32_t* mp = out_members;
  for (int n = 0; n < K; ++n) {
    out_sizes[n] = (int32_t)nodes[n].size();
    for (int v : nodes[n]) *mp++ = v;
    if (!nodes[n].empty()) {
      sc.members.assign(nodes[n].begin(), nodes[n].end());
      out_scores[n] = cluster_score(h, sc, lookup, lookup_len, logq0);
    } else {
      out_scores[n] = 0.0;
    }
  }
  return K;
}

}  // extern "C"
