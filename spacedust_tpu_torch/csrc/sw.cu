// Batched Smith-Waterman score passes for Hopper (sm_90a).
//
// Replaces the JAX package's three Pallas kernels on the clustersearch path:
//   * sw_forward: ops/sw_pallas.py::_kernel_rowmax (sw_scan_pallas with
//     per_column=False) -- per pair (score, t_end, q_end);
//   * sw_reverse: ops/sw_pallas.py::_kernel (per_column=True) -- the same DP
//     on the flipped prefixes, with the per-column max and the terminate
//     tracker that gives the alignment start;
//   * both kernels also take over ops/sw_engine.py::panel_gather: they read
//     query tokens, the int8 composition bias and target tokens straight
//     from the resident 1-D arrays at per-pair int64 offsets (forward or
//     flipped), so there are no panels, no alignment padding and no
//     separate gather launch.  The score grid of sw_pallas.py::score_grid
//     becomes a lookup s = int8(sub[q_i][t_j] + bias_i) into a table in
//     shared memory.
//
// Semantics (identical to ops/sw_tiled.py::sw_scan_core and to the plain
// version ops/sw.py::sw_scan_ref): Gotoh local alignment, H clamped at 0,
// E carried across target columns j, F the in-column gap along query rows
// i, computed by the sequential recurrence F_i = max(F_{i-1} - ge,
// H_{i-1} - go) (equal to the TPU's closed-form shift-max when go >= ge).
//   score          = max H over valid cells (0 when none is positive)
//   (t_end, q_end) = first column whose max strictly beats the running best,
//                    first row reaching it there; (-1, 0) when score == 0
//   (found, fj, fi)= first column whose max equals `terminate`, first row
//                    reaching it there; (0, -1, 0) when none (reverse only;
//                    the forward kernel writes the (0, -1, 0) placeholders)
//
// Structure mode (kStruct, spacedust_tpu/ops/sw_engine.py::_sw_bucket_struct,
// the XLA scan ops/sw_tiled.py::sw_scan_core(prof2=, tseq2=)): the cell
// score has two channels, each cast to int8 on its own before the sum,
//   s = int8(m3di[q_ss_i][t_ss_j] + bias3di_i) + int8(aa[q_aa_i][t_aa_j]),
// with both 21x21 tables in shared memory and the strip keeping both query
// tokens; sw_forward_struct / sw_reverse_struct are the same DP otherwise.
//
// Design: one thread per pair; the wrapper sorts pairs by cell count so a
// warp's pairs carry similar work.  A thread walks its pair in strips of
// kRows query rows: the strip's H/E state, tokens and bias live in
// registers while the thread sweeps all target columns; between strips,
// the last row's (H, F) -- and in the reverse kernel the running column
// max and its row -- cross through global scratch in a pair-minor layout
// (scratch[j * n + p]) so a warp's accesses coalesce.
//
// What bounds it on the card: global scratch traffic is 8 bytes (forward)
// or 16 bytes (reverse) per kRows cells each way, and a thread's column
// loop waits on that load, prefetched one column ahead; the rest is ~15
// integer instructions per cell.  With one thread per pair the card fills
// only when a launch carries >~100k pairs (132 SMs x 2048 threads), and a
// lone long pair runs on one thread: measured on an H100 80GB HBM3 at
// 700 W, one thread scores ~19 M cells/s, so a launch lasts at least as
// long as its longest pair takes alone.  Striped or anti-diagonal
// layouts, int16x2 / DPX max-plus and staged loads are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;      // query rows per register strip
constexpr int kAlphaPad = 32;  // sub table row pitch in shared memory
constexpr int kNeg = -(1 << 30);

// Score tables: channel 1 (sub with the query bias) and, in structure
// mode, channel 2 (sub2, no bias) on tokens qdata2 / tdata2.
struct Tables {
  const int8_t* sub;
  int alpha;
  const uint8_t* qdata2;
  const uint8_t* tdata2;
  const int8_t* sub2;
  int alpha2;
};

// s_tab[t * kAlphaPad + q] = tab[q][t], zero outside the alphabet
__device__ void load_table(int8_t* s_tab, const int8_t* tab, int alpha) {
  for (int k = threadIdx.x; k < kAlphaPad * kAlphaPad; k += blockDim.x) {
    const int t = k / kAlphaPad, q = k % kAlphaPad;
    s_tab[k] = (t < alpha && q < alpha) ? tab[q * alpha + t] : 0;
  }
}

template <bool kReverse, bool kStruct>
__global__ void __launch_bounds__(kThreads)
sw_scan_kernel(const uint8_t* __restrict__ qdata,
               const int8_t* __restrict__ qbias,
               const uint8_t* __restrict__ tdata, const Tables tab,
               const int64_t* __restrict__ jobs, int64_t job_stride, int n,
               int go, int ge, void* __restrict__ scratch,
               int32_t* __restrict__ out, int64_t out_stride) {
  __shared__ int8_t s_sub[kAlphaPad * kAlphaPad];
  __shared__ int8_t s_sub2[kStruct ? kAlphaPad * kAlphaPad : 1];
  load_table(s_sub, tab.sub, tab.alpha);
  if constexpr (kStruct) load_table(s_sub2, tab.sub2, tab.alpha2);
  __syncthreads();
  const uint8_t* __restrict__ qdata2 = tab.qdata2;
  const uint8_t* __restrict__ tdata2 = tab.tdata2;

  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t qoff = jobs[p];
  const int qlen = static_cast<int>(jobs[job_stride + p]);
  const int64_t toff = jobs[2 * job_stride + p];
  const int tlen = static_cast<int>(jobs[3 * job_stride + p]);
  const int term = static_cast<int>(jobs[4 * job_stride + p]);

  // reverse: flipped prefixes q[qlen-1-i], t[tlen-1-j]
  auto tpos = [&](int j) -> int64_t {
    return kReverse ? toff + tlen - 1 - j : toff + j;
  };

  int2* bnd2 = static_cast<int2*>(scratch);
  int4* bnd4 = static_cast<int4*>(scratch);

  int best = 0, bj = -1, bi = 0;     // (score, t_end, q_end)
  int found = 0, fj = -1, fi = 0;

  for (int i0 = 0; i0 < qlen; i0 += kRows) {
    const bool first = (i0 == 0);
    const bool last = (i0 + kRows >= qlen);
    const int nvalid = min(kRows, qlen - i0);
    int qt[kRows], qt2[kRows], qb[kRows], hmask[kRows], Hr[kRows],
        Er[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, qlen - 1);
      const int64_t qi = kReverse ? qoff + qlen - 1 - i : qoff + i;
      qt[r] = qdata[qi];
      qb[r] = qbias[qi];
      if constexpr (kStruct) qt2[r] = qdata2[qi];
      // rows past qlen are held at H = 0, as the JAX scan holds them;
      // they sit below every valid row, so nothing flows back up
      hmask[r] = (r < nvalid) ? -1 : 0;
      Hr[r] = 0;
      Er[r] = kNeg;
    }
    int sb = 0, sj = -1, si = 0;      // forward: best within this strip
    int diag_up = 0;                  // H[i0-1][j-1]
    int4 nxt = make_int4(0, kNeg, -1, 0);
    if (!first && tlen > 0) {
      if (kReverse) {
        nxt = bnd4[p];
      } else {
        const int2 b = bnd2[p];
        nxt = make_int4(b.x, b.y, -1, 0);
      }
    }
    int t_nxt = tlen > 0 ? tdata[tpos(0)] : 0;
    int t2_nxt = (kStruct && tlen > 0) ? tdata2[tpos(0)] : 0;
    for (int j = 0; j < tlen; ++j) {
      const int4 cur = nxt;           // (H[i0-1][j], F[i0][j], cmax, crow)
      const int t = t_nxt;
      const int t2 = t2_nxt;
      if (j + 1 < tlen) {
        if (!first) {
          const int64_t k = static_cast<int64_t>(j + 1) * n + p;
          if (kReverse) {
            nxt = bnd4[k];
          } else {
            const int2 b = bnd2[k];
            nxt = make_int4(b.x, b.y, -1, 0);
          }
        }
        t_nxt = tdata[tpos(j + 1)];
        if constexpr (kStruct) t2_nxt = tdata2[tpos(j + 1)];
      }
      const int8_t* col = s_sub + t * kAlphaPad;
      const int8_t* col2 = s_sub2 + (kStruct ? t2 * kAlphaPad : 0);
      int F = cur.y;
      int diag = diag_up;
      diag_up = cur.x;
      int cmax = -1, ci = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        int s = static_cast<int8_t>(col[qt[r]] + qb[r]);
        if constexpr (kStruct) s += col2[qt2[r]];
        const int e = max(Er[r] - ge, Hr[r] - go);
        const int h = max(max(max(diag + s, 0), e), F) & hmask[r];
        F = max(F - ge, h - go);
        diag = Hr[r];
        Hr[r] = h;
        Er[r] = e;
        if (kReverse) {
          if (h > cmax) { cmax = h; ci = i0 + r; }
        } else {
          if (h > sb) { sb = h; sj = j; si = i0 + r; }
        }
      }
      const int64_t k = static_cast<int64_t>(j) * n + p;
      if (kReverse) {
        // earlier strips hold smaller rows: they keep ties
        if (!first && !(cmax > cur.z)) { cmax = cur.z; ci = cur.w; }
        if (last) {
          if (cmax > best) { best = cmax; bj = j; bi = ci; }
          if (!found && cmax == term) { found = 1; fj = j; fi = ci; }
        } else {
          bnd4[k] = make_int4(Hr[kRows - 1], F, cmax, ci);
        }
      } else if (!last) {
        bnd2[k] = make_int2(Hr[kRows - 1], F);
      }
    }
    // forward: the lexicographically first (j, i) reaching the maximum;
    // on equal j the earlier strip has the smaller row
    if (!kReverse && (sb > best || (sb == best && sj < bj))) {
      best = sb; bj = sj; bi = si;
    }
  }
  out[p] = best;
  out[out_stride + p] = bj;
  out[2 * out_stride + p] = bi;
  out[3 * out_stride + p] = found;
  out[4 * out_stride + p] = fj;
  out[5 * out_stride + p] = fi;
}

template <bool kReverse, bool kStruct>
int launch(const void* qdata, const void* qbias, const void* tdata,
           const Tables& tab, const void* jobs, long long job_stride, int n,
           int go, int ge, void* scratch, void* out, long long out_stride,
           void* stream) {
  if (n <= 0) return 0;
  if (tab.alpha > kAlphaPad || (kStruct && tab.alpha2 > kAlphaPad))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  sw_scan_kernel<kReverse, kStruct><<<blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qdata), static_cast<const int8_t*>(qbias),
      static_cast<const uint8_t*>(tdata), tab,
      static_cast<const int64_t*>(jobs), job_stride, n, go, ge, scratch,
      static_cast<int32_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

Tables seq_tables(const void* sub, int alpha) {
  return Tables{static_cast<const int8_t*>(sub), alpha, nullptr, nullptr,
                nullptr, 0};
}

Tables struct_tables(const void* m3di, const void* qaa, const void* taa,
                     const void* aasc, int alpha, int alpha2) {
  return Tables{static_cast<const int8_t*>(m3di), alpha,
                static_cast<const uint8_t*>(qaa),
                static_cast<const uint8_t*>(taa),
                static_cast<const int8_t*>(aasc), alpha2};
}

}  // namespace

extern "C" {

// jobs: int64 rows (qoff, qlen, toff, tlen, terminate), row stride
// job_stride, n pairs from the pointer on; out: int32 rows (score, t_end,
// q_end, found, fj, fi), row stride out_stride; scratch: n * max(tlen)
// int2 (forward) or int4 (reverse).  Returns cudaGetLastError().
int sw_forward(const void* qdata, const void* qbias, const void* tdata,
               const void* sub, int alpha, const void* jobs,
               long long job_stride, int n, int go, int ge, void* scratch,
               void* out, long long out_stride, void* stream) {
  return launch<false, false>(qdata, qbias, tdata, seq_tables(sub, alpha),
                              jobs, job_stride, n, go, ge, scratch, out,
                              out_stride, stream);
}

int sw_reverse(const void* qdata, const void* qbias, const void* tdata,
               const void* sub, int alpha, const void* jobs,
               long long job_stride, int n, int go, int ge, void* scratch,
               void* out, long long out_stride, void* stream) {
  return launch<true, false>(qdata, qbias, tdata, seq_tables(sub, alpha),
                             jobs, job_stride, n, go, ge, scratch, out,
                             out_stride, stream);
}

// Structure mode: 3Di tokens (qss, tss) scored by m3di with the query's
// 3Di bias, amino-acid tokens (qaa, taa) by aasc; jobs, out and scratch as
// above (offsets index all four token arrays alike).
int sw_forward_struct(const void* qss, const void* qaa, const void* qbias,
                      const void* tss, const void* taa, const void* m3di,
                      int alpha, const void* aasc, int alpha2,
                      const void* jobs, long long job_stride, int n, int go,
                      int ge, void* scratch, void* out, long long out_stride,
                      void* stream) {
  return launch<false, true>(
      qss, qbias, tss, struct_tables(m3di, qaa, taa, aasc, alpha, alpha2),
      jobs, job_stride, n, go, ge, scratch, out, out_stride, stream);
}

int sw_reverse_struct(const void* qss, const void* qaa, const void* qbias,
                      const void* tss, const void* taa, const void* m3di,
                      int alpha, const void* aasc, int alpha2,
                      const void* jobs, long long job_stride, int n, int go,
                      int ge, void* scratch, void* out, long long out_stride,
                      void* stream) {
  return launch<true, true>(
      qss, qbias, tss, struct_tables(m3di, qaa, taa, aasc, alpha, alpha2),
      jobs, job_stride, n, go, ge, scratch, out, out_stride, stream);
}

}  // extern "C"
