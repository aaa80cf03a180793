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
// Structure mode (spacedust_tpu/ops/sw_engine.py::_sw_bucket_struct,
// the XLA scan ops/sw_tiled.py::sw_scan_core(prof2=, tseq2=)): the cell
// score has two channels, each cast to int8 on its own before the sum,
//   s = int8(m3di[q_ss_i][t_ss_j] + bias3di_i) + int8(aa[q_aa_i][t_aa_j]),
// with both 21x21 tables in shared memory and the strip keeping both query
// tokens; sw_forward_struct / sw_reverse_struct are the same DP otherwise.
//
// Two DP bodies live here.
//
// sw_forward / sw_reverse (sw_warp_kernel): a warp owns a pair.
// What bounds the DP on this card is the integer instruction rate, not
// bytes: a pair's tokens are a few KB and each cell needs 10 int32
// instructions (the lookup's address, the int8 wrap's add and sign
// extension, add and max-plus for each of E, H and F, the column max; 12
// with the reverse tracker) beside one shared-memory load, so 132 SMs x
// 64 int32 lanes set the ceiling.  This body spends 13.5 a cell at R = 16:
// the mask that holds rows past qlen at 0 (a compare and a select), the
// moves of the H history and a step's shuffles come on top.
// The card reaches it only when every lane works, so the design is about
// keeping lanes busy whatever the stage holds: one giant pair, a few
// thousand reverse pairs, or 80,000 short ones.
//   * Lane l keeps R consecutive query rows of a 32*R-row strip in
//     registers (tokens, bias, H, E).  The warp sweeps the target as an
//     anti-diagonal wavefront: at step s lane l computes column j = s - l,
//     for tlen + 31 uniform steps a strip; a lane outside [0, tlen) skips
//     the cells but takes part in every shuffle.
//   * What crosses from lane l to l + 1 after a column goes through
//     __shfl_up_sync: the column's target token, the last row's (H, F)
//     and, in the reverse kernel, the running column max and its row.
//     Only lane 0 needs memory: every 32 steps all lanes load the next 32
//     target tokens (and the previous strip's boundary) with one coalesced
//     access, a chunk ahead of use, and lane 0 takes column s from lane
//     s % 32 by a shuffle.
//   * Between strips lane 31 stores its (H, F) [and (cmax, row)] per
//     column and lane 0 of the next strip reads them back: 8 or 16 bytes
//     per column of a pair with qlen > 32*R only, in place (column j is
//     read 31 steps or more before it is written again), at a per-pair
//     offset that the wrapper prefix-sums over the launch (jobs row 6).
//   * R is a template argument in {4, 8, 12, 16}; the wrapper picks per
//     pair the class with the fewest lane-steps (jobs row 5), so a 290-row
//     query fills 25 of 32 lanes (R = 12), not 19, and a warp branches to
//     its pair's instantiation.  One launch carries every class: a launch
//     per class ran the classes' longest pairs one after the other, and a
//     stage lasts no less than its longest pair takes on a lone warp
//     (~22 ms for 5,917 x 5,496 on an H100 80GB HBM3 at 700 W).
//   * F_i = max(F_{i-1} - ge, Hb_{i-1} - go) with Hb the cell before F
//     joins it: equal to the textbook max(F - ge, H - go) when go >= ge
//     (the wrapper checks it) and one instruction shorter on the chain
//     that serialises a lane's rows.  max(a + b, c) and max(a + b, c, 0)
//     are the DPX forms __viaddmax_s32 / __viaddmax_s32_relu.
//   * Forward: a lane tracks the max of its rows per column and looks for
//     the row only when that max strictly beats its best; lanes merge
//     lexicographically (score, then smaller j, then smaller i) once, at
//     the end of the pair.  Reverse: the column max arrives from the lane
//     above and a row replaces it only when strictly greater, so earlier
//     rows keep ties; lane 31 of the last strip sees every column's final
//     (cmax, row) in column order and runs the best / terminate trackers.
//     Rows past qlen are held at H = 0 and can never beat row 0's
//     cmax >= 0, so a lane of such rows hands the value down untouched.
//   * A block is 4 warps = 4 pairs; the engine orders a stage longest
//     pair first, so the hardware's in-order block dispatch ends a launch
//     on its short pairs.
//
// sw_forward_struct / sw_reverse_struct (sw_scan_kernel<., true>): one
// thread per pair; the wrapper sorts pairs by cell count so a warp's pairs
// carry similar work.  A thread walks its pair in strips of kRows query
// rows: the strip's H/E state, tokens and bias live in registers while the
// thread sweeps all target columns; between strips, the last row's (H, F)
// -- and in the reverse kernel the running column max and its row -- cross
// through global scratch in a pair-minor layout (scratch[j * n + p]) so a
// warp's accesses coalesce.  It fills the card only when a launch carries
// >~100k pairs (132 SMs x 2048 threads), and a lone long pair runs on one
// thread at ~19 M cells/s (H100 80GB HBM3, 700 W), which is why the
// sequence kernels left it.  Moving the structure kernels to the
// warp-per-pair body, and int16x2 forms, are later work.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;      // query rows per register strip
constexpr int kAlphaPad = 32;  // sub table row pitch in shared memory
constexpr int kNeg = -(1 << 30);

// Structure mode's score tables: channel 1 (sub with the query bias) and
// channel 2 (sub2, no bias) on tokens qdata2 / tdata2.
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

// One-thread-per-pair body (structure kernels).
template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
sw_scan_kernel(const uint8_t* __restrict__ qdata,
               const int8_t* __restrict__ qbias,
               const uint8_t* __restrict__ tdata, const Tables tab,
               const int64_t* __restrict__ jobs, int64_t job_stride, int n,
               int go, int ge, void* __restrict__ scratch,
               int32_t* __restrict__ out, int64_t out_stride) {
  __shared__ int8_t s_sub[kAlphaPad * kAlphaPad];
  __shared__ int8_t s_sub2[kAlphaPad * kAlphaPad];
  load_table(s_sub, tab.sub, tab.alpha);
  load_table(s_sub2, tab.sub2, tab.alpha2);
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
      qt2[r] = qdata2[qi];
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
    int t2_nxt = tlen > 0 ? tdata2[tpos(0)] : 0;
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
        t2_nxt = tdata2[tpos(j + 1)];
      }
      const int8_t* col = s_sub + t * kAlphaPad;
      const int8_t* col2 = s_sub2 + t2 * kAlphaPad;
      int F = cur.y;
      int diag = diag_up;
      diag_up = cur.x;
      int cmax = -1, ci = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int s = static_cast<int8_t>(col[qt[r]] + qb[r]) + col2[qt2[r]];
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

// ---------------------------------------------------------------------
// Warp-per-pair body (sequence kernels).  jobs rows: qoff, qlen, toff,
// tlen, terminate, rows (the pair's class R), soff (its first boundary
// column in `scratch`; read only when qlen > 32 * R).
constexpr int kWarps = 4;              // pairs per block
constexpr unsigned kFull = 0xffffffffu;

template <bool kReverse> struct Boundary { using type = int2; };
template <> struct Boundary<true> { using type = int4; };

// One pair on the calling warp, R query rows a lane; writes the pair's six
// outputs at out[. * out_stride].
template <bool kReverse, int R>
__device__ __forceinline__ void sw_warp_pair(
    const int8_t* s_sub, const uint8_t* __restrict__ qdata,
    const int8_t* __restrict__ qbias, const uint8_t* __restrict__ tdata,
    int64_t qoff, int qlen, int64_t toff, int tlen, int term, int go,
    int ge, typename Boundary<kReverse>::type* __restrict__ bnd,
    int32_t* __restrict__ out, int64_t out_stride) {
  using Bnd = typename Boundary<kReverse>::type;
  const int lane = threadIdx.x & 31;

  int lb = 0, lj = -1, li = 0;         // forward: this lane's best so far
  int best = 0, bj = -1, bi = 0;       // reverse: lane 31, last strip
  int found = 0, fj = -1, fi = 0;

  for (int i0 = 0; i0 < qlen; i0 += 32 * R) {
    const bool first = (i0 == 0);
    const bool last = (qlen - i0 <= 32 * R);
    const int r0 = i0 + lane * R;      // this lane's first row
    const int nvalid = min(max(qlen - r0, 0), R);
    int qt[R], qb[R], Hr[R], Er[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = min(r0 + r, qlen - 1);
      const int64_t qi = kReverse ? qoff + qlen - 1 - i : qoff + i;
      qt[r] = qdata[qi];
      qb[r] = qbias[qi];
      Hr[r] = 0;
      Er[r] = kNeg;
    }
    int sb = 0, sj = -1, si = 0;       // forward: best within this strip
    int diag_up = 0;                   // H[r0-1][j-1]
    // what this lane hands to the next after a column
    int tok_o = 0, h_o = 0, f_o = kNeg, c_o = -1, ci_o = 0;
    // lane k of a chunk holds column 32 * (s / 32) + k: its target token
    // and, after the first strip, the boundary lane 31 left there
    int ctok = 0, ntok = 0;
    int4 cb = make_int4(0, kNeg, -1, 0), nb = cb;
    auto load_chunk = [&](int c) {
      if (c < tlen) {
        ntok = tdata[kReverse ? toff + tlen - 1 - c : toff + c];
        if (!first) {
          if constexpr (kReverse) {
            nb = bnd[c];
          } else {
            const int2 b = bnd[c];
            nb = make_int4(b.x, b.y, -1, 0);
          }
        }
      }
    };
    __syncwarp();                      // the previous strip's stores
    load_chunk(lane);
    const int nsteps = tlen + 31;
    for (int s = 0; s < nsteps; ++s) {
      const int k = s & 31;
      if (k == 0) {
        ctok = ntok;
        cb = nb;
        __syncwarp();
        load_chunk(s + 32 + lane);
      }
      int tok = __shfl_up_sync(kFull, tok_o, 1);
      int hin = __shfl_up_sync(kFull, h_o, 1);
      int fin = __shfl_up_sync(kFull, f_o, 1);
      int cin = -1, ciin = 0;
      if constexpr (kReverse) {
        cin = __shfl_up_sync(kFull, c_o, 1);
        ciin = __shfl_up_sync(kFull, ci_o, 1);
      }
      // lane 0 starts column s from the chunk
      const int t0 = __shfl_sync(kFull, ctok, k);
      int h0 = 0, f0 = kNeg, c0 = -1, ci0 = 0;
      if (!first) {                    // warp-uniform
        h0 = __shfl_sync(kFull, cb.x, k);
        f0 = __shfl_sync(kFull, cb.y, k);
        if constexpr (kReverse) {
          c0 = __shfl_sync(kFull, cb.z, k);
          ci0 = __shfl_sync(kFull, cb.w, k);
        }
      }
      if (lane == 0) {
        tok = t0; hin = h0; fin = f0; cin = c0; ciin = ci0;
      }
      const int j = s - lane;
      if (static_cast<unsigned>(j) < static_cast<unsigned>(tlen)) {
        const int8_t* col = s_sub + tok * kAlphaPad;
        int F = fin;
        int diag = diag_up;
        diag_up = hin;
        int cmax = cin, ci = ciin;
        int m = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int sc = static_cast<int8_t>(col[qt[r]] + qb[r]);
          const int e = __viaddmax_s32(Er[r], -ge, Hr[r] - go);
          const int hb = __viaddmax_s32_relu(diag, sc, e);
          // rows past qlen are held at H = 0
          const int h = (r < nvalid) ? max(hb, F) : 0;
          F = __viaddmax_s32(F, -ge, hb - go);
          diag = Hr[r];
          Hr[r] = h;
          Er[r] = e;
          if constexpr (kReverse) {
            if (h > cmax) { cmax = h; ci = r0 + r; }
          } else {
            m = max(m, h);
          }
        }
        if constexpr (!kReverse) {
          if (m > sb) {                // rare: look for the first such row
            sb = m;
            sj = j;
#pragma unroll
            for (int r = R - 1; r >= 0; --r)
              if (Hr[r] == m) si = r0 + r;
          }
        }
        tok_o = tok; h_o = Hr[R - 1]; f_o = F; c_o = cmax; ci_o = ci;
        if (lane == 31) {
          if (!last) {
            if constexpr (kReverse) {
              bnd[j] = make_int4(h_o, f_o, cmax, ci);
            } else {
              bnd[j] = make_int2(h_o, f_o);
            }
          } else if (kReverse) {
            if (cmax > best) { best = cmax; bj = j; bi = ci; }
            if (!found && cmax == term) { found = 1; fj = j; fi = ci; }
          }
        }
      }
    }
    // forward: the lexicographically first (j, i) reaching this lane's
    // maximum; on equal j the earlier strip has the smaller row
    if (!kReverse && (sb > lb || (sb == lb && sj < lj))) {
      lb = sb; lj = sj; li = si;
    }
  }
  if constexpr (kReverse) {
    if (lane != 31) return;
  } else {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int ob = __shfl_xor_sync(kFull, lb, d);
      const int oj = __shfl_xor_sync(kFull, lj, d);
      const int oi = __shfl_xor_sync(kFull, li, d);
      if (ob > lb || (ob == lb && (oj < lj || (oj == lj && oi < li)))) {
        lb = ob; lj = oj; li = oi;
      }
    }
    if (lane != 0) return;
    best = lb; bj = lj; bi = li;
  }
  out[0] = best;
  out[out_stride] = bj;
  out[2 * out_stride] = bi;
  out[3 * out_stride] = found;
  out[4 * out_stride] = fj;
  out[5 * out_stride] = fi;
}

template <bool kReverse>
__global__ void __launch_bounds__(32 * kWarps, 4)
sw_warp_kernel(const uint8_t* __restrict__ qdata,
               const int8_t* __restrict__ qbias,
               const uint8_t* __restrict__ tdata,
               const int8_t* __restrict__ sub, int alpha,
               const int64_t* __restrict__ jobs, int64_t job_stride, int n,
               int go, int ge, void* __restrict__ scratch,
               int32_t* __restrict__ out, int64_t out_stride) {
  __shared__ int8_t s_sub[kAlphaPad * kAlphaPad];
  load_table(s_sub, sub, alpha);
  __syncthreads();

  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n) return;                  // the whole warp leaves
  const int64_t qoff = jobs[p];
  const int qlen = static_cast<int>(jobs[job_stride + p]);
  const int64_t toff = jobs[2 * job_stride + p];
  const int tlen = static_cast<int>(jobs[3 * job_stride + p]);
  const int term = static_cast<int>(jobs[4 * job_stride + p]);
  const int rows = static_cast<int>(jobs[5 * job_stride + p]);
  auto* bnd = static_cast<typename Boundary<kReverse>::type*>(scratch) +
              (qlen > 32 * rows ? jobs[6 * job_stride + p] : 0);
  // warp-uniform: the wrapper writes one of these classes
  auto run = [&](auto r) {
    sw_warp_pair<kReverse, decltype(r)::value>(
        s_sub, qdata, qbias, tdata, qoff, qlen, toff, tlen, term, go, ge,
        bnd, out + p, out_stride);
  };
  switch (rows) {
    case 4: run(std::integral_constant<int, 4>{}); break;
    case 8: run(std::integral_constant<int, 8>{}); break;
    case 12: run(std::integral_constant<int, 12>{}); break;
    case 16: run(std::integral_constant<int, 16>{}); break;
  }
}

template <bool kReverse>
int launch_warp(const void* qdata, const void* qbias, const void* tdata,
                const void* sub, int alpha, const void* jobs,
                long long job_stride, int n, int go, int ge, void* scratch,
                void* out, long long out_stride, void* stream) {
  if (n <= 0) return 0;
  if (alpha > kAlphaPad) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kWarps - 1) / kWarps;
  sw_warp_kernel<kReverse><<<blocks, 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qdata), static_cast<const int8_t*>(qbias),
      static_cast<const uint8_t*>(tdata), static_cast<const int8_t*>(sub),
      alpha, static_cast<const int64_t*>(jobs), job_stride, n, go, ge,
      scratch, static_cast<int32_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

template <bool kReverse>
int launch(const void* qdata, const void* qbias, const void* tdata,
           const Tables& tab, const void* jobs, long long job_stride, int n,
           int go, int ge, void* scratch, void* out, long long out_stride,
           void* stream) {
  if (n <= 0) return 0;
  if (tab.alpha > kAlphaPad || tab.alpha2 > kAlphaPad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kThreads - 1) / kThreads;
  sw_scan_kernel<kReverse><<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qdata), static_cast<const int8_t*>(qbias),
      static_cast<const uint8_t*>(tdata), tab,
      static_cast<const int64_t*>(jobs), job_stride, n, go, ge, scratch,
      static_cast<int32_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int load_kernel(K* kernel) {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
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

// Loads the four kernels onto the current device (CUDA loads a kernel at
// its first use otherwise, inside whatever times that launch).  Returns
// the first CUDA error, or 0.
int sw_load() {
  int rc = load_kernel(sw_warp_kernel<false>);
  if (rc == 0) rc = load_kernel(sw_warp_kernel<true>);
  if (rc == 0) rc = load_kernel(sw_scan_kernel<false>);
  if (rc == 0) rc = load_kernel(sw_scan_kernel<true>);
  return rc;
}

// Sequence kernels (warp per pair).  jobs: int64 rows (qoff, qlen, toff,
// tlen, terminate, rows, soff), row stride job_stride, n pairs from the
// pointer on; rows is the pair's class (4, 8, 12 or 16 query rows a
// lane); out: int32 rows (score, t_end, q_end, found, fj, fi), row stride
// out_stride, pair p's result at column p; scratch: int2 (forward) or int4
// (reverse) per target column of every pair with qlen > 32 * rows, pair
// p's columns from soff[p] on.  Returns cudaGetLastError().
int sw_forward(const void* qdata, const void* qbias, const void* tdata,
               const void* sub, int alpha, const void* jobs,
               long long job_stride, int n, int go, int ge, void* scratch,
               void* out, long long out_stride, void* stream) {
  return launch_warp<false>(qdata, qbias, tdata, sub, alpha, jobs,
                            job_stride, n, go, ge, scratch, out, out_stride,
                            stream);
}

int sw_reverse(const void* qdata, const void* qbias, const void* tdata,
               const void* sub, int alpha, const void* jobs,
               long long job_stride, int n, int go, int ge, void* scratch,
               void* out, long long out_stride, void* stream) {
  return launch_warp<true>(qdata, qbias, tdata, sub, alpha, jobs,
                           job_stride, n, go, ge, scratch, out, out_stride,
                           stream);
}

// Structure mode (one thread per pair): 3Di tokens (qss, tss) scored by
// m3di with the query's 3Di bias, amino-acid tokens (qaa, taa) by aasc
// (offsets index all four token arrays alike).  jobs: int64 rows (qoff,
// qlen, toff, tlen, terminate); out as above; scratch: n * max(tlen) int2
// (forward) or int4 (reverse).
int sw_forward_struct(const void* qss, const void* qaa, const void* qbias,
                      const void* tss, const void* taa, const void* m3di,
                      int alpha, const void* aasc, int alpha2,
                      const void* jobs, long long job_stride, int n, int go,
                      int ge, void* scratch, void* out, long long out_stride,
                      void* stream) {
  return launch<false>(
      qss, qbias, tss, struct_tables(m3di, qaa, taa, aasc, alpha, alpha2),
      jobs, job_stride, n, go, ge, scratch, out, out_stride, stream);
}

int sw_reverse_struct(const void* qss, const void* qaa, const void* qbias,
                      const void* tss, const void* taa, const void* m3di,
                      int alpha, const void* aasc, int alpha2,
                      const void* jobs, long long job_stride, int n, int go,
                      int ge, void* scratch, void* out, long long out_stride,
                      void* stream) {
  return launch<true>(
      qss, qbias, tss, struct_tables(m3di, qaa, taa, aasc, alpha, alpha2),
      jobs, job_stride, n, go, ge, scratch, out, out_stride, stream);
}

}  // extern "C"
