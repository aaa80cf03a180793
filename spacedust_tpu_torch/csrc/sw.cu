// Batched Smith-Waterman score passes for Hopper (sm_90a).
//
// Replaces the JAX package's three Pallas kernels on the clustersearch path:
//   * sw_forward: ops/sw_pallas.py::_kernel_rowmax (sw_scan_pallas with
//     per_column=False) -- per pair (score, t_end, q_end);
//   * sw_reverse: ops/sw_pallas.py::_kernel (per_column=True) -- the same DP
//     on the flipped prefixes, with the per-column max and the terminate
//     tracker that gives the alignment start;
//   * sw_forward_shards / sw_reverse_shards (and their block path):
//     parallel/sw_sharded.py::_sharded_bucket_fn, the target-sharded
//     stage (see below);
//   * the kernels also take over ops/sw_engine.py::panel_gather: they read
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
// with both 21x21 tables in shared memory; sw_forward_struct /
// sw_reverse_struct are the same DP otherwise, and the same body
// (kStructCell).
//
// Profile queries (spacedust_tpu/ops/sw.py::sw_forward_from_profiles /
// sw_reverse_from_profiles, the XLA scan ops/sw_tiled.py::sw_scan_core
// over explicit (B, 21, Lq) profiles): the cell score is read from a
// per-position int8 profile of 21 columns (20 amino acids and X),
//   s = prof[q_i][t_j],
// with no bias and no wrap (the values are int8 already); the query side
// is one resident int8 array (sum of query lengths, 21), row-major, at
// the token arrays' offsets.  sw_forward_prof / sw_reverse_prof are the
// same DP otherwise, and the same body (kProfCell).
//
// One DP body (sw_warp_pair): a warp owns a pair.
// What bounds the DP on this card is the integer instruction rate, not
// bytes: a pair's tokens are a few KB and each cell needs 10 int32
// instructions (the lookup's address, the int8 wrap's add and sign
// extension, add and max-plus for each of E, H and F, the column max; 12
// with the reverse tracker; the second channel adds its lookup's address
// and the sum; the profile cell drops the address and the wrap: 8 and 10)
// beside one shared-memory load a channel, so 132 SMs x 64 int32 lanes
// set the ceiling.  This body spends 13.5 a cell at R = 16 in the
// sequence kernels: the mask that holds rows past qlen at 0 (a compare
// and a select), the moves of the H history and a step's shuffles come on
// top.
// The card reaches it only when every lane works, so the design is about
// keeping lanes busy whatever the stage holds: one giant pair, a few
// thousand reverse pairs, or 900,000 short ones.
//   * Lane l keeps R consecutive query rows of a 32*R-row strip in
//     registers (tokens of each channel, bias, H, E).  The warp sweeps the
//     target as an anti-diagonal wavefront: at step s lane l computes
//     column j = s - l, for tlen + 31 uniform steps a strip; a lane
//     outside [0, tlen) skips the cells but takes part in every shuffle.
//   * What crosses from lane l to l + 1 after a column goes through
//     __shfl_up_sync: the column's target token, the last row's (H, F)
//     and, in the reverse kernels, the running column max and its row.
//     Structure mode packs the column's two tokens into the one register
//     that travels (t_ss | t_aa << 8), so a step costs no extra shuffle.
//     Only lane 0 needs memory: every 32 steps all lanes load the next 32
//     target tokens (and the previous strip's boundary) with one coalesced
//     access a channel, a chunk ahead of use, and lane 0 takes column s
//     from lane s % 32 by a shuffle.
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
//   * Registers: a row costs a lane 4 of them in the sequence kernels
//     (token, bias, H, E), 5 in structure mode (the second token) and 2 in
//     the profile kernels (H, E).  The sequence and profile kernels keep 4
//     blocks of 4 warps an SM (at most 128 registers a thread); the
//     structure kernels take 3 (at most 168), so that R = 16 holds its rows
//     without spilling.
//   * Profile rows live in shared memory, not in registers: at each strip's
//     start a lane copies its R rows (flipped for the reverse pass) into
//     its own slots of its warp's region, token-major (a token's 32 * R
//     rows are contiguous), so the lane that owns a row is the only one to
//     write or read it and no synchronisation is needed.  A column's cell
//     reads lane l's row r at byte l * R + r of the token's rows: lanes
//     R / 4 words apart, which is conflict-free for R = 4 and 12.  For
//     R = 8 and 16 (2- and 4-way conflicts) the R / 4 words of a lane's
//     block are rotated by l * (R / 4) / 32, which puts the 32 lanes in 32
//     banks.  A warp's region holds 21 x 32 x 16 bytes (10.5 KB, 42 KB a
//     block).
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
// The target-sharded stage (spacedust_tpu/parallel/sw_sharded.py::
// _sharded_bucket_fn, the shard_map of the SW over the `targets` axis):
// each shard keeps only its own targets resident.  sw_forward_shards /
// sw_reverse_shards score a card's stage over all of its shards in one
// launch of the sequence body (sw_shards_kernel: the job table's eighth
// row is the pair's shard, whose tokens start at tbase[shard], toff
// shard-local), the pairs sorted longest first across the shards; the
// few pairs that would outlast an even share of the stage on one warp
// (ops/sw_cuda.py::shard_plan) take the block path, sw_forward_shards_
// block / sw_reverse_shards_block (sw_block_kernel<kReverse, kSeqCell,
// W>, a block of W warps a pair), launched first on a side stream so that
// its blocks are resident before the short launch fills the card.
//   * Why: a lone warp floors a stage at its longest pair (~21.5 ms for
//     5,917 x 5,496), while one SM could run ~10.6 G reverse cells/s (64
//     int32 lanes x 1.98 GHz / 12).  Warp w of the block sweeps strips
//     w, w + W, ... with the lone warp's sweep (sw_strips), behind the
//     warp of the strip before.  R for such a pair minimises
//     ceil(strips / W) * (R + 3) (ops/sw_cuda.py::block_rows): a smaller
//     R gives more strips to share.
//   * The boundary lane 31 hands to the next strip goes to a ring of two
//     slots of tlen columns a pair in global scratch: strip k writes slot
//     k % 2 and reads slot (k - 1) % 2.  Every 32 columns, and at the
//     last, lane 31 publishes how many 32-column chunks its warp has
//     written over all of its strips (__threadfence_block, then a
//     block-scope release store to the warp's counter in shared memory);
//     before it loads the chunk of columns c0 .. c0 + 31, every lane of a
//     warp waits (block-scope acquire loads, __nanosleep back-off) until
//     the warp of strip k - 1 has published that chunk.  The chunk feed
//     reads 32 to 63 columns ahead of its step and lane 31 writes column
//     j at step j + 31, so a strip runs at least 94 steps behind the one
//     above (its first load, of columns 0-31, waits for that strip's step
//     62).  Two slots are enough: strip k + 2, which overwrites slot
//     k % 2, reads what strip k + 1 writes and so cannot pass it, and
//     strip k + 1 has read a column of slot k % 2 before it writes that
//     column of its own slot.  (One slot would do as well, by the
//     in-place argument above, as the numpy model of this schedule in
//     tests/test_torch_sw_block.py shows; the ring keeps a strip's input
//     and output apart.)
//   * Forward: each warp merges its lanes as a lone warp does, then the
//     warps' (score, j, i) merge through shared memory in full
//     lexicographic order (strips interleave over the warps, so a warp's
//     index says nothing of its rows), after a named barrier (bar.sync 1,
//     32 W) that every warp reaches, with or without a strip.  Reverse:
//     lane 31 of the warp of the last strip ran the trackers and writes.
//   * W is a template argument, compiled at 16 alone (kBlockWarps): on an
//     H100 80GB HBM3 at 700 W, W = 16 took the 5,917 x 5,496 pair in
//     3.74 ms (W = 8: 4.63, W = 4: 6.60; a lone warp 21.51), and every
//     stage timed at 4, 8 and 16 ran fastest at 16.  A width that is
//     wanted again is one more instantiation, timed on the card.
//     __launch_bounds__(32 W, 16 / W) keeps a thread at 128 registers, so
//     R = 16 holds its rows without spilling.
//
// The profile reverse stage (B10 reverse, sw_reverse_prof) takes the same
// split: its few long pairs go to sw_reverse_prof_block (sw_block_kernel<
// true, kProfCell, W>) on the side stream, the rest to sw_reverse_prof, as
// ops/sw_cuda.py plans a stage of one shard.  What differs is the cell:
//   * a lane stages its R profile rows into its warp's region at each
//     strip's start and reads them for the strip's columns (see above), so
//     each warp of the block needs a region of its own: warp w sweeps
//     strips w, w + W, ..., and a region shared with another warp would be
//     overwritten by that warp's next strip while this one still reads it.
//     W regions of kProfRegion bytes (172,032 bytes at W = 16) are
//     dynamic shared memory, the opt-in limit raised by sw_load on every
//     card it readies;
//   * the targets are one array (no shard row), and there is no table.

#include <cstdint>
#include <type_traits>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kAlphaPad = 32;  // score table row pitch in shared memory
constexpr int kTable = kAlphaPad * kAlphaPad;
constexpr int kProfCols = 21;   // profile columns: 20 amino acids and X
constexpr int kMaxRows = 16;    // the largest class of rows a lane
constexpr int kProfRegion = kProfCols * 32 * kMaxRows;  // bytes a warp
constexpr int kNeg = -(1 << 30);
constexpr int kWarps = 4;              // pairs per block
constexpr int kBlockWarps = 16;        // the block path's warps a pair
constexpr unsigned kFull = 0xffffffffu;

// where a cell's score comes from: a 21x21 table with the query's bias
// (sequence), two tables (structure), a per-position profile (profile)
enum Cell { kSeqCell, kStructCell, kProfCell };

// Structure mode's second score channel: the tokens it reads (at the
// offsets of the first channel's) and its table, which takes no bias.
// The sequence kernels carry it empty.
struct Second {
  const uint8_t* qdata;
  const uint8_t* tdata;
  const int8_t* sub;
  int alpha;
};

// s_tab[t * kAlphaPad + q] = tab[q][t], zero outside the alphabet
__device__ void load_table(int8_t* s_tab, const int8_t* tab, int alpha) {
  for (int k = threadIdx.x; k < kTable; k += blockDim.x) {
    const int t = k / kAlphaPad, q = k % kAlphaPad;
    s_tab[k] = (t < alpha && q < alpha) ? tab[q * alpha + t] : 0;
  }
}

template <bool kReverse> struct Boundary { using type = int2; };
template <> struct Boundary<true> { using type = int4; };

// How the boundary lane 31 leaves after a column reaches lane 0 of the
// next strip.  InPlace: one warp sweeps the strips in order and strip
// k + 1 reads column c where strip k left it.
template <bool kReverse>
struct InPlace {
  using B = typename Boundary<kReverse>::type;
  B* bnd;
  __device__ __forceinline__ int first() const { return 0; }
  static constexpr int kStride = 1;
  __device__ __forceinline__ B* in(int) const { return bnd; }
  __device__ __forceinline__ B* out(int) const { return bnd; }
  __device__ __forceinline__ void wait(int, int) const {}
  __device__ __forceinline__ void publish(int, int) const {}
};

// The block path: warp w of W sweeps strips w, w + W, ...; strip k
// writes slot k % 2 of a ring of two slots of tlen columns and reads slot
// (k - 1) % 2.  prog[w] counts the 32-column chunks warp w has published,
// over all of its strips (strip k is its (k / W)-th).
template <bool kReverse, int W>
struct Ring {
  using B = typename Boundary<kReverse>::type;
  B* ring;
  int* prog;                           // shared memory, W counters
  int tlen, nchunks, warp;
  __device__ __forceinline__ int first() const { return warp; }
  static constexpr int kStride = W;
  __device__ __forceinline__ B* in(int strip) const {
    return ring + static_cast<int64_t>((strip - 1) & 1) * tlen;
  }
  __device__ __forceinline__ B* out(int strip) const {
    return ring + static_cast<int64_t>(strip & 1) * tlen;
  }
  // before a chunk of columns [c0, c0 + 32) is loaded: until strip - 1
  // has written all of them (all lanes wait, so that each lane's loads
  // follow its own acquire)
  __device__ __forceinline__ void wait(int strip, int c0) const {
    if (strip == 0 || c0 >= tlen) return;
    const int need = ((strip - 1) / W) * nchunks + (c0 >> 5) + 1;
    cuda::atomic_ref<int, cuda::thread_scope_block> p(prog[(strip - 1) % W]);
    int ns = 32;
    while (p.load(cuda::memory_order_acquire) < need) {
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
  }
  // lane 31, after writing column j: every 32 columns and at the last
  __device__ __forceinline__ void publish(int strip, int j) const {
    if ((j & 31) != 31 && j != tlen - 1) return;
    __threadfence_block();
    cuda::atomic_ref<int, cuda::thread_scope_block>(prog[warp]).store(
        (strip / W) * nchunks + (j >> 5) + 1, cuda::memory_order_release);
  }
};

// The strips of one pair that the calling warp sweeps (all of them for a
// lone warp), R query rows a lane.  Carries, for the forward pass, this
// lane's best (lb, lj, li) over its strips, and for the reverse pass the
// trackers of lane 31 of the last strip.  s_tab: the first channel's
// table, then (kStructCell) the second's; kProfCell: the warp's profile
// region, and qdata the resident int8 profile rows.
template <bool kReverse, int kCell, int R, typename Link>
__device__ __forceinline__ void sw_strips(
    const int8_t* s_tab, const uint8_t* __restrict__ qdata,
    const int8_t* __restrict__ qbias, const uint8_t* __restrict__ tdata,
    const uint8_t* __restrict__ qdata2, const uint8_t* __restrict__ tdata2,
    int64_t qoff, int qlen, int64_t toff, int tlen, int term, int go,
    int ge, const Link& link, int& lb, int& lj, int& li, int& best,
    int& bj, int& bi, int& found, int& fj, int& fi) {
  constexpr bool kStruct = kCell == kStructCell;
  constexpr bool kProf = kCell == kProfCell;
  const int lane = threadIdx.x & 31;
  // kProf: this lane's slots in the warp's region; row r of the lane sits
  // at byte goff[r / 4] + r % 4 of its block (see the note at the top)
  int8_t* const s_lane = const_cast<int8_t*>(s_tab) + lane * R;
  constexpr int kWords = R / 4;
  int goff[kProf ? kWords : 1];
  if constexpr (kProf) {
#pragma unroll
    for (int g = 0; g < kWords; ++g)
      goff[g] = (kWords % 2 == 0) ? 4 * ((g + (lane * kWords >> 5)) % kWords)
                                  : 4 * g;
  }

  for (int strip = link.first(), i0 = strip * 32 * R; i0 < qlen;
       strip += Link::kStride, i0 += Link::kStride * 32 * R) {
    const bool first = (i0 == 0);
    const bool last = (qlen - i0 <= 32 * R);
    const auto* bin = link.in(strip);
    auto* bout = link.out(strip);
    const int r0 = i0 + lane * R;      // this lane's first row
    const int nvalid = min(max(qlen - r0, 0), R);
    int qt[kProf ? 1 : R], qt2[kStruct ? R : 1], qb[kProf ? 1 : R];
    int Hr[R], Er[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = min(r0 + r, qlen - 1);
      const int64_t qi = kReverse ? qoff + qlen - 1 - i : qoff + i;
      if constexpr (kProf) {
        const int8_t* row = reinterpret_cast<const int8_t*>(qdata) +
                            qi * kProfCols;
        int8_t* slot = s_lane + goff[r >> 2] + (r & 3);
        for (int t = 0; t < kProfCols; ++t) slot[t * 32 * R] = row[t];
      } else {
        qt[r] = qdata[qi];
        if constexpr (kStruct) qt2[r] = qdata2[qi];
        qb[r] = qbias[qi];
      }
      Hr[r] = 0;
      Er[r] = kNeg;
    }
    int sb = 0, sj = -1, si = 0;       // forward: best within this strip
    int diag_up = 0;                   // H[r0-1][j-1]
    // what this lane hands to the next after a column
    int tok_o = 0, h_o = 0, f_o = kNeg, c_o = -1, ci_o = 0;
    // lane k of a chunk holds column 32 * (s / 32) + k: its target token
    // (kStruct: both channels', t | t2 << 8) and, after the first strip,
    // the boundary lane 31 left there
    int ctok = 0, ntok = 0;
    int4 cb = make_int4(0, kNeg, -1, 0), nb = cb;
    auto load_chunk = [&](int c) {
      if (c < tlen) {
        const int64_t tj = kReverse ? toff + tlen - 1 - c : toff + c;
        ntok = tdata[tj];
        if constexpr (kStruct) ntok |= tdata2[tj] << 8;
        if (!first) {
          if constexpr (kReverse) {
            nb = bin[c];
          } else {
            const int2 b = bin[c];
            nb = make_int4(b.x, b.y, -1, 0);
          }
        }
      }
    };
    __syncwarp();                      // the previous strip's stores
    link.wait(strip, 0);
    load_chunk(lane);
    const int nsteps = tlen + 31;
    for (int s = 0; s < nsteps; ++s) {
      const int k = s & 31;
      if (k == 0) {
        ctok = ntok;
        cb = nb;
        __syncwarp();
        link.wait(strip, s + 32);
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
        const int8_t* col =
            kProf ? s_lane + tok * (32 * R)
                  : s_tab + (kStruct ? tok & 0xff : tok) * kAlphaPad;
        const int8_t* col2 =
            kStruct ? s_tab + kTable + (tok >> 8) * kAlphaPad : nullptr;
        int F = fin;
        int diag = diag_up;
        diag_up = hin;
        int cmax = cin, ci = ciin;
        int m = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          int sc;
          if constexpr (kProf) {
            sc = col[goff[r >> 2] + (r & 3)];
          } else {
            sc = static_cast<int8_t>(col[qt[r]] + qb[r]);
            if constexpr (kStruct) sc += col2[qt2[r]];
          }
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
              bout[j] = make_int4(h_o, f_o, cmax, ci);
            } else {
              bout[j] = make_int2(h_o, f_o);
            }
            link.publish(strip, j);
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
}

// The warp's lanes' (score, j, i) merged lexicographically (score, then
// smaller j, then smaller i); every lane ends with the result.
__device__ __forceinline__ void warp_merge(int& lb, int& lj, int& li) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ob = __shfl_xor_sync(kFull, lb, d);
    const int oj = __shfl_xor_sync(kFull, lj, d);
    const int oi = __shfl_xor_sync(kFull, li, d);
    if (ob > lb || (ob == lb && (oj < lj || (oj == lj && oi < li)))) {
      lb = ob; lj = oj; li = oi;
    }
  }
}

__device__ __forceinline__ void write_out(int32_t* __restrict__ out,
                                          int64_t out_stride, int best,
                                          int bj, int bi, int found, int fj,
                                          int fi) {
  out[0] = best;
  out[out_stride] = bj;
  out[2 * out_stride] = bi;
  out[3 * out_stride] = found;
  out[4 * out_stride] = fj;
  out[5 * out_stride] = fi;
}

// One pair on the calling warp, R query rows a lane; writes the pair's six
// outputs at out[. * out_stride].
template <bool kReverse, int kCell, int R>
__device__ __forceinline__ void sw_warp_pair(
    const int8_t* s_tab, const uint8_t* __restrict__ qdata,
    const int8_t* __restrict__ qbias, const uint8_t* __restrict__ tdata,
    const uint8_t* __restrict__ qdata2, const uint8_t* __restrict__ tdata2,
    int64_t qoff, int qlen, int64_t toff, int tlen, int term, int go,
    int ge, typename Boundary<kReverse>::type* __restrict__ bnd,
    int32_t* __restrict__ out, int64_t out_stride) {
  int lb = 0, lj = -1, li = 0;         // forward: this lane's best so far
  int best = 0, bj = -1, bi = 0;       // reverse: lane 31, last strip
  int found = 0, fj = -1, fi = 0;
  sw_strips<kReverse, kCell, R>(s_tab, qdata, qbias, tdata, qdata2, tdata2,
                                qoff, qlen, toff, tlen, term, go, ge,
                                InPlace<kReverse>{bnd}, lb, lj, li, best, bj,
                                bi, found, fj, fi);
  const int lane = threadIdx.x & 31;
  if constexpr (kReverse) {
    if (lane != 31) return;
  } else {
    warp_merge(lb, lj, li);
    if (lane != 0) return;
    best = lb; bj = lj; bi = li;
  }
  write_out(out, out_stride, best, bj, bi, found, fj, fi);
}

// One pair on the block's W warps (the block path), R query rows a lane:
// warp w sweeps strips w, w + W, ... behind the warp of the strip before
// (Ring); ring: the pair's two slots of tlen boundary columns; prog and
// s_best: W ints and W int3 of shared memory, prog zeroed before.  Every
// warp reaches the forward merge's barrier, with or without a strip.
// s_tab: the score table (kSeqCell) or the calling warp's profile region
// (kProfCell).
template <bool kReverse, int kCell, int R, int W>
__device__ __forceinline__ void sw_block_pair(
    const int8_t* s_tab, const uint8_t* __restrict__ qdata,
    const int8_t* __restrict__ qbias, const uint8_t* __restrict__ tdata,
    int64_t qoff, int qlen, int64_t toff, int tlen, int term, int go,
    int ge, typename Boundary<kReverse>::type* ring, int* prog,
    int3* s_best, int32_t* __restrict__ out, int64_t out_stride) {
  static_assert(kCell != kStructCell,
                "the block path serves the sequence and profile cells");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int lb = 0, lj = -1, li = 0;
  int best = 0, bj = -1, bi = 0;
  int found = 0, fj = -1, fi = 0;
  sw_strips<kReverse, kCell, R>(
      s_tab, qdata, qbias, tdata, nullptr, nullptr, qoff, qlen, toff, tlen,
      term, go, ge, Ring<kReverse, W>{ring, prog, tlen, (tlen + 31) >> 5, warp},
      lb, lj, li, best, bj, bi, found, fj, fi);
  if constexpr (kReverse) {
    // lane 31 of the warp of the last strip ran the trackers
    const int strips = (qlen + 32 * R - 1) / (32 * R);
    if (warp != (strips - 1) % W || lane != 31) return;
  } else {
    // strips interleave over the warps: the whole (score, j, i) decides
    warp_merge(lb, lj, li);
    if (lane == 0) s_best[warp] = make_int3(lb, lj, li);
    asm volatile("bar.sync 1, %0;" ::"r"(32 * W) : "memory");
    if (threadIdx.x != 0) return;
    for (int w = 1; w < W; ++w) {
      const int3 o = s_best[w];
      if (o.x > lb || (o.x == lb && (o.y < lj || (o.y == lj && o.z < li)))) {
        lb = o.x; lj = o.y; li = o.z;
      }
    }
    best = lb; bj = lj; bi = li;
  }
  write_out(out, out_stride, best, bj, bi, found, fj, fi);
}

// A job of the table: pair p on the calling warp, its targets in tdata.
// jobs rows: qoff, qlen, toff, tlen, terminate, rows (the pair's class R),
// soff (its first boundary column in `scratch`; read only when
// qlen > 32 * R).
template <bool kReverse, int kCell>
__device__ __forceinline__ void warp_job(
    const int8_t* s_warp, const uint8_t* __restrict__ qdata,
    const int8_t* __restrict__ qbias, const uint8_t* __restrict__ tdata,
    const Second& ch2, const int64_t* __restrict__ jobs, int64_t job_stride,
    int p, int go, int ge, void* __restrict__ scratch,
    int32_t* __restrict__ out, int64_t out_stride) {
  const int64_t qoff = jobs[p];
  const int qlen = static_cast<int>(jobs[job_stride + p]);
  const int64_t toff = jobs[2 * job_stride + p];
  const int tlen = static_cast<int>(jobs[3 * job_stride + p]);
  const int term = static_cast<int>(jobs[4 * job_stride + p]);
  const int rows = static_cast<int>(jobs[5 * job_stride + p]);
  auto* bnd = static_cast<typename Boundary<kReverse>::type*>(scratch) +
              (qlen > 32 * rows ? jobs[6 * job_stride + p] : 0);
  auto run = [&](auto r) {
    sw_warp_pair<kReverse, kCell, decltype(r)::value>(
        s_warp, qdata, qbias, tdata, ch2.qdata, ch2.tdata, qoff, qlen, toff,
        tlen, term, go, ge, bnd, out + p, out_stride);
  };
  // warp-uniform: the wrapper writes one of these classes
  switch (rows) {
    case 4: run(std::integral_constant<int, 4>{}); break;
    case 8: run(std::integral_constant<int, 8>{}); break;
    case 12: run(std::integral_constant<int, 12>{}); break;
    case 16: run(std::integral_constant<int, 16>{}); break;
  }
}

template <bool kReverse, int kCell>
__global__ void __launch_bounds__(32 * kWarps, kCell == kStructCell ? 3 : 4)
sw_warp_kernel(const uint8_t* __restrict__ qdata,
               const int8_t* __restrict__ qbias,
               const uint8_t* __restrict__ tdata,
               const int8_t* __restrict__ sub, int alpha, const Second ch2,
               const int64_t* __restrict__ jobs, int64_t job_stride, int n,
               int go, int ge, void* __restrict__ scratch,
               int32_t* __restrict__ out, int64_t out_stride) {
  constexpr bool kStruct = kCell == kStructCell;
  __shared__ int8_t s_tab[kCell == kProfCell ? kWarps * kProfRegion
                                             : (kStruct ? 2 : 1) * kTable];
  if constexpr (kCell != kProfCell) {
    load_table(s_tab, sub, alpha);
    if constexpr (kStruct) load_table(s_tab + kTable, ch2.sub, ch2.alpha);
    __syncthreads();
  }

  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n) return;                  // the whole warp leaves
  const int8_t* s_warp =
      kCell == kProfCell ? s_tab + (threadIdx.x >> 5) * kProfRegion : s_tab;
  warp_job<kReverse, kCell>(s_warp, qdata, qbias, tdata, ch2, jobs,
                            job_stride, p, go, ge, scratch, out, out_stride);
}

// The target-sharded stage of a card (B8), its short pairs: the sequence
// kernel over jobs from all of the card's shards, pair p's targets in
// shard jobs[7][p], whose tokens start at tbase[shard] (toff shard-local).
template <bool kReverse>
__global__ void __launch_bounds__(32 * kWarps, 4)
sw_shards_kernel(const uint8_t* __restrict__ qdata,
                 const int8_t* __restrict__ qbias,
                 const uint8_t* const* __restrict__ tbase,
                 const int8_t* __restrict__ sub, int alpha,
                 const int64_t* __restrict__ jobs, int64_t job_stride,
                 int n, int go, int ge, void* __restrict__ scratch,
                 int32_t* __restrict__ out, int64_t out_stride) {
  __shared__ int8_t s_tab[kTable];
  load_table(s_tab, sub, alpha);
  __syncthreads();
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n) return;
  warp_job<kReverse, kSeqCell>(s_tab, qdata, qbias,
                               tbase[jobs[7 * job_stride + p]], Second{},
                               jobs, job_stride, p, go, ge, scratch, out,
                               out_stride);
}

// Its long pairs (the block path): block p sweeps pair p on W warps.
// jobs rows as above; soff is the pair's ring, two slots of tlen columns.
// targets: the device array of the card's shard pointers, pair p's
// tokens at targets[jobs[7][p]] (kSeqCell), or the one target array
// (kProfCell, whose W profile regions are the dynamic shared memory).
// At most 128 registers a thread whatever W, as the warp kernels.
template <bool kReverse, int kCell, int W>
__global__ void __launch_bounds__(32 * W, 16 / W)
sw_block_kernel(const uint8_t* __restrict__ qdata,
                const int8_t* __restrict__ qbias,
                const void* __restrict__ targets,
                const int8_t* __restrict__ sub, int alpha,
                const int64_t* __restrict__ jobs, int64_t job_stride, int n,
                int go, int ge, void* scratch, int32_t* __restrict__ out,
                int64_t out_stride) {
  constexpr bool kProf = kCell == kProfCell;
  __shared__ int8_t s_tab[kProf ? 1 : kTable];
  extern __shared__ __align__(16) int8_t s_regions[];
  __shared__ int s_prog[W];
  __shared__ int3 s_best[W];
  if constexpr (!kProf) load_table(s_tab, sub, alpha);
  if (threadIdx.x < W) s_prog[threadIdx.x] = 0;
  __syncthreads();
  const int p = blockIdx.x;
  if (p >= n) return;                  // the whole block leaves
  const int64_t qoff = jobs[p];
  const int qlen = static_cast<int>(jobs[job_stride + p]);
  const int64_t toff = jobs[2 * job_stride + p];
  const int tlen = static_cast<int>(jobs[3 * job_stride + p]);
  const int term = static_cast<int>(jobs[4 * job_stride + p]);
  const int rows = static_cast<int>(jobs[5 * job_stride + p]);
  const uint8_t* tdata;
  const int8_t* s_cell;
  if constexpr (kProf) {
    tdata = static_cast<const uint8_t*>(targets);
    s_cell = s_regions + (threadIdx.x >> 5) * kProfRegion;
  } else {
    tdata = static_cast<const uint8_t* const*>(
        targets)[jobs[7 * job_stride + p]];
    s_cell = s_tab;
  }
  auto* ring = static_cast<typename Boundary<kReverse>::type*>(scratch) +
               (qlen > 32 * rows ? jobs[6 * job_stride + p] : 0);
  auto run = [&](auto r) {
    sw_block_pair<kReverse, kCell, decltype(r)::value, W>(
        s_cell, qdata, qbias, tdata, qoff, qlen, toff, tlen, term, go, ge,
        ring, s_prog, s_best, out + p, out_stride);
  };
  switch (rows) {                      // block-uniform
    case 4: run(std::integral_constant<int, 4>{}); break;
    case 8: run(std::integral_constant<int, 8>{}); break;
    case 12: run(std::integral_constant<int, 12>{}); break;
    case 16: run(std::integral_constant<int, 16>{}); break;
  }
}

template <bool kReverse, int kCell>
int launch_warp(const void* qdata, const void* qbias, const void* tdata,
                const void* sub, int alpha, const Second& ch2,
                const void* jobs, long long job_stride, int n, int go,
                int ge, void* scratch, void* out, long long out_stride,
                void* stream) {
  if (n <= 0) return 0;
  if (alpha > kAlphaPad || ch2.alpha > kAlphaPad)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kWarps - 1) / kWarps;
  sw_warp_kernel<kReverse, kCell><<<blocks, 32 * kWarps, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qdata), static_cast<const int8_t*>(qbias),
      static_cast<const uint8_t*>(tdata), static_cast<const int8_t*>(sub),
      alpha, ch2, static_cast<const int64_t*>(jobs), job_stride, n, go, ge,
      scratch, static_cast<int32_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

template <bool kReverse>
int launch_shards(const void* qdata, const void* qbias, const void* tbase,
                  const void* sub, int alpha, const void* jobs,
                  long long job_stride, int n, int go, int ge, void* scratch,
                  void* out, long long out_stride, void* stream) {
  if (n <= 0) return 0;
  if (alpha > kAlphaPad) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kWarps - 1) / kWarps;
  sw_shards_kernel<kReverse><<<blocks, 32 * kWarps, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qdata), static_cast<const int8_t*>(qbias),
      static_cast<const uint8_t* const*>(tbase),
      static_cast<const int8_t*>(sub), alpha,
      static_cast<const int64_t*>(jobs), job_stride, n, go, ge, scratch,
      static_cast<int32_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

// the block path's dynamic shared memory: kProfCell's profile regions
template <int kCell>
constexpr int block_shared() {
  return kCell == kProfCell ? kBlockWarps * kProfRegion : 0;
}

template <bool kReverse, int kCell>
int launch_block(const void* qdata, const void* qbias, const void* targets,
                 const void* sub, int alpha, const void* jobs,
                 long long job_stride, int n, int go, int ge, void* scratch,
                 void* out, long long out_stride, void* stream) {
  if (n <= 0) return 0;
  if (alpha > kAlphaPad) return static_cast<int>(cudaErrorInvalidValue);
  sw_block_kernel<kReverse, kCell, kBlockWarps>
      <<<n, 32 * kBlockWarps, block_shared<kCell>(),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(qdata),
          static_cast<const int8_t*>(qbias), targets,
          static_cast<const int8_t*>(sub), alpha,
          static_cast<const int64_t*>(jobs), job_stride, n, go, ge, scratch,
          static_cast<int32_t*>(out), out_stride);
  return static_cast<int>(cudaGetLastError());
}

Second second(const void* qaa, const void* taa, const void* aasc,
              int alpha2) {
  return Second{static_cast<const uint8_t*>(qaa),
                static_cast<const uint8_t*>(taa),
                static_cast<const int8_t*>(aasc), alpha2};
}

template <typename K>
int load_kernel(K* kernel) {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
}

// loads the block kernel of the profile cell and lets it take its
// profile regions, past the 48 KB a block gets without asking
int load_prof_block() {
  auto* kernel = sw_block_kernel<true, kProfCell, kBlockWarps>;
  int rc = load_kernel(kernel);
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        block_shared<kProfCell>()));
  return rc;
}

}  // namespace

extern "C" {

// Loads the 11 kernels onto the current device (the six warp kernels, the
// two sharded ones and the three block kernels; CUDA loads a kernel at its
// first use otherwise, inside whatever times that launch) and sets the
// profile block kernel's shared-memory limit there (an attribute of the
// device's context: the caller readies every card it launches on).
// Returns the first CUDA error, or 0.
int sw_load() {
  int rc = load_kernel(sw_warp_kernel<false, kSeqCell>);
  if (rc == 0) rc = load_kernel(sw_warp_kernel<true, kSeqCell>);
  if (rc == 0) rc = load_kernel(sw_warp_kernel<false, kStructCell>);
  if (rc == 0) rc = load_kernel(sw_warp_kernel<true, kStructCell>);
  if (rc == 0) rc = load_kernel(sw_warp_kernel<false, kProfCell>);
  if (rc == 0) rc = load_kernel(sw_warp_kernel<true, kProfCell>);
  if (rc == 0) rc = load_kernel(sw_shards_kernel<false>);
  if (rc == 0) rc = load_kernel(sw_shards_kernel<true>);
  if (rc == 0)
    rc = load_kernel(sw_block_kernel<false, kSeqCell, kBlockWarps>);
  if (rc == 0)
    rc = load_kernel(sw_block_kernel<true, kSeqCell, kBlockWarps>);
  if (rc == 0) rc = load_prof_block();
  return rc;
}

// The six warp entry points.  jobs: int64 rows (qoff, qlen, toff, tlen,
// terminate, rows, soff), row stride job_stride, n pairs from the pointer
// on; rows is the pair's class (4, 8, 12 or 16 query rows a lane); out:
// int32 rows (score, t_end, q_end, found, fj, fi), row stride out_stride,
// pair p's result at column p; scratch: int2 (forward) or int4 (reverse)
// per target column of every pair with qlen > 32 * rows, pair p's columns
// from soff[p] on.  Returns cudaGetLastError().
int sw_forward(const void* qdata, const void* qbias, const void* tdata,
               const void* sub, int alpha, const void* jobs,
               long long job_stride, int n, int go, int ge, void* scratch,
               void* out, long long out_stride, void* stream) {
  return launch_warp<false, kSeqCell>(qdata, qbias, tdata, sub, alpha,
                                      Second{}, jobs, job_stride, n, go, ge,
                                      scratch, out, out_stride, stream);
}

int sw_reverse(const void* qdata, const void* qbias, const void* tdata,
               const void* sub, int alpha, const void* jobs,
               long long job_stride, int n, int go, int ge, void* scratch,
               void* out, long long out_stride, void* stream) {
  return launch_warp<true, kSeqCell>(qdata, qbias, tdata, sub, alpha,
                                     Second{}, jobs, job_stride, n, go, ge,
                                     scratch, out, out_stride, stream);
}

// Structure mode: 3Di tokens (qss, tss) scored by m3di with the query's
// 3Di bias, amino-acid tokens (qaa, taa) by aasc (offsets index all four
// token arrays alike).
int sw_forward_struct(const void* qss, const void* qaa, const void* qbias,
                      const void* tss, const void* taa, const void* m3di,
                      int alpha, const void* aasc, int alpha2,
                      const void* jobs, long long job_stride, int n, int go,
                      int ge, void* scratch, void* out, long long out_stride,
                      void* stream) {
  return launch_warp<false, kStructCell>(qss, qbias, tss, m3di, alpha,
                                         second(qaa, taa, aasc, alpha2),
                                         jobs, job_stride, n, go, ge,
                                         scratch, out, out_stride, stream);
}

int sw_reverse_struct(const void* qss, const void* qaa, const void* qbias,
                      const void* tss, const void* taa, const void* m3di,
                      int alpha, const void* aasc, int alpha2,
                      const void* jobs, long long job_stride, int n, int go,
                      int ge, void* scratch, void* out, long long out_stride,
                      void* stream) {
  return launch_warp<true, kStructCell>(qss, qbias, tss, m3di, alpha,
                                        second(qaa, taa, aasc, alpha2),
                                        jobs, job_stride, n, go, ge,
                                        scratch, out, out_stride, stream);
}

// Profile queries: qprof holds the queries' int8 profile rows (21 columns
// a residue, row-major, query element offsets index its rows), tdata the
// target tokens (0-20).
int sw_forward_prof(const void* qprof, const void* tdata, const void* jobs,
                    long long job_stride, int n, int go, int ge,
                    void* scratch, void* out, long long out_stride,
                    void* stream) {
  return launch_warp<false, kProfCell>(qprof, nullptr, tdata, nullptr,
                                       kProfCols, Second{}, jobs, job_stride,
                                       n, go, ge, scratch, out, out_stride,
                                       stream);
}

int sw_reverse_prof(const void* qprof, const void* tdata, const void* jobs,
                    long long job_stride, int n, int go, int ge,
                    void* scratch, void* out, long long out_stride,
                    void* stream) {
  return launch_warp<true, kProfCell>(qprof, nullptr, tdata, nullptr,
                                      kProfCols, Second{}, jobs, job_stride,
                                      n, go, ge, scratch, out, out_stride,
                                      stream);
}

// The target-sharded stage of a card (B8): its short pairs on the
// sequence kernel (a warp a pair), jobs as above with an eighth row, the
// pair's shard, whose target tokens start at tbase[shard] (a device array
// of the card's shard pointers; toff shard-local).
int sw_forward_shards(const void* qdata, const void* qbias, const void* tbase,
                      const void* sub, int alpha, const void* jobs,
                      long long job_stride, int n, int go, int ge,
                      void* scratch, void* out, long long out_stride,
                      void* stream) {
  return launch_shards<false>(qdata, qbias, tbase, sub, alpha, jobs,
                              job_stride, n, go, ge, scratch, out,
                              out_stride, stream);
}

int sw_reverse_shards(const void* qdata, const void* qbias, const void* tbase,
                      const void* sub, int alpha, const void* jobs,
                      long long job_stride, int n, int go, int ge,
                      void* scratch, void* out, long long out_stride,
                      void* stream) {
  return launch_shards<true>(qdata, qbias, tbase, sub, alpha, jobs,
                             job_stride, n, go, ge, scratch, out, out_stride,
                             stream);
}

// Its long pairs: a block of kBlockWarps (16) warps a pair; soff is the
// pair's ring of two slots of tlen columns (int2 forward, int4
// reverse) when qlen > 32 * rows.
int sw_forward_shards_block(const void* qdata, const void* qbias,
                            const void* tbase, const void* sub, int alpha,
                            const void* jobs, long long job_stride, int n,
                            int go, int ge, void* scratch, void* out,
                            long long out_stride, void* stream) {
  return launch_block<false, kSeqCell>(qdata, qbias, tbase, sub, alpha,
                                       jobs, job_stride, n, go, ge, scratch,
                                       out, out_stride, stream);
}

int sw_reverse_shards_block(const void* qdata, const void* qbias,
                            const void* tbase, const void* sub, int alpha,
                            const void* jobs, long long job_stride, int n,
                            int go, int ge, void* scratch, void* out,
                            long long out_stride, void* stream) {
  return launch_block<true, kSeqCell>(qdata, qbias, tbase, sub, alpha,
                                      jobs, job_stride, n, go, ge, scratch,
                                      out, out_stride, stream);
}

// The profile reverse stage's long pairs (B10 reverse): a block of
// kBlockWarps warps a pair, each warp with its own profile region; jobs
// as sw_reverse_prof's, soff the pair's ring of two slots of tlen int4
// columns when qlen > 32 * rows.
int sw_reverse_prof_block(const void* qprof, const void* tdata,
                          const void* jobs, long long job_stride, int n,
                          int go, int ge, void* scratch, void* out,
                          long long out_stride, void* stream) {
  return launch_block<true, kProfCell>(qprof, nullptr, tdata, nullptr,
                                       kProfCols, jobs, job_stride, n, go, ge,
                                       scratch, out, out_stride, stream);
}

}  // extern "C"
