// bal_round: the two kernels of one balancing round, for Hopper.
//
// bal_scores replaces kernels/bal_round/bal_round.py::bal_scores of the JAX
// package (body _scores_kernel) together with the torch gathers that fed it
// its pre-gathered (R, D) slabs: per row r of the ELL form (neighbour ids
// ell_idx, -1 on padding, and arc weights ell_w) it reads the neighbours'
// blocks from the label table and their weights, budgets and parents from
// the K-entry block tables itself, and computes the best admissible target
// block (target fits nbw <= nlm - vw, differs from the own block, and in
// restricted mode shares the own block's parent), chosen by the 4-stage
// argmax (max conn -> lightest block -> min h32(label, salt) -> min label),
// the fallback target fb_of_block[own] for rows with no admissible
// neighbour, and the relative gain g >= 0 ? g * cv : g / cv in f32 with
// cv = max(vw, 1), -inf where the vertex must not move (rows r >= n, rows
// of blocks that are not overloaded, rows with nowhere to go).
//
// What bounds it on the H100: the rate of memory requests more than bytes.
// A row must move its ids (the padding included: a row finds its valid
// lanes by reading them), the weights of its valid lanes and its outputs;
// its neighbours' blocks are gathers from the R-entry label table (4 MB at
// R = 2^20, in L2), their weights, budgets and parents from K-entry tables
// (in L1). The TPU kernel took those gathers pre-made because a TPU kernel
// does not gather well; on Hopper they are cache hits, and pre-gathering
// them wrote and read about 1.5 GB of slabs a round at R = 2^20. At the
// finest level a row has about 8 valid lanes of 32, in one or two blocks,
// so a warp a row (the first design, after lp_gain) left three quarters of
// its lanes idle, on instructions that every row pays whatever its lanes.
// Design: one row a thread. A warp stages its 32 rows' ids of a 32-lane tile in shared
// memory by coalesced 16-byte loads (four rows an instruction: one request
// a row, where a thread loading its own row makes eight); each thread reads
// its row from there CHUNK lanes at a time, loads the weights of the
// 16-byte groups that hold a valid lane (anywhere in the row), gathers the
// valid lanes' blocks (through the read-only path) and sums the weights per
// distinct block in a table of SLOTS_T registers (int32 sums that wrap,
// exact in any order). Admission and the tie chain (max conn -> lightest
// block -> min hash -> min label) then take one step a distinct block, as
// the lanes of one block tie on all four keys; own_conn is the own block's
// sum. The own block's table entries are loaded after the row's, so that
// the first loads wait for nothing. A row with more distinct blocks than
// SLOTS_T is taken by its whole warp (warp_row): each lane holds up to four
// 32-lane tiles of the row, one step a distinct label (a shuffle names it,
// a ballot a tile drops its lanes, one redux sums its weights; a row wider
// than 128 lanes sums each label over its tiles read again from L1), the
// tie chain four redux. Ids are checked where they index a table: a lane
// id outside [0, R), a label or fallback target outside [0, K) traps, as
// an out-of-range index does in PyTorch's gathers; the checks set a flag
// that is tested once before the outputs are written, since a branch after
// each load would make every later load wait for it. The f32 gain is
// computed in the reference's op order; this file is built without
// --use_fast_math, so int-to-float conversion rounds to nearest and '/' is
// IEEE division.
//
// bal_scores_heavy: the slab's width is capped (kernels/lp_move/ops.py::
// slab_width), so a hub keeps its first D arcs in the slab and the rest in
// an overflow CSR. bal_scores' row kernel leaves the heavy rows alone
// (each CTA finds its own in the ascending row list by two warp-wide
// 32-ary searches and marks them in shared memory: no per-row flag to
// clear, so no third launch), and one launch after it scores them over
// their whole rows, in the two width classes of
// lp_move_heavy (common.cuh; the plan, kernels/heavy.py, is built with the
// ELL): a row of at most WARP_LANES = 256 lanes is one warp's, which
// loads its tiles' ids and weights at once, gathers their blocks, sums
// each distinct block's weight (common.cuh::add_tile) in its own
// shared-memory table of 2 slots a distinct block (at most min(lanes,
// K); 4 KB at most), its own block's tables loaded meanwhile, and runs the
// admission and tie chain of warp_row as four redux, with no global table
// and no __syncthreads; a longer row is cut into HUB_RANGE = 1024-lane
// ranges of the hub-lane space, one CTA each, which add their sums into
// the row's table in global scratch (2 min(lanes, K) slots: a row holds
// at most K distinct blocks, so the table has at most 2 K slots and stays
// in L2; it is sized by the lanes as well, so no K is too large for it),
// and the row's last CTA (a ticket after a fence) walks it and writes the
// row by put_row. A warp's table is sized by the row's lanes too, so it
// fits shared memory for any K. The row kernel zeroes the hub tables and
// tickets, so a heavy call stays two launches. Bound: the heavy rows'
// lanes (8 bytes each, plus a label gather), read once, and O(1)
// operations a lane.
//
// greedy_pick replaces kernels/bal_round/bal_round.py::greedy_pick (body
// _pick_kernel): the sequential greedy application of the ranked pool of M
// candidates against the K-entry block-weight table. It is M dependent
// steps, bound by their latency, not by bytes or operations: each step
// reads two block weights that the step before may have written. Design:
// one CTA. All threads load up to POOL pool entries at once and precompute
// what does not depend on the walk (clamped ids, the budgets, the gate
// v > -inf && t != b); the at most 2 POOL distinct block ids the pass
// touches are deduplicated in parallel into a shared-memory hash table
// (atomicCAS, open addressing), whose slots stage those blocks' weights;
// one thread walks the steps against shared memory, the next step's entry
// loaded before the current one's weights are used, then the staged
// weights go back into the output table, which the CTA first copied from
// the input. K has no limit (only touched entries are staged) and M none
// (passes of POOL entries in turn). accept is written as one byte a step.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int MAX_TILES = 4;   // 32-lane tiles a lane holds in registers
constexpr int SLOTS_T = 4;     // distinct blocks a thread's row may hold
constexpr int CHUNK = 16;      // lanes a thread loads at once

// The block of vertex row i. A row outside [0, R) or a label outside
// [0, K) sets `bad` (the kernel traps before it writes) and reads or
// returns entry 0 instead, so no load waits for a check.
__device__ __forceinline__ int block_of(const int* __restrict__ labels,
                                        int i, int R, int K, bool& bad) {
  const bool out = (unsigned)i >= (unsigned)R;
  const int l = __ldg(labels + (out ? 0 : i));
  const bool lout = (unsigned)l >= (unsigned)K;
  bad |= out || lout;
  return lout ? 0 : l;
}

__device__ __forceinline__ bool better(int s, int c, int h, int l, int bs,
                                       int bc, int bh, int bl) {
  if (s != bs) return s > bs;
  if (c != bc) return c < bc;
  if (h != bh) return h < bh;
  return l < bl;
}

// conn of a group of lanes held in registers (labels lj, -1 on invalid
// lanes, weights wj, valid-lane ballots vm): for each distinct label among
// the group's valid lanes, the wrapping sum of the weights of all the
// row's lanes that carry it, given to the lanes that carry it. `whole`:
// the group is the whole row; otherwise every tile of the row is read
// again from memory (L1) for each label. One step a distinct label: a
// shuffle names it, one ballot a tile drops its lanes, one redux sums it.
template <int T>
__device__ __forceinline__ void label_sums(
    const int (&lj)[T], const int (&wj)[T], const unsigned (&vm)[T],
    int (&conn)[T], bool whole, const int* __restrict__ idx_row,
    const int* __restrict__ ew_row, const int* __restrict__ labels, int D,
    int R, int K, bool& bad) {
  unsigned rem[T];
#pragma unroll
  for (int q = 0; q < T; ++q) rem[q] = vm[q];
  for (;;) {
    int src = -1, val = 0;               // the first lane left (uniform)
#pragma unroll
    for (int q = 0; q < T; ++q)
      if (src < 0 && rem[q]) {
        src = __ffs(rem[q]) - 1;
        val = lj[q];
      }
    if (src < 0) break;
    const int lab = __shfl_sync(FULL_MASK, val, src);
    unsigned sum = 0;
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const bool eq = lj[q] == lab;
      rem[q] &= ~__ballot_sync(FULL_MASK, eq);
      if (whole && eq) sum += (unsigned)wj[q];
    }
    if (!whole)
      for (int i = threadIdx.x & 31; i < D; i += 32) {
        const int ii = __ldg(idx_row + i);
        if (ii >= 0 && block_of(labels, ii, R, K, bad) == lab)
          sum += (unsigned)__ldg(ew_row + i);
      }
    const int tot = (int)__reduce_add_sync(FULL_MASK, sum);
#pragma unroll
    for (int q = 0; q < T; ++q)
      if (lj[q] == lab) conn[q] = tot;
  }
}

// What every path needs of row r's own block: its block o, vertex weight v,
// parent op (restricted), whether o is over its budget, and its fallback
// target f with f's fit (bw[f] <= lm[f] - v, f != o). own_row loads o and
// v, own_tables the rest, so that a row's other loads can start between.
struct Own {
  int o, v, op, f;
  bool over, fb_ok;
};

__device__ __forceinline__ Own own_row(int r, const int* __restrict__ labels,
                                       const int* __restrict__ vw, int R,
                                       int K, bool& bad) {
  Own w;
  w.o = block_of(labels, r, R, K, bad);
  w.v = __ldg(vw + r);
  return w;
}

template <bool RES>
__device__ __forceinline__ void own_tables(Own& w, const int* __restrict__ bw,
                                           const int* __restrict__ lm,
                                           const int* __restrict__ par,
                                           const int* __restrict__ fb, int K,
                                           bool& bad) {
  w.op = RES ? __ldg(par + w.o) : 0;
  w.over = __ldg(bw + w.o) > __ldg(lm + w.o);
  const int f = __ldg(fb + w.o);
  bad |= (unsigned)f >= (unsigned)K;
  w.f = (unsigned)f >= (unsigned)K ? 0 : f;
  w.fb_ok = __ldg(bw + w.f) <= wsub(__ldg(lm + w.f), w.v) && w.f != w.o;
}

// The outputs of row r from its best admissible target (best score smax,
// -1 if none, and its label) and its own connectivity oc.
__device__ __forceinline__ void put_row(int r, int n, const Own& w, int smax,
                                        int best, int oc,
                                        float* __restrict__ rel,
                                        int* __restrict__ tgt) {
  const bool has_adj = smax >= 0;
  const int g = has_adj ? wsub(smax, oc) : wsub(0, oc);
  const bool movable = w.over && (has_adj || w.fb_ok) && r < n;
  const float gf = (float)g;
  const float cv = fmaxf((float)w.v, 1.0f);
  const float rg = g >= 0 ? __fmul_rn(gf, cv) : __fdiv_rn(gf, cv);
  rel[r] = movable ? rg : -INFINITY;
  tgt[r] = has_adj ? best : w.f;
}

// Add weight x of label l to the row's table of distinct labels (sl, sw,
// ns of them); `full` once a label finds no free slot.
__device__ __forceinline__ void add_label(int (&sl)[SLOTS_T],
                                          int (&sw)[SLOTS_T], int& ns,
                                          bool& full, int l, int x) {
  bool hit = false;
#pragma unroll
  for (int s = 0; s < SLOTS_T; ++s)
    if (s < ns && sl[s] == l) {
      sw[s] = wadd(sw[s], x);
      hit = true;
    }
  if (hit) return;
  full |= ns == SLOTS_T;
#pragma unroll
  for (int s = 0; s < SLOTS_T; ++s)
    if (s == ns) {
      sl[s] = l;
      sw[s] = x;
    }
  ns = min(ns + 1, SLOTS_T);
}

// Row r by the whole warp: each lane holds MAX_TILES of the row's lanes at
// a time, the connectivity is label_sums over them, the tie chain four
// redux; lane 0 writes the outputs. For rows whose labels overflow a
// thread's table.
template <bool RES>
__device__ void warp_row(int r, const int* __restrict__ idx,
                         const int* __restrict__ ew,
                         const int* __restrict__ labels,
                         const int* __restrict__ vw,
                         const int* __restrict__ bw,
                         const int* __restrict__ lm,
                         const int* __restrict__ par,
                         const int* __restrict__ fb, int R, int D, int n,
                         int K, uint32_t salt, float* __restrict__ rel,
                         int* __restrict__ tgt, bool& bad) {
  constexpr int T = MAX_TILES;
  const int lane = threadIdx.x & 31;
  Own w = own_row(r, labels, vw, R, K, bad);
  own_tables<RES>(w, bw, lm, par, fb, K, bad);
  const int* ir = idx + (size_t)r * D;
  const int* wr = ew + (size_t)r * D;
  // the lane's best candidate (score, block weight, hash, label) and the
  // row's own connectivity, once a lane carrying the own label is met
  int bs = -1, bc = I32_MAX, bh = I32_MAX, bl = I32_MAX, oc = 0;
  bool found = false;
  for (int j0 = 0; j0 < D; j0 += T * 32) {
    int lj[T], wj[T], nbw[T], nlm[T], npr[T], conn[T];
    unsigned vm[T];
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int j = j0 + q * 32 + lane;
      const int id = j < D ? __ldg(ir + j) : -1;
      vm[q] = __ballot_sync(FULL_MASK, id >= 0);
      lj[q] = id >= 0 ? block_of(labels, id, R, K, bad) : -1;
      wj[q] = id >= 0 ? __ldg(wr + j) : 0;
      const bool cand = lj[q] >= 0 && lj[q] != w.o;
      nbw[q] = cand ? __ldg(bw + lj[q]) : 0;
      nlm[q] = cand ? __ldg(lm + lj[q]) : 0;
      npr[q] = RES && cand ? __ldg(par + lj[q]) : 0;
      conn[q] = 0;
    }
    label_sums<T>(lj, wj, vm, conn, D <= T * 32, ir, wr, labels, D, R, K,
                  bad);
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int l = lj[q];
      // a lane with the own label holds own_conn in its conn
      const unsigned mine = __ballot_sync(FULL_MASK, l >= 0 && l == w.o);
      if (mine && !found) {
        oc = __shfl_sync(FULL_MASK, conn[q], __ffs(mine) - 1);
        found = true;
      }
      const bool ok = l >= 0 && l != w.o && nbw[q] <= wsub(nlm[q], w.v) &&
                      (!RES || npr[q] == w.op);
      if (ok && conn[q] >= 0) {
        const int h = h32(l, salt);
        if (better(conn[q], nbw[q], h, l, bs, bc, bh, bl)) {
          bs = conn[q]; bc = nbw[q]; bh = h; bl = l;
        }
      }
    }
  }
  // the tie chain over the lanes' best candidates: max score, then the
  // lightest block, the smallest hash, the smallest label
  const int smax = __reduce_max_sync(FULL_MASK, bs);
  int best = 0;
  if (smax >= 0) {
    bool tie = bs == smax;
    const int cmin = __reduce_min_sync(FULL_MASK, tie ? bc : I32_MAX);
    tie = tie && bc == cmin;
    const int hmin = __reduce_min_sync(FULL_MASK, tie ? bh : I32_MAX);
    tie = tie && bh == hmin;
    best = __reduce_min_sync(FULL_MASK, tie ? bl : I32_MAX);
  }
  if (lane == 0) put_row(r, n, w, smax, best, oc, rel, tgt);
}

// One row a thread: the thread reads its row's ids CHUNK at a time, their
// blocks and weights, and sums the weights per distinct block in a table
// of SLOTS_T; then the admission and the tie chain take one step a
// distinct block. Rows with more distinct blocks go to warp_row, one at a
// time, by the whole warp. RES: restricted (parent tables); VEC: D is a
// multiple of 32 and the slabs are 16-byte aligned.
template <bool RES, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
bal_scores_rows(const int* __restrict__ idx, const int* __restrict__ ew,
                const int* __restrict__ labels, const int* __restrict__ vw,
                const int* __restrict__ bw, const int* __restrict__ lm,
                const int* __restrict__ par, const int* __restrict__ fb,
                int R, int D, int n, int K, uint32_t salt,
                float* __restrict__ rel, int* __restrict__ tgt,
                int* __restrict__ zero, int zero_words,
                const int* __restrict__ hrow, int H) {
  const int lane = threadIdx.x & 31;
  // the heavy-row kernel's hub tables and tickets, for the launch after
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < zero_words;
       i += gridDim.x * blockDim.x)
    zero[i] = 0;
  // the CTA's heavy rows (hrow ascending), one bit each: the heavy-row
  // kernel scores them, so they are skipped here
  __shared__ unsigned s_heavy[WARPS];
  const int first = blockIdx.x * WARPS * 32;   // the CTA's first row
  if (H) {                                 // uniform over the CTA
    if (threadIdx.x < WARPS) s_heavy[threadIdx.x] = 0u;
    __syncthreads();
    if (threadIdx.x < 32) {
      const int hi = lower_bound_warp(hrow, H, first + WARPS * 32);
      for (int i = lower_bound_warp(hrow, H, first) + lane; i < hi;
           i += 32) {
        const unsigned d = (unsigned)(__ldg(hrow + i) - first);
        if (d < WARPS * 32u) atomicOr(&s_heavy[d >> 5], 1u << (d & 31));
      }
    }
    __syncthreads();
  }
  const int r0 = first + (threadIdx.x & ~31);
  if (r0 >= R) return;                     // the whole warp is past R
  const int r = r0 + lane;
  const bool live = r < R;
  const bool hv = H && (s_heavy[threadIdx.x >> 5] >> lane & 1u);
  const int rr = live ? r : R - 1;         // a row past R repeats the last
  bool bad = false;             // an id outside its table: trap at the end
  Own w = own_row(rr, labels, vw, R, K, bad);
  const int* ir = idx + (size_t)rr * D;
  const int* wr = ew + (size_t)rr * D;
  int sl[SLOTS_T], sw[SLOTS_T], ns = 0;
  bool full = false;
#pragma unroll
  for (int s = 0; s < SLOTS_T; ++s) sl[s] = sw[s] = 0;
  // VEC: a warp's 32 rows' ids of one 32-lane tile, staged by coalesced
  // loads (four rows an instruction), one row of 36 ints a thread
  __shared__ int4 stage[WARPS][32][9];
  int4 (&mine)[32][9] = stage[threadIdx.x >> 5];
  constexpr int TILE_L = VEC ? 32 : CHUNK;   // lanes a step of the loop
  for (int j0 = 0; j0 < D; j0 += TILE_L) {
    if (VEC) {
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int row = 4 * k + (lane >> 3);
        const int* src = idx + (size_t)min(r0 + row, R - 1) * D + j0;
        mine[row][lane & 7] =
            __ldg(reinterpret_cast<const int4*>(src) + (lane & 7));
      }
      __syncwarp();
    }
    if (hv) continue;                      // staged with the warp's rows
#pragma unroll
    for (int c0 = 0; c0 < TILE_L; c0 += CHUNK) {
      const int j = j0 + c0;
      int id[CHUNK], l[CHUNK], x[CHUNK];
      if (VEC) {         // weights by 16-byte loads where one id is valid
#pragma unroll
        for (int c = 0; c < CHUNK; c += 4) {
          const int4 a = mine[lane][(c0 + c) / 4];
          id[c] = a.x; id[c + 1] = a.y; id[c + 2] = a.z; id[c + 3] = a.w;
          int4 b = make_int4(0, 0, 0, 0);
          // the AND of four ids is negative only if all four are
          if ((a.x & a.y & a.z & a.w) >= 0)
            b = __ldg(reinterpret_cast<const int4*>(wr + j + c));
          x[c] = b.x; x[c + 1] = b.y; x[c + 2] = b.z; x[c + 3] = b.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          id[c] = j + c < D ? __ldg(ir + j + c) : -1;
          x[c] = id[c] >= 0 ? __ldg(wr + j + c) : 0;
        }
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
        l[c] = id[c] >= 0 ? block_of(labels, id[c], R, K, bad) : -1;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c)
        if (l[c] >= 0) add_label(sl, sw, ns, full, l[c], x[c]);
    }
  }
  own_tables<RES>(w, bw, lm, par, fb, K, bad);
  // admission and the tie chain, one step a distinct block
  int tb[SLOTS_T], tm[SLOTS_T], tp[SLOTS_T];
#pragma unroll
  for (int s = 0; s < SLOTS_T; ++s) {
    const bool cand = s < ns && sl[s] != w.o;
    tb[s] = cand ? __ldg(bw + sl[s]) : 0;
    tm[s] = cand ? __ldg(lm + sl[s]) : 0;
    tp[s] = RES && cand ? __ldg(par + sl[s]) : 0;
  }
  int bs = -1, bc = I32_MAX, bh = I32_MAX, bl = I32_MAX, oc = 0;
#pragma unroll
  for (int s = 0; s < SLOTS_T; ++s) {
    if (s >= ns) continue;
    if (sl[s] == w.o) {
      oc = sw[s];
    } else if (tb[s] <= wsub(tm[s], w.v) && (!RES || tp[s] == w.op) &&
               sw[s] >= 0) {
      const int h = h32(sl[s], salt);
      if (better(sw[s], tb[s], h, sl[s], bs, bc, bh, bl)) {
        bs = sw[s]; bc = tb[s]; bh = h; bl = sl[s];
      }
    }
  }
  if (live && !hv && !full) put_row(r, n, w, bs, bl, oc, rel, tgt);
  // rows with more distinct blocks than a thread's table: the warp's
  unsigned wide = __ballot_sync(FULL_MASK, live && !hv && full);
  while (wide) {
    const int src = __ffs(wide) - 1;
    wide &= wide - 1;
    warp_row<RES>(r0 + src, idx, ew, labels, vw, bw, lm, par, fb, R, D, n,
                  K, salt, rel, tgt, bad);
  }
  if (bad) __trap();
}

// ---- heavy rows --------------------------------------------------------

struct HeavyArgs {
  const int *idx, *ew, *labels, *vw, *bw, *lm, *par, *fb;
  int R, D, n, K;
  uint32_t salt;
  int H;
  const int *hrow, *hptr, *oidx, *ow;
  HubPlan plan;
  int2* tab;     // hub tables: (key, conn)
  int* ticket;   // one a hub row
  float* rel;
  int* tgt;
};

// A warp's tiles of heavy row r (its slab row at `row`, its overflow arcs
// from a0): lane p = p0 + step q + this lane of tile q, none at p >= lim.
// Every tile's ids and weights are loaded before any is used, then every
// tile's blocks gathered: l[q] the block (-1: none), x[q] the weight.
__device__ __forceinline__ void heavy_tiles(const HeavyArgs& a, size_t row,
                                            int a0, int p0, int step,
                                            int lim, int (&l)[ROW_TILES],
                                            int (&x)[ROW_TILES], bool& bad) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < ROW_TILES; ++q) {
    const int p = p0 + step * q + lane;
    l[q] = -1;
    x[q] = 0;
    if (p < lim) {
      const bool slab = p < a.D;
      const size_t i = slab ? row + p : (size_t)a0 + (p - a.D);
      l[q] = __ldg((slab ? a.idx : a.oidx) + i);
      x[q] = __ldg((slab ? a.ew : a.ow) + i);
    }
  }
#pragma unroll
  for (int q = 0; q < ROW_TILES; ++q)
    l[q] = l[q] >= 0 ? block_of(a.labels, l[q], a.R, a.K, bad) : -1;
}

// A distinct block l of a heavy row with its connectivity c: the own
// block's c is own_conn; another block is a candidate if it fits (and
// shares the own block's parent when restricted).
template <bool RES>
__device__ __forceinline__ void heavy_candidate(const HeavyArgs& a, int l,
                                                int c, const Own& w, int& bs,
                                                int& bc, int& bh, int& bl,
                                                int& oc, bool& seen) {
  if (l == w.o) {
    oc = c;
    seen = true;
    return;
  }
  const int nb = __ldg(a.bw + l);
  const bool ok = nb <= wsub(__ldg(a.lm + l), w.v) &&
                  (!RES || __ldg(a.par + l) == w.op);
  if (ok && c >= 0) {
    const int hh = h32(l, a.salt);
    if (better(c, nb, hh, l, bs, bc, bh, bl)) {
      bs = c; bc = nb; bh = hh; bl = l;
    }
  }
}

// Warp-class row h by one warp, in its table `s` (2 WARP_SLOTS ints of
// shared memory, slots for its distinct blocks, at most min(L, K)): a
// 32-lane tile at a time, the lanes of one block summed by
// __match_any_sync and one redux, the group's first lane adding the sum
// into the block's slot; then the slots, one a lane, and the tie chain
// as four redux. Writes the row by put_row.
template <bool RES>
__device__ void heavy_warp_row(const HeavyArgs& a, int h, int* s) {
  const int lane = threadIdx.x & 31;
  const int r = a.hrow[h];
  if (r < 0 || r >= a.R) __trap();
  const int a0 = a.hptr[h], L = a.D + (a.hptr[h + 1] - a0);
  if (L > WARP_LANES) return;              // a hub row: the hub CTAs'
  const int T = warp_slots(min(L, a.K));
  int* key = s;
  int* conn = key + T;
  for (int i = lane; i < T; i += 32) {
    key[i] = 0;
    conn[i] = 0;
  }
  __syncwarp();
  bool bad = false;
  Own w = own_row(r, a.labels, a.vw, a.R, a.K, bad);   // loads in flight
  own_tables<RES>(w, a.bw, a.lm, a.par, a.fb, a.K, bad);   // beside the row's
  int l[ROW_TILES], x[ROW_TILES];
  heavy_tiles(a, (size_t)r * a.D, a0, 0, 32, L, l, x, bad);
  auto insert = [&](int lab, int sum, int, int) {
    atomicAdd(conn + claim_pow2(key, T - 1, lab), sum);
  };
#pragma unroll
  for (int q = 0; q < ROW_TILES; ++q) {
    if (32 * q >= L) break;
    add_tile(l[q], x[q], 0, 0, insert);
  }
  __syncwarp();
  int bs = -1, bc = I32_MAX, bh = I32_MAX, bl = I32_MAX, oc = 0;
  bool seen = false;
  for (int i = lane; i < T; i += 32)
    if (key[i])
      heavy_candidate<RES>(a, key[i] - 1, conn[i], w, bs, bc, bh, bl, oc,
                           seen);
  int smax, cmin, best;
  warp_best(bs, bc, bh, bl, smax, cmin, best);
  const unsigned sn = __ballot_sync(FULL_MASK, seen);
  oc = sn ? __shfl_sync(FULL_MASK, oc, __ffs(sn) - 1) : 0;
  if (__any_sync(FULL_MASK, bad)) __trap();
  if (lane == 0) put_row(r, a.n, w, smax, smax >= 0 ? best : 0, oc, a.rel,
                         a.tgt);
}

constexpr int WALK = 16;   // table slots a thread loads at once

// Hub range c by one CTA: for each hub row the range crosses, its lanes
// there summed per block as a warp-class row sums them, into the row's
// table of 2 min(L, K) slots at 2 off; the row's last CTA walks that
// table and runs the tie chain over the CTA.
template <bool RES>
__device__ void heavy_hub_range(const HeavyArgs& a, int c, int* sh,
                                int* s_flag, int* s_oc) {
  const int warp = threadIdx.x >> 5;
  const HubPlan& P = a.plan;
  const int x0 = c * HUB_RANGE;
  const int x1 = min(x0 + HUB_RANGE, P.hubs[2 * P.n_hub + 1]);
  bool bad = false;
  for (int k = P.ranges[c]; k < P.n_hub; ++k) {   // uniform over the CTA
    const int off = P.hubs[2 * k + 1], end = P.hubs[2 * k + 3];
    if (off >= x1) break;
    const int h = P.hubs[2 * k], r = a.hrow[h];
    if (r < 0 || r >= a.R) __trap();
    const int a0 = a.hptr[h], L = end - off, T = 2 * min(L, a.K);
    if (L != a.D + (a.hptr[h + 1] - a0)) __trap();   // not this plan's
    int2* t = a.tab + 2 * (size_t)off;
    int* tk = reinterpret_cast<int*>(t);
    const int p0 = max(x0, off) - off + warp * 32, p1 = min(x1, end) - off;
    int l[ROW_TILES], x[ROW_TILES];   // a warp's tiles: at most 8 a range
    heavy_tiles(a, (size_t)r * a.D, a0, p0, HEAVY, p1, l, x, bad);
    auto insert = [&](int lab, int sum, int, int) {
      atomicAdd(tk + 2 * claim_slot(tk, T, lab, 2) + 1, sum);
    };
#pragma unroll
    for (int q = 0; q < ROW_TILES; ++q) {
      if (p0 + HEAVY * q >= p1) break;
      add_tile(l[q], x[q], 0, 0, insert);
    }
    if (!last_of_row(a.ticket, k, hub_ctas(off, end), s_flag)) continue;
    Own w = own_row(r, a.labels, a.vw, a.R, a.K, bad);
    own_tables<RES>(w, a.bw, a.lm, a.par, a.fb, a.K, bad);
    if (threadIdx.x == 0) *s_oc = 0;
    __syncthreads();
    int bs = -1, bc = I32_MAX, bh = I32_MAX, bl = I32_MAX, oc = 0;
    bool seen = false;
    for (int i0 = threadIdx.x; i0 < T; i0 += WALK * HEAVY) {
      int2 e[WALK];
#pragma unroll
      for (int q = 0; q < WALK; ++q) {
        const int i = i0 + q * HEAVY;
        e[q] = i < T ? __ldcg(t + i) : make_int2(0, 0);
      }
#pragma unroll
      for (int q = 0; q < WALK; ++q)
        if (e[q].x)
          heavy_candidate<RES>(a, e[q].x - 1, e[q].y, w, bs, bc, bh, bl, oc,
                               seen);
    }
    if (seen) *s_oc = oc;                 // one slot holds the own block
    int smax, cmin, best;
    cta_best(bs, bc, bh, bl, smax, cmin, best, sh);
    if (threadIdx.x == 0)
      put_row(r, a.n, w, smax, smax >= 0 ? best : 0, *s_oc, a.rel, a.tgt);
    __syncthreads();
  }
  if (__syncthreads_or(bad)) __trap();
}

// The heavy rows, after bal_scores_rows (which scored them on their slab
// lanes and cleared the hub tables and tickets): CTAs 0 .. G - 1 the hub
// ranges, then one warp a heavy row (hub rows' warps leave at once); each
// heavy row's outputs overwritten.
template <bool RES>
__global__ void __launch_bounds__(HEAVY)
bal_scores_heavy_rows(const __grid_constant__ HeavyArgs a) {
  __shared__ int s_tab[HEAVY_WARPS][2 * WARP_SLOTS];
  __shared__ int sh[33];
  __shared__ int s_flag, s_oc;
  if ((int)blockIdx.x < a.plan.G) {
    heavy_hub_range<RES>(a, blockIdx.x, sh, &s_flag, &s_oc);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int h = ((int)blockIdx.x - a.plan.G) * HEAVY_WARPS + warp;
  if (h < a.H) heavy_warp_row<RES>(a, h, s_tab[warp]);
}

// ---- greedy_pick ---------------------------------------------------------

constexpr int POOL = 512;          // pool entries a pass stages (threads)
constexpr int LOG_SLOTS = 11;
constexpr int SLOTS = 1 << LOG_SLOTS;   // >= 4 POOL: load factor <= 1/2
constexpr int EMPTY = -1;
constexpr int GATE = 1, T_IN = 2, B_IN = 4;

// One pool entry, as far as it does not depend on the walk: the hash slots
// of its clamped target and source blocks, its weight, the target's
// budget less the weight, the source's budget, and flags (GATE: v > -inf
// and t != b; T_IN / B_IN: the id lies in [0, K), so the step writes it).
struct __align__(16) Step {
  int ts, bs, c, lmt, lmb, flags, pad[2];
};

__device__ __forceinline__ int clampk(int x, int K) {
  return x < 0 ? 0 : (x >= K ? K - 1 : x);
}

// The slot of block id k >= 0 in the table, inserted if new.
__device__ __forceinline__ int slot_of(int* key, int k) {
  unsigned h = ((unsigned)k * 2654435761u) >> (32 - LOG_SLOTS);
  for (;;) {
    const int prev = atomicCAS(key + h, EMPTY, k);
    if (prev == EMPTY || prev == k) return (int)h;
    h = (h + 1) & (SLOTS - 1);
  }
}

__global__ void __launch_bounds__(POOL)
greedy_pick_kernel(const float* __restrict__ vals,
                   const int* __restrict__ tgt_blk,
                   const int* __restrict__ src_blk,
                   const int* __restrict__ cand_w,
                   const int* __restrict__ bw_in, const int* __restrict__ lm,
                   int M, int K, bool* __restrict__ accept,
                   int* __restrict__ bw) {
  __shared__ int key[SLOTS];
  __shared__ int wt[SLOTS];
  __shared__ Step step[POOL];
  const int tid = threadIdx.x;
#pragma unroll 8
  for (int i = tid; i < K; i += POOL) bw[i] = bw_in[i];
  for (int base = 0; base < M; base += POOL) {
    const int m = min(POOL, M - base);
    for (int s = tid; s < SLOTS; s += POOL) key[s] = EMPTY;
    // orders the copy (or the last pass's write-back) before the reads
    __syncthreads();
    if (tid < m) {
      const int i = base + tid;
      const int t = tgt_blk[i], b = src_blk[i], c = cand_w[i];
      const float v = vals[i];
      const int tc = clampk(t, K), bc = clampk(b, K);
      Step e;
      e.ts = slot_of(key, tc);
      e.bs = slot_of(key, bc);
      e.c = c;
      e.lmt = wsub(__ldg(lm + tc), c);
      e.lmb = __ldg(lm + bc);
      e.flags = (v > -INFINITY && t != b ? GATE : 0) |
                (t >= 0 && t < K ? T_IN : 0) | (b >= 0 && b < K ? B_IN : 0);
      step[tid] = e;
    }
    __syncthreads();
    for (int s = tid; s < SLOTS; s += POOL)
      if (key[s] != EMPTY) wt[s] = bw[key[s]];
    __syncthreads();
    if (tid == 0) {
      Step next = step[0];
      for (int i = 0; i < m; ++i) {
        const Step e = next;
        if (i + 1 < m) next = step[i + 1];
        const int wb = wt[e.bs], wtt = wt[e.ts];
        const bool ok = (e.flags & GATE) && wb > e.lmb && wtt <= e.lmt;
        if (ok) {
          // t != b: if both lie in [0, K) their slots differ
          if (e.flags & B_IN) wt[e.bs] = wsub(wb, e.c);
          if (e.flags & T_IN) wt[e.ts] = wadd(wtt, e.c);
        }
        accept[base + i] = ok;
      }
    }
    __syncthreads();
    for (int s = tid; s < SLOTS; s += POOL)
      if (key[s] != EMPTY) bw[key[s]] = wt[s];
  }
}

// greedy_pick's bound: one thread follows a ring of CHASE indices in
// shared memory, each load's address the value of the one before, and
// reports the clock64 cycles of `steps` loads.
constexpr int CHASE = 1024;

__global__ void smem_chase(int steps, long long* out) {
  __shared__ int ring[CHASE];
  for (int i = threadIdx.x; i < CHASE; i += blockDim.x)
    ring[i] = (i + 97) % CHASE;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int j = 0;
  const long long t0 = clock64();
#pragma unroll 16
  for (int s = 0; s < steps; ++s) j = ring[j];
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = j;                      // keeps the chase live
}

}  // namespace

// ell_idx / ell_w (R, D) row-major, labels / vw R entries, the block
// tables bw / lm / fb (and par, or nullptr for the unrestricted form) K
// entries. Rows r >= n are not movable. R, D, K >= 1. The kernel also
// zeroes zero_words ints at `zero` (bal_scores_heavy's scratch; 0: none)
// and leaves the H heavy rows hrow (ascending; 0: none) unscored, for
// bal_scores_heavy to score.
extern "C" int bal_scores(const int* ell_idx, const int* ell_w,
                          const int* labels, const int* vw, const int* bw,
                          const int* lm, const int* par, const int* fb,
                          int R, int D, int n, int K, uint32_t salt,
                          float* rel, int* tgt, int* zero, int zero_words,
                          const int* hrow, int H, void* stream) {
  if (R < 1 || D < 1 || K < 1 || zero_words < 0 || (zero_words && !zero) ||
      H < 0 || (H && !hrow))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((R + WARPS * 32 - 1) / (WARPS * 32));
  const bool vec = D % 32 == 0 && (uintptr_t)ell_idx % 16 == 0 &&
                   (uintptr_t)ell_w % 16 == 0;
  auto kernel = par ? (vec ? bal_scores_rows<true, true>
                           : bal_scores_rows<true, false>)
                    : (vec ? bal_scores_rows<false, true>
                           : bal_scores_rows<false, false>);
  kernel<<<grid, WARPS * 32, 0, s>>>(ell_idx, ell_w, labels, vw, bw, lm, par,
                                     fb, R, D, n, K, salt, rel, tgt, zero,
                                     zero_words, hrow, H);
  return (int)cudaGetLastError();
}

// After bal_scores on the same operands, which zeroed `scratch` (4
// HUB_RANGE G + n_hub ints: the hub rows' tables, 2 HUB_RANGE slots of 2
// ints a hub range, then their tickets, one a hub row): rescore the H >= 1
// heavy rows hrow (distinct, ascending, in [0, R); each of more than D
// lanes, its first D in the slab) over their whole rows, their further
// arcs at hptr[h] .. hptr[h + 1] of oidx / ow (M in all), their hub plan
// hubs ((n_hub + 1) x 2) / ranges (G) as kernels/heavy.py::heavy_plan
// builds it.
extern "C" int bal_scores_heavy(const int* ell_idx, const int* ell_w,
                                const int* labels, const int* vw,
                                const int* bw, const int* lm, const int* par,
                                const int* fb, int R, int D, int n, int K,
                                uint32_t salt, int H, const int* hrow,
                                const int* hptr, const int* hubs, int n_hub,
                                const int* ranges, int G, const int* oidx,
                                const int* ow, int M, int* scratch,
                                float* rel, int* tgt, void* stream) {
  if (R < 1 || D < 1 || K < 1 || H < 1 || M < 0 || n_hub < 0 || G < 0 ||
      n_hub > H || !hrow || !hptr || !hubs || (G && (!ranges || !scratch)) ||
      (M && (!oidx || !ow)) ||
      2 * ((int64_t)H * D + M) >= ((int64_t)1 << 31) ||
      (int64_t)G * HUB_RANGE >= ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  int2* tab = reinterpret_cast<int2*>(scratch);
  const HeavyArgs a{ell_idx, ell_w, labels, vw, bw, lm, par, fb, R, D, n, K,
                    salt, H, hrow, hptr, oidx, ow,
                    HubPlan{hubs, n_hub, ranges, G}, tab,
                    scratch ? scratch + 4 * (size_t)HUB_RANGE * G : nullptr,
                    rel, tgt};
  const unsigned grid = (unsigned)G +
                        (unsigned)((H + HEAVY_WARPS - 1) / HEAVY_WARPS);
  auto kernel = par ? bal_scores_heavy_rows<true>
                    : bal_scores_heavy_rows<false>;
  kernel<<<grid, HEAVY, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int greedy_pick(const float* vals, const int* tgt_blk,
                           const int* src_blk, const int* cand_w,
                           const int* bw, const int* lm, int M, int K,
                           bool* accept, int* bw_out, void* stream) {
  if (K < 1 || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  greedy_pick_kernel<<<1, POOL, 0, s>>>(vals, tgt_blk, src_blk, cand_w, bw,
                                        lm, M, K, accept, bw_out);
  return (int)cudaGetLastError();
}

// Cycles of `steps` dependent shared-memory loads, written to out[0]
// (out: two int64 on the device).
extern "C" int smem_chase_cycles(int steps, long long* out, void* stream) {
  smem_chase<<<1, 256, 0, (cudaStream_t)stream>>>(steps, out);
  return (int)cudaGetLastError();
}
