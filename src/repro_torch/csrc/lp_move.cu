// lp_move: one LP-clustering chunk step over an ELL slab, for Hopper.
//
// Replaces the TPU kernel kernels/lp_move/lp_move.py::lp_move_chunk of the
// JAX package (body _kernel) and computes what it computes: per row the
// label-equality connectivity, admission (host form ncw + vw <= W or the
// distributed form ncw <= nbud - vw), the 4-stage argmax (max conn ->
// lightest cluster -> min h32(label, salt) -> min label); per chunk the
// cluster-weight update and the hash-ordered revert of over-budget movers,
// ranked by (h32(v0 + row, salt ^ 0x9E3779B9), row).
//
// What bounds it on the H100: the bytes are few (phase A reads the (R, D)
// slabs once: the label slab whole, a warp reading a row's 32 lanes at
// once, and the weight slabs only where a lane is valid; phase B touches
// O(R) words plus the candidates of the revert, rows with pmove && newcw >
// W), so at the partitioner's sizes the limit is phase A's instruction
// issue, some 150 warp instructions a row whatever its degree, and the
// fixed cost of phase B's dependent launches.
//
// Design. Phase A is one warp per row, four rows per warp whose first 32
// lanes are loaded before any is worked on: a 32-lane tile of (label,
// weight) is broadcast by warp shuffles, walking only the set bits of the
// tile's valid-lane ballot (valid lanes need not be a prefix); the
// four-way tie chain is four single-instruction warp reductions
// (__reduce_max/min_sync), one key after the other; movers add their
// weight to the label-indexed d_in / d_out tables with int32 atomics. The
// shuffle walk costs two shuffles per valid lane and runs faster on the
// H100 than one __match_any_sync plus a masked __reduce_add_sync. The TPU
// kernel's R x R pairwise masks become the composed order of core/lp.py:
//   1. candidates: each 1024-row CTA flags its candidates, a CTA scan plus
//      a decoupled look-back over the CTAs compacts them, in row order,
//      into a (key, row) list, key = (target << 31) | rank; their count
//      stays on the device, and the digit histograms of every radix pass
//      are taken here;
//   2. a stable LSD radix sort of that list, 8-bit digits, as many passes
//      as the key has bytes (31 + bit_length(num_labels - 1) bits: at most
//      8); a pass ranks a 1024-key tile with warp match masks and places
//      it after the keys of smaller digits and the equal digits of earlier
//      tiles. Since the compaction keeps row order and the sort is stable,
//      equal (target, rank) keys stay in row order, the order of the plain
//      version and of the JAX composed path;
//   3. a segmented scan of vw by target over the sorted list, carried from
//      tile to tile, and the revert.
// Steps 2 and 3 are one launch of one CTA that walks the list tile after
// tile: there is no cut-over and no cooperative grid, because the
// candidates are few. The 2^20 main path's 120 calls have none at all
// (chip_smoke.py phase 4 prints each call's count), so the CTA returns at
// once. A chunk that has them pays 2-4 us on an H100 per 1024 of them
// and per pass (chip_smoke.py phase 2: 70,001 candidates, 6 passes, 1.49
// ms a call); spreading the passes over many CTAs would cut that, should
// such chunks turn up. Every kernel reads the count from the
// device, so a call is 4 launches (one of them the memset that clears the
// tables), whatever R, num_labels and the candidate count.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;        // phase A: warps per CTA
constexpr int ROWS = 4;         // phase A: rows per warp

// int counters at the head of the zeroed scratch: the candidate count and
// the candidates kernel's tile ticket
enum { C_COUNT = 0, C_TICKET = 1, N_COUNTERS = 2 };

// Lexicographic "better" of the argmax tie chain: higher score, then
// lighter cluster, then smaller hash, then smaller label.
__device__ __forceinline__ bool better(int s, int c, int h, int l, int bs,
                                       int bc, int bh, int bl) {
  if (s != bs) return s > bs;
  if (c != bc) return c < bc;
  if (h != bh) return h < bh;
  return l < bl;
}

__device__ __forceinline__ void check_label(int x, int num_labels) {
  if (x < 0 || x >= num_labels) __trap();
}

// One row of phase A for one warp. (l0, w0, c0, b0) are this lane's
// label, weight, cluster weight and budget in the row's first 32 lanes,
// loaded by the caller; wider rows load their further tiles here.
__device__ __forceinline__ void move_row(
    const int* __restrict__ nlab, const int* __restrict__ nw,
    const int* __restrict__ ncw, const int* __restrict__ nbud, int r, int D,
    int W, uint32_t salt, int num_labels, int l0, int w0, int c0, int b0,
    int o, int v, int* __restrict__ tgt, int* __restrict__ pmove,
    int* __restrict__ light, int* __restrict__ din, int* __restrict__ dout) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)r * D;
  int bs = -1, bc = I32_MAX, bh = I32_MAX, bl = I32_MAX;
  int own_conn = 0;
  bool own_seen = false;
  for (int j0 = 0; j0 < D; j0 += 32) {
    int lj = l0, wj = w0, cj = c0, bj = b0;
    if (j0 > 0) {
      const int j = j0 + lane;
      lj = j < D ? nlab[row + j] : -1;
      wj = lj >= 0 ? nw[row + j] : 0;
      cj = lj >= 0 ? ncw[row + j] : 0;
      bj = lj >= 0 && nbud ? nbud[row + j] : 0;
    }
    const unsigned jmask = __ballot_sync(FULL_MASK, lj >= 0);
    if (jmask == 0) continue;
    int conn = 0;
    for (int i0 = 0; i0 < D; i0 += 32) {
      int li = lj, wi = wj;
      unsigned imask = jmask;
      if (i0 != j0) {
        const int i = i0 + lane;
        li = i0 == 0 ? l0 : (i < D ? nlab[row + i] : -1);
        wi = i0 == 0 ? w0 : (li >= 0 ? nw[row + i] : 0);
        imask = __ballot_sync(FULL_MASK, li >= 0);
      }
      while (imask) {  // warp-uniform: only the valid source lanes
        const int s = __ffs(imask) - 1;
        imask &= imask - 1;
        const int ls = __shfl_sync(FULL_MASK, li, s);
        const int ws = __shfl_sync(FULL_MASK, wi, s);
        if (ls == lj) conn = wadd(conn, ws);
      }
    }
    if (lj >= 0) {
      const bool stay = lj == o;
      const bool fits = nbud ? (cj <= wsub(bj, v)) : (wadd(cj, v) <= W);
      const int score = (fits || stay) ? conn : -1;
      const int hj = h32(lj, salt);
      if (better(score, cj, hj, lj, bs, bc, bh, bl)) {
        bs = score; bc = cj; bh = hj; bl = lj;
      }
      if (stay) {  // conn of a lane of label o sums all of o's lanes
        own_conn = conn;
        own_seen = true;
      }
    }
  }
  // the tie chain over the warp, one key at a time
  const int s_best = __reduce_max_sync(FULL_MASK, bs);
  bool is_best = bs == s_best;
  const int c_best = __reduce_min_sync(FULL_MASK, is_best ? bc : I32_MAX);
  is_best = is_best && bc == c_best;
  const int h_best = __reduce_min_sync(FULL_MASK, is_best ? bh : I32_MAX);
  is_best = is_best && bh == h_best;
  const int l_best = __reduce_min_sync(FULL_MASK, is_best ? bl : I32_MAX);
  const unsigned seen = __ballot_sync(FULL_MASK, own_seen);
  own_conn = seen ? __shfl_sync(FULL_MASK, own_conn, __ffs(seen) - 1) : 0;
  if (lane == 0) {
    const bool mv = s_best > own_conn && l_best != o && l_best < I32_MAX &&
                    s_best > 0;
    tgt[r] = mv ? l_best : o;
    pmove[r] = mv ? 1 : 0;
    light[r] = c_best;
    if (mv) {
      check_label(l_best, num_labels);
      check_label(o, num_labels);
      atomicAdd(&din[l_best], v);
      atomicAdd(&dout[o], v);
    }
  }
}

// Phase A: one warp per row, ROWS rows per warp, whose first 32 lanes are
// all loaded before the first row is worked on.
__global__ void __launch_bounds__(WARPS * 32)
lp_move_rows(const int* __restrict__ nlab, const int* __restrict__ nw,
             const int* __restrict__ ncw, const int* __restrict__ nbud,
             const int* __restrict__ own, const int* __restrict__ vw, int R,
             int D, int W, uint32_t salt, int num_labels,
             int* __restrict__ tgt, int* __restrict__ pmove,
             int* __restrict__ light, int* __restrict__ din,
             int* __restrict__ dout) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS;
  if (r0 >= R) return;  // whole warp leaves together
  int l[ROWS], w[ROWS], c[ROWS], b[ROWS], o[ROWS], v[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const bool in = r0 + k < R;
    l[k] = in && lane < D ? nlab[(size_t)(r0 + k) * D + lane] : -1;
    o[k] = in ? own[r0 + k] : 0;
    v[k] = in ? vw[r0 + k] : 0;
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const size_t at = (size_t)(r0 + k) * D + lane;
    w[k] = l[k] >= 0 ? nw[at] : 0;
    c[k] = l[k] >= 0 ? ncw[at] : 0;
    b[k] = l[k] >= 0 && nbud ? nbud[at] : 0;
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    if (r0 + k < R)
      move_row(nlab, nw, ncw, nbud, r0 + k, D, W, salt, num_labels, l[k],
               w[k], c[k], b[k], o[k], v[k], tgt, pmove, light, din, dout);
}

// ---- phase B -----------------------------------------------------------


// newcw, moved, movedin per row; the candidates compacted in row order
// into (ckey, crow), their count into ctr[C_COUNT], every pass's digit
// histogram into hist.
__global__ void __launch_bounds__(TILE)
lp_move_candidates(const int* tgt, const int* pmove, const int* light,
                   const int* vw, const int* din, const int* dout, int R,
                   int W, int v0, uint32_t salt2, int passes, int* newcw,
                   int* movedin, int* moved, uint64_t* ckey, int* crow,
                   int* ctr, int* hist, uint64_t* cstat) {
  __shared__ int s_tile, s_excl;
  __shared__ int sf[32], sv[32];
  __shared__ int s_hist[MAX_PASSES * RADIX];
  if (threadIdx.x == 0) s_tile = atomicAdd(&ctr[C_TICKET], 1);
  for (int i = threadIdx.x; i < passes * RADIX; i += TILE) s_hist[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int r = tile * TILE + threadIdx.x;
  bool cand = false;
  uint64_t k = 0;
  if (r < R) {
    const int pm = pmove[r], t = tgt[r], lt = light[r], v = vw[r];
    moved[r] = pm;
    if (pm) {
      const int nc = wsub(wadd(lt, din[t]), dout[t]);
      newcw[r] = nc;
      if (nc > W) {
        cand = true;
        atomicAdd(&movedin[t], v);
        k = ((uint64_t)(uint32_t)t << 31) |
            (uint64_t)h32(wadd(v0, r), salt2);
        for (int p = 0; p < passes; ++p)
          atomicAdd(&s_hist[p * RADIX + digit(k, p)], 1);
      }
    }
  }
  bool f = false;
  int c = cand ? 1 : 0;
  cta_seg_scan(f, c, sf, sv);  // c: candidates up to and including r
  if (threadIdx.x == 0) {
    const int agg = sv[31];
    s_excl = lookback_sum(cstat, tile, agg);
    if (tile == (int)gridDim.x - 1) ctr[C_COUNT] = s_excl + agg;
  }
  __syncthreads();
  if (cand) {
    ckey[s_excl + c - 1] = k;
    crow[s_excl + c - 1] = r;
  }
  for (int i = threadIdx.x; i < passes * RADIX; i += TILE)
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
}

// The sort of the candidates, the cumulative moved-in weight of each
// within its target in sorted order, and the revert: one CTA, which walks
// the list in TILE-key tiles. A pass ranks each tile in shared memory and
// places it after the keys of smaller digits (hist) and the equal digits
// of earlier tiles (base[d] grows tile by tile): (k0, r0) -> (k1, r1) and
// back. The scan carries (head seen, sum) from tile to tile.
__global__ void __launch_bounds__(TILE)
lp_move_sort_revert(uint64_t* k0, int* r0, uint64_t* k1, int* r1,
                    int passes, const int* hist, const int* vw,
                    const int* newcw, const int* movedin, int W,
                    const int* ctr, int* moved) {
  __shared__ unsigned short wh[32 * RADIX];
  __shared__ int cnt[RADIX], base[RADIX];
  __shared__ int s_w[RADIX / 32], sf[32], sv[32];
  const int count = ctr[C_COUNT];
  if (count == 0) return;  // the usual case: no pass need wait on hist
  for (int pass = 0; pass < passes; ++pass) {
    const uint64_t* kin = pass & 1 ? k1 : k0;
    const int* rin = pass & 1 ? r1 : r0;
    uint64_t* kout = pass & 1 ? k0 : k1;
    int* rout = pass & 1 ? r0 : r1;
    const int h = threadIdx.x < RADIX ? hist[pass * RADIX + threadIdx.x] : 0;
    const int b = excl_scan_256(h, s_w);  // keys of smaller digits
    if (threadIdx.x < RADIX) base[threadIdx.x] = b;
    for (int t0 = 0; t0 < count; t0 += TILE) {
      const int p = t0 + threadIdx.x;
      const bool valid = p < count;
      const uint64_t k = valid ? kin[p] : 0;
      const int row = valid ? rin[p] : 0;
      const int d = valid ? digit(k, pass) : -1;
      const int rank = rank_in_tile(d, wh, cnt);
      if (valid) {
        kout[base[d] + rank] = k;
        rout[base[d] + rank] = row;
      }
      __syncthreads();
      if (threadIdx.x < RADIX) base[threadIdx.x] += cnt[threadIdx.x];
    }
    __syncthreads();  // this pass's stores before the next pass's loads
  }
  const uint64_t* ks = passes & 1 ? k1 : k0;
  const int* rs = passes & 1 ? r1 : r0;
  int carry = 0;
  for (int t0 = 0; t0 < count; t0 += TILE) {
    const int p = t0 + threadIdx.x;
    const bool valid = p < count;
    const uint64_t k = valid ? ks[p] : 0;
    const int row = valid ? rs[p] : 0;
    bool f = valid && (p == 0 || (ks[p - 1] >> 31) != (k >> 31));
    int within = valid ? vw[row] : 0;
    cta_seg_scan(f, within, sf, sv);
    if (!f) within = wadd(within, carry);
    if (valid) {
      int allowed = wsub(W, wsub(newcw[row], movedin[(int)(k >> 31)]));
      allowed = allowed > 0 ? allowed : 0;
      if (within > allowed) moved[row] = 0;
    }
    carry = sf[31] ? sv[31] : wadd(carry, sv[31]);
    __syncthreads();  // sf / sv are the next tile's
  }
}

// Scratch layout, 256-byte aligned pieces. Everything from din on is
// cleared by one memset per call.
struct Scratch {
  int *pmove, *light, *newcw;
  uint64_t* key[2];
  int* row[2];
  int *din, *dout, *movedin, *ctr, *hist;
  uint64_t* cstat;
  char* zero;
  size_t zero_bytes;
};

size_t carve(char* base, int R, int num_labels, Scratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~(size_t)255;
    return p;
  };
  const size_t r = (size_t)R, nl = (size_t)num_labels;
  const size_t tiles = (r + TILE - 1) / TILE;
  s->pmove = (int*)take(4 * r);
  s->light = (int*)take(4 * r);
  s->newcw = (int*)take(4 * r);
  for (int i = 0; i < 2; ++i) {
    s->key[i] = (uint64_t*)take(8 * r);
    s->row[i] = (int*)take(4 * r);
  }
  const size_t zero_from = off;
  s->din = (int*)take(4 * nl);
  s->dout = (int*)take(4 * nl);
  s->movedin = (int*)take(4 * nl);
  s->ctr = (int*)take(4 * N_COUNTERS);
  s->hist = (int*)take(4 * MAX_PASSES * RADIX);
  s->cstat = (uint64_t*)take(8 * tiles);
  s->zero = base ? base + zero_from : nullptr;
  s->zero_bytes = off - zero_from;
  return off;
}

// Radix passes over the key (target << 31) | rank.
int key_passes(int num_labels) {
  const unsigned top = (unsigned)(num_labels - 1);
  const int bits = 31 + (top ? 32 - __builtin_clz(top) : 0);
  return (bits + 7) / 8;
}

}  // namespace

// Bytes of scratch lp_move_chunk needs for R rows and num_labels labels.
extern "C" int lp_move_scratch_bytes(int R, int num_labels, int64_t* bytes) {
  if (R < 1 || num_labels < 1) return (int)cudaErrorInvalidValue;
  Scratch s;
  *bytes = (int64_t)carve(nullptr, R, num_labels, &s);
  return 0;
}

// nbud == nullptr selects the host admission form (fit_sum). Labels in
// own / nlab (and hence targets) must lie in [0, num_labels); a mover's
// label outside it stops the kernel (__trap). scratch holds
// lp_move_scratch_bytes(R, num_labels) bytes, 256-byte aligned, in any
// state; moved and tgt hold R ints each.
extern "C" int lp_move_chunk(const int* nlab, const int* nw, const int* ncw,
                             const int* nbud, const int* own, const int* vw,
                             int R, int D, int W, int v0, uint32_t salt,
                             int num_labels, int* moved, int* tgt,
                             void* scratch, void* stream) {
  if (R < 1 || D < 1 || num_labels < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch s;
  carve((char*)scratch, R, num_labels, &s);
  const int passes = key_passes(num_labels);
  const int tiles = (R + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(s.zero, 0, s.zero_bytes, st);
  if (err != cudaSuccess) return (int)err;
  lp_move_rows<<<(R + WARPS * ROWS - 1) / (WARPS * ROWS), WARPS * 32, 0,
                 st>>>(
      nlab, nw, ncw, nbud, own, vw, R, D, W, salt, num_labels, tgt, s.pmove,
      s.light, s.din, s.dout);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lp_move_candidates<<<tiles, TILE, 0, st>>>(
      tgt, s.pmove, s.light, vw, s.din, s.dout, R, W, v0,
      salt ^ 0x9E3779B9u, passes, s.newcw, s.movedin, moved, s.key[0],
      s.row[0], s.ctr, s.hist, s.cstat);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lp_move_sort_revert<<<1, TILE, 0, st>>>(
      s.key[0], s.row[0], s.key[1], s.row[1], passes, s.hist, vw, s.newcw,
      s.movedin, W, s.ctr, moved);
  return (int)cudaGetLastError();
}
