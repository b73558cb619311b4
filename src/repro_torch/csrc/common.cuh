// Shared device code of the port's kernels: the uint32 mix hash, int32
// arithmetic that wraps like XLA's, the CTA-wide pieces of the radix
// sorts of lp_move and seg_merge (scans, the stable rank of a tile's
// digits, the decoupled look-back over tiles), and the label tables,
// hub plan, tickets and tie-chain reductions of the heavy-row paths of
// lp_move and bal_scores.
//
// Every source includes this header and builds into its own shared
// library, so everything here has internal linkage (static / anonymous
// namespace) and the libraries never clash.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define I32_MAX 2147483647
#define I32_MIN (-I32_MAX - 1)
#define FULL_MASK 0xFFFFFFFFu

namespace {

// core/lp.py::_hash32 and kernels/lp_move/lp_move.py::_h32 bit for bit:
// the int32 is reinterpreted as uint32 (-1 hashes as 0xFFFFFFFF).
__device__ __forceinline__ int h32(int x, uint32_t salt) {
  uint32_t h = ((uint32_t)x * 2654435761u) ^ salt;
  h ^= h >> 15;
  return (int)(h & 0x7FFFFFFFu);
}

// int32 add/sub that wrap modulo 2^32, as XLA's int32 ops do (signed
// overflow is undefined in C++).
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

// Order-preserving map of an int32 to uint32 (signed compare == unsigned
// compare of the images).
__device__ __forceinline__ uint32_t ord32(int x) {
  return (uint32_t)x ^ 0x80000000u;
}

// ---- CTA-wide building blocks of the radix sorts. They take
// blockDim.x == TILE: 32 warps. ------------------------------------------

constexpr int TILE = 1024;      // threads of a CTA, one key each
constexpr int RADIX = 256;      // 8-bit digits
constexpr int MAX_PASSES = 8;   // keys of at most 64 bits

__device__ __forceinline__ int digit(uint64_t k, int pass) {
  return (int)((k >> (8 * pass)) & (RADIX - 1));
}

// Segmented inclusive scan of (f, v) over the CTA, f marking a segment's
// head: on return v is the sum from the last head at or before this thread
// and f whether there was one. sf / sv (32 each) end holding the warps'
// inclusive results, so sf[31] / sv[31] is the CTA's aggregate.
__device__ void cta_seg_scan(bool& f, int& v, int* sf, int* sv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int pv = __shfl_up_sync(FULL_MASK, v, off);
    const bool pf = __shfl_up_sync(FULL_MASK, (int)f, off);
    if (lane >= off) {
      if (!f) v = wadd(v, pv);
      f = f || pf;
    }
  }
  if (lane == 31) { sf[warp] = f; sv[warp] = v; }
  __syncthreads();
  if (warp == 0) {
    bool wf = sf[lane];
    int wv = sv[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int pv = __shfl_up_sync(FULL_MASK, wv, off);
      const bool pf = __shfl_up_sync(FULL_MASK, (int)wf, off);
      if (lane >= off) {
        if (!wf) wv = wadd(wv, pv);
        wf = wf || pf;
      }
    }
    sf[lane] = wf; sv[lane] = wv;
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) v = wadd(v, sv[warp - 1]);
    f = f || sf[warp - 1];
  }
}

// Exclusive prefix sum of x over threads 0..255 (other threads get junk).
__device__ int excl_scan_256(int x, int* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int p = __shfl_up_sync(FULL_MASK, v, off);
    if (lane >= off) v += p;
  }
  if (lane == 31 && warp < RADIX / 32) s_w[warp] = v;
  __syncthreads();
  int add = 0;
  if (warp < RADIX / 32)
    for (int w = 0; w < warp; ++w) add += s_w[w];
  __syncthreads();
  return add + v - x;
}

// Stable ranks of a CTA's keys by digit. Thread `lane` of warp w holds
// ITEMS keys, key j at position (w * ITEMS + j) * 32 + lane of the tile,
// the order the ranks follow; d[j] is its digit, -1 for no key. On return
// rank[j] counts the tile's keys before it with the same digit (junk for
// no key) and cnt[r] the tile's keys of digit r. A warp counts its own
// keys in its row of wh (32 x RADIX counts, at most 32 ITEMS each, their
// prefixes at most TILE ITEMS: 16 bits suffice for ITEMS <= 64), item
// after item, so the CTA meets only once for the prefix over the warps.
// That prefix runs on all four 256-thread groups at once, eight warps
// each: a group's eight counts, the groups' sums (kept in the group's
// first row), the exclusive prefixes.
template <int ITEMS>
__device__ void rank_in_tile(const int (&d)[ITEMS], int (&rank)[ITEMS],
                             unsigned short* wh, int* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 16 * RADIX; i += TILE)
    reinterpret_cast<unsigned*>(wh)[i] = 0u;
  __syncthreads();
  unsigned short* row = wh + warp * RADIX;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned peers = __match_any_sync(FULL_MASK, d[j]);
    const int before = d[j] >= 0 ? row[d[j]] : 0;
    rank[j] = before + __popc(peers & lower);
    __syncwarp();
    if (d[j] >= 0 && (peers & lower) == 0)
      row[d[j]] = (unsigned short)(before + __popc(peers));
    __syncwarp();
  }
  __syncthreads();
  const int dd = threadIdx.x & (RADIX - 1), g = threadIdx.x / RADIX;
  unsigned short* col = wh + g * 8 * RADIX + dd;   // warps 8g .. 8g + 7
  int c[8], sum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[q] = col[q * RADIX];
    sum += c[q];
  }
  __syncthreads();
  col[0] = (unsigned short)sum;
  __syncthreads();
  int pre = 0, total = 0;
#pragma unroll
  for (int q = 0; q < TILE / RADIX; ++q) {
    const int gs = wh[q * 8 * RADIX + dd];
    pre += q < g ? gs : 0;
    total += gs;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    col[q * RADIX] = (unsigned short)pre;
    pre += c[q];
  }
  if (g == 0) cnt[dd] = total;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (d[j] >= 0) rank[j] += row[d[j]];
}

// One key a thread, in thread order: its stable rank (0 for no key).
__device__ int rank_in_tile(int d, unsigned short* wh, int* cnt) {
  const int dj[1] = {d};
  int r[1];
  rank_in_tile<1>(dj, r, wh, cnt);
  return d >= 0 ? r[0] : 0;
}

// ---- decoupled look-back over tiles that take their index from an atomic
// ticket (blocks run in no order; a ticket ensures every earlier tile is
// already running, so the wait below ends). A status word is
// (tag << 32) | count. One status array may serve several scans in turn,
// one epoch each: in epoch e, tag 2e + 1 is a tile's own count, 2e + 2 its
// inclusive prefix, and any smaller tag (0 is the zeroed scratch) not
// published yet. ----------------------------------------------------------

__device__ __forceinline__ uint64_t vload(const uint64_t* p) {
  return *(const volatile uint64_t*)p;
}
__device__ __forceinline__ void vstore(uint64_t* p, uint64_t x) {
  *(volatile uint64_t*)p = x;
  __threadfence();
}
__device__ __forceinline__ uint64_t status(unsigned tag, int payload) {
  return ((uint64_t)tag << 32) | (uint32_t)payload;
}

// Exclusive prefix of the counts of the tiles before this one; one thread
// per scan. Tile q's status word is st[q * stride].
__device__ int lookback_sum(uint64_t* st, int tile, int agg, int stride = 1,
                            unsigned epoch = 0) {
  const unsigned own = 2u * epoch + 1u, incl = own + 1u;
  if (tile == 0) {
    vstore(st, status(incl, agg));
    return 0;
  }
  vstore(st + (size_t)tile * stride, status(own, agg));
  int excl = 0;
  for (int q = tile - 1;; --q) {
    uint64_t w;
    do { w = vload(st + (size_t)q * stride); } while ((w >> 32) < own);
    excl += (int)(uint32_t)w;
    if ((w >> 32) == incl) break;
  }
  vstore(st + (size_t)tile * stride, status(incl, excl + agg));
  return excl;
}

// The same for a scan of one count per tile, walked back by a whole warp
// (every lane calls it; lane 0 publishes): the lanes read 32 predecessors
// at once, so a tile that finds them unresolved passes 32 a step.
__device__ int lookback_sum_warp(uint64_t* st, int tile, int agg,
                                 unsigned epoch = 0) {
  const int lane = threadIdx.x & 31;
  const unsigned own = 2u * epoch + 1u, incl = own + 1u;
  if (tile == 0) {
    if (lane == 0) vstore(st, status(incl, agg));
    return 0;
  }
  if (lane == 0) vstore(st + tile, status(own, agg));
  int excl = 0;
  for (int base = tile - 1;; base -= 32) {
    const int q = base - lane;   // lane 0: the nearest predecessor
    uint64_t w = status(incl, 0);
    if (q >= 0)
      do { w = vload(st + q); } while ((w >> 32) < own);
    const unsigned done = __ballot_sync(FULL_MASK, (w >> 32) == incl);
    const int stop = done ? __ffs(done) - 1 : 31;
    excl += __reduce_add_sync(FULL_MASK,
                              lane <= stop ? (unsigned)(uint32_t)w : 0u);
    if (done) break;
  }
  if (lane == 0) vstore(st + tile, status(incl, excl + agg));
  return excl;
}

// ---- heavy rows (lp_move_heavy, bal_scores_heavy): a row too wide for
// the ELL slab, its D slab lanes and then its overflow arcs, L lanes in
// all. A row of at most WARP_LANES lanes (the warp class) is one warp's,
// which sums its arcs' weights per distinct label in a table of its own
// in shared memory (2 slots a distinct label at least, a power of two);
// the other rows (hubs) are laid end to end in a hub-lane space whose
// HUB_RANGE-lane ranges are one CTA each: a CTA adds its lanes' sums into
// the row's open-addressing table in global scratch (2 slots a lane,
// zeroed before the launch), and the row's last CTA to arrive (an atomic
// ticket after a fence) walks it. kernels/heavy.py builds the hub plan
// with the same two constants. Keys are label + 1, 0 empty. -------------

constexpr int HEAVY_WARPS = 4;           // warps of a heavy-row CTA
constexpr int HEAVY = HEAVY_WARPS * 32;  // its threads
constexpr int WARP_LANES = 256;          // a warp-class row's lanes at most
constexpr int WARP_SLOTS = 2 * WARP_LANES;   // its table's slots at most
constexpr int HUB_RANGE = 1024;          // hub lanes a CTA takes
constexpr int ROW_TILES = WARP_LANES >> 5;   // a warp's tiles of either
static_assert(HUB_RANGE == HEAVY * ROW_TILES, "a range: 8 tiles a warp");

constexpr int FEW_LABELS = 8;            // a tile's labels summed by redux

// Adds one 32-lane tile of (label l, -1: none; weight x; c, b: minima
// kept beside the sum) into a table: insert(label, sum, min c, min b) is
// called once a label by the label's first lane when the tile holds at
// most FEW_LABELS distinct labels (their sums taken by full-warp redux,
// one label after the other), else once a lane by every lane with a
// label. A redux over a group's own member mask serializes over the
// tile's distinct masks: with 32 distinct labels (lp_move's clusters at
// level 0), 32 of them, which made it the heavy rows' slowest step.
template <class Insert>
__device__ __forceinline__ void add_tile(int l, int x, int c, int b,
                                         Insert insert) {
  const int lane = threadIdx.x & 31;
  const unsigned grp = __match_any_sync(FULL_MASK, l);
  const unsigned leads =
      __ballot_sync(FULL_MASK, l >= 0 && lane == __ffs(grp) - 1);
  if (__popc(leads) > FEW_LABELS) {
    if (l >= 0) insert(l, x, c, b);
    return;
  }
  for (unsigned m = leads; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const int lab = __shfl_sync(FULL_MASK, l, src);
    const bool in = l == lab;
    const int sum = (int)__reduce_add_sync(FULL_MASK, in ? (unsigned)x : 0u);
    const int cmin = __reduce_min_sync(FULL_MASK, in ? c : I32_MAX);
    const int bmin = __reduce_min_sync(FULL_MASK, in ? b : I32_MAX);
    if (lane == src) insert(lab, sum, cmin, bmin);
  }
}

__device__ __forceinline__ unsigned mix32(int l) {
  unsigned h = (uint32_t)l * 2654435761u;
  return h ^ (h >> 16);
}

// The slot of label l >= 0 in the table `key` of T slots (any T, in
// global memory, atomics from many CTAs), claimed if new. T exceeds the
// labels the row holds, so a free slot is always found. `stride`: ints
// from one slot's key to the next.
__device__ __forceinline__ int claim_slot(int* key, int T, int l,
                                          int stride = 1) {
  unsigned s = mix32(l) % (unsigned)T;
  for (;;) {
    const int prev = atomicCAS(key + (size_t)s * stride, 0, l + 1);
    if (prev == 0 || prev == l + 1) return (int)s;
    s = s + 1 == (unsigned)T ? 0u : s + 1;
  }
}

// The same in a warp's table of mask + 1 slots (a power of two) in
// shared memory.
__device__ __forceinline__ int claim_pow2(int* key, unsigned mask, int l) {
  unsigned s = mix32(l) & mask;
  for (;;) {
    const int prev = atomicCAS(key + s, 0, l + 1);
    if (prev == 0 || prev == l + 1) return (int)s;
    s = (s + 1) & mask;
  }
}

// Slots of a warp's table for at most n distinct labels: a power of two,
// at least 2 n and 32 (one slot a lane to walk).
__device__ __forceinline__ int warp_slots(int n) {
  int T = 32;
  while (T < 2 * n) T <<= 1;
  return T;
}

// The hub rows' plan (kernels/heavy.py): hubs[2 k] is hub row k's heavy
// index, hubs[2 k + 1] its first lane in the hub-lane space (k = n_hub:
// H and the hub lanes in all); ranges[c] the hub row holding the first
// lane of range c.
struct HubPlan {
  const int* hubs;
  int n_hub;
  const int* ranges;
  int G;
};

// First index i in [0, n) with a[i] >= x (n if none), a ascending: by
// the whole warp, 32 probes a step, so ~log32(n) dependent loads.
__device__ int lower_bound_warp(const int* __restrict__ a, int n, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;                        // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int i = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned ge = __ballot_sync(FULL_MASK, __ldg(a + i) >= x);
    if (ge) {
      const int f = __ffs(ge) - 1;
      hi = min(lo + (f + 1) * step - 1, hi - 1);
      lo += f * step;
    } else {
      lo = hi;                               // the last probe is hi - 1
    }
  }
  const int i = lo + lane;
  const unsigned ge = __ballot_sync(FULL_MASK, i < hi && __ldg(a + i) >= x);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

// The CTAs that take hub row k: its ranges' count.
__device__ __forceinline__ int hub_ctas(int off, int end) {
  return (end - 1) / HUB_RANGE - off / HUB_RANGE + 1;
}

// After a CTA added its lanes of hub row k into the row's table: whether
// it arrived last (every CTA of the row has then added its sums, visible
// to this CTA's loads after the fence). All threads call it.
__device__ __forceinline__ bool last_of_row(int* ticket, int k, int ctas,
                                            int* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *s_flag = atomicAdd(ticket + k, 1) == ctas - 1;
    __threadfence();
  }
  __syncthreads();
  return *s_flag;
}

// The warp's tie chain over its lanes' best candidates (score bs, weight
// key bc, hash bh, label bl): max score, then the smallest weight key,
// hash, label, one redux each; every lane gets (score, weight, label).
__device__ __forceinline__ void warp_best(int bs, int bc, int bh, int bl,
                                          int& s, int& c, int& l) {
  s = __reduce_max_sync(FULL_MASK, bs);
  bool tie = bs == s;
  c = __reduce_min_sync(FULL_MASK, tie ? bc : I32_MAX);
  tie = tie && bc == c;
  const int h = __reduce_min_sync(FULL_MASK, tie ? bh : I32_MAX);
  tie = tie && bh == h;
  l = __reduce_min_sync(FULL_MASK, tie ? bl : I32_MAX);
}

// Max (MAX) or min of x over the CTA (blockDim.x a multiple of 32, at most
// 1024); every thread gets it. sh: 33 ints of shared memory, free again
// on return.
template <bool MAX>
__device__ int cta_reduce(int x, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = MAX ? __reduce_max_sync(FULL_MASK, x) : __reduce_min_sync(FULL_MASK, x);
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int y = lane < (int)(blockDim.x >> 5) ? sh[lane] : (MAX ? I32_MIN
                                                             : I32_MAX);
    y = MAX ? __reduce_max_sync(FULL_MASK, y)
            : __reduce_min_sync(FULL_MASK, y);
    if (lane == 0) sh[32] = y;
  }
  __syncthreads();
  const int r = sh[32];
  __syncthreads();
  return r;
}

// warp_best over the CTA, four CTA reductions.
__device__ __forceinline__ void cta_best(int bs, int bc, int bh, int bl,
                                         int& s, int& c, int& l, int* sh) {
  s = cta_reduce<true>(bs, sh);
  bool tie = bs == s;
  c = cta_reduce<false>(tie ? bc : I32_MAX, sh);
  tie = tie && bc == c;
  const int h = cta_reduce<false>(tie ? bh : I32_MAX, sh);
  tie = tie && bh == h;
  l = cta_reduce<false>(tie ? bl : I32_MAX, sh);
}

}  // namespace
