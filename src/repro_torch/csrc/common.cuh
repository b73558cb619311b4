// Shared device code of the port's kernels: the uint32 mix hash, int32
// arithmetic that wraps like XLA's, the CTA-wide pieces of the radix
// sorts of lp_move and seg_merge (scans, the stable rank of a tile's
// digits, the decoupled look-back over tiles), and the per-row label
// tables and CTA reductions of the heavy-row paths of lp_move and
// bal_scores.
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

// ---- heavy rows: a row too wide for the ELL slab is taken by one CTA,
// which sums its arcs' weights per distinct label in an open-addressing
// table of T >= 2 x (its lanes) slots in global scratch (keys label + 1, 0
// empty), then runs the tie chain over the table by CTA reductions. -----

constexpr int HEAVY = 256;      // threads of a heavy-row CTA

// The slot of label l >= 0 in the table `key` of T slots, claimed if new.
// T exceeds the labels the row holds, so a free slot is always found.
__device__ __forceinline__ int claim_slot(int* key, int T, int l) {
  unsigned s = ((uint32_t)l * 2654435761u) % (unsigned)T;
  for (;;) {
    const int prev = atomicCAS(key + s, 0, l + 1);
    if (prev == 0 || prev == l + 1) return (int)s;
    s = s + 1 == (unsigned)T ? 0u : s + 1;
  }
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

}  // namespace
