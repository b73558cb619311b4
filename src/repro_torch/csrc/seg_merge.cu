// seg_merge: segmented sort + duplicate-arc merge, for Hopper.
//
// Replaces kernels/seg_merge/seg_merge.py::seg_merge of the JAX package and
// computes what it computes: (src, dst) int32 records with w as payload are
// sorted by (src, dst), each record gets a run-start flag and the total
// weight of its equal-key run (int32 sums that wrap). Invalid records carry
// I32_MAX in src or dst and sort after every valid id.
//
// What bounds it on the H100: memory. A merge must read 12 B and write 16 B
// per record. At level 0 of a 2^20-vertex rgg2d graph L is 2.2 million
// records, far beyond one block, so the TPU kernel's single resident
// bitonic network (log^2 L compare-exchange stages over a power-of-two
// length) cannot carry over; a radix sort moves each record once a pass,
// and the pass count follows the width of the ids, not L.
//
// Design.
//   Key: the caller gives the width ``bits`` of the ids: every valid id
//   lies in [0, 2^bits - 1), and I32_MAX maps to that half's all-ones
//   value 2^bits - 1, above every valid id. bits == 32 takes any int32,
//   negatives included, by the order-preserving map ord32 (I32_MAX is then
//   all-ones too). The uint64 key (src' << bits) | dst' of 2 bits bits
//   orders records exactly as (src, dst) does.
//   Sort: a stable LSD radix sort over 8-bit digits, ceil(2 bits / 8)
//   passes (5 at level 0 of the 2^20 path, whose ids need 18 bits).
//     1. seg_hist: one read of src / dst gives every pass's digit
//        histogram; a thread counts 8 consecutive keys and adds each run
//        of equal digits once to shared memory.
//     2. seg_pass, one launch a pass (the Onesweep form): a CTA takes a
//        4096-key tile by atomic ticket, ranks its digits stably
//        (rank_in_tile: a warp ranks its 128 consecutive keys alone, the
//        CTA meets once for the prefix over its warps), and takes the
//        counts of each digit in the earlier tiles by a decoupled
//        look-back, one thread a digit (lookback_sum; one status array
//        serves every pass, one epoch each, so it is cleared once a
//        call). It then stages the tile in shared memory in digit order
//        and writes each digit's keys to one contiguous stretch. Pass 0
//        packs the keys from the inputs as it loads them.
//   Run totals, two passes whatever the run lengths:
//     3. seg_runs: run-start flags, run ids (a CTA scan of the flags plus a
//        warp-wide look-back), the unpacked keys, and each run's sum within
//        the tile (a segmented CTA scan of w). A run inside one tile stores
//        its total; a run longer than a tile (the invalid tail, a hub's
//        parallel arcs) adds its part once per tile it spans, into a
//        zeroed table. Integer adds make the order of the sums irrelevant.
//     4. seg_totals: each record gathers its run's total.
//   A call is passes + 4 launches (a memset of the counters, histograms,
//   status words and run table; seg_hist; the passes; seg_runs;
//   seg_totals), whatever L, and waits for nothing on the host.
//   On the H100 the passes take most of the device time (chip_smoke.py
//   phase 5 prints each kernel's share), each moving its 24 bytes a key
//   at well under the HBM rate: the tiles' ranking and look-backs, not
//   the bytes, set the pace.
#include "common.cuh"

namespace {

constexpr int ITEMS = 4;                 // keys a thread ranks in a tile
constexpr int TILE_KEYS = ITEMS * TILE;  // keys of a seg_pass tile
constexpr int PASS_SMEM = 12 * TILE_KEYS;  // the staged tile: keys, values
constexpr int HIST_THREADS = 256;
constexpr int HIST_ITEMS = 8;            // consecutive keys a thread counts
constexpr int HIST_BLOCKS = 1024;

// int counters at the head of the zeroed scratch: one tile ticket for each
// pass, one for seg_runs
enum { C_RUNS = MAX_PASSES, N_COUNTERS = MAX_PASSES + 1 };

__device__ __forceinline__ uint32_t map_half(int x, int bits) {
  if (bits == 32) return ord32(x);
  return x == I32_MAX ? (1u << bits) - 1u : (uint32_t)x;
}

__device__ __forceinline__ int unmap_half(uint32_t h, int bits) {
  if (bits == 32) return (int)(h ^ 0x80000000u);
  return h == (1u << bits) - 1u ? I32_MAX : (int)h;
}

__device__ __forceinline__ uint64_t pack(int s, int d, int bits) {
  return ((uint64_t)map_half(s, bits) << bits) | map_half(d, bits);
}

// Every pass's digit histogram of the packed keys. A thread counts
// HIST_ITEMS consecutive keys and adds each run of equal digits once. The
// contraction's records come in the fine graph's CSR order, so src repeats
// over each vertex's arcs: the high digits then cost one shared atomic a
// run, not one a key on a contended word.
__global__ void __launch_bounds__(HIST_THREADS)
seg_hist(const int* __restrict__ src, const int* __restrict__ dst, int L,
         int bits, int passes, int* __restrict__ hist) {
  __shared__ int sh[MAX_PASSES * RADIX];
  for (int i = threadIdx.x; i < passes * RADIX; i += HIST_THREADS) sh[i] = 0;
  __syncthreads();
  const size_t chunk = (size_t)HIST_THREADS * HIST_ITEMS;
  for (size_t i0 = (size_t)blockIdx.x * chunk + threadIdx.x * HIST_ITEMS;
       i0 < (size_t)L; i0 += (size_t)gridDim.x * chunk) {
    const int n = (size_t)L - i0 < HIST_ITEMS ? (int)((size_t)L - i0)
                                              : HIST_ITEMS;
    uint64_t k[HIST_ITEMS];
#pragma unroll
    for (int j = 0; j < HIST_ITEMS; ++j)
      k[j] = j < n ? pack(src[i0 + j], dst[i0 + j], bits) : 0;
    for (int p = 0; p < passes; ++p) {
      int prev = digit(k[0], p), run = 1;
#pragma unroll
      for (int j = 1; j < HIST_ITEMS; ++j) {
        if (j >= n) break;
        const int d = digit(k[j], p);
        if (d != prev) {
          atomicAdd(&sh[p * RADIX + prev], run);
          prev = d;
          run = 0;
        }
        ++run;
      }
      atomicAdd(&sh[p * RADIX + prev], run);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * RADIX; i += HIST_THREADS)
    if (sh[i]) atomicAdd(&hist[i], sh[i]);
}

// One stable scatter pass by digit ``pass``. kin == nullptr: pass 0, which
// packs the keys from (src, dst) and takes w as the values.
// Two CTAs an SM (32 registers a thread) hide more of each tile's
// latencies than one with more registers (measured on the H100).
__global__ void __launch_bounds__(TILE, 2)
seg_pass(const int* __restrict__ src, const int* __restrict__ dst,
         const int* __restrict__ w, const uint64_t* __restrict__ kin,
         const int* __restrict__ vin, uint64_t* __restrict__ kout,
         int* __restrict__ vout, int L, int bits, int pass,
         const int* __restrict__ hist, int* ctr, uint64_t* st) {
  // the staged tile; the rank counts (32 x RADIX shorts) alias its keys,
  // whose staging begins after the ranking ends
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* sk = (uint64_t*)smem;
  int* sv = (int*)(smem + 8 * TILE_KEYS);
  unsigned short* wh = (unsigned short*)smem;
  __shared__ int cnt[RADIX], lbase[RADIX], gbase[RADIX];
  __shared__ int s_w[RADIX / 32];
  __shared__ int s_tile;
  const int t = threadIdx.x;
  if (t == 0) s_tile = atomicAdd(&ctr[pass], 1);
  __syncthreads();
  const int tile = s_tile;
  const size_t t0 = (size_t)tile * TILE_KEYS;
  const size_t left = (size_t)L - t0;
  const int n = left < TILE_KEYS ? (int)left : TILE_KEYS;
  // a warp's keys are 32 ITEMS consecutive ones, item after item
  const int i0 = (t >> 5) * 32 * ITEMS + (t & 31);
  uint64_t k[ITEMS];
  int v[ITEMS], d[ITEMS], pos[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = i0 + 32 * j;
    k[j] = 0;
    v[j] = 0;
    if (i < n) {
      if (kin) {
        k[j] = kin[t0 + i];
        v[j] = vin[t0 + i];
      } else {
        k[j] = pack(src[t0 + i], dst[t0 + i], bits);
        v[j] = w[t0 + i];
      }
    }
    d[j] = i < n ? digit(k[j], pass) : -1;
  }
  rank_in_tile<ITEMS>(d, pos, wh, cnt);
  const int c = t < RADIX ? cnt[t] : 0;             // this tile's digit t
  const int lb = excl_scan_256(c, s_w);             // ... starts here in it
  const int h = t < RADIX ? hist[pass * RADIX + t] : 0;
  const int hb = excl_scan_256(h, s_w);             // keys of smaller digits
  if (t < RADIX) {
    lbase[t] = lb;
    gbase[t] = hb - lb + lookback_sum(st + t, tile, c, RADIX, (unsigned)pass);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (d[j] >= 0) {
      const int at = lbase[d[j]] + pos[j];
      sk[at] = k[j];
      sv[at] = v[j];
    }
  __syncthreads();
  for (int i = t; i < n; i += TILE) {
    const uint64_t kk = sk[i];
    const int o = gbase[digit(kk, pass)] + i;
    kout[o] = kk;
    vout[o] = sv[i];
  }
}

// Flags, run ids, unpacked keys and run partial sums of the sorted
// records, one record a thread, a TILE-record tile by atomic ticket. A run
// that lies in one tile stores its total; one that spans tiles adds each
// tile's part to the zeroed table. The warp-wide look-back and two CTAs
// an SM were each faster on the H100 than one thread's walk and one CTA.
__global__ void __launch_bounds__(TILE, 2)
seg_runs(const uint64_t* __restrict__ key, const int* __restrict__ val,
         int L, int bits, int passes, int* ctr, uint64_t* st,
         int* __restrict__ s_src, int* __restrict__ s_dst,
         int* __restrict__ first, int* __restrict__ rid,
         int* __restrict__ run_sum) {
  __shared__ int sf[32], sv[32];
  __shared__ int s_tile, s_excl;
  const int t = threadIdx.x;
  if (t == 0) s_tile = atomicAdd(&ctr[C_RUNS], 1);
  __syncthreads();
  const int tile = s_tile;
  const size_t l = (size_t)L, i = (size_t)tile * TILE + t;
  const bool valid = i < l;
  uint64_t k = 0;
  int w = 0;
  bool head = false, last = false;
  if (valid) {
    k = key[i];
    w = val[i];
    head = i == 0 || key[i - 1] != k;
    last = i + 1 == l || key[i + 1] != k;  // the run ends here
  }
  bool f = false;
  int heads = head ? 1 : 0;
  cta_seg_scan(f, heads, sf, sv);  // run heads up to and including i
  if (t < 32) {
    const int e = lookback_sum_warp(st, tile, sv[31], (unsigned)passes);
    if (t == 0) s_excl = e;
  }
  __syncthreads();  // s_excl, and sv[31] read before the next scan
  bool in_tile = head;  // becomes: the run's head lies in this tile
  int part = w;         // becomes: w from there (or the tile's start) to i
  cta_seg_scan(in_tile, part, sf, sv);
  if (!valid) return;
  const int id = s_excl + heads - 1;
  const uint32_t mask = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
  s_src[i] = unmap_half((uint32_t)(k >> bits), bits);
  s_dst[i] = unmap_half((uint32_t)k & mask, bits);
  first[i] = head ? 1 : 0;
  rid[i] = id;
  if (last && in_tile)
    run_sum[id] = part;
  else if (last || t == TILE - 1)
    atomicAdd(&run_sum[id], part);
}

__global__ void seg_totals(const int* __restrict__ run_sum, int L,
                           int* __restrict__ tot) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (size_t)L) tot[i] = run_sum[tot[i]];
}

// Scratch layout, 256-byte aligned pieces. Everything from ctr on is
// cleared by one memset per call.
struct Scratch {
  uint64_t* key[2];
  int* val[2];
  int *ctr, *hist, *run_sum;
  uint64_t* st;
  char* zero;
  size_t zero_bytes;
};

size_t carve(char* base, int L, Scratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~(size_t)255;
    return p;
  };
  const size_t l = (size_t)L;
  const size_t tiles = (l + TILE_KEYS - 1) / TILE_KEYS;
  for (int i = 0; i < 2; ++i) {
    s->key[i] = (uint64_t*)take(8 * l);
    s->val[i] = (int*)take(4 * l);
  }
  const size_t zero_from = off;
  s->ctr = (int*)take(4 * N_COUNTERS);
  s->hist = (int*)take(4 * MAX_PASSES * RADIX);
  // a status word per digit and seg_pass tile; seg_runs's tiles (TILE
  // records each) need fewer
  s->st = (uint64_t*)take(8 * tiles * RADIX);
  s->run_sum = (int*)take(4 * l);
  s->zero = base ? base + zero_from : nullptr;
  s->zero_bytes = off - zero_from;
  return off;
}

}  // namespace

// Bytes of scratch seg_merge needs for L records.
extern "C" int seg_merge_scratch_bytes(int L, int64_t* bytes) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  Scratch s;
  *bytes = (int64_t)carve(nullptr, L, &s);
  return 0;
}

// L in [1, 2^31); bits in [1, 32]: every src / dst is I32_MAX or, for
// bits < 32, lies in [0, 2^bits - 1). scratch holds
// seg_merge_scratch_bytes(L) bytes, 256-byte aligned, in any state; the
// four outputs hold L ints each.
extern "C" int seg_merge(const int* src, const int* dst, const int* w, int L,
                         int bits, int* s_src, int* s_dst, int* tot,
                         int* first, void* scratch, void* stream) {
  if (L < 1 || bits < 1 || bits > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Scratch s;
  carve((char*)scratch, L, &s);
  const int passes = (2 * bits + 7) / 8;
  const size_t l = (size_t)L;
  const int tiles = (int)((l + TILE_KEYS - 1) / TILE_KEYS);
  const size_t hb = (l + HIST_THREADS * HIST_ITEMS - 1) /
                    (HIST_THREADS * HIST_ITEMS);
  const int hist_blocks = hb < HIST_BLOCKS ? (int)hb : HIST_BLOCKS;
  // the staged tile passes the 48 KB a launch gets without asking; set
  // once, at the first call (a later one may be under stream capture)
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        seg_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, PASS_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaError_t err = cudaMemsetAsync(s.zero, 0, s.zero_bytes, st);
  if (err != cudaSuccess) return (int)err;
  seg_hist<<<hist_blocks, HIST_THREADS, 0, st>>>(src, dst, L, bits, passes,
                                                 s.hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int p = 0; p < passes; ++p) {
    const int in = (p + 1) & 1, out = p & 1;
    seg_pass<<<tiles, TILE, PASS_SMEM, st>>>(
        src, dst, w, p ? s.key[in] : nullptr, p ? s.val[in] : nullptr,
        s.key[out], s.val[out], L, bits, p, s.hist, s.ctr, s.st);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int last = (passes - 1) & 1;
  seg_runs<<<(int)((l + TILE - 1) / TILE), TILE, 0, st>>>(
      s.key[last], s.val[last], L, bits, passes, s.ctr, s.st, s_src, s_dst,
      first, tot, s.run_sum);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  seg_totals<<<(int)((l + 255) / 256), 256, 0, st>>>(s.run_sum, L, tot);
  return (int)cudaGetLastError();
}
