// Shared device code of the port's kernels: the uint32 mix hash, int32
// arithmetic that wraps like XLA's, and seg_merge's bitonic (key, value)
// sort for lengths beyond one block and segmented Hillis-Steele scans.
//
// Every source includes this header and builds into its own shared
// library, so everything here has internal linkage (static / anonymous
// namespace) and the libraries never clash.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define I32_MAX 2147483647
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

// ---- bitonic sort of (uint64 key, int value) pairs, ascending by
// (key, value). n is a power of two. Stages whose compare distance j is
// below the tile run in shared memory; larger distances are one global
// pass each. ------------------------------------------------------------

constexpr int SORT_TILE = 2048;

__device__ __forceinline__ bool kv_gt(uint64_t ka, int va, uint64_t kb,
                                      int vb) {
  return ka > kb || (ka == kb && va > vb);
}

// Compare-exchange of slots i < l (l = i | j); ascending iff (gi & k) == 0.
__device__ __forceinline__ void kv_cx(uint64_t* key, int* val, unsigned i,
                                      unsigned l, bool asc) {
  uint64_t ki = key[i], kl = key[l];
  int vi = val[i], vl = val[l];
  if (kv_gt(ki, vi, kl, vl) == asc) {
    key[i] = kl; key[l] = ki;
    val[i] = vl; val[l] = vi;
  }
}

__device__ __forceinline__ unsigned pair_lo(unsigned t, unsigned j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// Stages j < tile of merge step k (k == 0: full sort of each tile).
__global__ void __launch_bounds__(SORT_TILE / 2)
bitonic_tile(uint64_t* key, int* val, int tile, int kmerge) {
  __shared__ uint64_t sk[SORT_TILE];
  __shared__ int sv[SORT_TILE];
  const unsigned base = blockIdx.x * (unsigned)tile;
  for (unsigned t = threadIdx.x; t < (unsigned)tile; t += blockDim.x) {
    sk[t] = key[base + t];
    sv[t] = val[base + t];
  }
  const unsigned k0 = kmerge ? (unsigned)kmerge : 2u;
  const unsigned k1 = kmerge ? (unsigned)kmerge : (unsigned)tile;
  for (unsigned k = k0; k <= k1; k <<= 1) {
    unsigned j = kmerge ? (unsigned)tile >> 1 : k >> 1;
    for (; j > 0; j >>= 1) {
      __syncthreads();
      for (unsigned t = threadIdx.x; t < (unsigned)tile / 2; t += blockDim.x) {
        unsigned i = pair_lo(t, j);
        kv_cx(sk, sv, i, i | j, ((base + i) & k) == 0);
      }
    }
  }
  __syncthreads();
  for (unsigned t = threadIdx.x; t < (unsigned)tile; t += blockDim.x) {
    key[base + t] = sk[t];
    val[base + t] = sv[t];
  }
}

__global__ void bitonic_step(uint64_t* key, int* val, unsigned half,
                             unsigned j, unsigned k) {
  unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half) return;
  unsigned i = pair_lo(t, j);
  kv_cx(key, val, i, i | j, (i & k) == 0);
}

static cudaError_t bitonic_sort(uint64_t* key, int* val, int n,
                                cudaStream_t s) {
  const int tile = n < SORT_TILE ? n : SORT_TILE;
  const int threads = tile / 2;
  bitonic_tile<<<n / tile, threads, 0, s>>>(key, val, tile, 0);
  const unsigned half = (unsigned)n / 2;
  for (unsigned k = 2u * tile; k <= (unsigned)n; k <<= 1) {
    for (unsigned j = k >> 1; j >= (unsigned)tile; j >>= 1)
      bitonic_step<<<(half + 255) / 256, 256, 0, s>>>(key, val, half, j, k);
    bitonic_tile<<<n / tile, threads, 0, s>>>(key, val, tile, (int)k);
  }
  return cudaGetLastError();
}

// ---- segmented inclusive scans (Hillis-Steele, one global pass per
// doubling step). flag marks a segment's first element (forward) or
// last element (backward). ----------------------------------------------

__global__ void seg_scan_step(const int* sum, const uint8_t* flag,
                              int* sum_out, uint8_t* flag_out, int n,
                              int step, int backward) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int p = backward ? i + step : i - step;
  bool in = backward ? p < n : p >= 0;
  int s = sum[i];
  uint8_t f = flag[i];
  if (in) {
    if (!f) s = wadd(s, sum[p]);
    f = f | flag[p];
  }
  sum_out[i] = s;
  flag_out[i] = f;
}

// Scans ``sum`` in place; ``flag`` is consumed. tmp buffers hold n each.
static cudaError_t seg_scan(int* sum, uint8_t* flag, int* sum_tmp,
                            uint8_t* flag_tmp, int n, bool backward,
                            cudaStream_t s) {
  int* a = sum; uint8_t* fa = flag;
  int* b = sum_tmp; uint8_t* fb = flag_tmp;
  const int blocks = (n + 255) / 256;
  for (int step = 1; step < n; step <<= 1) {
    seg_scan_step<<<blocks, 256, 0, s>>>(a, fa, b, fb, n, step,
                                         backward ? 1 : 0);
    int* t = a; a = b; b = t;
    uint8_t* ft = fa; fa = fb; fb = ft;
  }
  if (a != sum)
    cudaMemcpyAsync(sum, a, sizeof(int) * (size_t)n,
                    cudaMemcpyDeviceToDevice, s);
  return cudaGetLastError();
}

}  // namespace
