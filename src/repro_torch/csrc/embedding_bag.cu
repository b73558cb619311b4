// embedding_bag: out[b] = sum_j table[idx[b, j]], for Hopper.
//
// Replaces kernels/embedding_bag/embedding_bag.py::embedding_bag_1row of
// the JAX package (body _kernel): each bag's output row starts at zero and
// the table rows of its indices are added in j order; repeated indices are
// added again, not deduped. Every element is 0 + t_0 + t_1 + ... in that
// order, which the plain version repeats, so the two agree bit for bit.
//
// What bounds it on the H100: memory, B * BAG gathered rows of D floats
// and B output rows (34 MB at B = 65,536, D = 64, BAG = 1: 0.01 ms), and
// the latency of the two dependent loads of a bag (its index, then the
// row). The TPU kernel steers one table-row DMA per grid step with
// prefetched indices.
//
// Design. A group of G lanes owns BPT consecutive bags; G is ceil(D / 4)
// rounded up to a power of two, at most 32, so every lane carries a
// 16-byte float4 column (a half-warp a bag at D = 64) and a wider row
// loops over its columns. Each thread loads the indices of its BPT bags
// first, then issues all BPT row loads before the first add, and fetches
// the next j's indices before adding this j's rows: several rows are in
// flight per thread and the grid is about one wave of resident warps. A D
// that is not a multiple of 4, or an unaligned table, takes the scalar
// path (one warp a bag). The kernel compares each index with V as it loads
// it and stops (__trap) on one outside [0, V) instead of reading outside
// the table; callers check their indices before the launch.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BPT = 4;   // bags per thread of the float4 path
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ int checked(int i, int V) {
  if ((unsigned)i >= (unsigned)V) __trap();
  return i;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
embedding_bag_vec(const int* __restrict__ idx,
                  const float4* __restrict__ table, int B, int BAG, int nv,
                  int V, float4* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long b0 = t / G * BPT;
  if (b0 >= B) return;
  const int nb = B - b0 < BPT ? (int)(B - b0) : BPT;
  const int* bag = idx + b0 * BAG;
  for (int c = (int)(t % G); c < nv; c += G) {
    float4 acc[BPT];
    int nxt[BPT];
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      nxt[k] = k < nb && BAG > 0 ? checked(bag[k * BAG], V) : 0;
    }
    for (int j = 0; j < BAG; ++j) {
      float4 row[BPT];
#pragma unroll
      for (int k = 0; k < BPT; ++k)
        row[k] = k < nb ? table[(size_t)nxt[k] * nv + c]
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j + 1 < BAG) {
#pragma unroll
        for (int k = 0; k < BPT; ++k)
          if (k < nb) nxt[k] = checked(bag[k * BAG + j + 1], V);
      }
#pragma unroll
      for (int k = 0; k < BPT; ++k) {
        acc[k].x = __fadd_rn(acc[k].x, row[k].x);
        acc[k].y = __fadd_rn(acc[k].y, row[k].y);
        acc[k].z = __fadd_rn(acc[k].z, row[k].z);
        acc[k].w = __fadd_rn(acc[k].w, row[k].w);
      }
    }
#pragma unroll
    for (int k = 0; k < BPT; ++k)
      if (k < nb) out[(size_t)(b0 + k) * nv + c] = acc[k];
  }
}

__global__ void __launch_bounds__(THREADS)
embedding_bag_scalar(const int* __restrict__ idx,
                     const float* __restrict__ table, int B, int BAG, int D,
                     int V, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int* bag = idx + (size_t)b * BAG;
  float* o = out + (size_t)b * D;
  for (int c = lane; c < D; c += 32) {
    float acc = 0.0f;
    for (int j = 0; j < BAG; ++j)
      acc = __fadd_rn(acc, table[(size_t)checked(bag[j], V) * D + c]);
    o[c] = acc;
  }
}

template <int G>
cudaError_t launch_vec(const int* idx, const float* table, int B, int BAG,
                       int nv, int V, float* out, cudaStream_t s) {
  const long long threads = ((long long)B + BPT - 1) / BPT * G;
  embedding_bag_vec<G><<<(unsigned)((threads + THREADS - 1) / THREADS),
                         THREADS, 0, s>>>(
      idx, reinterpret_cast<const float4*>(table), B, BAG, nv, V,
      reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

// idx (B, BAG) row-major; table (V, D) and out (B, D) row-major. B, D,
// V >= 1, BAG >= 0. An index outside [0, V) stops the kernel.
extern "C" int embedding_bag(const int* idx, const float* table, int B,
                             int BAG, int D, int V, float* out,
                             void* stream) {
  if (B < 1 || D < 1 || V < 1 || BAG < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (D % 4 == 0) && ((uintptr_t)table % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (!vec) {
    embedding_bag_scalar<<<(B + WARPS - 1) / WARPS, THREADS, 0, s>>>(
        idx, table, B, BAG, D, V, out);
    return (int)cudaGetLastError();
  }
  const int nv = D / 4;
  if (nv <= 1) return (int)launch_vec<1>(idx, table, B, BAG, nv, V, out, s);
  if (nv <= 2) return (int)launch_vec<2>(idx, table, B, BAG, nv, V, out, s);
  if (nv <= 4) return (int)launch_vec<4>(idx, table, B, BAG, nv, V, out, s);
  if (nv <= 8) return (int)launch_vec<8>(idx, table, B, BAG, nv, V, out, s);
  if (nv <= 16)
    return (int)launch_vec<16>(idx, table, B, BAG, nv, V, out, s);
  return (int)launch_vec<32>(idx, table, B, BAG, nv, V, out, s);
}
