// embedding_bag: out[b] = sum_j table[idx[b, j]], for Hopper.
//
// Replaces kernels/embedding_bag/embedding_bag.py::embedding_bag_1row of
// the JAX package (body _kernel): each bag's output row starts at zero and
// the table rows of its indices are added in j order; repeated indices are
// added again, not deduped. Every element is 0 + t_0 + t_1 + ... in that
// order, which the plain version repeats, so the two agree bit for bit.
//
// What bounds it on the H100: memory (B * BAG gathered rows of D floats and
// B output rows) and, at small B, the launch itself. The TPU kernel steers
// one table-row DMA per grid step with prefetched indices; here one warp
// owns a bag, reads its indices itself and walks the row in 16-byte float4
// columns (a D that is not a multiple of 4, or an unaligned table, takes
// the scalar path), so neighbouring lanes read neighbouring words of a
// row. Indices are checked against [0, V) by the wrapper before the launch.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
embedding_bag_rows(const int* __restrict__ idx,
                   const float* __restrict__ table, int B, int BAG, int D,
                   int vec, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int* bag = idx + (size_t)b * BAG;
  float* o = out + (size_t)b * D;
  if (vec) {
    const int nv = D >> 2;
    for (int c = lane; c < nv; c += 32) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < BAG; ++j) {
        const float4 t =
            reinterpret_cast<const float4*>(table + (size_t)bag[j] * D)[c];
        acc.x = __fadd_rn(acc.x, t.x);
        acc.y = __fadd_rn(acc.y, t.y);
        acc.z = __fadd_rn(acc.z, t.z);
        acc.w = __fadd_rn(acc.w, t.w);
      }
      reinterpret_cast<float4*>(o)[c] = acc;
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < BAG; ++j)
        acc = __fadd_rn(acc, table[(size_t)bag[j] * D + c]);
      o[c] = acc;
    }
  }
}

}  // namespace

// idx (B, BAG) row-major, every entry in [0, V); table (V, D) and out
// (B, D) row-major. B, D >= 1, BAG >= 0.
extern "C" int embedding_bag(const int* idx, const float* table, int B,
                             int BAG, int D, float* out, void* stream) {
  if (B < 1 || D < 1 || BAG < 0) return (int)cudaErrorInvalidValue;
  const int vec = (D % 4 == 0) && ((uintptr_t)table % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  embedding_bag_rows<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      idx, table, B, BAG, D, vec, out);
  return (int)cudaGetLastError();
}
