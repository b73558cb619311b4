// bsr_spmm: Y = A X with A in padded block-sparse-row form, for Hopper.
//
// Replaces kernels/bsr_spmm/bsr_spmm.py::bsr_spmm of the JAX package (body
// _kernel): block row r of Y (BS rows) is the sum over its NNZ slots s of
// vals[r * NNZ + s] (a dense BS x BS block) times the BS rows of X at
// column block col[r * NNZ + s]. Padded slots point at column block 0 with
// all-zero values and are multiplied like the others, as the reference
// does, so a non-finite X value reaches Y the same way.
//
// What bounds it on the H100: the dense block products, 2 BS^2 F flops per
// slot, in IEEE f32 on the CUDA cores (no TF32 mma: the reference's
// tolerance is 1e-5). The TPU kernel revisits its output once per slot;
// here one CTA owns a (block row, 64-column) tile of Y, keeps it in
// registers across all NNZ slots and writes it once. Each slot is streamed
// in 32-deep K slices: the 128 x 32 slice of the A block (rows padded to
// one word to keep the stores free of bank conflicts) and the 32 x 64
// slice of X sit in shared memory (24 KB), and each of the 256 threads
// accumulates an 8 x 4 register tile with fmaf. Any F is taken (the ragged
// column tile is masked) and any BS up to 128 (rows and K beyond BS are
// zero-filled).
#include "common.cuh"

namespace {

constexpr int TM = 128;       // rows of a Y tile: the largest BS
constexpr int TF = 64;        // columns of a Y tile
constexpr int TK = 32;        // depth of one K slice
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
bsr_spmm_tiles(const int* __restrict__ col, const float* __restrict__ vals,
               const float* __restrict__ x, int NNZ, int BS, int F,
               float* __restrict__ y) {
  __shared__ float As[TM][TK + 1];
  __shared__ __align__(16) float Xs[TK][TF];
  const int r = blockIdx.x;
  const int f0 = blockIdx.y * TF;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;

  for (int s = 0; s < NNZ; ++s) {
    const size_t slot = (size_t)r * NNZ + s;
    const float* A = vals + slot * BS * BS;
    const float* X = x + (size_t)col[slot] * BS * F;
    for (int k0 = 0; k0 < BS; k0 += TK) {
      for (int e = tid; e < TM * TK; e += THREADS) {
        const int i = e / TK, kk = e % TK, k = k0 + kk;
        As[i][kk] = (i < BS && k < BS) ? A[(size_t)i * BS + k] : 0.0f;
      }
      for (int e = tid; e < TK * TF; e += THREADS) {
        const int kk = e / TF, cc = e % TF, k = k0 + kk, f = f0 + cc;
        Xs[kk][cc] = (k < BS && f < F) ? X[(size_t)k * F + f] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TK; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(&Xs[kk][tx * 4]);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float a = As[ty * 8 + m][kk];
          acc[m][0] = fmaf(a, b.x, acc[m][0]);
          acc[m][1] = fmaf(a, b.y, acc[m][1]);
          acc[m][2] = fmaf(a, b.z, acc[m][2]);
          acc[m][3] = fmaf(a, b.w, acc[m][3]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = ty * 8 + m;
    if (i >= BS) continue;
    float* yr = y + ((size_t)r * BS + i) * F;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = f0 + tx * 4 + c;
      if (f < F) yr[f] = acc[m][c];
    }
  }
}

}  // namespace

// col (RB * NNZ) column-block ids, each below x's CB = rows / BS; vals
// (RB * NNZ, BS, BS) and x (CB * BS, F) row-major; y (RB * BS, F).
// RB, F >= 1, 1 <= BS <= 128.
extern "C" int bsr_spmm(const int* col, const float* vals, const float* x,
                        int RB, int NNZ, int BS, int F, float* y,
                        void* stream) {
  if (RB < 1 || F < 1 || BS < 1 || BS > TM || NNZ < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)RB, (unsigned)((F + TF - 1) / TF));
  bsr_spmm_tiles<<<grid, THREADS, 0, s>>>(col, vals, x, NNZ, BS, F, y);
  return (int)cudaGetLastError();
}
