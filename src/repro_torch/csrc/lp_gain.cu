// lp_gain: the label-propagation gain over ELL rows, for Hopper.
//
// Replaces kernels/lp_gain/lp_gain.py::lp_gain_ell of the JAX package (body
// _kernel). Per row r of the (N, D) slab: conn[j] = sum_i w[i] * [lab[i] ==
// lab[j]], a lane fits if it is valid (lab >= 0), leaves the own label and
// tgt_w[j] + vw[r] <= budget; best = max_j (fits ? conn[j] : -1), target =
// the smallest label among the fitting maximisers (-1 when best < 0), and
// own_conn = sum of w over the valid lanes carrying the own label.
//
// What bounds it on the H100: memory. The f32 sums are exact while they
// stay integer-valued below 2^24, so any summation order gives the plain
// version's bits. The TPU kernel builds a D x D equality matrix per row and
// contracts it on the MXU; that does not carry over. Design: one warp per
// row (like bal_scores), lanes own neighbour slots, a 32-slot tile of
// (label, weight) is broadcast by shuffles and each lane adds the weights
// that match its label in lane order; tiles without a valid lane are
// skipped (a -1 lane never matches a valid label), and w / tgt_w are read
// only for valid lanes. The (score, label) maximum is one lexicographic
// warp reduction; own_conn a warp sum. Built without --use_fast_math, so
// the add of the budget test rounds to nearest as the plain version's.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int BIG = 1 << 30;   // the reference's "no maximiser" label

// (s, l) before (bs, bl): the larger score, then the smaller label
__device__ __forceinline__ bool gain_better(float s, int l, float bs,
                                            int bl) {
  return s > bs || (s == bs && l < bl);
}

__global__ void __launch_bounds__(WARPS * 32)
lp_gain_rows(const int* __restrict__ lab, const float* __restrict__ w,
             const float* __restrict__ tgt_w, const int* __restrict__ own,
             const float* __restrict__ vw, const float* __restrict__ budget,
             int N, int D, float* __restrict__ best,
             int* __restrict__ target, float* __restrict__ own_conn) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= N) return;
  const size_t row = (size_t)r * D;
  const int o = own[r];
  const float v = vw[r];
  const float cap = budget[0];
  // every lane j < D scores: (conn, label) if it fits, else (-1, BIG)
  float bs = -INFINITY;
  int bl = BIG;
  float oc = 0.0f;
  for (int j0 = 0; j0 < D; j0 += 32) {
    const int j = j0 + lane;
    const int lj = j < D ? lab[row + j] : -1;
    if (__ballot_sync(FULL_MASK, lj >= 0) == 0) {
      if (j < D && gain_better(-1.0f, BIG, bs, bl)) {
        bs = -1.0f;
        bl = BIG;
      }
      continue;
    }
    float conn = 0.0f;
    for (int i0 = 0; i0 < D; i0 += 32) {
      const int i = i0 + lane;
      const int li = i < D ? lab[row + i] : -1;
      if (__ballot_sync(FULL_MASK, li >= 0) == 0) continue;
      const float wi = li >= 0 ? w[row + i] : 0.0f;
#pragma unroll 8
      for (int s = 0; s < 32; ++s) {
        const int ls = __shfl_sync(FULL_MASK, li, s);
        const float ws = __shfl_sync(FULL_MASK, wi, s);
        if (ls == lj) conn = __fadd_rn(conn, ws);
      }
    }
    if (j < D) {
      float s = -1.0f;
      int l = BIG;
      if (lj >= 0) {
        if (lj == o) {
          oc = __fadd_rn(oc, w[row + j]);
        } else if (__fadd_rn(tgt_w[row + j], v) <= cap) {
          s = conn;
          l = lj;
        }
      }
      if (gain_better(s, l, bs, bl)) {
        bs = s;
        bl = l;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_down_sync(FULL_MASK, bs, off);
    const int l = __shfl_down_sync(FULL_MASK, bl, off);
    if (gain_better(s, l, bs, bl)) {
      bs = s;
      bl = l;
    }
    oc = __fadd_rn(oc, __shfl_down_sync(FULL_MASK, oc, off));
  }
  if (lane == 0) {
    best[r] = bs;
    target[r] = bs >= 0.0f ? bl : -1;
    own_conn[r] = oc;
  }
}

}  // namespace

// Slabs (N, D) row-major, the per-row columns N entries, budget one f32 on
// the device. N >= 1, D >= 1.
extern "C" int lp_gain_ell(const int* lab, const float* w,
                           const float* tgt_w, const int* own,
                           const float* vw, const float* budget, int N,
                           int D, float* best, int* target, float* own_conn,
                           void* stream) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  lp_gain_rows<<<(N + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      lab, w, tgt_w, own, vw, budget, N, D, best, target, own_conn);
  return (int)cudaGetLastError();
}
