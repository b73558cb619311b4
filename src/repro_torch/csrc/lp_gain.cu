// lp_gain: the label-propagation gain over ELL rows, for Hopper.
//
// Replaces kernels/lp_gain/lp_gain.py::lp_gain_ell of the JAX package (body
// _kernel). Per row r of the (N, D) slab: conn[j] = sum_i w[i] * [lab[i] ==
// lab[j]], a lane fits if it is valid (lab >= 0), leaves the own label and
// tgt_w[j] + vw[r] <= budget; best = max_j (fits ? conn[j] : -1), target =
// the smallest label among the fitting maximisers (-1 when best < 0), and
// own_conn = sum of w over the valid lanes carrying the own label.
//
// What bounds it on the H100: memory, and the count of a warp's steps for
// the few valid lanes of a row (about 8 of 32 on rgg2d). The f32 sums are
// exact while they stay integer-valued below 2^24, so any summation order
// gives the plain version's bits. The TPU kernel builds a D x D equality
// matrix per row and contracts it on the MXU; that does not carry over.
// Design: one warp per row, rows padded to a warp's 32 lanes by the entry
// point (not the TPU's 128). Each lane loads its lanes of the row once into
// registers (T 32-lane tiles, T = ceil(D / 32) up to 4) with one ballot of
// the valid lanes a tile, and forms the connectivity by walking only the
// set bits of those ballots, in lane order: one shuffle of (label, weight)
// a valid lane, each lane adding the weights that match its own labels.
// w and tgt_w are read only for valid lanes. A warp takes two rows at
// T = 1 and starts both rows' loads before it uses either. own_conn is the
// connectivity of any lane carrying the own label (the same sum), so it
// needs no reduction of its own; the (score, label) maximum is two redux
// instructions over an order-preserving int key of the score. Rows wider
// than 128 lanes keep 128 in registers at a time and walk the row's tiles
// from memory (L1) for each group. Built without --use_fast_math, so the
// add of the budget test rounds to nearest as the plain version's.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int BIG = 1 << 30;   // the reference's "no maximiser" label
constexpr int MAX_TILES = 4;   // 32-lane tiles a lane holds in registers

// Order-preserving map of an f32 that is not NaN to an int32 (the larger
// float, the larger int; -0 never occurs: conn sums start at +0), and back.
__device__ __forceinline__ int score_key(float s) {
  const int b = __float_as_int(s);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float key_score(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// Add the weight of every valid lane of one 32-lane tile (ballot `m`,
// labels `li`, weights `wi`) to the conn[q] whose label matches, in lane
// order: one shuffle step a valid lane.
template <int T>
__device__ __forceinline__ void walk(unsigned m, int li, float wi,
                                     const int (&lj)[T], float (&conn)[T]) {
  while (m) {
    const int s = __ffs(m) - 1;
    m &= m - 1;
    const int ls = __shfl_sync(FULL_MASK, li, s);
    const float ws = __shfl_sync(FULL_MASK, wi, s);
#pragma unroll
    for (int q = 0; q < T; ++q)
      if (ls == lj[q]) conn[q] = __fadd_rn(conn[q], ws);
  }
}

// R rows of T tiles each, one warp: the R rows' loads all start before
// any of them is used, so a warp keeps R rows' memory requests in flight.
template <int T, int R>
__global__ void __launch_bounds__(WARPS * 32)
lp_gain_rows(const int* __restrict__ lab, const float* __restrict__ w,
             const float* __restrict__ tgt_w, const int* __restrict__ own,
             const float* __restrict__ vw, const float* __restrict__ budget,
             int N, int D, float* __restrict__ best,
             int* __restrict__ target, float* __restrict__ own_conn) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * R;
  if (r0 >= N) return;
  const float cap = budget[0];
  int o[R];
  float v[R];
#pragma unroll
  for (int p = 0; p < R; ++p) {
    const int r = min(r0 + p, N - 1);     // a row past N repeats the last
    o[p] = own[r];
    v[p] = vw[r];
  }
  // the lane's best candidate (score key, then smallest label) and the
  // row's own connectivity, once a lane carrying the own label is met
  int bk[R], bl[R];
  float oc[R];
  bool found[R];
#pragma unroll
  for (int p = 0; p < R; ++p) {
    bk[p] = INT_MIN;
    bl[p] = BIG;
    oc[p] = 0.0f;
    found[p] = false;
  }
  for (int j0 = 0; j0 < D; j0 += T * 32) {
    int lj[R][T];
    float wj[R][T], tw[R][T], conn[R][T];
    unsigned vm[R][T];
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const size_t row = (size_t)min(r0 + p, N - 1) * D;
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const int j = j0 + q * 32 + lane;
        lj[p][q] = j < D ? lab[row + j] : -1;
      }
    }
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const size_t row = (size_t)min(r0 + p, N - 1) * D + j0 + lane;
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const int l = lj[p][q];
        vm[p][q] = __ballot_sync(FULL_MASK, l >= 0);
        wj[p][q] = l >= 0 ? w[row + q * 32] : 0.0f;
        tw[p][q] = l >= 0 && l != o[p] ? tgt_w[row + q * 32] : 0.0f;
        conn[p][q] = 0.0f;
      }
    }
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const size_t row = (size_t)min(r0 + p, N - 1) * D;
      if (D <= T * 32) {           // the whole row is in registers
#pragma unroll
        for (int t = 0; t < T; ++t)
          walk<T>(vm[p][t], lj[p][t], wj[p][t], lj[p], conn[p]);
      } else {
        for (int i0 = 0; i0 < D; i0 += 32) {
          const int i = i0 + lane;
          const int li = i < D ? lab[row + i] : -1;
          const unsigned m = __ballot_sync(FULL_MASK, li >= 0);
          walk<T>(m, li, li >= 0 ? w[row + i] : 0.0f, lj[p], conn[p]);
        }
      }
#pragma unroll
      for (int q = 0; q < T; ++q) {
        const int l = lj[p][q];
        // a lane with the own label holds own_conn in its conn
        const unsigned mine = __ballot_sync(FULL_MASK, l >= 0 && l == o[p]);
        if (mine && !found[p]) {
          oc[p] = __shfl_sync(FULL_MASK, conn[p][q], __ffs(mine) - 1);
          found[p] = true;
        }
        if (j0 + q * 32 + lane >= D) continue;
        const bool fits = l >= 0 && l != o[p] &&
                          __fadd_rn(tw[p][q], v[p]) <= cap;
        const int k = score_key(fits ? conn[p][q] : -1.0f);
        const int kl = fits ? l : BIG;
        if (k > bk[p] || (k == bk[p] && kl < bl[p])) {
          bk[p] = k;
          bl[p] = kl;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < R; ++p) {
    const int kmax = __reduce_max_sync(FULL_MASK, bk[p]);
    const int lmin = (int)__reduce_min_sync(
        FULL_MASK, bk[p] == kmax ? (unsigned)bl[p] : (unsigned)BIG);
    if (lane == 0 && r0 + p < N) {
      const float bs = key_score(kmax);
      best[r0 + p] = bs;
      target[r0 + p] = bs >= 0.0f ? lmin : -1;
      own_conn[r0 + p] = oc[p];
    }
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
  const int tiles = (D + 31) / 32;
  const int rows = tiles == 1 ? 2 : 1;     // rows a warp
  const int per_cta = WARPS * rows;
  const unsigned grid = (unsigned)((N + per_cta - 1) / per_cta);
  auto kernel = tiles == 1 ? lp_gain_rows<1, 2>
                : tiles == 2 ? lp_gain_rows<2, 1>
                : tiles == 3 ? lp_gain_rows<3, 1>
                             : lp_gain_rows<MAX_TILES, 1>;
  kernel<<<grid, WARPS * 32, 0, s>>>(lab, w, tgt_w, own, vw, budget, N, D,
                                     best, target, own_conn);
  return (int)cudaGetLastError();
}
