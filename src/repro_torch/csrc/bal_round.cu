// bal_round: the two kernels of one balancing round, for Hopper.
//
// bal_scores replaces kernels/bal_round/bal_round.py::bal_scores of the JAX
// package (body _scores_kernel): per vertex the best admissible target block
// (target fits nbw <= nlm - vw, differs from the own block, and in
// restricted mode shares the own block's parent), chosen by the 4-stage
// argmax (max conn -> lightest block -> min h32(label, salt) -> min label),
// the fallback target for rows with no admissible neighbor, and the
// relative gain g >= 0 ? g * cv : g / cv in f32 with cv = max(vw, 1), -inf
// where the vertex must not move.
//
// What bounds it on the H100: memory. It reads the (R, D) slabs once (16 B
// per lane, 20 B restricted) plus seven row columns, with O(deg^2) integer
// compares per row. Design: one warp per row over the R = n_pad + 1 rows,
// lanes own neighbor slots, a 32-slot tile is broadcast by shuffles, padded
// slots are skipped; the tie chain is one lexicographic warp reduction. The
// f32 gain is computed in the reference's op order; this file is built
// without --use_fast_math, so int-to-float conversion rounds to nearest and
// '/' is IEEE division.
//
// greedy_pick replaces kernels/bal_round/bal_round.py::greedy_pick (body
// _pick_kernel): the sequential greedy application of the ranked pool of M
// candidates against the K-entry block-weight table. It is M dependent
// steps, bound by their latency, not by bytes: one block copies bw into the
// output table and one thread walks the pool in order, reading and updating
// the tables in global memory (M = 128 steps touch at most 256 entries, so
// staging them in shared memory would gain nothing and would limit K).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ bool better(int s, int c, int h, int l, int bs,
                                       int bc, int bh, int bl) {
  if (s != bs) return s > bs;
  if (c != bc) return c < bc;
  if (h != bh) return h < bh;
  return l < bl;
}

__global__ void __launch_bounds__(WARPS * 32)
bal_scores_rows(
    const int* __restrict__ nlab, const int* __restrict__ nw,
    const int* __restrict__ nbw, const int* __restrict__ nlm,
    const int* __restrict__ npar, const int* __restrict__ own,
    const int* __restrict__ opar, const int* __restrict__ vw,
    const int* __restrict__ ovr, const int* __restrict__ vld,
    const int* __restrict__ fb_t, const int* __restrict__ fb_ok, int R,
    int D, uint32_t salt, float* __restrict__ rel, int* __restrict__ tgt) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const size_t row = (size_t)r * D;
  const int o = own[r];
  const int v = vw[r];
  const int op = npar ? opar[r] : 0;
  int bs = -1, bc = I32_MAX, bh = I32_MAX, bl = I32_MAX;
  int own_conn = 0;
  for (int j0 = 0; j0 < D; j0 += 32) {
    const int j = j0 + lane;
    const int lj = j < D ? nlab[row + j] : -1;
    if (__ballot_sync(FULL_MASK, lj >= 0) == 0) continue;
    int conn = 0;
    for (int i0 = 0; i0 < D; i0 += 32) {
      const int i = i0 + lane;
      const int li = i < D ? nlab[row + i] : -1;
      const int wi = i < D ? nw[row + i] : 0;
      if (__ballot_sync(FULL_MASK, li >= 0) == 0) continue;
#pragma unroll 8
      for (int s = 0; s < 32; ++s) {
        const int ls = __shfl_sync(FULL_MASK, li, s);
        const int ws = __shfl_sync(FULL_MASK, wi, s);
        if (ls == lj) conn = wadd(conn, ws);
      }
    }
    if (lj >= 0) {
      const int cj = nbw[row + j];
      bool ok = cj <= wsub(nlm[row + j], v) && lj != o;
      if (npar) ok = ok && npar[row + j] == op;
      const int score = ok ? conn : -1;
      const int hj = h32(lj, salt);
      if (better(score, cj, hj, lj, bs, bc, bh, bl)) {
        bs = score; bc = cj; bh = hj; bl = lj;
      }
      if (lj == o) own_conn = wadd(own_conn, nw[row + j]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int s = __shfl_down_sync(FULL_MASK, bs, off);
    const int c = __shfl_down_sync(FULL_MASK, bc, off);
    const int h = __shfl_down_sync(FULL_MASK, bh, off);
    const int l = __shfl_down_sync(FULL_MASK, bl, off);
    if (better(s, c, h, l, bs, bc, bh, bl)) {
      bs = s; bc = c; bh = h; bl = l;
    }
    own_conn = wadd(own_conn, __shfl_down_sync(FULL_MASK, own_conn, off));
  }
  if (lane == 0) {
    const bool has_adj = bs >= 0;
    const int g = has_adj ? wsub(bs, own_conn) : wsub(0, own_conn);
    const bool movable = ovr[r] != 0 && (has_adj || fb_ok[r] != 0) &&
                         vld[r] != 0;
    const float gf = (float)g;
    const float cv = fmaxf((float)v, 1.0f);
    const float rg = g >= 0 ? __fmul_rn(gf, cv) : __fdiv_rn(gf, cv);
    rel[r] = movable ? rg : -INFINITY;
    tgt[r] = has_adj ? bl : fb_t[r];
  }
}

__device__ __forceinline__ int clampk(int x, int K) {
  return x < 0 ? 0 : (x >= K ? K - 1 : x);
}

__global__ void greedy_pick_kernel(const float* vals, const int* tgt_blk,
                                   const int* src_blk, const int* cand_w,
                                   const int* bw_in, const int* lm, int M,
                                   int K, int* accept, int* bw) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) bw[i] = bw_in[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 0; i < M; ++i) {
    const int t = tgt_blk[i], b = src_blk[i], c = cand_w[i];
    const int tc = clampk(t, K), bc = clampk(b, K);
    const bool ok = vals[i] > -INFINITY && bw[bc] > lm[bc] &&
                    bw[tc] <= wsub(lm[tc], c) && t != b;
    if (ok) {
      if (b >= 0 && b < K) bw[b] = wsub(bw[b], c);
      if (t >= 0 && t < K) bw[t] = wadd(bw[t], c);
    }
    accept[i] = ok ? 1 : 0;
  }
}

}  // namespace

// npar / opar == nullptr selects the unrestricted form. Rows are R, slabs
// (R, D) row-major; the per-row columns hold R entries.
extern "C" int bal_scores(const int* nlab, const int* nw, const int* nbw,
                          const int* nlm, const int* npar, const int* own,
                          const int* opar, const int* vw, const int* ovr,
                          const int* vld, const int* fb_t, const int* fb_ok,
                          int R, int D, uint32_t salt, float* rel, int* tgt,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bal_scores_rows<<<(R + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      nlab, nw, nbw, nlm, npar, own, opar, vw, ovr, vld, fb_t, fb_ok, R, D,
      salt, rel, tgt);
  return (int)cudaGetLastError();
}

extern "C" int greedy_pick(const float* vals, const int* tgt_blk,
                           const int* src_blk, const int* cand_w,
                           const int* bw, const int* lm, int M, int K,
                           int* accept, int* bw_out, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  greedy_pick_kernel<<<1, 256, 0, s>>>(vals, tgt_blk, src_blk, cand_w, bw,
                                       lm, M, K, accept, bw_out);
  return (int)cudaGetLastError();
}
