// lp_move: one LP-clustering chunk step over an ELL slab, for Hopper.
//
// Replaces the TPU kernel kernels/lp_move/lp_move.py::lp_move_chunk of the
// JAX package (body _kernel) and computes what it computes: per row the
// label-equality connectivity, admission (host form ncw + vw <= W or the
// distributed form ncw <= nbud - vw), the 4-stage argmax (max conn ->
// lightest cluster -> min h32(label, salt) -> min label); per chunk the
// cluster-weight update and the hash-ordered revert of over-budget movers,
// ranked by (h32(v0 + row, salt ^ 0x9E3779B9), row).
//
// What bounds it on the H100: memory. Phase A reads the (R, D) slabs once
// (12 B per lane, 16 B with nbud) and does O(deg^2) integer compares per
// row, far below the card's integer rate at these degrees. Phase B touches
// O(R) words plus a sort of R (key, row) pairs.
//
// Design. Phase A is one warp per row: each lane owns lanes j = lane,
// lane + 32, ... of the row; a row tile of 32 lanes is broadcast by warp
// shuffles, so conn[j] costs deg^2/32 shuffles per lane and nothing leaves
// registers; padded lanes (label -1) are skipped. The TPU kernel's R x R
// pairwise masks (6.9e10 pairs per chunk at level 0 of a 2^20-vertex graph)
// are replaced by the composed order of core/lp.py: exact int32 atomicAdd
// into label-indexed tables for d_in / d_out / moved-in weight, a bitonic
// sort of the candidates by (target, rank, row), and a segmented scan for
// the cumulative moved-in weight.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

// Lexicographic "better" of the argmax tie chain: higher score, then
// lighter cluster, then smaller hash, then smaller label.
__device__ __forceinline__ bool better(int s, int c, int h, int l, int bs,
                                       int bc, int bh, int bl) {
  if (s != bs) return s > bs;
  if (c != bc) return c < bc;
  if (h != bh) return h < bh;
  return l < bl;
}

__global__ void __launch_bounds__(WARPS * 32)
lp_move_rows(const int* __restrict__ nlab,
                             const int* __restrict__ nw,
                             const int* __restrict__ ncw,
                             const int* __restrict__ nbud,
                             const int* __restrict__ own,
                             const int* __restrict__ vw, int R, int D, int W,
                             uint32_t salt, int* __restrict__ tgt,
                             int* __restrict__ pmove,
                             int* __restrict__ light) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= R) return;  // whole warp leaves together
  const size_t row = (size_t)r * D;
  const int o = own[r];
  const int v = vw[r];
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
      const int cj = ncw[row + j];
      const int wj = nw[row + j];
      const bool stay = lj == o;
      const bool fits = nbud ? (cj <= wsub(nbud[row + j], v))
                             : (wadd(cj, v) <= W);
      const int score = (fits || stay) ? conn : -1;
      const int hj = h32(lj, salt);
      if (better(score, cj, hj, lj, bs, bc, bh, bl)) {
        bs = score; bc = cj; bh = hj; bl = lj;
      }
      if (stay) own_conn = wadd(own_conn, wj);
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
    const bool mv = bs > own_conn && bl != o && bl < I32_MAX && bs > 0;
    tgt[r] = mv ? bl : o;
    pmove[r] = mv ? 1 : 0;
    light[r] = bc;
  }
}

__device__ __forceinline__ void check_label(int x, int num_labels) {
  if (x < 0 || x >= num_labels) __trap();
}

__global__ void lp_move_tally(const int* tgt, const int* pmove,
                              const int* own, const int* vw, int R,
                              int num_labels, int* din, int* dout) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R || !pmove[r]) return;
  check_label(tgt[r], num_labels);
  check_label(own[r], num_labels);
  atomicAdd(&din[tgt[r]], vw[r]);
  atomicAdd(&dout[own[r]], vw[r]);
}

__global__ void lp_move_candidates(const int* tgt, const int* pmove,
                                   const int* light, const int* vw,
                                   const int* din, const int* dout, int R,
                                   int Rp, int W, int v0, uint32_t salt2,
                                   int* newcw, int* movedin, int* moved,
                                   uint64_t* key, int* val) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= Rp) return;
  uint64_t k = ~0ull;
  if (r < R) {
    const int t = tgt[r];
    bool cand = false;
    if (pmove[r]) {
      const int nc = wsub(wadd(light[r], din[t]), dout[t]);
      newcw[r] = nc;
      cand = nc > W;
    }
    moved[r] = pmove[r];
    if (cand) {
      atomicAdd(&movedin[t], vw[r]);
      k = ((uint64_t)(uint32_t)t << 31) | (uint64_t)h32(wadd(v0, r), salt2);
    }
  }
  key[r] = k;
  val[r] = r;
}

__global__ void lp_move_scan_init(const uint64_t* key, const int* val,
                                  const int* vw, int Rp, int* sum,
                                  uint8_t* flag) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Rp) return;
  const uint64_t k = key[p];
  sum[p] = k != ~0ull ? vw[val[p]] : 0;
  flag[p] = p == 0 || (k >> 31) != (key[p - 1] >> 31);
}

__global__ void lp_move_revert(const uint64_t* key, const int* val,
                               const int* within, const int* tgt,
                               const int* newcw, const int* movedin, int Rp,
                               int W, int* moved) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= Rp || key[p] == ~0ull) return;
  const int r = val[p];
  int allowed = wsub(W, wsub(newcw[r], movedin[tgt[r]]));
  allowed = allowed > 0 ? allowed : 0;
  if (within[p] > allowed) moved[r] = 0;
}

}  // namespace

// nbud == nullptr selects the host admission form (fit_sum). Labels in
// own / nlab (and hence targets) must lie in [0, num_labels): the weight
// tables din / dout / movedin hold num_labels ints each and must be zero
// on entry. Rp is R rounded up to a power of two; key / val / sum /
// sum_tmp / flag / flag_tmp hold Rp entries, newcw R.
extern "C" int lp_move_chunk(const int* nlab, const int* nw, const int* ncw,
                             const int* nbud, const int* own, const int* vw,
                             int R, int D, int W, int v0, uint32_t salt,
                             int num_labels, int Rp, int* moved, int* tgt,
                             int* pmove, int* light, int* newcw, int* din,
                             int* dout, int* movedin, uint64_t* key, int* val,
                             int* sum, int* sum_tmp, uint8_t* flag,
                             uint8_t* flag_tmp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  lp_move_rows<<<(R + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      nlab, nw, ncw, nbud, own, vw, R, D, W, salt, tgt, pmove, light);
  lp_move_tally<<<(R + 255) / 256, 256, 0, s>>>(tgt, pmove, own, vw, R,
                                                num_labels, din, dout);
  lp_move_candidates<<<(Rp + 255) / 256, 256, 0, s>>>(
      tgt, pmove, light, vw, din, dout, R, Rp, W, v0, salt ^ 0x9E3779B9u,
      newcw, movedin, moved, key, val);
  cudaError_t err = bitonic_sort(key, val, Rp, s);
  if (err != cudaSuccess) return (int)err;
  lp_move_scan_init<<<(Rp + 255) / 256, 256, 0, s>>>(key, val, vw, Rp, sum,
                                                      flag);
  err = seg_scan(sum, flag, sum_tmp, flag_tmp, Rp, false, s);
  if (err != cudaSuccess) return (int)err;
  lp_move_revert<<<(Rp + 255) / 256, 256, 0, s>>>(key, val, sum, tgt, newcw,
                                                  movedin, Rp, W, moved);
  return (int)cudaGetLastError();
}
