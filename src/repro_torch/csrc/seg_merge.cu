// seg_merge: segmented sort + duplicate-arc merge, for Hopper.
//
// Replaces kernels/seg_merge/seg_merge.py::seg_merge of the JAX package and
// computes what it computes: (src, dst) int32 records with w as payload are
// sorted by (src, dst), each record gets a run-start flag and the total
// weight of its equal-key run. Invalid records carry src = dst = I32_MAX,
// w = 0 and sort to the tail.
//
// What bounds it on the H100: memory. A merge must read 12 B and write 16 B
// per record; a sort moves each record O(log^2 L) times. At level 0 of a
// 2^20-vertex rgg2d graph L is 2.2 million records (8.4 million before
// self loops drop), far beyond one block, so the TPU kernel's single
// resident bitonic network cannot carry over.
// Design: the key packs (src, dst) into one order-preserving uint64; a
// bitonic sort runs its short-distance stages in shared memory (2048-record
// tiles) and each long-distance stage as one global pass. The sort is not
// stable, but equal keys are exactly the records that merge, so no output
// depends on their order. Run totals come from forward and backward
// segmented scans: tot = fwd + bwd - w.
#include "common.cuh"

namespace {

__global__ void pack_keys(const int* src, const int* dst, const int* w,
                          int L, uint64_t* key, int* val) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  key[i] = ((uint64_t)ord32(src[i]) << 32) | (uint64_t)ord32(dst[i]);
  val[i] = w[i];
}

__global__ void unpack_runs(const uint64_t* key, const int* val, int L,
                            int* s_src, int* s_dst, int* first, int* fsum,
                            uint8_t* fflag, int* bsum, uint8_t* bflag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const uint64_t k = key[i];
  const bool f = i == 0 || k != key[i - 1];
  const bool e = i == L - 1 || k != key[i + 1];
  s_src[i] = (int)((uint32_t)(k >> 32) ^ 0x80000000u);
  s_dst[i] = (int)((uint32_t)k ^ 0x80000000u);
  first[i] = f ? 1 : 0;
  fsum[i] = val[i];
  fflag[i] = f;
  bsum[i] = val[i];
  bflag[i] = e;
}

__global__ void run_totals(const int* fsum, const int* bsum, const int* val,
                           int L, int* tot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  tot[i] = wsub(wadd(fsum[i], bsum[i]), val[i]);
}

}  // namespace

// L is a power of two >= 2 (the caller pads with I32_MAX keys, w = 0).
// key / val / fsum / bsum / tmp / flag_tmp hold L entries, flags 2 * L.
extern "C" int seg_merge(const int* src, const int* dst, const int* w, int L,
                         int* s_src, int* s_dst, int* tot, int* first,
                         uint64_t* key, int* val, int* fsum, int* bsum,
                         int* tmp, uint8_t* flags, uint8_t* flag_tmp,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (L + 255) / 256;
  pack_keys<<<blocks, 256, 0, s>>>(src, dst, w, L, key, val);
  cudaError_t err = bitonic_sort(key, val, L, s);
  if (err != cudaSuccess) return (int)err;
  unpack_runs<<<blocks, 256, 0, s>>>(key, val, L, s_src, s_dst, first, fsum,
                                     flags, bsum, flags + L);
  err = seg_scan(fsum, flags, tmp, flag_tmp, L, false, s);
  if (err != cudaSuccess) return (int)err;
  err = seg_scan(bsum, flags + L, tmp, flag_tmp, L, true, s);
  if (err != cudaSuccess) return (int)err;
  run_totals<<<blocks, 256, 0, s>>>(fsum, bsum, val, L, tot);
  return (int)cudaGetLastError();
}
