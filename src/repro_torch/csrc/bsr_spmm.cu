// bsr_spmm: Y = A X with A in padded block-sparse-row form, for Hopper.
//
// Replaces kernels/bsr_spmm/bsr_spmm.py::bsr_spmm of the JAX package (body
// _kernel): block row r of Y (BS rows) is the sum over its NNZ slots s of
// vals[r * NNZ + s] (a dense BS x BS block) times the BS rows of X at
// column block col[r * NNZ + s]. Padded slots point at column block 0 with
// all-zero values and are multiplied like the others, as the reference
// does, so a non-finite X value reaches Y the same way.
//
// What bounds it on the H100: the bytes of the dense blocks (each read
// once), and the block products, 2 BS^2 F flops a slot, beyond the f32
// CUDA-core rate. Design:
//
// * One CTA per block row owns a 128 x 128 tile of Y in registers across
//   all NNZ slots and writes it once; wider F loops over column tiles
//   inside the CTA (the X blocks shared by neighbouring block rows come
//   from L2). At F <= 128 each vals block crosses HBM once.
// * Each slot streams in 32-deep K slices through a 2-stage ring in
//   dynamic shared memory filled by cp.async, so slice k+1 (or the next
//   slot's first slice) loads while slice k is multiplied; two CTAs share
//   an SM. Rows are padded (A by 4 floats, X by 8) so the fragment loads
//   are free of bank conflicts.
// * Products on the tensor cores in error-compensated TF32 ("3xTF32"):
//   each operand is split into hi = tf32(v) and lo = tf32(v - hi), both
//   rounded to nearest, ties away (cvt.rna's rounding, done by two integer
//   operations), and a_lo x_hi + a_hi x_lo + a_hi x_hi are summed with
//   mma.sync m16n8k8. The dropped a_lo x_lo and the rounding of lo leave
//   about 2^-21 of each product. Each mma rounds its sum toward zero at
//   the scale of its largest addend, so the three products of an 8-deep
//   step sum in a fresh f32 value and reach the Y tile by one add,
//   rounded to nearest. Chained onto the Y tile, they cost three
//   truncations a step at |Y|'s scale, several times f32's error.
// * Once a slice has landed, each warp scans a share of it once and
//   flags every 16 x 8 sub-tile of A that holds a nonzero or a value the
//   split cannot take (not finite, or beyond 2^60, where a split product
//   could overflow), and every 8-deep row group of X with such a value.
//   The split breaks non-finite values (inf - inf is NaN; 0 x inf in the
//   a_lo x_hi term is NaN where the plain version gives inf), so a
//   flagged sub-tile, and every sub-tile of a flagged depth of X, is
//   multiplied in exact f32 fmaf into the same accumulators, in the same
//   fragment layout.
// * A sub-tile of A that is all zero is skipped when its depth of X is
//   finite: a 0 x finite product adds a signed zero, which never changes
//   an accumulator that starts at +0 and never becomes -0. Graph blocks
//   are mostly zeros (grid2d: 4.19 M nonzeros among 637 M entries, 10%
//   of the sub-tiles), so the time depends on the data. A warp's four m16
//   tiles are every other one (warp rows 0 and 1 interleave), so a
//   slice's band of nonzeros near the diagonal keeps all eight warps at
//   work.
//
// Any F is taken (the ragged column tile is masked) and any BS up to 128
// (rows and K beyond BS are zero-filled); BS and F multiples of 4 load 16
// bytes a copy, other shapes 4.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TM = 128;        // rows of a Y tile: the largest BS
constexpr int TN = 128;        // columns of a Y tile
constexpr int TK = 32;         // depth of one K slice
constexpr int STAGES = 2;      // K slices in the ring
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns) of 64 x 32
constexpr int A_LD = TK + 4;   // padded row strides, in floats
constexpr int X_LD = TN + 8;
constexpr int A_STAGE = TM * A_LD;
constexpr int X_STAGE = TK * X_LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + X_STAGE) * 4;
constexpr float SPLIT_MAX = 0x1p60f;   // beyond: exact f32

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 for a finite v whose rounding does not overflow: half
// of the 13 dropped bits added to the sign-magnitude pattern, then the 13
// bits cleared, which rounds the magnitude to nearest, ties away. Two
// integer operations; sm_90 compiles cvt.rna.tf32.f32 to a longer
// sequence.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo + (at most 2^-22 |v|): the kernel only splits values up to
// SPLIT_MAX, so neither rounding overflows
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a b, one m16n8k8 TF32 product: a row-major 16 x 8, b col-major 8 x 8
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage K slice [k0, k0 + TK) of block A (BS x BS) and of the BS x F rows
// X, columns [f0, f0 + TN), zero-filled beyond BS and F.
template <bool VEC>
__device__ __forceinline__ void load_slice(float* As, float* Xs,
                                           const float* A, const float* X,
                                           int k0, int BS, int F, int f0) {
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int e = tid; e < TM * TK / 4; e += THREADS) {
      const int i = e / (TK / 4), c = e % (TK / 4) * 4, k = k0 + c;
      const bool ok = i < BS && k < BS;
      cp_async16(As + i * A_LD + c, ok ? A + (size_t)i * BS + k : A, ok);
    }
#pragma unroll
    for (int e = tid; e < TK * TN / 4; e += THREADS) {
      const int kk = e / (TN / 4), c = e % (TN / 4) * 4;
      const int k = k0 + kk, f = f0 + c;
      const bool ok = k < BS && f < F;
      cp_async16(Xs + kk * X_LD + c, ok ? X + (size_t)k * F + f : X, ok);
    }
  } else {
    for (int e = tid; e < TM * TK; e += THREADS) {
      const int i = e / TK, c = e % TK, k = k0 + c;
      const bool ok = i < BS && k < BS;
      cp_async4(As + i * A_LD + c, ok ? A + (size_t)i * BS + k : A, ok);
    }
    for (int e = tid; e < TK * TN; e += THREADS) {
      const int kk = e / TN, c = e % TN, k = k0 + kk, f = f0 + c;
      const bool ok = k < BS && f < F;
      cp_async4(Xs + kk * X_LD + c, ok ? X + (size_t)k * F + f : X, ok);
    }
  }
}

// Flags of one staged K slice, one byte a warp: warp w scans m16 tile w of
// the A slice (rows 16w .. 16w + 15, 4 float4 a lane) and sets bit k8 of
// fa[w] if its 16 x 8 sub-tile at depth 8 k8 holds a nonzero, bit 4 + k8
// if it holds a value that does not split; and rows 4w .. 4w + 3 of the
// X slice (depth 8 (w / 2) ..), setting fx[w] if one of them does not
// split. Each warp writes only its own bytes, so nothing is zeroed.
__device__ __forceinline__ void scan_slice(const float* As, const float* Xs,
                                           unsigned char* fa,
                                           unsigned char* fx, int warp,
                                           int lane) {
  // on magnitudes as integers: nonzero if any is above 0; does not split
  // if any is above SPLIT_MAX's (inf and NaN are)
  unsigned amax = 0, xmax = 0;
  bool nz = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = j * 32 + lane;
    const uint4 v = *reinterpret_cast<const uint4*>(
        As + (16 * warp + q / 8) * A_LD + q % 8 * 4);
    const unsigned m = max(max(v.x & 0x7FFFFFFFu, v.y & 0x7FFFFFFFu),
                           max(v.z & 0x7FFFFFFFu, v.w & 0x7FFFFFFFu));
    amax = max(amax, m);
    nz = nz || m != 0u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        Xs + (4 * warp + j) * X_LD + lane * 4);
    xmax = max(xmax, max(max(v.x & 0x7FFFFFFFu, v.y & 0x7FFFFFFFu),
                         max(v.z & 0x7FFFFFFFu, v.w & 0x7FFFFFFFu)));
  }
  const unsigned split_max = __float_as_uint(SPLIT_MAX);
  const unsigned nzb = __ballot_sync(FULL_MASK, nz);
  const unsigned badb = __ballot_sync(FULL_MASK, amax > split_max);
  const bool xbad = __any_sync(FULL_MASK, xmax > split_max);
  if (lane == 0) {
    unsigned byte = 0;
#pragma unroll
    for (int k8 = 0; k8 < 4; ++k8) {   // lane's depth: (lane & 7) >> 1
      const unsigned lanes = 0x03030303u << (2 * k8);
      byte |= (nzb & lanes ? 1u : 0u) << k8;
      byte |= (badb & lanes ? 16u : 0u) << k8;
    }
    fa[warp] = (unsigned char)byte;
    fx[warp] = (unsigned char)xbad;
  }
}

// The warp's 64 x 32 share of one staged K slice: m16 tiles 2 mt + wm
// (mt < 4) and columns wn.. of the tile; acc[mt][nt] is the m16n8 tile
// (mt, nt) in mma's C layout (rows g and g + 8, columns 2t and 2t + 1).
// fa / fx: the slice's flags.
__device__ __forceinline__ void multiply_slice(float (&acc)[4][4][4],
                                               const float* As,
                                               const float* Xs, uint64_t fa,
                                               uint64_t fx, int kmax,
                                               int mmax, int nmax, int wm,
                                               int wn, int g, int t) {
  // byte mt: the flags of m16 tile 2 mt + wm
  const unsigned mine = __byte_perm((unsigned)fa, (unsigned)(fa >> 32),
                                    wm ? 0x7531 : 0x6420);
#pragma unroll 1
  for (int k8 = 0; k8 < TK / 8; ++k8) {
    const int kk = 8 * k8;
    if (kk >= kmax) break;
    const unsigned nzm = mine >> k8 & 0x01010101u;
    unsigned badm = mine >> (4 + k8) & 0x01010101u;   // bit 8 mt: tile mt
    if ((fx >> (16 * k8)) & 0xFFFFu)
      badm = 0x01010101u;            // every product of this depth: exact
    if ((nzm | badm) == 0) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int m0 = (2 * mt + wm) * 16;
      if (m0 >= mmax) break;
      if (badm >> (8 * mt) & 1u) {   // a value that does not split: f32
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float a0 = As[(m0 + g) * A_LD + kk + q];
          const float a1 = As[(m0 + g + 8) * A_LD + kk + q];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float* px = Xs + (kk + q) * X_LD + wn + nt * 8 + 2 * t;
            float(&c)[4] = acc[mt][nt];
            c[0] = fmaf(a0, px[0], c[0]);
            c[1] = fmaf(a0, px[1], c[1]);
            c[2] = fmaf(a1, px[0], c[2]);
            c[3] = fmaf(a1, px[1], c[3]);
          }
        }
      } else if (nzm >> (8 * mt) & 1u) {
        const float* pa = As + (m0 + g) * A_LD + kk + t;
        uint32_t ah[4], al[4];
        split(pa[0], ah[0], al[0]);
        split(pa[8 * A_LD], ah[1], al[1]);
        split(pa[4], ah[2], al[2]);
        split(pa[8 * A_LD + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (wn + nt * 8 >= nmax) break;
          const float* pb = Xs + (kk + t) * X_LD + wn + nt * 8 + g;
          uint32_t bh[2], bl[2];
          split(pb[0], bh[0], bl[0]);
          split(pb[4 * X_LD], bh[1], bl[1]);
          float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(s, al, bh);    // the small products first
          mma_tf32(s, ah, bl);
          mma_tf32(s, ah, bh);
          float(&c)[4] = acc[mt][nt];
#pragma unroll
          for (int q = 0; q < 4; ++q) c[q] += s[q];
        }
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
bsr_spmm_rows(const int* __restrict__ col, const float* __restrict__ vals,
              const float* __restrict__ x, int NNZ, int BS, int F,
              float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;
  float* const Xs = smem + STAGES * A_STAGE;
  __shared__ __align__(8) unsigned char flags[STAGES][2][8];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = (warp & 3) * 32;
  const int slices = (BS + TK - 1) / TK;       // K slices a slot
  const int steps = NNZ * slices;
  const int* const cols = col + (size_t)r * NNZ;
  for (int f0 = 0; f0 < F; f0 += TN) {
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
    // stage `step`, whose slot's column block is c
    auto fill = [&](int step, int c) {
      if (step < steps) {
        const int stage = step % STAGES;
        load_slice<VEC>(As + stage * A_STAGE, Xs + stage * X_STAGE,
                        vals + ((size_t)r * NNZ + step / slices) * BS * BS,
                        x + (size_t)c * BS * F, step % slices * TK, BS, F,
                        f0);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p)
      fill(p, p < steps ? cols[p / slices] : 0);
    // the column block of the next slice to stage, read a step ahead
    int next = STAGES - 1 < steps ? cols[(STAGES - 1) / slices] : 0;
    for (int step = 0; step < steps; ++step) {
      const int stage = step % STAGES;
      cp_async_wait<STAGES - 2>();
      __syncthreads();     // slice `step` is in; slice step - 1 is used up
      fill(step + STAGES - 1, next);
      if (step + STAGES < steps) next = cols[(step + STAGES) / slices];
      scan_slice(As + stage * A_STAGE, Xs + stage * X_STAGE,
                 flags[stage][0], flags[stage][1], warp, lane);
      __syncthreads();     // the slice's flags are in
      multiply_slice(
          acc, As + stage * A_STAGE, Xs + stage * X_STAGE,
          *reinterpret_cast<const uint64_t*>(flags[stage][0]),
          *reinterpret_cast<const uint64_t*>(flags[stage][1]),
          BS - step % slices * TK, BS, F - f0, wm, wn, g, t);
    }
    cp_async_wait<0>();
    __syncthreads();       // the ring is free for the next column tile
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (2 * mt + wm) * 16 + g + 8 * h;
        if (i >= BS) continue;
        float* yr = y + ((size_t)r * BS + i) * F;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int f = f0 + wn + nt * 8 + 2 * t;
          const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if ((F & 1) == 0) {
            if (f < F) *reinterpret_cast<float2*>(yr + f) = make_float2(v0, v1);
          } else {
            if (f < F) yr[f] = v0;
            if (f + 1 < F) yr[f + 1] = v1;
          }
        }
      }
    }
  }
}

template <bool VEC>
int launch(const int* col, const float* vals, const float* x, int RB,
           int NNZ, int BS, int F, float* y, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        bsr_spmm_rows<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bsr_spmm_rows<VEC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  bsr_spmm_rows<VEC>
      <<<(unsigned)RB, THREADS, SMEM_BYTES, s>>>(col, vals, x, NNZ, BS, F, y);
  return (int)cudaGetLastError();
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
  const bool vec = BS % 4 == 0 && F % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(vals) |
                    reinterpret_cast<uintptr_t>(x)) % 16 == 0;
  return vec ? launch<true>(col, vals, x, RB, NNZ, BS, F, y, s)
             : launch<false>(col, vals, x, RB, NNZ, BS, F, y, s);
}
