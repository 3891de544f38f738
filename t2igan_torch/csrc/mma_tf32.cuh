// Helpers shared by the f32 memory-read kernels (memory_read.cu, forward;
// memory_read_bwd.cu, backward) and the f32 fused tail (reschain.cu): f32
// products on the TF32 tensor cores at f32 accuracy ("3xTF32"), for sm_80
// and later (built for sm_90a).
//
// 3xTF32.  Every f32 operand x is split into hi = tf32_rna(x) and
// lo = tf32_rna(x - hi) (10 mantissa bits, ties away from zero, as
// cvt.rna.tf32.f32 rounds), so x = hi + lo up to 2^-22 |x|.  A product
// a b is taken as al bh + ah bl + ah bh on mma.sync m16n8k8 (TF32 in, f32
// accumulators); the dropped al bl is below 2^-22 |a b|.  Each term of a
// sum is then off by up to 3 * 2^-22 of its magnitude, about what f32
// rounding in a sum of a few terms costs, where one TF32 product would be
// off by 2^-11.
//
// Fragment maps of mma.sync.m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major) a[0]: (g, t)   a[1]: (g+8, t)
//                         a[2]: (g, t+4) a[3]: (g+8, t+4)
//   B (8 x 8, "col")      b[0]: (k t, n g)   b[1]: (k t+4, n g)
//   C (16 x 8, f32)       c[0..1]: (g, 2t..2t+1)   c[2..3]: (g+8, 2t..2t+1)
// A C fragment does not have the A layout (lane t holds columns 2t, 2t+1,
// where A wants t, t+4).  Where a product's result feeds the next product
// from registers (P in O = P V, ds in dq = ds K), the k index of that
// product is permuted instead: k = t stands for column 2t and k = t + 4 for
// 2t + 1, in A and in B alike, so the sum is the same and the A fragment is
// {c[0], c[2], c[1], c[3]}.  B then reads rows 2t and 2t + 1 of its tile.
//
// Shared-memory tiles are row-major f32 with a row stride of width + 4
// floats (widths are multiples of 16, so the stride is 4 mod 8).  ldmatrix
// moves 16-bit elements, so the fragments come from 32-bit shared loads.
// With a stride X = 4 mod 8 both ways a warp gathers a fragment hit 32
// distinct banks: X[row0 + g][col0 + t] (A of Q and B of K^T: bank
// 4g + t + const for X = 4 mod 32, a permutation of it otherwise) and
// X[row0 + 2t (+1)][col0 + g] (the permuted B, and the backward's dK/dV
// operands: bank 8t + g + const).  The float2 stores of C fragments into
// such a tile meet 2-way conflicts; they are few.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace mr {

// x rounded to TF32, ties away from zero, as cvt.rna.tf32.f32 rounds a
// finite x: half a TF32 step added to the magnitude bits (a carry moves
// the exponent), the 13 bits below the TF32 mantissa cleared.  Two integer
// operations, which the kernels ran faster than cvt.rna (the same bits).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo up to 2^-22 |x|, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(const float (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// d += a * b, TF32 inputs, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b at f32 accuracy: the two small products first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// The row stride, in floats, of an f32 tile `width` wide (a multiple of 16).
__host__ __device__ constexpr int f32_stride(int width) { return width + 4; }

// A shared tile whose elements a kernel reads as TF32 pairs: staged already
// split (kPreSplit: hi and lo arrays) where shared memory allows, else as
// f32 and split at each read.
template <bool kPreSplit>
struct SplitTile {
  float* hi;  // the f32 values when not pre-split
  float* lo;  // unused when not pre-split
  __device__ __forceinline__ void put(int idx, float x) const {
    if constexpr (kPreSplit) {
      uint32_t h, l;
      split_tf32(x, h, l);
      hi[idx] = __uint_as_float(h);
      lo[idx] = __uint_as_float(l);
    } else {
      hi[idx] = x;
    }
  }
  __device__ __forceinline__ void get(int idx, uint32_t& h, uint32_t& l) const {
    if constexpr (kPreSplit) {
      h = __float_as_uint(hi[idx]);
      l = __float_as_uint(lo[idx]);
    } else {
      split_tf32(hi[idx], h, l);
    }
  }
  // The B fragment of elements idx0 and idx1.
  __device__ __forceinline__ void get_b(int idx0, int idx1, uint32_t (&h)[2],
                                        uint32_t (&l)[2]) const {
    get(idx0, h[0], l[0]);
    get(idx1, h[1], l[1]);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

// Copies rows [row0, row0 + rows) of a [n_rows, C] f32 matrix in device
// memory into a shared tile [rows][CP + 4]: zeros past n_rows and past C.
// A row is C * 4 bytes, a multiple of 16, so every row starts as `src`
// does: the copies are 16 bytes where src is 16-byte aligned, else 8, else
// 4.  Threads tid, tid + n_threads, ... share the chunks.
template <int CP>
__device__ __forceinline__ void load_rows_f32_async(float* dst, const float* src, int row0,
                                                    int rows, int n_rows, int C, int tid,
                                                    int n_threads) {
  constexpr int S = f32_stride(CP);
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) & 15;
  if (align == 0) {
    constexpr int kChunks = CP / 4;
    for (int i = tid; i < rows * kChunks; i += n_threads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 4;
      const bool in = row0 + r < n_rows && c < C;
      cp_async16(dst + r * S + c, in ? src + (size_t)(row0 + r) * C + c : src, in ? 16 : 0);
    }
  } else if ((align & 7) == 0) {
    constexpr int kChunks = CP / 2;
    for (int i = tid; i < rows * kChunks; i += n_threads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 2;
      const bool in = row0 + r < n_rows && c < C;
      cp_async8(dst + r * S + c, in ? src + (size_t)(row0 + r) * C + c : src, in ? 8 : 0);
    }
  } else {
    for (int i = tid; i < rows * CP; i += n_threads) {
      const int r = i / CP, c = i - r * CP;
      const bool in = row0 + r < n_rows && c < C;
      cp_async4(dst + r * S + c, in ? src + (size_t)(row0 + r) * C + c : src, in ? 4 : 0);
    }
  }
}

// Stages one batch row's [L, C] f32 matrix into a tile [LP][CP + 4] with
// zeros past L and past C: the whole block, through cp.async (the caller
// commits and waits).  Once the copies have landed and the block has met
// at a barrier, split_staged splits a pre-split tile in place.
template <int LP, int CP, bool kPreSplit>
__device__ __forceinline__ void stage_f32_async(const SplitTile<kPreSplit>& dst,
                                                const float* src, int L, int C) {
  load_rows_f32_async<CP>(dst.hi, src, 0, LP, L, C, threadIdx.x, blockDim.x);
}

template <int LP, int CP, bool kPreSplit>
__device__ __forceinline__ void split_staged(const SplitTile<kPreSplit>& t) {
  if constexpr (kPreSplit) {
    constexpr int S = f32_stride(CP);
    for (int i = threadIdx.x; i < LP * CP; i += blockDim.x) {
      const int idx = (i / CP) * S + i % CP;
      t.put(idx, t.hi[idx]);
    }
  }
}

// The A fragment (16 x 8) of a shared f32 tile at (row0, col0), split.
__device__ __forceinline__ void load_a_f32(const float* t, int stride, int row0, int col0,
                                           int lane, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = lane >> 2, c = lane & 3;
  const float* p = t + (row0 + g) * stride + col0 + c;
  const float x[4] = {p[0], p[8 * stride], p[4], p[8 * stride + 4]};
  split_tf32(x, hi, lo);
}

// The A fragment of a C fragment's values under the permuted k index.
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split_tf32(x, hi, lo);
}

}  // namespace mr
