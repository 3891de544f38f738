// Helpers shared by the bf16 memory-read kernels (memory_read.cu, forward;
// memory_read_bwd.cu, backward): asynchronous copies, ldmatrix, the
// m16n8k16 bf16 tensor-core product and the fragment maps that tie them
// together, for sm_80 and later (built for sm_90a).
//
// Fragment maps of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major) a[0]: (g, 2t..2t+1)   a[1]: (g+8, 2t..2t+1)
//                          a[2]: (g, 2t+8..+9)   a[3]: (g+8, 2t+8..+9)
//   B (16 x 8, "col")      b[0]: (k 2t..2t+1, n g)   b[1]: (k 2t+8..+9, n g)
//   C (16 x 8, f32)        c[0..1]: (g, 2t..2t+1)    c[2..3]: (g+8, 2t..2t+1)
// So the C fragments of two neighbouring n-tiles j = 2i, 2i+1, packed to
// bf16 pairs, are the A fragment of k-step i: {C(2i)[0..1], C(2i)[2..3],
// C(2i+1)[0..1], C(2i+1)[2..3]}.  That is how a product's f32 result feeds
// the next product from registers.
//
// Shared-memory tiles are row-major bf16 with a row stride of (width + 8)
// elements: 16 bytes of padding put the eight 16-byte rows that one
// ldmatrix phase reads on eight distinct groups of four banks.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mr {

constexpr float kNeg = -1e9f;  // padding fill, as in the JAX package

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- or 8-byte global -> shared copy; copies src_bytes (0 or the full
// size) and fills the rest of the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [row0, row0 + rows) of a [n_rows, C] bf16 matrix in device
// memory into a shared tile [rows][CP + 8]: zeros past n_rows and past C
// (C % 4 == 0, so a row is whole 8-byte chunks; 16-byte chunks when
// C % 8 == 0).  Threads tid, tid + n_threads, ... share the chunks.  The
// source must be 16-byte aligned (8 when C % 8 != 0).
template <int CP>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int row0, int rows, int n_rows, int C, int tid,
                                                int n_threads) {
  constexpr int S = CP + 8;
  if ((C & 7) == 0) {
    constexpr int kChunks = CP / 8;  // 16-byte chunks a row
    for (int i = tid; i < rows * kChunks; i += n_threads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 8;
      const bool in = row0 + r < n_rows && c < C;
      const __nv_bfloat16* s = in ? src + (size_t)(row0 + r) * C + c : src;
      cp_async16(dst + r * S + c, s, in ? 16 : 0);
    }
  } else {
    constexpr int kChunks = CP / 4;  // 8-byte chunks a row
    for (int i = tid; i < rows * kChunks; i += n_threads) {
      const int r = i / kChunks, c = (i - r * kChunks) * 4;
      const bool in = row0 + r < n_rows && c < C;
      const __nv_bfloat16* s = in ? src + (size_t)(row0 + r) * C + c : src;
      cp_async8(dst + r * S + c, s, in ? 8 : 0);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix addresses, lane l reading row l % 8 of matrix l / 8.
// A fragment (16 x 16) of a row-major tile at (row0, col0):
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* t, int stride,
                                                       int row0, int col0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return t + (row0 + (m & 1) * 8 + r) * stride + col0 + (m >> 1) * 8;
}
// A fragment of the transpose of a row-major tile: A[m][k] = t[k0 + k][m0 + m]
// (use with ldmatrix_x4_trans).
__device__ __forceinline__ const __nv_bfloat16* at_addr(const __nv_bfloat16* t, int stride,
                                                        int k0, int m0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return t + (k0 + (m >> 1) * 8 + r) * stride + m0 + (m & 1) * 8;
}
// B fragments of two n-tiles (n0, n0 + 8) at k-step k0, from a tile stored
// [n][k] (ldmatrix_x4 -> {b0, b1} of n0, then of n0 + 8):
__device__ __forceinline__ const __nv_bfloat16* bn_addr(const __nv_bfloat16* t, int stride,
                                                        int n0, int k0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return t + (n0 + (m >> 1) * 8 + r) * stride + k0 + (m & 1) * 8;
}
// ... and from a tile stored [k][n] (ldmatrix_x4_trans, same order):
__device__ __forceinline__ const __nv_bfloat16* bk_addr(const __nv_bfloat16* t, int stride,
                                                        int k0, int n0, int lane) {
  const int m = lane >> 3, r = lane & 7;
  return t + (k0 + (m & 1) * 8 + r) * stride + n0 + (m >> 1) * 8;
}

// Stages K or V of one batch row, [L, C] in device memory, into a shared
// tile [LP][CP + 8] with zeros past L and past C: the whole block, async.
template <int LP, int CP>
__device__ __forceinline__ void stage_kv_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int L, int C) {
  load_rows_async<CP>(dst, src, 0, LP, L, C, threadIdx.x, blockDim.x);
}

// Per-thread slot masks for the C fragments of an [16, LP] logits tile:
// bit 2j + e stands for slot 8j + 2t + e.  `excluded`: the slot lies past
// L (it exists only because L is padded to LP) and is left out of the
// softmax; `padded`: a real slot that pad_mask marks, filled with -1e9 and
// kept, so a fully padded row is uniform over the L real slots.
template <int LP>
__device__ __forceinline__ void slot_masks(const uint8_t* pad_row, int L, int lane,
                                           uint32_t& excluded, uint32_t& padded) {
  static_assert(LP <= 128, "two bits a slot pair, 32 bits");
  excluded = 0;
  padded = 0;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < LP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = 8 * j + 2 * t + e;
      if (s >= L)
        excluded |= 1u << (2 * j + e);
      else if (pad_row != nullptr && pad_row[s])
        padded |= 1u << (2 * j + e);
    }
}

// Masked softmax over the slots of the C fragments s[LP / 8][4] of rows g
// and g + 8, in place, in f32: -1e9 at padded slots, 0 at excluded ones.
// The row max and sum are taken over the quad of lanes that holds a row.
template <int LP>
__device__ __forceinline__ void softmax_rows(float (&s)[LP / 8][4], uint32_t excluded,
                                             uint32_t padded) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < LP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t bit = 1u << (2 * j + (i & 1));
      if (padded & bit) s[j][i] = kNeg;
      if (!(excluded & bit)) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < LP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t bit = 1u << (2 * j + (i & 1));
      const float e = (excluded & bit) ? 0.f : __expf(s[j][i] - mx[i >> 1]);
      s[j][i] = e;
      sum[i >> 1] += e;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
  const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
  for (int j = 0; j < LP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] *= inv[i >> 1];
}

// The (LP, CP) a kernel is built for: L and C rounded up to the next of
// 16, 32, 64, 80, 128 (slots) and 16, 32, 64, 128 (channels).
__host__ __forceinline__ int pick_slots(int L) {
  return L <= 16 ? 16 : L <= 32 ? 32 : L <= 64 ? 64 : L <= 80 ? 80 : 128;
}
__host__ __forceinline__ int pick_channels(int C) {
  return C <= 16 ? 16 : C <= 32 ? 32 : C <= 64 ? 64 : 128;
}

}  // namespace mr
