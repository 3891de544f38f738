// DM-GAN memory read, forward: every pixel attends over the word memory.
//
// Replaces t2igan/ops/pallas/memory_read.py::_kernel (the Pallas TPU kernel
// that memory_read_fused launches).  For each batch row b and pixel p:
//
//   logits[s] = q[b,p,:] . k[b,s,:]             (f32 accumulation)
//   logits[s] = -1e9 where pad[b,s]             (padding slot)
//   attn      = softmax(logits)                 (f32)
//   out[b,p,:] = sum_s attn[s] * v[b,s,:]       (f32, stored in the model dtype)
//
// The [B, HW, L] attention never reaches device memory.  In bf16 the
// attention is rounded to bf16 before the read-out, as the TPU kernel does
// (memory_read.py:55); in f32 nothing is rounded.
//
// What bounds it: per pixel the kernel must read q and write out, 2*C values,
// while it does 4*L*C flops.  At the sampler's shapes (C = 64, L = 77,
// bf16) that is 77 flops per byte of device memory, far below the H100's
// ~295 bf16 tensor-core flops per byte, so the work is bound by device
// memory bytes: the 128x128 stage at batch 128 moves 0.54 GB, 0.160 ms at
// 3.35 TB/s, where its 41.3 GFLOP take 0.042 ms at 989 TFLOP/s.
//
// bf16, on the tensor cores (memory_read_fwd_tc_kernel):
//  * One block of 8 warps owns one batch row and a run of pixels (`tile`, a
//    multiple of 128, sized by the wrapper so that the grid fills the
//    card).  K and V of the row are staged once per block as
//    bf16, L and C zero-padded to the kernel's (LP, CP) and rows padded by
//    16 bytes so that ldmatrix is free of bank conflicts: 23 KB at L = 77,
//    C = 64.
//  * Each warp walks 16-pixel row tiles of the run.  Its query tiles come
//    in through a two-stage cp.async ring of 16-byte copies (8-byte when
//    C % 8 != 0; zero fill past the run and past C), so the next tile's
//    load overlaps this tile's math.
//  * S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 accumulators); the masked
//    softmax runs on the accumulator fragments with the row max and sum
//    over the lane quad; P, rounded to bf16, is reused from registers as
//    the A operand of O = P V (V through ldmatrix.trans).  Slots past L,
//    which exist only because of the padding, are left out of the max and
//    the sum; a padding slot of pad_mask gets -1e9 and stays in, so a fully
//    padded row is uniform over the L real slots.
//  * O is rounded to bf16, staged in the warp's spent query buffer and
//    written as 16-byte rows.
//  * The byte bound is what is left: 41 GFLOP are far below mma.sync's
//    rate, so no wgmma is needed.
//
// f32, on the tensor cores at f32 accuracy (memory_read_fwd_f32_kernel):
//  * The bf16 kernel's shape: one batch row and a run of pixels a block,
//    16-pixel row tiles a warp through a two-stage cp.async ring of f32
//    rows (16-, 8- or 4-byte copies as the query's alignment allows; one
//    stage where shared memory is short, the next tile's copy then issued
//    once S is done).  16 warps a block where L + C is small (221 KB of
//    shared memory at L = 77, C = 64, 128 registers a thread), else 8.
//  * Every product is 3xTF32 on mma.sync m16n8k8 (mma_tf32.cuh): operands
//    split into TF32 hi and lo, three products into f32 accumulators.  K
//    and V are staged once per block through cp.async and split in place
//    (hi and lo arrays, [LP][CP + 4] each, ~85 KB at L = 77, C = 64), or
//    kept f32 and split at each read where four arrays do not fit (C = 128
//    with L > 32).  The query fragments are split in registers.
//  * S = Q K^T, then the masked softmax in f32 on the accumulator fragments
//    under the bf16 kernel's rules (softmax_rows).  P is split in registers
//    and reused as the A operand of O = P V under the permuted slot index
//    (mma_tf32.cuh), so V is read at rows 2t and 2t + 1.  Nothing is
//    rounded below f32: O goes out as f32 pairs straight from the
//    fragments (each quad writes 32 contiguous bytes of a row).
//  * What bounds it: 3xTF32 triples the tensor-core work, 124 GFLOP at the
//    128x128 stage of the batch-128 sampler, 0.25 ms at 495 TFLOP/s, below
//    the 1.08 GB of f32 q and out, 0.32 ms at 3.35 TB/s; the CUDA cores'
//    67 TFLOP/s would need 0.62 ms for the stage's 41 GFLOP of f32 work.
//    Timed on the H100, dropping two of the three products saved far
//    less than two thirds of the time, so issue and latency hold it back
//    more than the TF32 rate: 16 warps a block helped, two row tiles a
//    warp (half the shared reads) did not.
//
// C interface (loaded with ctypes): t2igan_memory_read_fwd returns the
// cudaError_t of the launch.  It launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;                   // warps per block
constexpr int kTcRows = 16;                   // pixels a warp takes at a time
constexpr int kTcStep = kTcWarps * kTcRows;   // pixels a block step covers
constexpr int kMaxTile = 1 << 16;             // pixels a block may own

// Shared memory: ks, vs [LP][CP + 8]; each warp's two query buffers
// [2][16][CP + 8], the spent one reused for its output rows.
template <int LP, int CP>
constexpr size_t tc_smem_bytes() {
  return (2 * (size_t)LP + (size_t)kTcWarps * 2 * kTcRows) * (CP + 8) * sizeof(bf16);
}

template <int LP, int CP>
__global__ void __launch_bounds__(kTcWarps * 32)
memory_read_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ pad,
                          bf16* __restrict__ out, int hw, int L, int C, int tile) {
  constexpr int S = CP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + LP * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* qw = vs + LP * S + warp * 2 * kTcRows * S;

  const int b = blockIdx.y;
  const bf16* qb = q + (size_t)b * hw * C;
  bf16* ob = out + (size_t)b * hw * C;
  const int p_end = min(hw, blockIdx.x * tile + tile);
  const int p_first = blockIdx.x * tile + warp * kTcRows;  // this warp's first row tile
  const int n_own = p_first < p_end ? (p_end - p_first + kTcStep - 1) / kTcStep : 0;

  // K, V and the first query tile, all in flight at once.
  mr::stage_kv_async<LP, CP>(ks, k + (size_t)b * L * C, L, C);
  mr::stage_kv_async<LP, CP>(vs, v + (size_t)b * L * C, L, C);
  if (n_own > 0) mr::load_rows_async<CP>(qw, qb, p_first, kTcRows, p_end, C, lane, 32);
  mr::cp_async_commit();
  uint32_t excluded, padded;
  mr::slot_masks<LP>(pad == nullptr ? nullptr : pad + (size_t)b * L, L, lane, excluded, padded);
  mr::cp_async_wait<0>();
  __syncthreads();

  for (int i = 0; i < n_own; ++i) {
    const int p0 = p_first + i * kTcStep;
    bf16* cur = qw + (i & 1) * kTcRows * S;
    if (i + 1 < n_own)
      mr::load_rows_async<CP>(qw + ((i + 1) & 1) * kTcRows * S, qb, p0 + kTcStep, kTcRows,
                              p_end, C, lane, 32);
    mr::cp_async_commit();
    mr::cp_async_wait<1>();
    __syncwarp();

    // S = Q K^T: [16, LP] in C fragments of LP / 8 n-tiles.
    float s[LP / 8][4];
#pragma unroll
    for (int j = 0; j < LP / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < CP / 16; ++kc) {
      uint32_t a[4];
      mr::ldmatrix_x4(a, mr::a_addr(cur, S, 0, kc * 16, lane));
#pragma unroll
      for (int jp = 0; jp < LP / 16; ++jp) {
        uint32_t bb[4];
        mr::ldmatrix_x4(bb, mr::bn_addr(ks, S, jp * 16, kc * 16, lane));
        mr::mma_bf16(s[2 * jp], a, bb[0], bb[1]);
        mr::mma_bf16(s[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
    mr::softmax_rows<LP>(s, excluded, padded);

    // P in bf16, as the A fragments of O = P V.
    uint32_t pa[LP / 16][4];
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      pa[kk][0] = mr::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = mr::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = mr::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = mr::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    float o[CP / 8][4];
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk)
#pragma unroll
      for (int np = 0; np < CP / 16; ++np) {
        uint32_t bb[4];
        mr::ldmatrix_x4_trans(bb, mr::bk_addr(vs, S, kk * 16, np * 16, lane));
        mr::mma_bf16(o[2 * np], pa[kk], bb[0], bb[1]);
        mr::mma_bf16(o[2 * np + 1], pa[kk], bb[2], bb[3]);
      }

    // O in bf16 through the spent query buffer, out as 16-byte rows.
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      *reinterpret_cast<uint32_t*>(cur + g * S + 8 * j + 2 * t) = mr::pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(cur + (g + 8) * S + 8 * j + 2 * t) =
          mr::pack_bf16(o[j][2], o[j][3]);
    }
    __syncwarp();
    if ((C & 7) == 0) {
      for (int idx = lane; idx < kTcRows * (CP / 8); idx += 32) {
        const int r = idx / (CP / 8), c = (idx - r * (CP / 8)) * 8;
        if (p0 + r < p_end && c < C)
          *reinterpret_cast<uint4*>(ob + (size_t)(p0 + r) * C + c) =
              *reinterpret_cast<const uint4*>(cur + r * S + c);
      }
    } else {
      for (int idx = lane; idx < kTcRows * (CP / 4); idx += 32) {
        const int r = idx / (CP / 4), c = (idx - r * (CP / 4)) * 4;
        if (p0 + r < p_end && c < C)
          *reinterpret_cast<uint2*>(ob + (size_t)(p0 + r) * C + c) =
              *reinterpret_cast<const uint2*>(cur + r * S + c);
      }
    }
    __syncwarp();  // cur is refilled two tiles on
  }
}

template <int LP, int CP>
cudaError_t tc_launch(const void* q, const void* k, const void* v, const void* pad, void* out,
                      int batch, int hw, int L, int C, int tile, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<LP, CP>();
  auto kernel = memory_read_fwd_tc_kernel<LP, CP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((hw + tile - 1) / tile, batch), kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(pad), static_cast<bf16*>(out), hw, L, C, tile);
  return cudaGetLastError();
}

template <int LP>
cudaError_t tc_launch_c(const void* q, const void* k, const void* v, const void* pad, void* out,
                        int batch, int hw, int L, int C, int tile, cudaStream_t s) {
  switch (mr::pick_channels(C)) {
    case 16: return tc_launch<LP, 16>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 32: return tc_launch<LP, 32>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 64: return tc_launch<LP, 64>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 128: return tc_launch<LP, 128>(q, k, v, pad, out, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t tc_launch_l(const void* q, const void* k, const void* v, const void* pad, void* out,
                        int batch, int hw, int L, int C, int tile, cudaStream_t s) {
  switch (mr::pick_slots(L)) {
    case 16: return tc_launch_c<16>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 32: return tc_launch_c<32>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 64: return tc_launch_c<64>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 80: return tc_launch_c<80>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 128: return tc_launch_c<128>(q, k, v, pad, out, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

// ---- f32 on the tensor cores, as 3xTF32 ----

constexpr size_t kMaxSmem = 232448;  // per block on sm_90

// Shared memory: K and V [LP][CP + 4] (hi and lo arrays each when
// pre-split), then each warp's query ring [stages][16][CP + 4].
constexpr size_t fwd_f32_bytes(int LP, int CP, int warps, int kv_arrays, int stages) {
  return ((size_t)kv_arrays * LP + (size_t)stages * warps * kTcRows) * mr::f32_stride(CP) *
         sizeof(float);
}

// Warps a block: 16 (four a scheduler, to hide the latency of the
// products' chains) where K and V pre-split and a two-stage ring fit and
// the kernel's registers fit 128 a thread (L + C small), else 8.
__host__ __device__ constexpr int fwd_f32_warps(int LP, int CP) {
  return LP + CP <= 160 && fwd_f32_bytes(LP, CP, 16, 4, 2) <= kMaxSmem ? 16 : 8;
}

template <int LP, int CP>
struct FwdF32 {
  static constexpr int S = mr::f32_stride(CP);
  static constexpr int kWarps = fwd_f32_warps(LP, CP);
  static constexpr int kStep = kWarps * kTcRows;  // pixels a block step covers
  static constexpr bool kPreSplit = fwd_f32_bytes(LP, CP, kWarps, 4, 2) <= kMaxSmem;
  static constexpr int kStages =
      kPreSplit || fwd_f32_bytes(LP, CP, kWarps, 2, 2) <= kMaxSmem ? 2 : 1;
  static constexpr size_t kSmem = fwd_f32_bytes(LP, CP, kWarps, kPreSplit ? 4 : 2, kStages);
};

template <int LP, int CP>
__global__ void __launch_bounds__(fwd_f32_warps(LP, CP) * 32)
memory_read_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const uint8_t* __restrict__ pad,
                           float* __restrict__ out, int hw, int L, int C, int tile) {
  using P = FwdF32<LP, CP>;
  constexpr int S = P::S, kStages = P::kStages, kStep = P::kStep;
  constexpr bool kPre = P::kPreSplit;
  constexpr int kArr = kPre ? 2 : 1;  // arrays a staged matrix takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const mr::SplitTile<kPre> ks{base, base + LP * S};
  const mr::SplitTile<kPre> vs{base + kArr * LP * S, base + (kArr + 1) * LP * S};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* qw = base + 2 * kArr * LP * S + warp * kStages * kTcRows * S;

  const int b = blockIdx.y;
  const float* qb = q + (size_t)b * hw * C;
  float* ob = out + (size_t)b * hw * C;
  const int p_end = min(hw, blockIdx.x * tile + tile);
  const int p_first = blockIdx.x * tile + warp * kTcRows;  // this warp's first row tile
  const int n_own = p_first < p_end ? (p_end - p_first + kStep - 1) / kStep : 0;

  // K, V and the first query tile, all in flight at once; K and V are
  // split in place once they have landed.
  mr::stage_f32_async<LP, CP>(ks, k + (size_t)b * L * C, L, C);
  mr::stage_f32_async<LP, CP>(vs, v + (size_t)b * L * C, L, C);
  mr::cp_async_commit();
  if (n_own > 0) mr::load_rows_f32_async<CP>(qw, qb, p_first, kTcRows, p_end, C, lane, 32);
  mr::cp_async_commit();
  uint32_t excluded, padded;
  mr::slot_masks<LP>(pad == nullptr ? nullptr : pad + (size_t)b * L, L, lane, excluded, padded);
  mr::cp_async_wait<1>();
  __syncthreads();
  mr::split_staged<LP, CP>(ks);
  mr::split_staged<LP, CP>(vs);
  __syncthreads();

  for (int i = 0; i < n_own; ++i) {
    const int p0 = p_first + i * kStep;
    const float* cur = qw + (kStages == 2 ? (i & 1) : 0) * kTcRows * S;
    if (kStages == 2) {
      if (i + 1 < n_own)
        mr::load_rows_f32_async<CP>(qw + ((i + 1) & 1) * kTcRows * S, qb, p0 + kStep, kTcRows,
                                    p_end, C, lane, 32);
      mr::cp_async_commit();
      mr::cp_async_wait<1>();
    } else {
      mr::cp_async_wait<0>();
    }
    __syncwarp();

    // S = Q K^T: [16, LP] in C fragments of LP / 8 n-tiles.
    float s[LP / 8][4];
#pragma unroll
    for (int j = 0; j < LP / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < CP / 8; ++kc) {
      uint32_t ah[4], al[4];
      mr::load_a_f32(cur, S, 0, kc * 8, lane, ah, al);
#pragma unroll
      for (int j = 0; j < LP / 8; ++j) {
        uint32_t bh[2], bl[2];
        const int row = (8 * j + g) * S + kc * 8 + t;
        ks.get_b(row, row + 4, bh, bl);
        mr::mma_3xtf32(s[j], ah, al, bh, bl);
      }
    }
    if (kStages == 1) {  // the query tile is spent: bring in the next one
      __syncwarp();
      if (i + 1 < n_own)
        mr::load_rows_f32_async<CP>(qw, qb, p0 + kStep, kTcRows, p_end, C, lane, 32);
      mr::cp_async_commit();
    }
    mr::softmax_rows<LP>(s, excluded, padded);

    // O = P V, P from registers under the permuted slot index.
    float o[CP / 8][4];
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < LP / 8; ++kk) {
      uint32_t ph[4], pl[4];
      mr::c_as_a(s[kk], ph, pl);
#pragma unroll
      for (int n = 0; n < CP / 8; ++n) {
        uint32_t bh[2], bl[2];
        const int row = (8 * kk + 2 * t) * S + 8 * n + g;
        vs.get_b(row, row + S, bh, bl);
        mr::mma_3xtf32(o[n], ph, pl, bh, bl);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + g + 8 * h;
      if (p < p_end) {
#pragma unroll
        for (int n = 0; n < CP / 8; ++n) {
          const int c = 8 * n + 2 * t;
          if (c < C)
            *reinterpret_cast<float2*>(ob + (size_t)p * C + c) =
                make_float2(o[n][2 * h], o[n][2 * h + 1]);
        }
      }
    }
    __syncwarp();  // cur is refilled two tiles on (the next tile, with one stage)
  }
}

template <int LP, int CP>
cudaError_t f32_launch(const void* q, const void* k, const void* v, const void* pad, void* out,
                       int batch, int hw, int L, int C, int tile, cudaStream_t stream) {
  constexpr size_t smem = FwdF32<LP, CP>::kSmem;
  static_assert(smem <= kMaxSmem, "shared memory of the f32 forward");
  auto kernel = memory_read_fwd_f32_kernel<LP, CP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((hw + tile - 1) / tile, batch), FwdF32<LP, CP>::kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<float*>(out), hw, L, C, tile);
  return cudaGetLastError();
}

template <int LP>
cudaError_t f32_launch_c(const void* q, const void* k, const void* v, const void* pad, void* out,
                         int batch, int hw, int L, int C, int tile, cudaStream_t s) {
  switch (mr::pick_channels(C)) {
    case 16: return f32_launch<LP, 16>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 32: return f32_launch<LP, 32>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 64: return f32_launch<LP, 64>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 128: return f32_launch<LP, 128>(q, k, v, pad, out, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t f32_launch_l(const void* q, const void* k, const void* v, const void* pad, void* out,
                         int batch, int hw, int L, int C, int tile, cudaStream_t s) {
  switch (mr::pick_slots(L)) {
    case 16: return f32_launch_c<16>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 32: return f32_launch_c<32>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 64: return f32_launch_c<64>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 80: return f32_launch_c<80>(q, k, v, pad, out, batch, hw, L, C, tile, s);
    case 128: return f32_launch_c<128>(q, k, v, pad, out, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: [batch, hw, C]; k, v: [batch, L, C], all contiguous, f32
// (is_bf16 = 0; every pointer 4-byte aligned) or bf16 (is_bf16 = 1; every
// pointer 16-byte aligned).  pad: [batch, L] bytes, nonzero at a padding
// slot, or null for no padding.  tile: pixels per block, a multiple of 128
// in 128..65536.  Needs 1 <= L <= 128, 4 <= C <= 128 with C % 4 == 0,
// batch <= 65535.
extern "C" int t2igan_memory_read_fwd(const void* q, const void* k, const void* v,
                                      const void* pad, void* out, int batch, int hw, int L,
                                      int C, int tile, int is_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || hw < 1 || L < 1 || L > 128 || C < 4 || C > 128 ||
      C % 4 != 0 || tile < kTcStep || tile > kMaxTile || tile % kTcStep != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)tc_launch_l(q, k, v, pad, out, batch, hw, L, C, tile, s);
  return (int)f32_launch_l(q, k, v, pad, out, batch, hw, L, C, tile, s);
}
