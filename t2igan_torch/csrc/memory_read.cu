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
// f32 (the check dtype), on the CUDA cores (memory_read_fwd_kernel):
//  * One block per (batch row, tile of 256 pixels); K (transposed, one
//    padding column against bank conflicts) and V for that row are staged
//    once in shared memory as f32.
//  * A warp computes a group of 8 pixels at a time: lanes split the L slots
//    for the logits, warp-shuffle max and sum give the softmax, then lanes
//    split the C channels for attn . v.  The group's q rows and attention
//    rows sit in per-warp shared buffers read as float4 broadcasts.
//  * L <= 128 and C <= 128 are template parameters (slots and channels per
//    lane), so every accumulator lives in registers.  Ragged pixel tiles are
//    masked; slots past L are excluded.
//
// C interface (loaded with ctypes): t2igan_memory_read_fwd returns the
// cudaError_t of the launch.  It launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;           // warps per block
constexpr int kGroup = 8;           // pixels a warp computes together
constexpr int kGroupsPerWarp = 4;   // groups each warp walks through
constexpr int kTile = kWarps * kGroup * kGroupsPerWarp;  // pixels per block
constexpr float kNeg = -1e9f;       // padding fill, as in the JAX package

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory layout, all f32:
//   kt [C][LP + 1]        keys, transposed (slot fastest), zero past L
//   vs [L4][C]            values, rows L..L4-1 zero (L4 = L rounded up to 4)
//   qs [kWarps][kGroup][C]   each warp's query rows
//   ps [kWarps][kGroup][LP]  each warp's attention rows, zero past L
template <int NS>
__host__ __device__ __forceinline__ size_t smem_floats(int L, int C) {
  const int LP = 32 * NS;
  const int L4 = (L + 3) & ~3;
  return (size_t)C * (LP + 1) + (size_t)L4 * C + (size_t)kWarps * kGroup * C +
         (size_t)kWarps * kGroup * LP;
}

// NS: slots per lane (L <= 32*NS).  NC: channels per lane (C <= 32*NC).
template <typename T, int NS, int NC>
__global__ void __launch_bounds__(kWarps * 32)
memory_read_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ pad,
                       T* __restrict__ out, int hw, int L, int C) {
  constexpr int LP = 32 * NS;
  constexpr int KTS = LP + 1;  // row stride of kt
  const int L4 = (L + 3) & ~3;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vs = kt + (size_t)C * KTS;
  float* qs = vs + (size_t)L4 * C;
  float* ps = qs + (size_t)kWarps * kGroup * C;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t kv_off = (size_t)b * L * C;

  // Stage K (transposed) and V for this batch row; reads are coalesced.
  for (int i = threadIdx.x; i < L4 * C; i += blockDim.x) {
    const int s = i / C, c = i - s * C;
    const bool in = s < L;
    kt[c * KTS + s] = in ? to_f32(k[kv_off + i]) : 0.f;
    vs[i] = in ? to_f32(v[kv_off + i]) : 0.f;
  }
  for (int i = threadIdx.x; i < C * (LP - L4); i += blockDim.x) {
    const int c = i / (LP - L4);
    kt[c * KTS + L4 + (i - c * (LP - L4))] = 0.f;
  }

  // Per-lane slot state: slot s = lane + 32*i is real (s < L) and kept
  // (not padding).
  bool real[NS], keep[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int s = lane + 32 * i;
    real[i] = s < L;
    keep[i] = real[i] && (pad == nullptr || pad[(size_t)b * L + s] == 0);
  }
  __syncthreads();

  float* qw = qs + warp * kGroup * C;
  float* pw = ps + warp * kGroup * LP;
  const size_t q_off = (size_t)b * hw * C;

  for (int g = 0; g < kGroupsPerWarp; ++g) {
    const int p0 = blockIdx.x * kTile + (g * kWarps + warp) * kGroup;
    if (p0 >= hw) break;  // the rest of this warp's groups lie past the image

    // The group's query rows as f32; pixels past hw read as zero.
    const int n_valid = min(kGroup, hw - p0);
    for (int i = lane; i < kGroup * C; i += 32)
      qw[i] = i < n_valid * C ? to_f32(q[q_off + (size_t)p0 * C + i]) : 0.f;
    __syncwarp();

    // logits[p][i] for slot lane + 32*i.
    float acc[kGroup][NS];
#pragma unroll
    for (int p = 0; p < kGroup; ++p)
#pragma unroll
      for (int i = 0; i < NS; ++i) acc[p][i] = 0.f;
    for (int c = 0; c < C; c += 4) {
      float kr[4][NS];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < NS; ++i) kr[j][i] = kt[(c + j) * KTS + lane + 32 * i];
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + p * C + c);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float a = acc[p][i];
          a = fmaf(qv.x, kr[0][i], a);
          a = fmaf(qv.y, kr[1][i], a);
          a = fmaf(qv.z, kr[2][i], a);
          a = fmaf(qv.w, kr[3][i], a);
          acc[p][i] = a;
        }
      }
    }

    // Masked softmax over the L slots, one pixel at a time.
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        acc[p][i] = keep[i] ? acc[p][i] : kNeg;
        if (real[i]) m = fmaxf(m, acc[p][i]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float e = real[i] ? expf(acc[p][i] - m) : 0.f;
        acc[p][i] = e;
        sum += e;
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int i = 0; i < NS; ++i) pw[p * LP + lane + 32 * i] = acc[p][i] / sum;
    }
    __syncwarp();

    // out[p][c] for channel c = lane + 32*n.
    float o[kGroup][NC];
#pragma unroll
    for (int p = 0; p < kGroup; ++p)
#pragma unroll
      for (int n = 0; n < NC; ++n) o[p][n] = 0.f;
    for (int s = 0; s < L4; s += 4) {
      float vr[4][NC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = lane + 32 * n;
          vr[j][n] = c < C ? vs[(s + j) * C + c] : 0.f;
        }
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + p * LP + s);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          float a = o[p][n];
          a = fmaf(pv.x, vr[0][n], a);
          a = fmaf(pv.y, vr[1][n], a);
          a = fmaf(pv.z, vr[2][n], a);
          a = fmaf(pv.w, vr[3][n], a);
          o[p][n] = a;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      if (p < n_valid) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = lane + 32 * n;
          if (c < C) out[q_off + (size_t)(p0 + p) * C + c] = from_f32<T>(o[p][n]);
        }
      }
    }
    __syncwarp();  // qw and pw are rewritten by the next group
  }
}

template <typename T, int NS, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pad, void* out,
                   int batch, int hw, int L, int C, cudaStream_t stream) {
  const size_t smem = smem_floats<NS>(L, C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(memory_read_fwd_kernel<T, NS, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((hw + kTile - 1) / kTile, batch);
  memory_read_fwd_kernel<T, NS, NC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(pad), static_cast<T*>(out), hw, L, C);
  return cudaGetLastError();
}

template <typename T, int NS>
cudaError_t launch_nc(const void* q, const void* k, const void* v, const void* pad, void* out,
                      int batch, int hw, int L, int C, cudaStream_t stream) {
  switch ((C + 31) / 32) {
    case 1: return launch<T, NS, 1>(q, k, v, pad, out, batch, hw, L, C, stream);
    case 2: return launch<T, NS, 2>(q, k, v, pad, out, batch, hw, L, C, stream);
    case 3: return launch<T, NS, 3>(q, k, v, pad, out, batch, hw, L, C, stream);
    case 4: return launch<T, NS, 4>(q, k, v, pad, out, batch, hw, L, C, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_ns(const void* q, const void* k, const void* v, const void* pad, void* out,
                      int batch, int hw, int L, int C, cudaStream_t stream) {
  switch ((L + 31) / 32) {
    case 1: return launch_nc<T, 1>(q, k, v, pad, out, batch, hw, L, C, stream);
    case 2: return launch_nc<T, 2>(q, k, v, pad, out, batch, hw, L, C, stream);
    case 3: return launch_nc<T, 3>(q, k, v, pad, out, batch, hw, L, C, stream);
    case 4: return launch_nc<T, 4>(q, k, v, pad, out, batch, hw, L, C, stream);
  }
  return cudaErrorInvalidValue;
}

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

}  // namespace

// q, out: [batch, hw, C]; k, v: [batch, L, C], all contiguous, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1; every pointer 16-byte aligned).
// pad: [batch, L] bytes, nonzero at a padding slot, or null for no padding.
// tile: pixels per block of the bf16 kernel, a multiple of 128 in
// 128..65536 (the f32 kernel takes 256 pixels per block).  Needs
// 1 <= L <= 128, 4 <= C <= 128 with C % 4 == 0, batch <= 65535.
extern "C" int t2igan_memory_read_fwd(const void* q, const void* k, const void* v,
                                      const void* pad, void* out, int batch, int hw, int L,
                                      int C, int tile, int is_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || hw < 1 || L < 1 || L > 128 || C < 4 || C > 128 ||
      C % 4 != 0 || tile < kTcStep || tile > kMaxTile || tile % kTcStep != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)tc_launch_l(q, k, v, pad, out, batch, hw, L, C, tile, s);
  return (int)launch_ns<float>(q, k, v, pad, out, batch, hw, L, C, s);
}
