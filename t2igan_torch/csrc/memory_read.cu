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
// The [B, HW, L] attention never reaches device memory.
//
// What bounds it: per pixel the kernel must read q and write out, 2*C values,
// while it does 4*L*C flops.  At the sampler's shapes (C = 64, L = 77,
// bf16) that is 77 flops per byte of device memory, far below the H100's
// ~295 bf16 tensor-core flops per byte, so the work is bound by device
// memory bytes: the 128x128 stage at batch 128 moves ~0.54 GB, ~0.16 ms at
// 3.35 TB/s.  Done in fp32 on the CUDA cores (67 TFLOP/s), the same 41 GFLOP
// need ~0.6 ms, so this first version is bound by its arithmetic and by the
// shared-memory loads that feed it, not by the bytes.
//
// What the design does about it:
//  * One block per (batch row, tile of 256 pixels); K (transposed, one
//    padding column against bank conflicts) and V for that row are staged
//    once in shared memory as f32, so device memory sees each q and out
//    element once and K/V once per tile (from L2).
//  * A warp computes a group of 8 pixels at a time: lanes split the L slots
//    for the logits (each K value loaded from shared memory feeds 8 FMAs),
//    warp-shuffle max and sum give the softmax, then lanes split the C
//    channels for attn . v (each V value feeds 8 FMAs).  The group's q rows
//    and attention rows sit in per-warp shared buffers read as float4
//    broadcasts.
//  * L <= 128 and C <= 128 are template parameters (slots and channels per
//    lane), so every accumulator lives in registers.  Ragged pixel tiles are
//    masked; slots past L are excluded and need no padding on the host.
//  * Moving the two products onto the tensor cores (mma.sync / wgmma) is the
//    next step toward the byte bound.
//
// C interface (loaded with ctypes): t2igan_memory_read_fwd returns the
// cudaError_t of the launch.  It launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;           // warps per block
constexpr int kGroup = 8;           // pixels a warp computes together
constexpr int kGroupsPerWarp = 4;   // groups each warp walks through
constexpr int kTile = kWarps * kGroup * kGroupsPerWarp;  // pixels per block
constexpr float kNeg = -1e9f;       // padding fill, as in the JAX package

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

}  // namespace

// q, out: [batch, hw, C]; k, v: [batch, L, C], all contiguous, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1).  pad: [batch, L] bytes, nonzero at a
// padding slot, or null for no padding.  Needs 1 <= L <= 128,
// 4 <= C <= 128 with C % 4 == 0, batch <= 65535.
extern "C" int t2igan_memory_read_fwd(const void* q, const void* k, const void* v,
                                      const void* pad, void* out, int batch, int hw, int L,
                                      int C, int is_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || hw < 1 || L < 1 || L > 128 || C < 4 || C > 128 ||
      C % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch_ns<__nv_bfloat16>(q, k, v, pad, out, batch, hw, L, C, s);
  return (int)launch_ns<float>(q, k, v, pad, out, batch, hw, L, C, s);
}
