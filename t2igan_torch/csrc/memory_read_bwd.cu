// DM-GAN memory read, backward: gradients of the read with respect to the
// query map, the keys and the values.
//
// Replaces t2igan/ops/pallas/memory_read.py::_bwd_kernel (the Pallas TPU
// kernel that the custom_vjp of memory_read_fused runs).  For each batch
// row b and pixel p, with the attention recomputed as in the forward:
//
//   attn[s]  = softmax_s(q[p] . k[s], -1e9 at padding)          (f32)
//   dattn[s] = dout[p] . v[s]
//   ds[s]    = attn[s] * (dattn[s] - sum_t attn[t] * dattn[t]),  0 at padding
//   dq[p]    = sum_s ds[s] * k[s]
//   dk[s]   += ds[s] * q[p]          dv[s] += attn[s] * dout[p]
//
// ds is zero at a padding slot because the -1e9 fill passes no gradient;
// that changes nothing but a fully padded row, whose logits do not depend
// on q or k.  The row sum is taken as sum(attn * dattn), not as the flash
// form sum(dout * out): out was rounded to the model dtype.
//
// What bounds it: per pixel the kernel must read q and dout and write dq,
// 3*C values, while it does 10*L*C flops (four L x C products and the
// softmax).  At the train step's shapes (C = 64, L = 77, bf16) that is
// ~128 flops per byte, below the H100's ~295 bf16 tensor-core flops per
// byte, so the work is bound by device memory bytes: the 128x128 stage at
// batch 16 moves 101 MB, 0.030 ms at 3.35 TB/s, where its 12.9 GFLOP take
// 0.013 ms at 989 TFLOP/s.
//
// Both versions: one block per (batch row, tile of pixels); the wrapper
// sizes the tile so that the blocks fill the card (f32: a multiple of 32,
// at most 1024, ~264 blocks; bf16: a multiple of 128, at most 4096, ~132
// blocks, one per SM).  The TPU grid ran the pixel tiles in order and summed dK/dV in
// VMEM scratch.  Here tiles run in parallel: each block writes its f32
// partial dK/dV to a workspace [2, batch, tiles, L, C], and a second kernel
// sums the tiles in order and writes dk/dv in the model dtype.  No atomics,
// so the gradients are the same from run to run.
//
// bf16, on the tensor cores (memory_read_bwd_tc_kernel); P and ds are
// rounded to bf16 before the three products that take them:
//  * K and V of the row are staged once per block as bf16, L and C
//    zero-padded to the kernel's (LP, CP), rows padded by 16 bytes against
//    ldmatrix bank conflicts.  The block walks its tile in steps of 128
//    pixels, 16 rows a warp; each warp brings its rows of q and dout in
//    through cp.async, two steps in flight where shared memory allows.
//  * Phase A, per warp: S = Q K^T and dP = dO V^T on mma.sync (bf16 in, f32
//    accumulators); the masked softmax and ds = P (dP - rowsum(P dP)) in
//    f32 on the fragments (rows over the lane quad); ds = 0 at padding and
//    past L; dQ = ds K with ds reused from registers as the A operand and K
//    through ldmatrix.trans.  P and ds go to shared memory as bf16.
//  * Phase B, after one barrier, the whole block: dK += ds^T Q and
//    dV += P^T dO over the step's pixels on mma.sync, both operands through
//    ldmatrix.trans.  The [LP x CP] f32 sums are split across the warps in
//    16 x 16 units and stay in registers across the tile (40 a thread at
//    L = 77, C = 64).
//
// f32 (the check dtype), on the CUDA cores (memory_read_bwd_kernel):
//  * K and V of the row are staged once per block in shared memory as f32,
//    transposed with one padding column: lanes over slots (logits, dattn)
//    and lanes over channels (dq = ds . K) both read it without bank
//    conflicts.
//  * The block walks its tile in sub-tiles of 32 pixels.  Phase A: each
//    warp takes 4 pixels, recomputes logits and softmax (lanes over
//    slots, warp shuffles), dattn and ds, writes attn and ds rows to
//    shared memory and dq straight to device memory.  Phase B: the whole
//    block adds ds^T q and attn^T dout of the 32 pixels into dK and dV;
//    each thread owns fixed 4-slot x 4-channel micro-tiles whose sums stay
//    in registers across the block's sub-tiles.
//
// C interface (loaded with ctypes): t2igan_memory_read_bwd returns the
// cudaError_t of the two launches.  It launches on the given stream, does
// not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;                     // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 4;                     // pixels a warp takes per sub-tile
constexpr int kSub = kWarps * kGroup;         // pixels per sub-tile (32)
constexpr float kNeg = -1e9f;                 // padding fill, as in the JAX package
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }

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

// Shared memory layout, all f32 (LP = 32*NS slots, KTS = LP + 1):
//   kt [C][KTS]      keys, transposed, zero past L
//   vt [C][KTS]      values, transposed, zero past L
//   qs [kSub][C]     the sub-tile's query rows (zero past hw)
//   gs [kSub][C]     the sub-tile's dout rows (zero past hw)
//   ps [kSub][LP]    attention rows, zero past L
//   dss [kSub][LP]   ds rows, zero past L and at padding
template <int NS>
__host__ __device__ __forceinline__ size_t smem_floats(int C) {
  const int LP = 32 * NS;
  return 2 * (size_t)C * (LP + 1) + 2 * (size_t)kSub * C + 2 * (size_t)kSub * LP;
}

// NS: slots per lane (L <= 32*NS).  NC: channels per lane (C <= 32*NC).
// MT: 4x4 (slot, channel) micro-tiles of dK/dV per thread; the L4 x C
// outputs (L4 = L rounded up to 4) hold at most 64*NS*NC of them.
template <typename T, int NS, int NC, int MT>
__global__ void __launch_bounds__(kThreads)
memory_read_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ pad,
                       const T* __restrict__ dout, T* __restrict__ dq,
                       float* __restrict__ work, int batch, int hw, int L, int C,
                       int tile) {
  constexpr int LP = 32 * NS;
  constexpr int KTS = LP + 1;
  const int L4 = (L + 3) & ~3;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);
  float* vt = kt + (size_t)C * KTS;
  float* qs = vt + (size_t)C * KTS;
  float* gs = qs + (size_t)kSub * C;
  float* ps = gs + (size_t)kSub * C;
  float* dss = ps + (size_t)kSub * LP;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t kv_off = (size_t)b * L * C;

  // Stage K and V transposed, zero for slots L..LP-1.
  for (int i = threadIdx.x; i < LP * C; i += kThreads) {
    const int s = i / C, c = i - s * C;
    const bool in = s < L;
    kt[c * KTS + s] = in ? to_f32(k[kv_off + i]) : 0.f;
    vt[c * KTS + s] = in ? to_f32(v[kv_off + i]) : 0.f;
  }

  bool real[NS], keep[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int s = lane + 32 * i;
    real[i] = s < L;
    keep[i] = real[i] && (pad == nullptr || pad[(size_t)b * L + s] == 0);
  }

  // This thread's micro-tiles: rows s0..s0+3 and channels c0..c0+3.
  const int mt_c = C >> 2;
  const int n_mt = (L4 >> 2) * mt_c;
  float acc_k[MT][4][4], acc_v[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_k[m][i][j] = acc_v[m][i][j] = 0.f;
  __syncthreads();

  const size_t q_off = (size_t)b * hw * C;
  const int tile0 = blockIdx.x * tile;
  const int tile_end = min(hw, tile0 + tile);
  float* qw = qs + warp * kGroup * C;
  float* gw = gs + warp * kGroup * C;
  float* pw = ps + warp * kGroup * LP;
  float* dw = dss + warp * kGroup * LP;

  for (int base = tile0; base < tile_end; base += kSub) {
    // ---- Phase A: this warp's kGroup pixels. ----
    const int p0 = base + warp * kGroup;
    const int n_valid = max(0, min(kGroup, tile_end - p0));
    for (int i = lane; i < kGroup * C; i += 32) {
      const bool in = i < n_valid * C;
      qw[i] = in ? to_f32(q[q_off + (size_t)p0 * C + i]) : 0.f;
      gw[i] = in ? to_f32(dout[q_off + (size_t)p0 * C + i]) : 0.f;
    }
    __syncwarp();

    float lg[kGroup][NS], da[kGroup][NS];
#pragma unroll
    for (int p = 0; p < kGroup; ++p)
#pragma unroll
      for (int i = 0; i < NS; ++i) lg[p][i] = da[p][i] = 0.f;
    for (int c = 0; c < C; c += 4) {
      float kr[4][NS], vr[4][NS];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          kr[j][i] = kt[(c + j) * KTS + lane + 32 * i];
          vr[j][i] = vt[(c + j) * KTS + lane + 32 * i];
        }
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + p * C + c);
        const float4 gv = *reinterpret_cast<const float4*>(gw + p * C + c);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float a = lg[p][i], d = da[p][i];
          a = fmaf(qv.x, kr[0][i], a);
          a = fmaf(qv.y, kr[1][i], a);
          a = fmaf(qv.z, kr[2][i], a);
          a = fmaf(qv.w, kr[3][i], a);
          d = fmaf(gv.x, vr[0][i], d);
          d = fmaf(gv.y, vr[1][i], d);
          d = fmaf(gv.z, vr[2][i], d);
          d = fmaf(gv.w, vr[3][i], d);
          lg[p][i] = a;
          da[p][i] = d;
        }
      }
    }

    // Masked softmax (as the forward kernel takes it), then ds.
#pragma unroll
    for (int p = 0; p < kGroup; ++p) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        lg[p][i] = keep[i] ? lg[p][i] : kNeg;
        if (real[i]) m = fmaxf(m, lg[p][i]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float e = real[i] ? expf(lg[p][i] - m) : 0.f;
        lg[p][i] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        lg[p][i] = lg[p][i] / sum;  // attn
        rs = fmaf(lg[p][i], da[p][i], rs);
      }
      rs = warp_sum(rs);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int s = lane + 32 * i;
        pw[p * LP + s] = lg[p][i];
        dw[p * LP + s] = keep[i] ? lg[p][i] * (da[p][i] - rs) : 0.f;
      }
    }
    __syncwarp();

    // dq[p][c] = sum_s ds[p][s] * k[s][c], lanes over channels.
    float o[kGroup][NC];
#pragma unroll
    for (int p = 0; p < kGroup; ++p)
#pragma unroll
      for (int n = 0; n < NC; ++n) o[p][n] = 0.f;
    for (int s = 0; s < L4; s += 4) {
      float kr[4][NC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = lane + 32 * n;
          kr[j][n] = c < C ? kt[c * KTS + s + j] : 0.f;
        }
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const float4 dv4 = *reinterpret_cast<const float4*>(dw + p * LP + s);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          float a = o[p][n];
          a = fmaf(dv4.x, kr[0][n], a);
          a = fmaf(dv4.y, kr[1][n], a);
          a = fmaf(dv4.z, kr[2][n], a);
          a = fmaf(dv4.w, kr[3][n], a);
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
          if (c < C) dq[q_off + (size_t)(p0 + p) * C + c] = from_f32<T>(o[p][n]);
        }
      }
    }
    __syncthreads();  // every warp's rows are in shared memory

    // ---- Phase B: dK += ds^T q, dV += attn^T dout over the sub-tile. ----
    // Pixels past hw have zero q and dout rows, so they add nothing.
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = threadIdx.x + kThreads * m;
      if (mt < n_mt) {
        const int s0 = (mt / mt_c) << 2, c0 = (mt % mt_c) << 2;
        for (int p = 0; p < kSub; ++p) {
          const float4 d4 = *reinterpret_cast<const float4*>(dss + p * LP + s0);
          const float4 a4 = *reinterpret_cast<const float4*>(ps + p * LP + s0);
          const float4 q4 = *reinterpret_cast<const float4*>(qs + p * C + c0);
          const float4 g4 = *reinterpret_cast<const float4*>(gs + p * C + c0);
          const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
          const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
          const float qr[4] = {q4.x, q4.y, q4.z, q4.w};
          const float gr[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc_k[m][i][j] = fmaf(dr[i], qr[j], acc_k[m][i][j]);
              acc_v[m][i][j] = fmaf(ar[i], gr[j], acc_v[m][i][j]);
            }
        }
      }
    }
    __syncthreads();  // the next sub-tile rewrites the rows
  }

  // This block's partial sums: work[0 or 1][b][tile index][s][c].
  const size_t part = (size_t)L * C;
  float* wk = work + ((size_t)b * gridDim.x + blockIdx.x) * part;
  float* wv = wk + (size_t)batch * gridDim.x * part;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = threadIdx.x + kThreads * m;
    if (mt < n_mt) {
      const int s0 = (mt / mt_c) << 2, c0 = (mt % mt_c) << 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (s0 + i < L) {
          *reinterpret_cast<float4*>(wk + (size_t)(s0 + i) * C + c0) =
              make_float4(acc_k[m][i][0], acc_k[m][i][1], acc_k[m][i][2], acc_k[m][i][3]);
          *reinterpret_cast<float4*>(wv + (size_t)(s0 + i) * C + c0) =
              make_float4(acc_v[m][i][0], acc_v[m][i][1], acc_v[m][i][2], acc_v[m][i][3]);
        }
      }
    }
  }
}

// dk/dv[b][e] = sum over tiles t = 0..n_tiles-1, in order, of
// work[which][b][t][e]; blockIdx.z picks dk (0) or dv (1).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
memory_read_bwd_reduce(const float* __restrict__ work, T* __restrict__ dk,
                       T* __restrict__ dv, int batch, int n_tiles, int LC) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= LC) return;
  const int b = blockIdx.y, which = blockIdx.z;
  const float* src = work + (((size_t)which * batch + b) * n_tiles) * LC + e;
  float acc = 0.f;
  for (int t = 0; t < n_tiles; ++t) acc += src[(size_t)t * LC];
  T* dst = which == 0 ? dk : dv;
  dst[(size_t)b * LC + e] = from_f32<T>(acc);
}

template <typename T, int NS, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pad,
                   const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                   int hw, int L, int C, int tile, cudaStream_t stream) {
  constexpr int MT = (NS * NC + 3) / 4;
  auto kernel = memory_read_bwd_kernel<T, NS, NC, MT>;
  const size_t smem = smem_floats<NS>(C) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (hw + tile - 1) / tile;
  kernel<<<dim3(n_tiles, batch), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(pad), static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(work), batch, hw, L, C, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int LC = L * C;
  memory_read_bwd_reduce<T><<<dim3((LC + kReduceThreads - 1) / kReduceThreads, batch, 2),
                              kReduceThreads, 0, stream>>>(
      static_cast<const float*>(work), static_cast<T*>(dk), static_cast<T*>(dv), batch,
      n_tiles, LC);
  return cudaGetLastError();
}

template <typename T, int NS>
cudaError_t launch_nc(const void* q, const void* k, const void* v, const void* pad,
                      const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                      int hw, int L, int C, int tile, cudaStream_t s) {
  switch ((C + 31) / 32) {
    case 1: return launch<T, NS, 1>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 2: return launch<T, NS, 2>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 3: return launch<T, NS, 3>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 4: return launch<T, NS, 4>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_ns(const void* q, const void* k, const void* v, const void* pad,
                      const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                      int hw, int L, int C, int tile, cudaStream_t s) {
  switch ((L + 31) / 32) {
    case 1: return launch_nc<T, 1>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 2: return launch_nc<T, 2>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 3: return launch_nc<T, 3>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 4: return launch_nc<T, 4>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

// ---- bf16 on the tensor cores ----

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 8;                   // warps per block
constexpr int kTcRows = 16;                   // pixels a warp takes per step
constexpr int kTcStep = kTcWarps * kTcRows;   // pixels per block step
constexpr size_t kMaxSmem = 232448;           // per block on sm_90

// Shared memory: ks, vs [LP][CP + 8]; the steps' q and dout rows
// [stages][128][CP + 8] each; P and ds [128][LP + 8] each.  Two stages
// where they fit, else one (LP = CP = 128).
constexpr size_t bwd_tc_bytes(int LP, int CP, int stages) {
  return (2 * (size_t)LP * (CP + 8) + 2 * (size_t)stages * kTcStep * (CP + 8) +
          2 * (size_t)kTcStep * (LP + 8)) *
         sizeof(bf16);
}

template <int LP, int CP>
struct BwdTc {
  static constexpr int S = CP + 8;
  static constexpr int SP = LP + 8;
  static constexpr int kStages = bwd_tc_bytes(LP, CP, 2) <= kMaxSmem ? 2 : 1;
  static constexpr size_t kSmem = bwd_tc_bytes(LP, CP, kStages);
  // 16 x 16 output units of dK and dV, spread over the warps.
  static constexpr int kUnitsEach = (LP / 16) * (CP / 16);
  static constexpr int kUnitsPerWarp = (2 * kUnitsEach + kTcWarps - 1) / kTcWarps;
};

template <int LP, int CP>
__global__ void __launch_bounds__(kTcWarps * 32)
memory_read_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const uint8_t* __restrict__ pad,
                          const bf16* __restrict__ dout, bf16* __restrict__ dq,
                          float* __restrict__ work, int batch, int hw, int L, int C, int tile) {
  using P = BwdTc<LP, CP>;
  constexpr int S = P::S, SP = P::SP, kStages = P::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + LP * S;
  bf16* qs = vs + LP * S;                        // [kStages][128][S]
  bf16* gs = qs + kStages * kTcStep * S;         // [kStages][128][S]
  bf16* ps = gs + kStages * kTcStep * S;         // [128][SP]
  bf16* ds = ps + kTcStep * SP;                  // [128][SP]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * kTcRows;  // this warp's rows of a step
  const int b = blockIdx.y;
  const size_t q_off = (size_t)b * hw * C;
  const int tile0 = blockIdx.x * tile;
  const int tile_end = min(hw, tile0 + tile);
  const int n_steps = (tile_end - tile0 + kTcStep - 1) / kTcStep;

  auto load_step = [&](int step, int buf) {
    const int row = tile0 + step * kTcStep + r0;
    mr::load_rows_async<CP>(qs + (buf * kTcStep + r0) * S, q + q_off, row, kTcRows, tile_end, C,
                            lane, 32);
    mr::load_rows_async<CP>(gs + (buf * kTcStep + r0) * S, dout + q_off, row, kTcRows, tile_end,
                            C, lane, 32);
  };

  // K, V and the first step's rows, all in flight at once.
  mr::stage_kv_async<LP, CP>(ks, k + (size_t)b * L * C, L, C);
  mr::stage_kv_async<LP, CP>(vs, v + (size_t)b * L * C, L, C);
  load_step(0, 0);
  mr::cp_async_commit();
  uint32_t excluded, padded;
  mr::slot_masks<LP>(pad == nullptr ? nullptr : pad + (size_t)b * L, L, lane, excluded, padded);

  float acc[P::kUnitsPerWarp][2][4];
#pragma unroll
  for (int u = 0; u < P::kUnitsPerWarp; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) acc[u][h][0] = acc[u][h][1] = acc[u][h][2] = acc[u][h][3] = 0.f;
  mr::cp_async_wait<0>();
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    const int base = tile0 + step * kTcStep;
    const int buf = kStages == 2 ? (step & 1) : 0;
    if (kStages == 2) {
      if (step + 1 < n_steps) load_step(step + 1, (step + 1) & 1);
      mr::cp_async_commit();
      mr::cp_async_wait<1>();
    } else {
      if (step > 0) {
        load_step(step, 0);
        mr::cp_async_commit();
      }
      mr::cp_async_wait<0>();
    }
    __syncwarp();
    const bf16* qt = qs + (buf * kTcStep + r0) * S;
    const bf16* gt = gs + (buf * kTcStep + r0) * S;

    // ---- Phase A: this warp's 16 pixels (rows past the tile are zero). ----
    float sc[LP / 8][4], dp[LP / 8][4];
#pragma unroll
    for (int j = 0; j < LP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < CP / 16; ++kc) {
      uint32_t aq[4], ag[4];
      mr::ldmatrix_x4(aq, mr::a_addr(qt, S, 0, kc * 16, lane));
      mr::ldmatrix_x4(ag, mr::a_addr(gt, S, 0, kc * 16, lane));
#pragma unroll
      for (int jp = 0; jp < LP / 16; ++jp) {
        uint32_t bb[4];
        mr::ldmatrix_x4(bb, mr::bn_addr(ks, S, jp * 16, kc * 16, lane));
        mr::mma_bf16(sc[2 * jp], aq, bb[0], bb[1]);
        mr::mma_bf16(sc[2 * jp + 1], aq, bb[2], bb[3]);
        mr::ldmatrix_x4(bb, mr::bn_addr(vs, S, jp * 16, kc * 16, lane));
        mr::mma_bf16(dp[2 * jp], ag, bb[0], bb[1]);
        mr::mma_bf16(dp[2 * jp + 1], ag, bb[2], bb[3]);
      }
    }
    mr::softmax_rows<LP>(sc, excluded, padded);

    // ds = P (dP - rowsum(P dP)) in f32, 0 at padding and past L.
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < LP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) rs[i >> 1] = fmaf(sc[j][i], dp[j][i], rs[i >> 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    }
#pragma unroll
    for (int j = 0; j < LP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t bit = 1u << (2 * j + (i & 1));
        dp[j][i] = ((excluded | padded) & bit) ? 0.f : sc[j][i] * (dp[j][i] - rs[i >> 1]);
      }

    // P and ds in bf16: to shared memory for phase B, ds as the A
    // fragments of dQ = ds K.
    uint32_t da[LP / 16][4];
#pragma unroll
    for (int j = 0; j < LP / 8; ++j) {
      const uint32_t p_lo = mr::pack_bf16(sc[j][0], sc[j][1]);
      const uint32_t p_hi = mr::pack_bf16(sc[j][2], sc[j][3]);
      const uint32_t d_lo = mr::pack_bf16(dp[j][0], dp[j][1]);
      const uint32_t d_hi = mr::pack_bf16(dp[j][2], dp[j][3]);
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(ps + (r0 + g) * SP + col) = p_lo;
      *reinterpret_cast<uint32_t*>(ps + (r0 + g + 8) * SP + col) = p_hi;
      *reinterpret_cast<uint32_t*>(ds + (r0 + g) * SP + col) = d_lo;
      *reinterpret_cast<uint32_t*>(ds + (r0 + g + 8) * SP + col) = d_hi;
      da[j >> 1][(j & 1) * 2] = d_lo;
      da[j >> 1][(j & 1) * 2 + 1] = d_hi;
    }
    float o[CP / 8][4];
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk)
#pragma unroll
      for (int np = 0; np < CP / 16; ++np) {
        uint32_t bb[4];
        mr::ldmatrix_x4_trans(bb, mr::bk_addr(ks, S, kk * 16, np * 16, lane));
        mr::mma_bf16(o[2 * np], da[kk], bb[0], bb[1]);
        mr::mma_bf16(o[2 * np + 1], da[kk], bb[2], bb[3]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = base + r0 + g + 8 * h;
      if (p < tile_end) {
#pragma unroll
        for (int j = 0; j < CP / 8; ++j) {
          const int c = 8 * j + 2 * t;
          if (c < C)
            *reinterpret_cast<uint32_t*>(dq + q_off + (size_t)p * C + c) =
                mr::pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
        }
      }
    }
    __syncthreads();  // every warp's P and ds rows are in shared memory

    // ---- Phase B: dK += ds^T Q, dV += P^T dO over the step's pixels. ----
    // Rows past the tile have zero q and dout, and so zero ds: they add
    // nothing, and k-steps wholly past it are skipped.
    const int n_k = min(kTcStep / 16, (tile_end - base + 15) / 16);
    const bf16* qb = qs + buf * kTcStep * S;
    const bf16* gb = gs + buf * kTcStep * S;
#pragma unroll
    for (int u = 0; u < P::kUnitsPerWarp; ++u) {
      const int unit = warp + kTcWarps * u;
      if (unit < 2 * P::kUnitsEach) {
        const int which = unit / P::kUnitsEach, rem = unit - which * P::kUnitsEach;
        const int mt = rem / (CP / 16), nt = rem - mt * (CP / 16);
        const bf16* at = which == 0 ? ds : ps;
        const bf16* bt = which == 0 ? qb : gb;
        for (int kk = 0; kk < n_k; ++kk) {
          uint32_t a[4], bb[4];
          mr::ldmatrix_x4_trans(a, mr::at_addr(at, SP, kk * 16, mt * 16, lane));
          mr::ldmatrix_x4_trans(bb, mr::bk_addr(bt, S, kk * 16, nt * 16, lane));
          mr::mma_bf16(acc[u][0], a, bb[0], bb[1]);
          mr::mma_bf16(acc[u][1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the next step rewrites P, ds and this buffer
  }

  // This block's partial sums: work[0 or 1][b][tile index][s][c].
  const size_t part = (size_t)L * C;
#pragma unroll
  for (int u = 0; u < P::kUnitsPerWarp; ++u) {
    const int unit = warp + kTcWarps * u;
    if (unit < 2 * P::kUnitsEach) {
      const int which = unit / P::kUnitsEach, rem = unit - which * P::kUnitsEach;
      const int mt = rem / (CP / 16), nt = rem - mt * (CP / 16);
      float* w = work + (((size_t)which * batch + b) * gridDim.x + blockIdx.x) * part;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = mt * 16 + g + 8 * half;
          const int c = nt * 16 + 8 * h + 2 * t;
          if (s < L && c < C)
            *reinterpret_cast<float2*>(w + (size_t)s * C + c) =
                make_float2(acc[u][h][2 * half], acc[u][h][2 * half + 1]);
        }
    }
  }
}

template <int LP, int CP>
cudaError_t tc_launch(const void* q, const void* k, const void* v, const void* pad,
                      const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                      int hw, int L, int C, int tile, cudaStream_t stream) {
  constexpr size_t smem = BwdTc<LP, CP>::kSmem;
  auto kernel = memory_read_bwd_tc_kernel<LP, CP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (hw + tile - 1) / tile;
  kernel<<<dim3(n_tiles, batch), kTcWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(pad), static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(work), batch, hw, L, C, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int LC = L * C;
  memory_read_bwd_reduce<bf16><<<dim3((LC + kReduceThreads - 1) / kReduceThreads, batch, 2),
                                 kReduceThreads, 0, stream>>>(
      static_cast<const float*>(work), static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch,
      n_tiles, LC);
  return cudaGetLastError();
}

template <int LP>
cudaError_t tc_launch_c(const void* q, const void* k, const void* v, const void* pad,
                        const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                        int hw, int L, int C, int tile, cudaStream_t s) {
  switch (mr::pick_channels(C)) {
    case 16: return tc_launch<LP, 16>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 32: return tc_launch<LP, 32>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 64: return tc_launch<LP, 64>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 128: return tc_launch<LP, 128>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t tc_launch_l(const void* q, const void* k, const void* v, const void* pad,
                        const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                        int hw, int L, int C, int tile, cudaStream_t s) {
  switch (mr::pick_slots(L)) {
    case 16: return tc_launch_c<16>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 32: return tc_launch_c<32>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 64: return tc_launch_c<64>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 80: return tc_launch_c<80>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 128: return tc_launch_c<128>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout, dq: [batch, hw, C]; k, v, dk, dv: [batch, L, C], all contiguous,
// f32 (is_bf16 = 0) or bf16 (is_bf16 = 1; every pointer 16-byte aligned).
// pad: [batch, L] bytes, nonzero at a padding slot, or null.  work: f32
// [2, batch, ceil(hw / tile), L, C].  tile: pixels per block, a multiple of
// 32 in 32..65536.  Needs 1 <= L <= 128, 4 <= C <= 128 with C % 4 == 0,
// batch <= 65535.
extern "C" int t2igan_memory_read_bwd(const void* q, const void* k, const void* v,
                                      const void* pad, const void* dout, void* dq, void* dk,
                                      void* dv, void* work, int batch, int hw, int L, int C,
                                      int tile, int is_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || hw < 1 || L < 1 || L > 128 || C < 4 || C > 128 ||
      C % 4 != 0 || tile < kSub || tile > (1 << 16) || tile % kSub != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)tc_launch_l(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
  return (int)launch_ns<float>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
}
