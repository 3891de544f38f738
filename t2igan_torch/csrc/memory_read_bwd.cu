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
// Both versions: one block of 8 warps per (batch row, run of pixels); the
// wrapper sizes the run (a multiple of 128 pixels, at most 4096) so that
// ~132 blocks, one per SM, share the work.  The TPU grid ran the pixel
// tiles in order and summed dK/dV in VMEM scratch.  Here tiles run in
// parallel: each block writes its f32
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
// f32, on the tensor cores at f32 accuracy (memory_read_bwd_f32_kernel):
//  * The bf16 kernel's phases, every product 3xTF32 on mma.sync m16n8k8
//    (mma_tf32.cuh: operands split into TF32 hi and lo, three products into
//    f32 accumulators), nothing rounded below f32.
//  * Shared memory holds f32 tiles with rows of width + 4 floats, read as
//    32-bit fragments free of bank conflicts: K and V [LP][CP + 4]
//    (staged through cp.async; each split in place into hi and lo where
//    that fits, K first, as it feeds two of phase A's three products, else
//    split at each read: at L = 77, C = 64, K is split and V is not); the
//    step's q and dout rows; P and ds
//    [step][LP + 4].  The step is 128 pixels (8 warps of 16 rows in phase
//    A) where shared memory allows (216 KB at L = 77, C = 64, one copy
//    stage), else 64 or 32 pixels with the other warps idle in phase A.
//  * Phase A, per warp: S = Q K^T and dP = dO V^T; the masked softmax and
//    ds = P (dP - rowsum(P dP)) in f32 on the fragments, ds = 0 at padding
//    and past L; dQ = ds K with ds split in registers and reused as the A
//    operand under the permuted slot index (K read at rows 2t, 2t + 1).
//    P and ds go to shared memory as f32.
//  * Phase B, after one barrier, the whole block: dK += ds^T Q (warps 0-3)
//    and dV += P^T dO (warps 4-7) over the step's pixels, under a permuted
//    pixel index, so both operands are read at rows 2t and 2t + 1.  Each
//    warp owns a fixed set of 16 x 8 output tiles (all LP slots and a
//    quarter of the channels at C >= 32: 40 f32 sums a thread at L = 77,
//    C = 64), so each fragment it loads feeds several products, and the
//    sums stay in registers across the run.
//  * What bounds it: at the train step's shapes the 3xTF32 work, 38.8
//    GFLOP at the 128x128 stage at batch 16, 0.078 ms at 495 TFLOP/s,
//    above its 0.20 GB of f32 q, dout and dq, 0.060 ms at 3.35 TB/s; the
//    CUDA cores' 67 TFLOP/s would need 0.19 ms for its 12.9 GFLOP of f32
//    work.  With one block an SM, the two barriers a step and the step's
//    rows loaded only once the last step is done (one copy stage), it
//    reaches about a quarter of that bound (PERF.md).
//
// C interface (loaded with ctypes): t2igan_memory_read_bwd returns the
// cudaError_t of the two launches.  It launches on the given stream, does
// not synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kReduceThreads = 256;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

// ---- f32 on the tensor cores, as 3xTF32 ----

// Shared memory: K and V [LP][CP + 4] (hi and lo arrays when pre-split:
// kv_arrays counts them); the step's q and dout rows [stages][step][CP + 4]
// each; P and ds [step][LP + 4] each.
constexpr size_t bwd_f32_bytes(int LP, int CP, int kv_arrays, int warps_a, int stages) {
  return ((size_t)kv_arrays * LP * mr::f32_stride(CP) +
          2 * (size_t)stages * kTcRows * warps_a * mr::f32_stride(CP) +
          2 * (size_t)kTcRows * warps_a * mr::f32_stride(LP)) *
         sizeof(float);
}

template <int LP, int CP>
struct BwdF32 {
  static constexpr int S = mr::f32_stride(CP);
  static constexpr int SP = mr::f32_stride(LP);
  // Phase A warps (16 rows each): as many as fit with f32 K and V and one
  // copy stage; then, where they fit, K pre-split (it feeds two of phase
  // A's three products), V pre-split, a second stage.
  static constexpr int kWarpsA = bwd_f32_bytes(LP, CP, 2, 8, 1) <= kMaxSmem   ? 8
                                 : bwd_f32_bytes(LP, CP, 2, 4, 1) <= kMaxSmem ? 4
                                                                              : 2;
  static constexpr bool kPreK = bwd_f32_bytes(LP, CP, 3, kWarpsA, 1) <= kMaxSmem;
  static constexpr bool kPreV = bwd_f32_bytes(LP, CP, 4, kWarpsA, 1) <= kMaxSmem;
  static constexpr int kArrays = 2 + kPreK + kPreV;
  static constexpr int kStages = bwd_f32_bytes(LP, CP, kArrays, kWarpsA, 2) <= kMaxSmem ? 2 : 1;
  static constexpr size_t kSmem = bwd_f32_bytes(LP, CP, kArrays, kWarpsA, kStages);
  static constexpr int kStep = kTcRows * kWarpsA;
  // Phase B: 4 warps for each of dK and dV, over 16 x 8 output tiles: kNW
  // warps along the channels (kNPer n-tiles each), kMW along the slots
  // (kMPer m-tiles each).
  static constexpr int kMT = LP / 16, kNT = CP / 8;
  static constexpr int kNW = kNT < 4 ? kNT : 4;
  static constexpr int kMW = 4 / kNW;
  static constexpr int kNPer = kNT / kNW;
  static constexpr int kMPer = (kMT + kMW - 1) / kMW;
};

template <int LP, int CP>
__global__ void __launch_bounds__(kTcWarps * 32)
memory_read_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const uint8_t* __restrict__ pad,
                           const float* __restrict__ dout, float* __restrict__ dq,
                           float* __restrict__ work, int batch, int hw, int L, int C, int tile) {
  using P = BwdF32<LP, CP>;
  constexpr int S = P::S, SP = P::SP, kStages = P::kStages, kStep = P::kStep;
  constexpr int kArrK = P::kPreK ? 2 : 1;  // arrays K takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  const mr::SplitTile<P::kPreK> ks{base, base + LP * S};
  const mr::SplitTile<P::kPreV> vs{base + kArrK * LP * S, base + (kArrK + 1) * LP * S};
  float* qs = base + P::kArrays * LP * S;     // [kStages][kStep][S]
  float* gs = qs + kStages * kStep * S;       // [kStages][kStep][S]
  float* ps = gs + kStages * kStep * S;       // [kStep][SP]
  float* ds = ps + kStep * SP;                // [kStep][SP]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * kTcRows;  // this warp's rows of a step (phase A)
  const bool in_a = warp < P::kWarpsA;
  const int b = blockIdx.y;
  const size_t q_off = (size_t)b * hw * C;
  const int tile0 = blockIdx.x * tile;
  const int tile_end = min(hw, tile0 + tile);
  const int n_steps = (tile_end - tile0 + kStep - 1) / kStep;

  auto load_step = [&](int step, int buf) {
    const int row = tile0 + step * kStep + r0;
    mr::load_rows_f32_async<CP>(qs + (buf * kStep + r0) * S, q + q_off, row, kTcRows, tile_end,
                                C, lane, 32);
    mr::load_rows_f32_async<CP>(gs + (buf * kStep + r0) * S, dout + q_off, row, kTcRows,
                                tile_end, C, lane, 32);
  };

  // K, V and the first step's rows, all in flight at once; K and V are
  // split in place (where pre-split) once they have landed.
  mr::stage_f32_async<LP, CP>(ks, k + (size_t)b * L * C, L, C);
  mr::stage_f32_async<LP, CP>(vs, v + (size_t)b * L * C, L, C);
  if (in_a) load_step(0, 0);
  mr::cp_async_commit();
  uint32_t excluded, padded;
  mr::slot_masks<LP>(pad == nullptr ? nullptr : pad + (size_t)b * L, L, lane, excluded, padded);

  // Phase B's output tiles: dK (warps 0-3) or dV (warps 4-7).
  const int which = warp >> 2;
  const int mw = (warp & 3) / P::kNW, nw = (warp & 3) % P::kNW;
  float acc[P::kMPer][P::kNPer][4];
#pragma unroll
  for (int mi = 0; mi < P::kMPer; ++mi)
#pragma unroll
    for (int ni = 0; ni < P::kNPer; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
  mr::cp_async_wait<0>();
  __syncthreads();
  mr::split_staged<LP, CP>(ks);
  mr::split_staged<LP, CP>(vs);
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    const int base_px = tile0 + step * kStep;
    const int buf = kStages == 2 ? (step & 1) : 0;
    if (kStages == 2) {
      if (in_a && step + 1 < n_steps) load_step(step + 1, (step + 1) & 1);
      mr::cp_async_commit();
      mr::cp_async_wait<1>();
    } else {
      if (in_a && step > 0) load_step(step, 0);
      mr::cp_async_commit();
      mr::cp_async_wait<0>();
    }
    __syncwarp();

    // ---- Phase A: this warp's 16 pixels (rows past the tile are zero;
    // a warp whose rows all lie past it is not read in phase B). ----
    if (in_a && base_px + r0 < tile_end) {
      const float* qt = qs + (buf * kStep + r0) * S;
      const float* gt = gs + (buf * kStep + r0) * S;
      float sc[LP / 8][4], dp[LP / 8][4];
#pragma unroll
      for (int j = 0; j < LP / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < CP / 8; ++kc) {
        uint32_t qh[4], ql[4], gh[4], gl[4];
        mr::load_a_f32(qt, S, 0, kc * 8, lane, qh, ql);
        mr::load_a_f32(gt, S, 0, kc * 8, lane, gh, gl);
#pragma unroll
        for (int j = 0; j < LP / 8; ++j) {
          uint32_t bh[2], bl[2];
          const int row = (8 * j + g) * S + kc * 8 + t;
          ks.get_b(row, row + 4, bh, bl);
          mr::mma_3xtf32(sc[j], qh, ql, bh, bl);
          vs.get_b(row, row + 4, bh, bl);
          mr::mma_3xtf32(dp[j], gh, gl, bh, bl);
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

      // P and ds to shared memory for phase B.
#pragma unroll
      for (int j = 0; j < LP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(ps + (r0 + g) * SP + col) = make_float2(sc[j][0], sc[j][1]);
        *reinterpret_cast<float2*>(ps + (r0 + g + 8) * SP + col) = make_float2(sc[j][2], sc[j][3]);
        *reinterpret_cast<float2*>(ds + (r0 + g) * SP + col) = make_float2(dp[j][0], dp[j][1]);
        *reinterpret_cast<float2*>(ds + (r0 + g + 8) * SP + col) = make_float2(dp[j][2], dp[j][3]);
      }

      // dQ = ds K, ds from registers under the permuted slot index.
      float o[CP / 8][4];
#pragma unroll
      for (int j = 0; j < CP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < LP / 8; ++kk) {
        uint32_t dh[4], dl[4];
        mr::c_as_a(dp[kk], dh, dl);
#pragma unroll
        for (int n = 0; n < CP / 8; ++n) {
          uint32_t bh[2], bl[2];
          const int row = (8 * kk + 2 * t) * S + 8 * n + g;
          ks.get_b(row, row + S, bh, bl);
          mr::mma_3xtf32(o[n], dh, dl, bh, bl);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = base_px + r0 + g + 8 * h;
        if (p < tile_end) {
#pragma unroll
          for (int n = 0; n < CP / 8; ++n) {
            const int c = 8 * n + 2 * t;
            if (c < C)
              *reinterpret_cast<float2*>(dq + q_off + (size_t)p * C + c) =
                  make_float2(o[n][2 * h], o[n][2 * h + 1]);
          }
        }
      }
    }
    __syncthreads();  // every warp's P and ds rows are in shared memory

    // ---- Phase B: dK += ds^T Q, dV += P^T dO over the step's pixels,
    // under the permuted pixel index (k = t is pixel 2t, k = t + 4 is
    // 2t + 1).  Rows past the tile have zero q and dout, so they add
    // nothing; k-steps wholly past it are skipped. ----
    const int n_k = min(kStep / 8, (tile_end - base_px + 7) / 8);
    const float* at = which == 0 ? ds : ps;
    const float* bt = (which == 0 ? qs : gs) + buf * kStep * S;
    for (int kk = 0; kk < n_k; ++kk) {
      const int row = 8 * kk + 2 * t;
      uint32_t ah[P::kMPer][4], al[P::kMPer][4];
#pragma unroll
      for (int mi = 0; mi < P::kMPer; ++mi) {
        const int m0 = (mw * P::kMPer + mi) * 16;
        if (m0 < LP) {
          const float* a = at + row * SP + m0 + g;
          const float x[4] = {a[0], a[8], a[SP], a[SP + 8]};
          mr::split_tf32(x, ah[mi], al[mi]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < P::kNPer; ++ni) {
        const float* bp = bt + row * S + (nw * P::kNPer + ni) * 8 + g;
        uint32_t bh[2], bl[2];
        mr::split_tf32(bp[0], bh[0], bl[0]);
        mr::split_tf32(bp[S], bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < P::kMPer; ++mi)
          if ((mw * P::kMPer + mi) * 16 < LP) mr::mma_3xtf32(acc[mi][ni], ah[mi], al[mi], bh, bl);
      }
    }
    __syncthreads();  // the next step rewrites P, ds and the rows
  }

  // This block's partial sums: work[0 or 1][b][tile index][s][c].
  float* w = work + (((size_t)which * batch + b) * gridDim.x + blockIdx.x) * ((size_t)L * C);
#pragma unroll
  for (int mi = 0; mi < P::kMPer; ++mi)
#pragma unroll
    for (int ni = 0; ni < P::kNPer; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = (mw * P::kMPer + mi) * 16 + g + 8 * h;
        const int c = (nw * P::kNPer + ni) * 8 + 2 * t;
        if (s < L && c < C)
          *reinterpret_cast<float2*>(w + (size_t)s * C + c) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
}

template <int LP, int CP>
cudaError_t f32_launch(const void* q, const void* k, const void* v, const void* pad,
                       const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                       int hw, int L, int C, int tile, cudaStream_t stream) {
  constexpr size_t smem = BwdF32<LP, CP>::kSmem;
  static_assert(smem <= kMaxSmem, "shared memory of the f32 backward");
  auto kernel = memory_read_bwd_f32_kernel<LP, CP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (hw + tile - 1) / tile;
  kernel<<<dim3(n_tiles, batch), kTcWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(pad), static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(work), batch, hw, L, C, tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int LC = L * C;
  memory_read_bwd_reduce<float><<<dim3((LC + kReduceThreads - 1) / kReduceThreads, batch, 2),
                                  kReduceThreads, 0, stream>>>(
      static_cast<const float*>(work), static_cast<float*>(dk), static_cast<float*>(dv), batch,
      n_tiles, LC);
  return cudaGetLastError();
}

template <int LP>
cudaError_t f32_launch_c(const void* q, const void* k, const void* v, const void* pad,
                         const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                         int hw, int L, int C, int tile, cudaStream_t s) {
  switch (mr::pick_channels(C)) {
    case 16: return f32_launch<LP, 16>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 32: return f32_launch<LP, 32>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 64: return f32_launch<LP, 64>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 128: return f32_launch<LP, 128>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t f32_launch_l(const void* q, const void* k, const void* v, const void* pad,
                         const void* dout, void* dq, void* dk, void* dv, void* work, int batch,
                         int hw, int L, int C, int tile, cudaStream_t s) {
  switch (mr::pick_slots(L)) {
    case 16: return f32_launch_c<16>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 32: return f32_launch_c<32>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 64: return f32_launch_c<64>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 80: return f32_launch_c<80>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
    case 128: return f32_launch_c<128>(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout, dq: [batch, hw, C]; k, v, dk, dv: [batch, L, C], all contiguous,
// f32 (is_bf16 = 0; every pointer 4-byte aligned) or bf16 (is_bf16 = 1;
// every pointer 16-byte aligned).  pad: [batch, L] bytes, nonzero at a
// padding slot, or null.  work: f32 [2, batch, ceil(hw / tile), L, C].
// tile: pixels per block, a multiple of 128 in 128..65536.  Needs 1 <= L <= 128, 4 <= C <= 128 with C % 4 == 0,
// batch <= 65535.
extern "C" int t2igan_memory_read_bwd(const void* q, const void* k, const void* v,
                                      const void* pad, const void* dout, void* dq, void* dk,
                                      void* dv, void* work, int batch, int hw, int L, int C,
                                      int tile, int is_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || hw < 1 || L < 1 || L > 128 || C < 4 || C > 128 ||
      C % 4 != 0 || tile < kTcStep || tile > (1 << 16) || tile % kTcStep != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)tc_launch_l(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
  return (int)f32_launch_l(q, k, v, pad, dout, dq, dk, dv, work, batch, hw, L, C, tile, s);
}
