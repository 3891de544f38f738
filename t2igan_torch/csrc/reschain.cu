// Fused eval stage tail of the DM-GAN generator (K3): R residual blocks,
// the nearest-2x upsample conv with GLU and, optionally, the RGB head, on
// folded eval-mode BatchNorm weights.
//
// Replaces t2igan/ops/pallas/reschain.py::_make_kernel's `kernel` (the
// Pallas TPU kernel that resblock_chain_up_fused launches).  In NHWC, with
// every conv zero-padded at the image border:
//
//   R times:  y = GLU(conv3x3(h, k1) * s1 + b1)            (stored in T)
//             h = T(f32(h) + conv3x3(y, k2) * s2 + b2)
//   then      up = T(GLU(conv3x3(nearest2x(h), k_up) * s_up + b_up))
//   then      rgb = T(tanh(conv3x3(up, k_rgb)))             (optional)
//
// What bounds it: at the sampler's shapes (batch 128, C = 128, R = 2, H = W
// = 64 and 128) the two calls do 6.04 TFLOP and move ~1 GB at their edges,
// ~6000 flops per byte: far above the H100's ~295 bf16 flops per byte, so
// the work is bound by the tensor cores (6.1 ms at 989 TFLOP/s).
//
// What this first version does about it:
//  * Every conv is an implicit GEMM on the tensor cores in bf16
//    (mma.sync.m16n8k16, f32 accumulation): M = a tile of output pixels,
//    N = output channels, K = taps x input channels.  A block computes 128
//    pixels x 64 GEMM columns with 8 warps (4 along M, 2 along N; each warp
//    2 x 4 tiles of 16 x 8), walking K in 64-channel slices of one tap
//    that it stages in shared memory with 16-byte loads; out-of-image taps
//    load zeros, so no halo masks are needed.  No TMA, wgmma or software
//    pipeline yet: that is the next step toward the bound.
//  * The epilogues are fused: the folded BN affine, GLU (each block holds
//    the value half and the gate half of the same channels), the residual
//    add, tanh, and the bf16 rounding points of the Pallas kernel.
//  * The upsample conv runs as its four 2x2 subpixel phases (K = 4C instead
//    of 9C on the 4x larger map: 2.25x fewer flops), one phase per
//    blockIdx.z, each writing its interleaved pixels of [B, 2H, 2W, C/2].
//    The 2x-upsampled input and the pre-GLU 2C maps never exist in memory.
//  * The RGB head (3 output channels) uses one 8-column tile per warp.
//  * f32 (the dtype of the card check) runs the same tiling with CUDA-core
//    FMAs into the same accumulator layout.
//
// Device memory traffic between the launches: y and h [B, H, W, C] between
// the convs of each residual block, and `up` [B, 2H, 2W, C/2] between the
// upsample conv and the RGB head (1.07 GB at the last stage, batch 128,
// bf16).  Keeping the chain on chip is later work.
//
// C interface (loaded with ctypes): t2igan_reschain launches 2R + 1 kernels
// (2R + 2 with the head) on the given stream and returns the cudaError_t
// of the first failed launch, or 0.  It does not synchronise and allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { kGlu3x3 = 0, kResidual3x3 = 1, kUpPhase = 2, kRgb3x3 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

struct ConvArgs {
  const void* in;     // [B, H, W, Cin]
  const void* wt;     // [phases][N][taps * Cin]
  const float* aff;   // [2, N]: scale, shift (unused by the RGB head)
  const void* res;    // [B, H, W, N] residual (kResidual3x3 only; may alias out)
  void* out;          // see the epilogue
  int batch, H, W, Cin, N;
};

// WM x WN warps; each warp TM x TN tiles of 16 pixels x 8 columns.
template <typename T, int MODE, int WM, int WN, int TM, int TN>
__global__ void __launch_bounds__(WM * WN * 32)
reschain_conv(ConvArgs p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BM = WM * TM * 16;                 // pixels per block
  constexpr int NB = WN * TN * 8;                  // GEMM columns per block
  constexpr bool kGlu = MODE == kGlu3x3 || MODE == kUpPhase;
  constexpr int kVec = 16 / sizeof(T);             // elements per 16-byte load
  constexpr int BK = sizeof(T) == 2 ? 64 : 32;     // K slice (channels of one tap)
  constexpr int LDS = BK + kVec;                   // padded row: no bank conflicts
  constexpr int kVecPerRow = BK / kVec;
  constexpr int kRowsPerPass = kThreads / kVecPerRow;
  constexpr int kAPasses = BM / kRowsPerPass;
  constexpr int kTaps = MODE == kUpPhase ? 4 : 9;
  constexpr int kTapW = MODE == kUpPhase ? 2 : 3;
  static_assert(!kGlu || TN % 2 == 0, "GLU pairs value and gate tiles");
  static_assert(BM % kRowsPerPass == 0, "A tile rows per pass");

  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[NB * LDS];

  const T* __restrict__ in = static_cast<const T*>(p.in);
  const int H = p.H, W = p.W, Cin = p.Cin, N = p.N;
  const int K = kTaps * Cin;
  const long long M = (long long)p.batch * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int phase = blockIdx.z;                    // subpixel phase (kUpPhase)
  const int pa = phase >> 1, pb = phase & 1;
  const T* __restrict__ wt = static_cast<const T*>(p.wt) + (size_t)phase * N * K;
  const int half = kGlu ? N / 2 : N;               // channels out of the epilogue
  const int n0 = blockIdx.y * (kGlu ? NB / 2 : NB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;

  // Pixels of the A rows this thread stages (row = tid / kVecPerRow + pass).
  const int cv = tid % kVecPerRow;
  int pix_b[kAPasses], pix_y[kAPasses], pix_x[kAPasses];
#pragma unroll
  for (int j = 0; j < kAPasses; ++j) {
    const long long m = m0 + tid / kVecPerRow + j * kRowsPerPass;
    if (m < M) {
      pix_b[j] = (int)(m / ((long long)H * W));
      const int r = (int)(m - (long long)pix_b[j] * H * W);
      pix_y[j] = r / W;
      pix_x[j] = r - pix_y[j] * W;
    } else {
      pix_b[j] = -1; pix_y[j] = 0; pix_x[j] = 0;
    }
  }

  // Shared-memory row of this warp's n8 tile j; GEMM column of B-tile row r.
  auto tile_row = [&](int j) {
    if (kGlu) {
      constexpr int hn = TN / 2;
      return j < hn ? (wn * hn + j) * 8 : NB / 2 + (wn * hn + j - hn) * 8;
    }
    return (wn * TN + j) * 8;
  };
  auto column = [&](int r, bool& valid) {
    if (kGlu) {
      const int c = n0 + (r < NB / 2 ? r : r - NB / 2);
      valid = c < half;
      return r < NB / 2 ? c : half + c;
    }
    valid = n0 + r < N;
    return n0 + r;
  };

  float acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int tap = 0; tap < kTaps; ++tap) {
    const int tu = tap / kTapW, tv = tap - tu * kTapW;
    const int dy = MODE == kUpPhase ? pa + tu - 1 : tu - 1;
    const int dx = MODE == kUpPhase ? pb + tv - 1 : tv - 1;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int c = c0 + cv * kVec;
#pragma unroll
      for (int j = 0; j < kAPasses; ++j) {
        const int row = tid / kVecPerRow + j * kRowsPerPass;
        const int yy = pix_y[j] + dy, xx = pix_x[j] + dx;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (pix_b[j] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W && c < Cin)
          v = *reinterpret_cast<const uint4*>(
              in + (((size_t)pix_b[j] * H + yy) * W + xx) * Cin + c);
        *reinterpret_cast<uint4*>(As + row * LDS + cv * kVec) = v;
      }
      for (int i = tid; i < NB * kVecPerRow; i += kThreads) {
        const int r = i / kVecPerRow, cb = c0 + (i - r * kVecPerRow) * kVec;
        bool valid;
        const int n = column(r, valid);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (valid && cb < Cin)
          v = *reinterpret_cast<const uint4*>(wt + (size_t)n * K + (size_t)tap * Cin + cb);
        *reinterpret_cast<uint4*>(Bs + r * LDS + (i - r * kVecPerRow) * kVec) = v;
      }
      __syncthreads();

      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          uint32_t af[TM][4], bfr[TN][2];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const T* a = As + ((wm * TM + i) * 16 + g) * LDS + kk + 2 * t;
            af[i][0] = *reinterpret_cast<const uint32_t*>(a);
            af[i][1] = *reinterpret_cast<const uint32_t*>(a + 8 * LDS);
            af[i][2] = *reinterpret_cast<const uint32_t*>(a + 8);
            af[i][3] = *reinterpret_cast<const uint32_t*>(a + 8 * LDS + 8);
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const T* bp = Bs + (tile_row(j) + g) * LDS + kk + 2 * t;
            bfr[j][0] = *reinterpret_cast<const uint32_t*>(bp);
            bfr[j][1] = *reinterpret_cast<const uint32_t*>(bp + 8);
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              asm volatile(
                  "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                  "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                  : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
                    "+f"(acc[i][j][3])
                  : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                    "r"(bfr[j][0]), "r"(bfr[j][1]));
        }
      } else {
        // f32: CUDA-core FMAs into the mma accumulator layout (thread owns
        // rows g, g+8 and columns 2t, 2t+1 of each 16 x 8 tile).
#pragma unroll 4
        for (int k = 0; k < BK; ++k) {
          float av[TM][2], bv[TN][2];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int r = (wm * TM + i) * 16 + g;
            av[i][0] = to_f32(As[r * LDS + k]);
            av[i][1] = to_f32(As[(r + 8) * LDS + k]);
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int r = tile_row(j) + 2 * t;
            bv[j][0] = to_f32(Bs[r * LDS + k]);
            bv[j][1] = to_f32(Bs[(r + 1) * LDS + k]);
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc[i][j][0] = fmaf(av[i][0], bv[j][0], acc[i][j][0]);
              acc[i][j][1] = fmaf(av[i][0], bv[j][1], acc[i][j][1]);
              acc[i][j][2] = fmaf(av[i][1], bv[j][0], acc[i][j][2]);
              acc[i][j][3] = fmaf(av[i][1], bv[j][1], acc[i][j][3]);
            }
        }
      }
      __syncthreads();
    }
  }

  // Epilogue: element (row g + 8h, column 2t + e) of each tile.
  T* out = static_cast<T*>(p.out);
  const T* res = static_cast<const T*>(p.res);
  const float* scale = p.aff;
  const float* shift = p.aff + N;
  constexpr int kOutTiles = kGlu ? TN / 2 : TN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = m0 + (wm * TM + i) * 16 + g + 8 * hh;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kOutTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = tile_row(j) + 2 * t + e;
          bool valid;
          const int n = column(r, valid);
          if (!valid) continue;
          const float v = acc[i][j][2 * hh + e];
          if constexpr (MODE == kGlu3x3 || MODE == kUpPhase) {
            const float gate = acc[i][j + TN / 2][2 * hh + e];
            const float o = (v * scale[n] + shift[n]) *
                            sigmoidf(gate * scale[half + n] + shift[half + n]);
            size_t idx = (size_t)m * half + n;
            if (MODE == kUpPhase) {
              const long long hw = (long long)H * W;
              const long long bi = m / hw;
              const int rr = (int)(m - bi * hw);
              const int yy = rr / W, xx = rr - yy * W;
              idx = (((size_t)bi * 2 * H + 2 * yy + pa) * 2 * W + 2 * xx + pb) * half + n;
            }
            out[idx] = from_f32<T>(o);
          } else if constexpr (MODE == kResidual3x3) {
            const size_t idx = (size_t)m * N + n;
            out[idx] = from_f32<T>(to_f32(res[idx]) + v * scale[n] + shift[n]);
          } else {
            out[(size_t)m * N + n] = from_f32<T>(tanhf(v));
          }
        }
    }
}

template <typename T, int MODE, int WM, int WN, int TM, int TN>
cudaError_t launch(const ConvArgs& a, int gemm_cols, int phases, cudaStream_t stream) {
  constexpr int BM = WM * TM * 16;
  constexpr int NB = WN * TN * 8;
  constexpr bool kGlu = MODE == kGlu3x3 || MODE == kUpPhase;
  const long long M = (long long)a.batch * a.H * a.W;
  const int per_block = kGlu ? NB / 2 : NB;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (gemm_cols + per_block - 1) / per_block,
                  phases);
  reschain_conv<T, MODE, WM, WN, TM, TN><<<grid, WM * WN * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, int n_res, const void* const* w1, const void* const* a1,
                const void* const* w2, const void* const* a2, const void* w_up,
                const void* a_up, const void* w_rgb, void* up_out, void* rgb_out,
                void* scratch_y, void* scratch_h, int B, int H, int W, int C,
                cudaStream_t s) {
  cudaError_t err;
  const void* h = x;
  for (int r = 0; r < n_res; ++r) {
    // y = GLU(conv(h, k1) * s1 + b1): GEMM N = 2C, C channels out.
    ConvArgs c1{h, w1[r], static_cast<const float*>(a1[r]), nullptr, scratch_y,
                B, H, W, C, 2 * C};
    if ((err = launch<T, kGlu3x3, 4, 2, 2, 4>(c1, C, 1, s)) != cudaSuccess) return err;
    // h = h + conv(y, k2) * s2 + b2, written to scratch_h (in place after
    // the first block: each element's residual is read by the thread
    // that overwrites it).
    ConvArgs c2{scratch_y, w2[r], static_cast<const float*>(a2[r]), h, scratch_h,
                B, H, W, C, C};
    if ((err = launch<T, kResidual3x3, 4, 2, 2, 4>(c2, C, 1, s)) != cudaSuccess) return err;
    h = scratch_h;
  }
  // up = GLU(conv(nearest2x(h), k_up) * s + b) as four subpixel phases.
  ConvArgs cu{h, w_up, static_cast<const float*>(a_up), nullptr, up_out, B, H, W, C, C};
  if ((err = launch<T, kUpPhase, 4, 2, 2, 4>(cu, C / 2, 4, s)) != cudaSuccess) return err;
  if (w_rgb != nullptr) {
    ConvArgs cr{up_out, w_rgb, nullptr, nullptr, rgb_out, B, 2 * H, 2 * W, C / 2, 3};
    if ((err = launch<T, kRgb3x3, 8, 1, 2, 1>(cr, 3, 1, s)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x: [B, H, W, C] contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); C a
// multiple of 16, n_res >= 1.  w1[r]: [2C][9C], w2[r]: [C][9C], w_up:
// [4][C][4C] (the subpixel phase kernels), w_rgb: [3][9 * C/2] or null, all
// in x's dtype with each output channel's (tap, channel) run contiguous.
// a1[r]: f32 [2, 2C]; a2[r], a_up: f32 [2, C] (scale row, shift row).
// up_out: [B, 2H, 2W, C/2]; rgb_out: [B, 2H, 2W, 3] when w_rgb is given;
// scratch_y, scratch_h: [B, H, W, C] each.  x is not written.
extern "C" int t2igan_reschain(const void* x, int n_res, const void* const* w1,
                               const void* const* a1, const void* const* w2,
                               const void* const* a2, const void* w_up, const void* a_up,
                               const void* w_rgb, void* up_out, void* rgb_out,
                               void* scratch_y, void* scratch_h, int B, int H, int W,
                               int C, int is_bf16, void* stream) {
  if (n_res < 1 || B < 1 || H < 1 || W < 1 || C < 16 || C % 16 != 0 ||
      (long long)B * 4 * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run<__nv_bfloat16>(x, n_res, w1, a1, w2, a2, w_up, a_up, w_rgb, up_out,
                                   rgb_out, scratch_y, scratch_h, B, H, W, C, s);
  return (int)run<float>(x, n_res, w1, a1, w2, a2, w_up, a_up, w_rgb, up_out, rgb_out,
                         scratch_y, scratch_h, B, H, W, C, s);
}
