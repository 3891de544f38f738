// Fused eval stage tail of the DM-GAN generator (K3): R residual blocks,
// the nearest-2x upsample conv with GLU and, optionally, the RGB head, on
// folded eval-mode BatchNorm weights.
//
// Replaces t2igan/ops/pallas/reschain.py::_make_kernel's `kernel` (the
// Pallas TPU kernel that resblock_chain_up_fused launches).  In NHWC, with
// every conv zero-padded at the image border:
//
//   R times:  y = T(GLU(conv3x3(h, k1) * s1 + b1))
//             h = T(f32(h) + conv3x3(y, k2) * s2 + b2)
//   then      up = T(GLU(conv3x3(nearest2x(h), k_up) * s_up + b_up))
//   then      rgb = T(tanh(conv3x3(up, k_rgb)))             (optional)
//
// with T the storage type and every conv summed in f32 (the Pallas kernel's
// rounding points).  The upsample conv runs as its four 2x2 subpixel phases
// (K = 4C on the low-res map instead of 9C on the 4x larger one); the 2x
// input and the pre-GLU maps never exist in memory.
//
// What bounds it: at the sampler's shapes (batch 128, C = 128, R = 2, H = W
// = 64 and 128) the two calls do 6.04 TFLOP and move ~1 GB at their edges,
// ~6000 flops per byte, far above the H100's ~295 bf16 flops per byte: the
// convs are bound by the tensor cores (6.1 ms at 989 TFLOP/s).  The RGB
// head alone is bound by bytes (it reads the 1.07 GB `up` map at 256^2).
//
// bf16, on Hopper (conv_tc, rgb_head_tc):
//  * Each conv is an implicit GEMM on wgmma (m64nNk16, f32 accumulators).
//    M is a tile of 128 (C -> 2C) or 256 (C -> C, upsample) output pixels
//    taken as a rows x cols patch of one image (tile_geometry in
//    ops/kernels/reschain.py picks it): 64 or 128 rows for each of two
//    consumer warpgroups.  N is every GEMM column of the conv in one block
//    (256 for C -> 2C, 128 for C -> C and for one upsample phase), so each
//    input tile is staged once per conv.  K walks taps x input channels in
//    slices of one tap x 64 channels (128-byte rows and swizzle) or, for
//    C -> C, x 32 (64-byte rows and swizzle, 6 stages instead of 3): the
//    fastest of those measured for each kind.
//  * A producer warp feeds a ring of shared-memory stages with TMA: the
//    input tile of tap (dy, dx) is the box at (b, y0 + dy, x0 + dx, c0) of
//    a 4-D tensor map over the NHWC input, and TMA fills coordinates
//    outside the image (negative ones too) with zeros: the convs' zero
//    padding, with no masks.  Weight tiles are boxes of a 4-D map over
//    [phases][N][taps][Cin] (zeros past Cin and N as well).  Full/empty
//    mbarriers pace the ring; setmaxnreg moves registers from the producer
//    warpgroup to the two consumer warpgroups.
//  * Blocks run in clusters of two on neighbouring pixel patches: each
//    loads half of every weight tile and multicasts it to both, halving
//    the weights' L2 traffic (faster for every conv kind, as measured).
//    The grid is persistent (as many clusters as the card holds, walking
//    the tiles), so the producer loads the next tile during the epilogue.
//  * Epilogues in registers: the affine, GLU (the wrapper interleaves the
//    value and gate columns in groups of 8, so a thread holds each
//    channel's value and gate), the residual add in f32 (the residual is
//    read at the tile's start, before its own pixels are overwritten when
//    the residual conv runs in place), one rounding to bf16.  No branch on
//    the columns (the affines are zero-padded) and single-op exp and
//    reciprocal in the sigmoid: with an IEEE reciprocal the epilogue, which
//    no product overlaps, was the largest cost of the GLU convs.  The tile
//    is staged through swizzled shared memory and written as 16-byte rows.
//  * The RGB head (C/2 -> 3, tanh) is its own kernel, built for bytes:
//    each block loads an 8 x 32 pixel tile of `up` with its one-pixel halo
//    in one TMA box (zeros outside the image), runs mma.sync m16n8k16 with
//    the 3 output channels in an 8-column tile, and writes 6-byte pixels as
//    16-byte stores where a tile row allows.
//
// f32 (the dtype of the card check) stays on the CUDA cores (reschain_conv):
// 128 pixels x 64 GEMM columns a block, K staged in shared memory with
// 16-byte loads, the value half and the gate half of the same channels in
// one block (the wrapper's f32 layout is the plain [Cout][taps x Cin]).
//
// Device memory traffic between the launches: y and h [B, H, W, C] between
// the convs of each residual block, and `up` [B, 2H, 2W, C/2] between the
// upsample conv and the RGB head.  Keeping the chain on chip is later work.
//
// C interface (loaded with ctypes): t2igan_reschain launches 2R + 1 kernels
// (2R + 2 with the head) on the given stream and returns the cudaError_t
// of the first failed launch, or 0.  It does not synchronise and allocates
// nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_tma.cuh"

namespace {

enum Mode { kGlu3x3 = 0, kResidual3x3 = 1, kUpPhase = 2, kRgb3x3 = 3 };

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }
// The bf16 epilogues' sigmoid: approximate exp and reciprocal, one MUFU
// op each (a few ulp in f32, far below the bf16 rounding that follows).
__device__ __forceinline__ float fast_sigmoidf(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + __expf(-x)));
  return r;
}

// ===========================================================================
// f32: CUDA cores
// ===========================================================================

struct ConvArgs {
  const float* in;    // [B, H, W, Cin]
  const float* wt;    // [phases][N][taps * Cin]
  const float* aff;   // [2, N]: scale, shift (unused by the RGB head)
  const float* res;   // [B, H, W, N] residual (kResidual3x3 only; may alias out)
  float* out;         // see the epilogue
  int batch, H, W, Cin, N;
};

// WM x WN warps; each warp TM x TN tiles of 16 pixels x 8 columns; thread
// (g, t) of a warp owns rows g, g + 8 and columns 2t, 2t + 1 of each tile.
template <int MODE, int WM, int WN, int TM, int TN>
__global__ void __launch_bounds__(WM * WN * 32)
reschain_conv(ConvArgs p) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BM = WM * TM * 16;                 // pixels per block
  constexpr int NB = WN * TN * 8;                  // GEMM columns per block
  constexpr bool kGlu = MODE == kGlu3x3 || MODE == kUpPhase;
  constexpr int kVec = 4;                          // floats per 16-byte load
  constexpr int BK = 32;                           // K slice (channels of one tap)
  constexpr int LDS = BK + kVec;                   // padded row: no bank conflicts
  constexpr int kVecPerRow = BK / kVec;
  constexpr int kRowsPerPass = kThreads / kVecPerRow;
  constexpr int kAPasses = BM / kRowsPerPass;
  constexpr int kTaps = MODE == kUpPhase ? 4 : 9;
  constexpr int kTapW = MODE == kUpPhase ? 2 : 3;
  static_assert(!kGlu || TN % 2 == 0, "GLU pairs value and gate tiles");
  static_assert(BM % kRowsPerPass == 0, "A tile rows per pass");

  __shared__ __align__(16) float As[BM * LDS];
  __shared__ __align__(16) float Bs[NB * LDS];

  const float* __restrict__ in = p.in;
  const int H = p.H, W = p.W, Cin = p.Cin, N = p.N;
  const int K = kTaps * Cin;
  const long long M = (long long)p.batch * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int phase = blockIdx.z;                    // subpixel phase (kUpPhase)
  const int pa = phase >> 1, pb = phase & 1;
  const float* __restrict__ wt = p.wt + (size_t)phase * N * K;
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

#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float av[TM][2], bv[TN][2];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = (wm * TM + i) * 16 + g;
          av[i][0] = As[r * LDS + k];
          av[i][1] = As[(r + 8) * LDS + k];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int r = tile_row(j) + 2 * t;
          bv[j][0] = Bs[r * LDS + k];
          bv[j][1] = Bs[(r + 1) * LDS + k];
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
      __syncthreads();
    }
  }

  // Epilogue: element (row g + 8h, column 2t + e) of each tile.
  float* out = p.out;
  const float* res = p.res;
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
            out[idx] = o;
          } else if constexpr (MODE == kResidual3x3) {
            const size_t idx = (size_t)m * N + n;
            out[idx] = res[idx] + v * scale[n] + shift[n];
          } else {
            out[(size_t)m * N + n] = tanhf(v);
          }
        }
    }
}

template <int MODE, int WM, int WN, int TM, int TN>
cudaError_t launch(const ConvArgs& a, int gemm_cols, int phases, cudaStream_t stream) {
  constexpr int BM = WM * TM * 16;
  constexpr int NB = WN * TN * 8;
  constexpr bool kGlu = MODE == kGlu3x3 || MODE == kUpPhase;
  const long long M = (long long)a.batch * a.H * a.W;
  const int per_block = kGlu ? NB / 2 : NB;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (gemm_cols + per_block - 1) / per_block,
                  phases);
  reschain_conv<MODE, WM, WN, TM, TN><<<grid, WM * WN * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run_f32(const float* x, int n_res, const void* const* w1, const void* const* a1,
                    const void* const* w2, const void* const* a2, const void* w_up,
                    const void* a_up, const void* w_rgb, void* up_out, void* rgb_out,
                    void* scratch_y, void* scratch_h, int B, int H, int W, int C,
                    cudaStream_t s) {
  cudaError_t err;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  float* y = static_cast<float*>(scratch_y);
  float* hs = static_cast<float*>(scratch_h);
  const float* h = x;
  for (int r = 0; r < n_res; ++r) {
    // y = GLU(conv(h, k1) * s1 + b1): GEMM N = 2C, C channels out.
    ConvArgs c1{h, f(w1[r]), f(a1[r]), nullptr, y, B, H, W, C, 2 * C};
    if ((err = launch<kGlu3x3, 4, 2, 2, 4>(c1, C, 1, s)) != cudaSuccess) return err;
    // h = h + conv(y, k2) * s2 + b2, written to scratch_h (in place after
    // the first block: each element's residual is read by the thread
    // that overwrites it).
    ConvArgs c2{y, f(w2[r]), f(a2[r]), h, hs, B, H, W, C, C};
    if ((err = launch<kResidual3x3, 4, 2, 2, 4>(c2, C, 1, s)) != cudaSuccess) return err;
    h = hs;
  }
  // up = GLU(conv(nearest2x(h), k_up) * s + b) as four subpixel phases.
  ConvArgs cu{h, f(w_up), f(a_up), nullptr, static_cast<float*>(up_out), B, H, W, C, C};
  if ((err = launch<kUpPhase, 4, 2, 2, 4>(cu, C / 2, 4, s)) != cudaSuccess) return err;
  if (w_rgb != nullptr) {
    ConvArgs cr{static_cast<const float*>(up_out), f(w_rgb), nullptr, nullptr,
                static_cast<float*>(rgb_out), B, 2 * H, 2 * W, C / 2, 3};
    if ((err = launch<kRgb3x3, 8, 1, 2, 1>(cr, 3, 1, s)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ===========================================================================
// bf16: wgmma + TMA
// ===========================================================================

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;          // threads 0..255 consume, 256..383 produce
constexpr int kThreadsTc = 384;
constexpr int kSmemMax = 232448;         // shared memory a block can have
constexpr int kCluster = 2;              // blocks sharing each weight tile by multicast
constexpr int kAffinePad = 256;          // affine rows are zero-padded to this many columns

struct TcArgs {
  const float* aff;   // [2][n_tiles * BN]: scale row, shift row, GEMM column order, zero-padded
  const bf16* res;    // kResidual3x3: [B, H, W, c_out], may alias out
  bf16* out;          // [B, H, W, c_out]; kUpPhase: [B, 2H, 2W, c_out]
  int H, W;           // the input's grid
  int cin, n_gemm, c_out;
  int rows, cols;     // the pixel patch of a tile: rows x cols = kBM
  int tiles_y, tiles_x, m_tiles, n_tiles;
  int m_groups, total;  // pixel patches of a cluster (one a block), groups in all
  int aff_stride;      // n_gemm rounded up to kAffinePad
};

// A tile: BM = 128 MW output pixels x BN GEMM columns; consumer warpgroup
// wg owns pixels 64 MW wg .. 64 MW (wg + 1) - 1, as MW wgmma row blocks of
// 64.  K slices of BK channels (a 2 BK-byte swizzled row).  One block an
// SM; the ring takes as many stages as fit beside the staging tiles.
template <int MODE, int BN, int MW, int BK>
struct TcShape {
  static constexpr bool kGlu = MODE != kResidual3x3;
  static constexpr int kBM = 128 * MW;
  static constexpr int kOutCh = kGlu ? BN / 2 : BN;  // channels a tile writes
  static constexpr int kRow = BK * 2;                // bytes of a tile row
  static constexpr int kABytes = kBM * kRow;
  static constexpr int kBBytes = BN * kRow;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRowBytes = kOutCh * 2;       // a staged output pixel
  static constexpr int kStgBytes = 64 * MW * kRowBytes;  // per consumer warpgroup
  static constexpr int kFree = kSmemMax - 1024 - 2 * kStgBytes - 8 * 16;
  static constexpr int kStages = kFree / kStageBytes < 8 ? kFree / kStageBytes : 8;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStgBytes + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 4 && kSmem <= kSmemMax, "shared memory of one block");
};

struct Tile {
  int b, y0, x0, n0, phase;
  bool valid;  // false: the second patch of a pair past the last one (zeros in, no stores)
};

// Group t of a cluster: pixel patch groups fastest, then N tiles, then
// subpixel phases; the block of cluster rank r takes patch kCluster
// (t % m_groups) + r.  The blocks of a group share the weight tile (n0,
// phase).
__device__ __forceinline__ Tile decode(const TcArgs& p, int t, uint32_t rank, int bn) {
  Tile r;
  const int mt = kCluster * (t % p.m_groups) + (int)rank, rest = t / p.m_groups;
  r.valid = mt < p.m_tiles;
  r.n0 = (rest % p.n_tiles) * bn;
  r.phase = rest / p.n_tiles;
  const int per_img = p.tiles_y * p.tiles_x;
  r.b = mt / per_img;
  const int s = mt - r.b * per_img;
  r.y0 = (s / p.tiles_x) * p.rows;
  r.x0 = (s - (s / p.tiles_x) * p.tiles_x) * p.cols;
  return r;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (tc::smem_u32(p) & 1023)) & 1023);
}

// Stores the bf16 pair (lo, hi) of channels 8 * chunk + 2 * t4 (+1) of
// staged pixel row r; chunks are XOR-swizzled by r % 8 (no bank conflicts).
__device__ __forceinline__ void stage_pair(uint8_t* stg, int row_bytes, int r, int chunk, int t4,
                                           float lo, float hi) {
  *reinterpret_cast<uint32_t*>(stg + r * row_bytes + ((chunk ^ (r & 7)) << 4) + 4 * t4) =
      mr::pack_bf16(lo, hi);
}

template <int MODE, int BN, int MW, int BK>
__global__ void __launch_bounds__(kThreadsTc, 1)
conv_tc(const __grid_constant__ CUtensorMap in_map, const __grid_constant__ CUtensorMap wt_map,
        const TcArgs p) {
  using S = TcShape<MODE, BN, MW, BK>;
  constexpr int kABytes = S::kABytes;
  constexpr int kTaps = MODE == kUpPhase ? 4 : 9;
  constexpr int kTapW = MODE == kUpPhase ? 2 : 3;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_tiles = align1024(smem_raw);                 // [stages][kBM pixels][kRow]
  uint8_t* b_tiles = a_tiles + S::kStages * kABytes;      // [stages][BN columns][kRow]
  uint8_t* stg = b_tiles + S::kStages * S::kBBytes;       // [2][64 pixels][kRowBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + 2 * S::kStgBytes);
  uint64_t* empty = full + S::kStages;

  const int k_slices = (p.cin + BK - 1) / BK;
  const int k_iters = kTaps * k_slices;
  const uint32_t rank = tc::cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      // One arrival per consumer warp of both blocks: the peer's half of
      // each weight tile lands in this block's stage too.
      tc::mbar_init(&empty[s], kCluster * kConsumers / 32);
    }
    tc::fence_barrier_init();
  }
  tc::cluster_sync();  // both blocks' barriers exist before any multicast

  if (threadIdx.x >= kConsumers) {
    // Producer warpgroup: one thread keeps the ring full.
    tc::reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      tc::prefetch_tensormap(&in_map);
      tc::prefetch_tensormap(&wt_map);
      int stage = 0;
      uint32_t parity = 0;
      for (int t = cluster; t < p.total; t += clusters) {
        const Tile tl = decode(p, t, rank, BN);
        const int pa = tl.phase >> 1, pb = tl.phase & 1;
        for (int it = 0; it < k_iters; ++it) {
          const int tap = it / k_slices, c0 = (it - tap * k_slices) * BK;
          const int tu = tap / kTapW, tv = tap - tu * kTapW;
          const int dy = MODE == kUpPhase ? pa + tu - 1 : tu - 1;
          const int dx = MODE == kUpPhase ? pb + tv - 1 : tv - 1;
          tc::mbar_wait(&empty[stage], parity ^ 1);
          tc::mbar_expect_tx(&full[stage], S::kStageBytes);
          tc::tma_load_4d(a_tiles + stage * kABytes, &in_map, &full[stage], c0, tl.x0 + dx,
                          tl.y0 + dy, tl.b);
          // This block's half of the weight tile, to both blocks.
          tc::tma_load_4d_multicast(b_tiles + stage * S::kBBytes + rank * (BN / 2) * S::kRow,
                                    &wt_map, &full[stage], (1 << kCluster) - 1, c0, tap,
                                    tl.n0 + (int)rank * (BN / 2), tl.phase);
          if (++stage == S::kStages) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
      // Wait until both blocks' consumers have released every stage: no
      // arrival or multicast reaches this block after it exits.
      for (int i = 0; i < S::kStages; ++i) {
        tc::mbar_wait(&empty[stage], parity ^ 1);
        if (++stage == S::kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroups: rows 64 MW wg .. 64 MW (wg + 1) - 1 of each tile.
    tc::reg_alloc<232>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    uint8_t* my_stg = stg + wg * S::kStgBytes;
    const float* scale = p.aff;
    const float* shift = p.aff + p.aff_stride;
    const int cols_log2 = __ffs(p.cols) - 1;  // patch widths are powers of two
    float acc[MW][BN / 2];
    int stage = 0;
    uint32_t parity = 0;
    for (int t = cluster; t < p.total; t += clusters) {
      const Tile tl = decode(p, t, rank, BN);

      // The residual of this thread's outputs, read before the mainloop
      // (rows 64 mw + 16 warp + g + 8h, channels n0 + 8j + 2 t4 (+1)).
      uint32_t res_v[MW][MODE == kResidual3x3 ? BN / 4 : 1];
      if constexpr (MODE == kResidual3x3) {
#pragma unroll
        for (int mw = 0; mw < MW; ++mw)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 64 * (MW * wg + mw) + 16 * warp + g + 8 * h;
            const int y = tl.y0 + (m >> cols_log2), x = tl.x0 + (m & (p.cols - 1));
            const bool in = tl.valid && y < p.H && x < p.W;
            const bf16* src =
                p.res + ((size_t)(tl.b * p.H + y) * p.W + x) * p.c_out + tl.n0 + 2 * t4;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
              res_v[mw][2 * j + h] = in && tl.n0 + 8 * j < p.n_gemm
                                         ? *reinterpret_cast<const uint32_t*>(src + 8 * j)
                                         : 0u;
          }
      }

#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mw][i] = 0.f;
      int prev = -1;
      for (int it = 0; it < k_iters; ++it) {
        tc::mbar_wait(&full[stage], parity);
        const uint64_t da =
            tc::swizzle_desc<S::kRow>(a_tiles + stage * kABytes + wg * MW * 64 * S::kRow);
        const uint64_t db = tc::swizzle_desc<S::kRow>(b_tiles + stage * S::kBBytes);
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) tc::fence_regs(acc[mw]);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int mw = 0; mw < MW; ++mw)
            tc::wgmma_bf16<BN>(acc[mw], da + mw * (64 * S::kRow / 16) + 2 * kk, db + 2 * kk);
        tc::wgmma_commit();
        // Keep this slice's products in flight; the previous slice's are
        // done, so its stage goes back to the producer.
        tc::wgmma_wait<1>();
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) tc::fence_regs(acc[mw]);
        if (prev >= 0 && lane == 0)
          for (uint32_t r = 0; r < kCluster; ++r) tc::mbar_arrive_cluster(&empty[prev], r);
        prev = stage;
        if (++stage == S::kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
      tc::wgmma_wait<0>();
#pragma unroll
      for (int mw = 0; mw < MW; ++mw) tc::fence_regs(acc[mw]);
      if (lane == 0)
        for (uint32_t r = 0; r < kCluster; ++r) tc::mbar_arrive_cluster(&empty[prev], r);

      // Epilogue into the staging tile: pixel row 64 mw + 16 warp + g + 8h.
      // No branch on the columns: past n_gemm the weights and the padded
      // affine are zeros, and the copy below skips those channels.
      if constexpr (S::kGlu) {
        // Columns 16q .. 16q + 7: values of channels 8q .. 8q + 7 of this
        // tile; 16q + 8 .. 16q + 15: their gates.
#pragma unroll
        for (int q = 0; q < BN / 16; ++q) {
          const int col = tl.n0 + 16 * q + 2 * t4;
          const float2 sv = __ldg(reinterpret_cast<const float2*>(scale + col));
          const float2 sg = __ldg(reinterpret_cast<const float2*>(scale + col + 8));
          const float2 bv = __ldg(reinterpret_cast<const float2*>(shift + col));
          const float2 bg = __ldg(reinterpret_cast<const float2*>(shift + col + 8));
#pragma unroll
          for (int mw = 0; mw < MW; ++mw)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v0 = acc[mw][8 * q + 2 * h] * sv.x + bv.x;
              const float v1 = acc[mw][8 * q + 2 * h + 1] * sv.y + bv.y;
              const float g0 = acc[mw][8 * q + 4 + 2 * h] * sg.x + bg.x;
              const float g1 = acc[mw][8 * q + 4 + 2 * h + 1] * sg.y + bg.y;
              stage_pair(my_stg, S::kRowBytes, 64 * mw + 16 * warp + g + 8 * h, q, t4,
                         v0 * fast_sigmoidf(g0), v1 * fast_sigmoidf(g1));
            }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = tl.n0 + 8 * j + 2 * t4;
          const float2 s = __ldg(reinterpret_cast<const float2*>(scale + col));
          const float2 b = __ldg(reinterpret_cast<const float2*>(shift + col));
#pragma unroll
          for (int mw = 0; mw < MW; ++mw)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t rv = res_v[mw][2 * j + h];
              const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
              stage_pair(my_stg, S::kRowBytes, 64 * mw + 16 * warp + g + 8 * h, j, t4,
                         r.x + (acc[mw][4 * j + 2 * h] * s.x + b.x),
                         r.y + (acc[mw][4 * j + 2 * h + 1] * s.y + b.y));
            }
        }
      }
      tc::named_barrier(1 + wg, 128);

      // 16-byte rows out: in-image pixels and channels only.
      constexpr int kChunks = S::kOutCh / 8;
      const int ch0 = S::kGlu ? tl.n0 / 2 : tl.n0;
      const int pa = tl.phase >> 1, pb = tl.phase & 1;
      for (int i = threadIdx.x & 127; i < 64 * MW * kChunks; i += 128) {
        const int r = i / kChunks, c = i - r * kChunks;
        const int m = 64 * MW * wg + r;
        const int y = tl.y0 + (m >> cols_log2), x = tl.x0 + (m & (p.cols - 1));
        const int ch = ch0 + 8 * c;
        if (!tl.valid || y >= p.H || x >= p.W || ch >= p.c_out) continue;
        const uint4 v =
            *reinterpret_cast<const uint4*>(my_stg + r * S::kRowBytes + ((c ^ (r & 7)) << 4));
        const size_t pix = MODE == kUpPhase
                               ? ((size_t)(tl.b * 2 * p.H + 2 * y + pa)) * 2 * p.W + 2 * x + pb
                               : (size_t)(tl.b * p.H + y) * p.W + x;
        *reinterpret_cast<uint4*>(p.out + pix * p.c_out + ch) = v;
      }
      tc::named_barrier(1 + wg, 128);  // the staging tile is free again
    }
  }
}

// The RGB head: an 8 x 32 pixel tile a block, 8 warps, warp w on tile row w
// (two 16-pixel m16 tiles), 3 output channels in one n8 tile.
constexpr int kHeadRows = 8, kHeadCols = 32;
constexpr int kHaloRows = kHeadRows + 2, kHaloCols = kHeadCols + 2;
constexpr int kHaloBytes = kHaloRows * kHaloCols * 128;
constexpr int kHeadThreads = 32 * kHeadRows;
constexpr int kHeadCh = 64;               // channels a halo slice: 128 bytes, 128-byte swizzle
constexpr int kWsStride = 9 * kHeadCh + 8;  // bf16 a weight row: +16 bytes, no bank conflicts
constexpr int kHeadSmem =
    kHaloBytes + 8 * kWsStride * 2 + kHeadRows * kHeadCols * 3 * 2 + 16 + 1024;

struct HeadArgs {
  const bf16* wt;  // [3][9 * cin]
  bf16* out;       // [B, H, W, 3]
  int H, W, cin, tiles_y, tiles_x;
};

__global__ void __launch_bounds__(kHeadThreads, 3)
rgb_head_tc(const __grid_constant__ CUtensorMap up_map, const HeadArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* halo = align1024(smem_raw);                  // [10 x 34 pixels][128 B], swizzled
  bf16* ws = reinterpret_cast<bf16*>(halo + kHaloBytes);  // [8][kWsStride], rows 3..7 zero
  bf16* os = ws + 8 * kWsStride;                          // [8][32][3]
  uint64_t* bar = reinterpret_cast<uint64_t*>(os + kHeadRows * kHeadCols * 3);

  const int per_img = p.tiles_y * p.tiles_x;
  const int b = blockIdx.x / per_img, s = blockIdx.x - b * per_img;
  const int ty = s / p.tiles_x;
  const int y0 = ty * kHeadRows, x0 = (s - ty * p.tiles_x) * kHeadCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  if (threadIdx.x == 0) {
    tc::mbar_init(bar, 1);
    tc::fence_barrier_init();
  }
  __syncthreads();

  float acc[2][4] = {};
  const int slices = (p.cin + kHeadCh - 1) / kHeadCh;
  for (int sl = 0; sl < slices; ++sl) {
    if (threadIdx.x == 0) {
      tc::mbar_expect_tx(bar, kHaloBytes);
      tc::tma_load_4d(halo, &up_map, bar, sl * kHeadCh, x0 - 1, y0 - 1, b);
    }
    for (int i = threadIdx.x; i < 8 * 9 * kHeadCh; i += kHeadThreads) {
      const int n = i / (9 * kHeadCh), r = i - n * 9 * kHeadCh;
      const int tap = r / kHeadCh, c = sl * kHeadCh + r - tap * kHeadCh;
      ws[n * kWsStride + r] =
          n < 3 && c < p.cin ? p.wt[(size_t)n * 9 * p.cin + tap * p.cin + c] : __float2bfloat16(0.f);
    }
    __syncthreads();
    tc::mbar_wait(bar, sl & 1);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int u = tap / 3, v = tap - u * 3;
#pragma unroll
      for (int kk = 0; kk < kHeadCh / 16; ++kk) {
        const bf16* wb = ws + g * kWsStride + tap * kHeadCh + kk * 16 + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wb + 8);
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          // Lane l reads row l % 16 of the A tile, channels 8 (l / 16)..+7.
          const int hr = (warp + u) * kHaloCols + 16 * grp + (lane & 15) + v;
          const int kc = 2 * kk + (lane >> 4);
          uint32_t a[4];
          mr::ldmatrix_x4(a, halo + hr * 128 + ((kc ^ (hr & 7)) << 4));
          mr::mma_bf16(acc[grp], a, b0, b1);
        }
      }
    }
    __syncthreads();  // halo and weights are free for the next slice
  }

  // Channel 2 t4 + e of pixels 16 grp + g (+8): t4 = 0 holds 0 and 1, t4 = 1
  // holds 2.
  if (t4 < 2) {
#pragma unroll
    for (int grp = 0; grp < 2; ++grp)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = 2 * t4 + e;
          if (ch < 3)
            os[(warp * kHeadCols + 16 * grp + g + 8 * h) * 3 + ch] =
                __float2bfloat16(tanhf(acc[grp][2 * h + e]));
        }
  }
  __syncthreads();

  // Warp w writes tile row w: 16-byte stores for a whole, aligned row.
  const int y = y0 + warp;
  if (y >= p.H) return;
  const int nx = min(kHeadCols, p.W - x0);
  bf16* dst = p.out + ((size_t)(b * p.H + y) * p.W + x0) * 3;
  const bf16* src = os + warp * kHeadCols * 3;
  if (nx == kHeadCols && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    if (lane < kHeadCols * 3 * 2 / 16)
      reinterpret_cast<uint4*>(dst)[lane] = reinterpret_cast<const uint4*>(src)[lane];
  } else {
    for (int i = lane; i < nx * 3; i += 32) dst[i] = src[i];
  }
}

// --- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D bf16 tensor map, dims innermost first, dense strides, zeros
// outside.
bool map_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
            const uint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4] = {1, 1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < 4; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    stride *= dims[i];
    if (i < 3) gstride[i] = stride;
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim, gstride,
             bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Geometry {
  int rows, cols, tiles_y, tiles_x, channels;  // channels: the TMA box's depth
};

// One conv: input map over [B, H, W, cin] (box BK x cols x rows x 1),
// weight map over [phases][n_gemm][taps][cin] (box BK x 1 x BN x 1).
template <int MODE, int BN, int MW, int BK>
cudaError_t launch_tc(const void* in, const void* wt, const float* aff, const bf16* res, bf16* out,
                      int B, int H, int W, int cin, int n_gemm, int c_out, const Geometry& geo,
                      int sms, cudaStream_t s) {
  using S = TcShape<MODE, BN, MW, BK>;
  constexpr int kTaps = MODE == kUpPhase ? 4 : 9;
  constexpr CUtensorMapSwizzle kSwizzle =
      S::kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (geo.rows * geo.cols != S::kBM || geo.tiles_y * geo.rows < H ||
      geo.tiles_x * geo.cols < W || geo.channels != BK)
    return cudaErrorInvalidValue;
  const int phases = MODE == kUpPhase ? 4 : 1;
  CUtensorMap in_map, wt_map;
  if (!map_4d(&in_map, in, {(uint64_t)cin, (uint64_t)W, (uint64_t)H, (uint64_t)B},
              {BK, (uint32_t)geo.cols, (uint32_t)geo.rows, 1}, kSwizzle) ||
      !map_4d(&wt_map, wt, {(uint64_t)cin, kTaps, (uint64_t)n_gemm, (uint64_t)phases},
              {BK, 1, BN / kCluster, 1}, kSwizzle))
    return cudaErrorInvalidValue;
  TcArgs a{aff, res, out, H, W, cin, n_gemm, c_out, geo.rows, geo.cols, geo.tiles_y,
           geo.tiles_x, 0, 0, 0, 0, (n_gemm + kAffinePad - 1) / kAffinePad * kAffinePad};
  a.m_tiles = B * geo.tiles_y * geo.tiles_x;
  a.n_tiles = (n_gemm + BN - 1) / BN;
  a.m_groups = (a.m_tiles + kCluster - 1) / kCluster;
  a.total = a.m_groups * a.n_tiles * phases;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreadsTc);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  // Once per kernel (the calls are not free): the shared memory it takes
  // and how many clusters of it the card holds at once.
  static int max_clusters = 0;
  if (max_clusters == 0) {
    cudaError_t err = cudaFuncSetAttribute(conv_tc<MODE, BN, MW, BK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(kCluster * sms / 2);
    err = cudaOccupancyMaxActiveClusters(&max_clusters, conv_tc<MODE, BN, MW, BK>, &cfg);
    if (err != cudaSuccess) return err;
    if (max_clusters < 1) return cudaErrorInvalidConfiguration;
  }
  // Persistent: as many clusters as the card holds at once.
  cfg.gridDim = dim3(kCluster * (a.total < max_clusters ? a.total : max_clusters));
  return cudaLaunchKernelEx(&cfg, conv_tc<MODE, BN, MW, BK>, in_map, wt_map, a);
}

cudaError_t run_bf16(const bf16* x, int n_res, const void* const* w1, const void* const* a1,
                     const void* const* w2, const void* const* a2, const void* w_up,
                     const void* a_up, const void* w_rgb, void* up_out, void* rgb_out,
                     void* scratch_y, void* scratch_h, int B, int H, int W, int C,
                     const int* geometry, cudaStream_t s) {
  auto geo = [&](int i) {
    const int* g = geometry + 5 * i;
    return Geometry{g[0], g[1], g[2], g[3], g[4]};
  };
  const Geometry glu = geo(0), res = geo(1), up = geo(2), head = geo(3);
  if (head.rows != kHeadRows || head.cols != kHeadCols || head.tiles_y * kHeadRows < 2 * H ||
      head.tiles_x * kHeadCols < 2 * W || head.channels != kHeadCh)
    return cudaErrorInvalidValue;
  static int sms = 0;  // the persistent grid: one block per SM
  cudaError_t err;
  int dev;
  if (sms == 0 &&
      ((err = cudaGetDevice(&dev)) != cudaSuccess ||
       (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess))
    return err;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  bf16* y = static_cast<bf16*>(scratch_y);
  bf16* hs = static_cast<bf16*>(scratch_h);
  const bf16* h = x;
  for (int r = 0; r < n_res; ++r) {
    // y = GLU(conv(h, k1) * s1 + b1): GEMM N = 2C (value/gate interleaved), C out.
    if ((err = launch_tc<kGlu3x3, 256, 1, 64>(h, w1[r], f(a1[r]), nullptr, y, B, H, W, C, 2 * C,
                                              C, glu, sms, s)) != cudaSuccess)
      return err;
    // h = h + conv(y, k2) * s2 + b2 into scratch_h (in place after the first
    // block: a tile reads its residual before it writes the same pixels).
    if ((err = launch_tc<kResidual3x3, 128, 2, 32>(y, w2[r], f(a2[r]), h, hs, B, H, W, C, C, C,
                                                   res, sms, s)) != cudaSuccess)
      return err;
    h = hs;
  }
  // up = GLU(conv(nearest2x(h), k_up) * s + b): four subpixel phases.
  if ((err = launch_tc<kUpPhase, 128, 2, 64>(h, w_up, f(a_up), nullptr,
                                             static_cast<bf16*>(up_out), B, H, W, C, C, C / 2,
                                             up, sms, s)) != cudaSuccess)
    return err;
  if (w_rgb != nullptr) {
    CUtensorMap up_map;
    if (!map_4d(&up_map, up_out,
                {(uint64_t)C / 2, (uint64_t)2 * W, (uint64_t)2 * H, (uint64_t)B},
                {kHeadCh, kHaloCols, kHaloRows, 1}, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    const HeadArgs a{static_cast<const bf16*>(w_rgb), static_cast<bf16*>(rgb_out), 2 * H, 2 * W,
                     C / 2, head.tiles_y, head.tiles_x};
    static bool attribute_set = false;
    if (!attribute_set) {
      if ((err = cudaFuncSetAttribute(rgb_head_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kHeadSmem)) != cudaSuccess)
        return err;
      attribute_set = true;
    }
    rgb_head_tc<<<B * head.tiles_y * head.tiles_x, kHeadThreads, kHeadSmem, s>>>(up_map, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x: [B, H, W, C] contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); C a
// multiple of 16, n_res >= 1.  Weights in x's dtype, each output channel's
// (tap, channel) run contiguous: w1[r]: [2C][9C], w2[r]: [C][9C], w_up:
// [4][C][4C] (the subpixel phase kernels), w_rgb: [3][9 * C/2] or null.
// a1[r]: f32 [2, 2C]; a2[r], a_up: f32 [2, C] (scale row, shift row).  In
// bf16 the GLU convs' columns (w1, a1; w_up, a_up per phase) come in groups
// of 16: the values of 8 channels, then their gates, and every affine row
// is zero-padded to a multiple of 256 columns; in f32 all values, then all
// gates, unpadded.  up_out: [B, 2H, 2W, C/2]; rgb_out: [B, 2H, 2W, 3] when w_rgb is
// given; scratch_y, scratch_h: [B, H, W, C] each.  x is not written.
// geometry (bf16 only): rows, cols, tiles_y, tiles_x and the TMA box depth
// in channels of the tiles over [H, W] of the C -> 2C convs (128 pixels),
// the C -> C convs and the upsample phases (256 pixels), then of the RGB
// head over [2H, 2W] (tile_geometry in ops/kernels/reschain.py); a depth
// other than the kernel's is refused.  bf16 tensors start on
// 16-byte boundaries.
extern "C" int t2igan_reschain(const void* x, int n_res, const void* const* w1,
                               const void* const* a1, const void* const* w2,
                               const void* const* a2, const void* w_up, const void* a_up,
                               const void* w_rgb, void* up_out, void* rgb_out,
                               void* scratch_y, void* scratch_h, int B, int H, int W,
                               int C, int is_bf16, const int* geometry, void* stream) {
  if (n_res < 1 || B < 1 || H < 1 || W < 1 || C < 16 || C % 16 != 0 ||
      (long long)B * 4 * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)run_bf16(static_cast<const __nv_bfloat16*>(x), n_res, w1, a1, w2, a2, w_up,
                         a_up, w_rgb, up_out, rgb_out, scratch_y, scratch_h, B, H, W, C,
                         geometry, s);
  return (int)run_f32(static_cast<const float*>(x), n_res, w1, a1, w2, a2, w_up, a_up, w_rgb,
                      up_out, rgb_out, scratch_y, scratch_h, B, H, W, C, s);
}
