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
// = 64 and 128) the two calls do 6.04 TFLOP and move ~1 GB at their edges
// in bf16 (~2 GB in f32), ~6000 (~3000) flops per byte, far above the
// H100's ~295 bf16 (~150 TF32) flops per byte: the convs are bound by the
// tensor cores.  bf16 takes 6.1 ms at 989 TFLOP/s.  f32 is held to f32
// accuracy, so each product runs as three TF32 products (3xTF32): 18.1
// TFLOP at 495 TFLOP/s, 36.6 ms, where the same work on the CUDA cores'
// 67 TFLOP/s takes 90 ms.  The RGB head alone is bound by bytes (it reads
// the `up` map at 256^2: 1.07 GB in bf16, 2.15 GB in f32).
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
// f32 (every entry point's default dtype; conv_tf32, rgb_head_tf32) runs
// the bf16 design on the TF32 tensor cores as 3xTF32 (mma_tf32.cuh): each
// f32 x is split into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and each
// K step of 8 takes a_lo b_hi + a_hi b_lo + a_hi b_hi into one f32
// accumulator, small terms first, so every conv is summed in f32 at f32
// accuracy and the chain rounds where the Pallas kernel does.
//  * wgmma m64nNk8 .tf32: B (the weights) from shared memory, split once
//    on the host into TF32 hi and lo tensors (lay_out_operands), both
//    multicast through the ring; A (the input tile) from registers, split
//    as it is read.  The tiles, N, the producer warp, the consumer
//    warpgroups, the clusters and the persistent grid are bf16's; K
//    slices are 16 channels (64-byte rows, the 64-byte swizzle), so a
//    stage of hi, lo and the input tile fits 5 (C -> 2C) or 7 times.
//  * Each thread reads its A fragment of a slice as one 16-byte load a
//    row (channels 4t .. 4t + 3, free of bank conflicts under the 64-byte
//    swizzle): k = t of the slice's first k8 step is channel 4t, k = t + 4
//    is 4t + 1, and so on, and the wrapper orders the weights' input
//    channels the same way (each 16 by the 4 x 4 transpose).  Products
//    read the A registers asynchronously, so each slice waits for its
//    products before the next rewrites them; the two consumer warpgroups
//    keep the tensor cores fed in turn (a second register set, to keep a
//    slice's products in flight, measured no faster).
//  * The tensor cores add each product to the f32 accumulator rounding
//    toward zero, three times a k8 step: the chain stands a few C 2^-24
//    of its scale from float64 (plain f32 ~1e-6), inside the f32 bound
//    (f32_tol, f32_f64_tol in ops/kernels/reschain.py).
//  * Epilogues in registers as in bf16, in f32: the affine, GLU, the
//    residual read and written by the same thread (in place; a thread
//    issues the loads of four column tiles before their stores, which
//    may alias them), and no staging tile: a thread's f32 pair is an
//    8-byte store and four threads fill a 32-byte sector.
//  * The RGB head (rgb_head_tf32): bf16's 8 x 32 tile and warps, the halo
//    in slices of 16 channels by TMA, two in flight; each slice is split
//    into hi (in place) and lo once, then the nine taps run 3xTF32 on
//    mma.sync m16n8k8 with the 3 output channels in one n8 tile.
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

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_tma.cuh"

namespace {

enum Mode { kGlu3x3 = 0, kResidual3x3 = 1, kUpPhase = 2, kRgb3x3 = 3 };

// The epilogues' sigmoid: approximate exp and reciprocal, one MUFU op each.
// A few ulp in f32: far below the bf16 rounding that follows, and in f32
// below what the tensor cores' accumulation costs (the f32 checks read the
// same errors with it as with an IEEE sigmoid, and the GLU kinds ran 5-8%
// faster).
__device__ __forceinline__ float fast_sigmoidf(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + __expf(-x)));
  return r;
}

// ===========================================================================
// What both dtypes share: the persistent grid, clusters, tiles
// ===========================================================================

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;          // threads 0..255 consume, 256..383 produce
constexpr int kThreadsTc = 384;
constexpr int kSmemMax = 232448;         // shared memory a block can have
constexpr int kCluster = 2;              // blocks sharing each weight tile by multicast
constexpr int kAffinePad = 256;          // affine rows are zero-padded to this many columns

// T: the storage type, bf16 or float.
template <typename T>
struct TcArgs {
  const float* aff;   // [2][n_tiles * BN]: scale row, shift row, GEMM column order, zero-padded
  const T* res;       // kResidual3x3: [B, H, W, c_out], may alias out
  T* out;             // [B, H, W, c_out]; kUpPhase: [B, 2H, 2W, c_out]
  int H, W;           // the input's grid
  int cin, n_gemm, c_out;
  int rows, cols;     // the pixel patch of a tile: rows x cols = kBM
  int tiles_y, tiles_x, m_tiles, n_tiles;
  int m_groups, total;  // pixel patches of a cluster (one a block), groups in all
  int aff_stride;      // n_gemm rounded up to kAffinePad
};

struct Tile {
  int b, y0, x0, n0, phase;
  bool valid;  // false: the second patch of a pair past the last one (zeros in, no stores)
};

// Group t of a cluster: pixel patch groups fastest, then N tiles, then
// subpixel phases; the block of cluster rank r takes patch kCluster
// (t % m_groups) + r.  The blocks of a group share the weight tile (n0,
// phase).
template <typename T>
__device__ __forceinline__ Tile decode(const TcArgs<T>& p, int t, uint32_t rank, int bn) {
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

// ===========================================================================
// bf16: wgmma + TMA
// ===========================================================================

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
        const TcArgs<bf16> p) {
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

// ===========================================================================
// f32: 3xTF32 on wgmma + TMA
// ===========================================================================

// The bf16 tiles (BM = 128 MW output pixels x BN GEMM columns, consumer
// warpgroup wg on rows 64 MW wg ..) with K slices of 16 channels: 64-byte
// rows under the 64-byte swizzle.  A stage holds the input tile and the
// weight tile's TF32 hi and lo parts.  No staging tile: a thread's f32 pair
// of one pixel is a whole 8-byte store, four threads fill a 32-byte sector.
template <int MODE, int BN, int MW>
struct Tf32Shape {
  static constexpr bool kGlu = MODE != kResidual3x3;
  static constexpr int kBK = 16;                     // channels of a K slice
  static constexpr int kRow = kBK * 4;               // bytes of a tile row
  static constexpr int kBM = 128 * MW;
  static constexpr int kABytes = kBM * kRow;
  static constexpr int kBBytes = BN * kRow;          // one of hi, lo
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kFree = kSmemMax - 1024 - 8 * 16;
  static constexpr int kStages = kFree / kStageBytes < 8 ? kFree / kStageBytes : 8;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 4 && kSmem <= kSmemMax, "shared memory of one block");
};

// Byte offset of the 16-byte chunk c of row r in a tile of 64-byte rows
// under the 64-byte swizzle (1024-byte aligned base).
__device__ __forceinline__ int swz64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// The two k8 steps of one 16-channel slice, split: thread (g, t) of a warp
// reads channels 4t .. 4t + 3 of rows r0 and r0 + 8 as one 16-byte load
// each; k = t of step s is channel 4t + 2s and k = t + 4 is 4t + 2s + 1.
// The weights' K order follows (lay_out_operands permutes each 16 input
// channels by the 4 x 4 transpose), so the sums are the conv's.
__device__ __forceinline__ void load_a_slice(const uint8_t* tile, int r0, int t4,
                                             uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
  const float4 v0 = *reinterpret_cast<const float4*>(tile + swz64(r0, t4));
  const float4 v1 = *reinterpret_cast<const float4*>(tile + swz64(r0 + 8, t4));
  const float x0[4] = {v0.x, v1.x, v0.y, v1.y};
  const float x1[4] = {v0.z, v1.z, v0.w, v1.w};
  mr::split_tf32(x0, hi[0], lo[0]);
  mr::split_tf32(x1, hi[1], lo[1]);
}

template <int MODE, int BN, int MW>
__global__ void __launch_bounds__(kThreadsTc, 1)
conv_tf32(const __grid_constant__ CUtensorMap in_map, const __grid_constant__ CUtensorMap wt_map,
          const TcArgs<float> p) {
  using S = Tf32Shape<MODE, BN, MW>;
  constexpr int kTaps = MODE == kUpPhase ? 4 : 9;
  constexpr int kTapW = MODE == kUpPhase ? 2 : 3;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_tiles = align1024(smem_raw);                  // [stages][kBM pixels][64 B]
  uint8_t* b_tiles = a_tiles + S::kStages * S::kABytes;    // [stages][hi, lo][BN columns][64 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_tiles + S::kStages * 2 * S::kBBytes);
  uint64_t* empty = full + S::kStages;

  const int k_slices = (p.cin + S::kBK - 1) / S::kBK;
  const int k_iters = kTaps * k_slices;
  const uint32_t rank = tc::cluster_rank();
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], kCluster * kConsumers / 32);
    }
    tc::fence_barrier_init();
  }
  tc::cluster_sync();

  if (threadIdx.x >= kConsumers) {
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
          const int tap = it / k_slices, c0 = (it - tap * k_slices) * S::kBK;
          const int tu = tap / kTapW, tv = tap - tu * kTapW;
          const int dy = MODE == kUpPhase ? pa + tu - 1 : tu - 1;
          const int dx = MODE == kUpPhase ? pb + tv - 1 : tv - 1;
          tc::mbar_wait(&empty[stage], parity ^ 1);
          tc::mbar_expect_tx(&full[stage], S::kStageBytes);
          tc::tma_load_4d(a_tiles + stage * S::kABytes, &in_map, &full[stage], c0, tl.x0 + dx,
                          tl.y0 + dy, tl.b);
          // This block's half of the hi and the lo weight tile, to both blocks.
#pragma unroll
          for (int part = 0; part < 2; ++part)
            tc::tma_load_4d_multicast(
                b_tiles + (2 * stage + part) * S::kBBytes + rank * (BN / 2) * S::kRow, &wt_map,
                &full[stage], (1 << kCluster) - 1, c0, tap, tl.n0 + (int)rank * (BN / 2),
                2 * tl.phase + part);
          if (++stage == S::kStages) {
            stage = 0;
            parity ^= 1;
          }
        }
      }
      for (int i = 0; i < S::kStages; ++i) {
        tc::mbar_wait(&empty[stage], parity ^ 1);
        if (++stage == S::kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    tc::reg_alloc<232>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float* scale = p.aff;
    const float* shift = p.aff + p.aff_stride;
    const int cols_log2 = __ffs(p.cols) - 1;
    float acc[MW][BN / 2];
    int stage = 0;
    uint32_t parity = 0;
    for (int t = cluster; t < p.total; t += clusters) {
      const Tile tl = decode(p, t, rank, BN);
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mw][i] = 0.f;
      for (int it = 0; it < k_iters; ++it) {
        tc::mbar_wait(&full[stage], parity);
        const uint8_t* a = a_tiles + stage * S::kABytes;
        uint32_t ah[MW][2][4], al[MW][2][4];
#pragma unroll
        for (int mw = 0; mw < MW; ++mw)
          load_a_slice(a, 64 * (MW * wg + mw) + 16 * warp + g, t4, ah[mw], al[mw]);
        const uint64_t dh = tc::swizzle_desc<S::kRow>(b_tiles + 2 * stage * S::kBBytes);
        const uint64_t dl = tc::swizzle_desc<S::kRow>(b_tiles + (2 * stage + 1) * S::kBBytes);
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) tc::fence_regs(acc[mw]);
        tc::wgmma_fence();
        // Each k8 step as a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first.
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int mw = 0; mw < MW; ++mw) tc::wgmma_tf32<BN>(acc[mw], al[mw][s], dh + 2 * s);
#pragma unroll
          for (int mw = 0; mw < MW; ++mw) tc::wgmma_tf32<BN>(acc[mw], ah[mw][s], dl + 2 * s);
#pragma unroll
          for (int mw = 0; mw < MW; ++mw) tc::wgmma_tf32<BN>(acc[mw], ah[mw][s], dh + 2 * s);
        }
        tc::wgmma_commit();
        // The A registers are rewritten next slice: wait for every product.
        tc::wgmma_wait<0>();
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) tc::fence_regs(acc[mw]);
        if (lane == 0)
          for (uint32_t r = 0; r < kCluster; ++r) tc::mbar_arrive_cluster(&empty[stage], r);
        if (++stage == S::kStages) {
          stage = 0;
          parity ^= 1;
        }
      }

      // Epilogue from registers: rows 64 mw + 16 warp + g + 8h of this
      // warpgroup, f32 pairs of channels straight to device memory.
      size_t pix[MW][2];
      bool in[MW][2];
      const int pa = tl.phase >> 1, pb = tl.phase & 1;
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 64 * (MW * wg + mw) + 16 * warp + g + 8 * h;
          const int y = tl.y0 + (m >> cols_log2), x = tl.x0 + (m & (p.cols - 1));
          in[mw][h] = tl.valid && y < p.H && x < p.W;
          pix[mw][h] = MODE == kUpPhase
                           ? ((size_t)(tl.b * 2 * p.H + 2 * y + pa)) * 2 * p.W + 2 * x + pb
                           : (size_t)(tl.b * p.H + y) * p.W + x;
        }
      if constexpr (S::kGlu) {
        // Columns 16q .. 16q + 7: values of channels 8q .. 8q + 7 of this
        // tile; 16q + 8 .. 16q + 15: their gates.
#pragma unroll
        for (int q = 0; q < BN / 16; ++q) {
          const int col = tl.n0 + 16 * q + 2 * t4;
          const int ch = tl.n0 / 2 + 8 * q + 2 * t4;
          if (ch >= p.c_out) continue;
          const float2 sv = __ldg(reinterpret_cast<const float2*>(scale + col));
          const float2 sg = __ldg(reinterpret_cast<const float2*>(scale + col + 8));
          const float2 bv = __ldg(reinterpret_cast<const float2*>(shift + col));
          const float2 bg = __ldg(reinterpret_cast<const float2*>(shift + col + 8));
#pragma unroll
          for (int mw = 0; mw < MW; ++mw)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!in[mw][h]) continue;
              const float v0 = acc[mw][8 * q + 2 * h] * sv.x + bv.x;
              const float v1 = acc[mw][8 * q + 2 * h + 1] * sv.y + bv.y;
              const float g0 = acc[mw][8 * q + 4 + 2 * h] * sg.x + bg.x;
              const float g1 = acc[mw][8 * q + 4 + 2 * h + 1] * sg.y + bg.y;
              *reinterpret_cast<float2*>(p.out + pix[mw][h] * p.c_out + ch) =
                  make_float2(v0 * fast_sigmoidf(g0), v1 * fast_sigmoidf(g1));
            }
        }
      } else {
        // The residual is read by the thread that overwrites it (the conv
        // runs in place after the first block).  res may alias out, so
        // the loads of kG column tiles are all issued before their stores:
        // otherwise each load waits behind the store before it.
        constexpr int kG = 4;
#pragma unroll
        for (int j0 = 0; j0 < BN / 8; j0 += kG) {
          float2 r[kG][MW][2];
#pragma unroll
          for (int jj = 0; jj < kG; ++jj) {
            const int ch = tl.n0 + 8 * (j0 + jj) + 2 * t4;
#pragma unroll
            for (int mw = 0; mw < MW; ++mw)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                r[jj][mw][h] = in[mw][h] && ch < p.c_out
                                   ? *reinterpret_cast<const float2*>(
                                         p.res + pix[mw][h] * p.c_out + ch)
                                   : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int jj = 0; jj < kG; ++jj) {
            const int j = j0 + jj, ch = tl.n0 + 8 * j + 2 * t4;
            if (ch >= p.c_out) continue;
            const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + ch));
            const float2 sh = __ldg(reinterpret_cast<const float2*>(shift + ch));
#pragma unroll
            for (int mw = 0; mw < MW; ++mw)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (!in[mw][h]) continue;
                *reinterpret_cast<float2*>(p.out + pix[mw][h] * p.c_out + ch) =
                    make_float2(r[jj][mw][h].x + (acc[mw][4 * j + 2 * h] * sc.x + sh.x),
                                r[jj][mw][h].y + (acc[mw][4 * j + 2 * h + 1] * sc.y + sh.y));
              }
          }
        }
      }
    }
  }
}

// The RGB head in f32: the bf16 head's 8 x 32 pixel tile and warps, the
// halo in slices of 16 channels (64-byte rows, the 64-byte swizzle), two
// slices in flight.  Each slice is split into TF32 hi (in place) and lo
// once, so the nine taps read split values; 3xTF32 on mma.sync m16n8k8,
// the 3 output channels in one n8 tile.
constexpr int kHeadChF = 16;
constexpr int kHaloBytesF = kHaloRows * kHaloCols * kHeadChF * 4;
constexpr int kHaloStrideF = (kHaloBytesF + 1023) / 1024 * 1024;
constexpr int kWsFloatsF = 2 * 8 * 9 * kHeadChF;  // [hi, lo][8 columns][9 taps][16 channels]
constexpr int kHeadSmemF =
    3 * kHaloStrideF + kWsFloatsF * 4 + kHeadRows * kHeadCols * 3 * 4 + 16 + 1024;

struct HeadArgsF {
  const float* wt;  // [hi, lo][3][9 * cin], TF32 each
  float* out;       // [B, H, W, 3]
  int H, W, cin, tiles_y, tiles_x;
};

__global__ void __launch_bounds__(kHeadThreads, 2)
rgb_head_tf32(const __grid_constant__ CUtensorMap up_map, const HeadArgsF p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* halo = align1024(smem_raw);                      // [2][kHaloStrideF]: slices, hi
  uint8_t* halo_lo = halo + 2 * kHaloStrideF;               // the current slice's lo
  float* ws = reinterpret_cast<float*>(halo + 3 * kHaloStrideF);
  float* os = ws + kWsFloatsF;                               // [8][32][3]
  uint64_t* bar = reinterpret_cast<uint64_t*>(os + kHeadRows * kHeadCols * 3);  // [2]

  const int per_img = p.tiles_y * p.tiles_x;
  const int b = blockIdx.x / per_img, s = blockIdx.x - b * per_img;
  const int ty = s / p.tiles_x;
  const int y0 = ty * kHeadRows, x0 = (s - ty * p.tiles_x) * kHeadCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int slices = (p.cin + kHeadChF - 1) / kHeadChF;

  if (threadIdx.x == 0) {
    tc::mbar_init(&bar[0], 1);
    tc::mbar_init(&bar[1], 1);
    tc::fence_barrier_init();
    tc::mbar_expect_tx(&bar[0], kHaloBytesF);
    tc::tma_load_4d(halo, &up_map, &bar[0], 0, x0 - 1, y0 - 1, b);
  }
  __syncthreads();

  float acc[2][4] = {};
  for (int sl = 0; sl < slices; ++sl) {
    const int buf = sl & 1;
    uint8_t* hi = halo + buf * kHaloStrideF;
    if (threadIdx.x == 0 && sl + 1 < slices) {
      // The other buffer was split in place two slices ago (generic
      // writes, ordered by the last __syncthreads) and is free.
      tc::fence_proxy_async();
      tc::mbar_expect_tx(&bar[buf ^ 1], kHaloBytesF);
      tc::tma_load_4d(halo + (buf ^ 1) * kHaloStrideF, &up_map, &bar[buf ^ 1],
                      (sl + 1) * kHeadChF, x0 - 1, y0 - 1, b);
    }
    // This slice's weights, zeros past the 3 columns and past cin (a
    // multiple of 8, so 4 channels at once).
    for (int i = threadIdx.x; i < kWsFloatsF / 4; i += kHeadThreads) {
      const int row = i / (kHeadChF / 4), c = sl * kHeadChF + 4 * (i - row * (kHeadChF / 4));
      const int part = row / 72, n = (row / 9) & 7, tap = row % 9;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < 3 && c < p.cin)
        v = __ldg(reinterpret_cast<const float4*>(p.wt + ((size_t)part * 3 + n) * 9 * p.cin +
                                                  tap * p.cin + c));
      reinterpret_cast<float4*>(ws)[i] = v;
    }
    tc::mbar_wait(&bar[buf], (sl >> 1) & 1);
    for (int i = threadIdx.x; i < kHaloBytesF / 16; i += kHeadThreads) {
      float4* h4 = reinterpret_cast<float4*>(hi) + i;
      const float4 v = *h4;
      const float x[4] = {v.x, v.y, v.z, v.w};
      uint32_t vh[4], vl[4];
      mr::split_tf32(x, vh, vl);
      *h4 = make_float4(__uint_as_float(vh[0]), __uint_as_float(vh[1]), __uint_as_float(vh[2]),
                        __uint_as_float(vh[3]));
      reinterpret_cast<float4*>(halo_lo)[i] =
          make_float4(__uint_as_float(vl[0]), __uint_as_float(vl[1]), __uint_as_float(vl[2]),
                      __uint_as_float(vl[3]));
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int u = tap / 3, v = tap - u * 3;
      // B fragments of both k8 steps: column g, channels 4 t4 .. 4 t4 + 3.
      const float4 wh = *reinterpret_cast<const float4*>(ws + (g * 9 + tap) * kHeadChF + 4 * t4);
      const float4 wl =
          *reinterpret_cast<const float4*>(ws + ((8 + g) * 9 + tap) * kHeadChF + 4 * t4);
      const uint32_t bh[2][2] = {{__float_as_uint(wh.x), __float_as_uint(wh.y)},
                                 {__float_as_uint(wh.z), __float_as_uint(wh.w)}};
      const uint32_t bl[2][2] = {{__float_as_uint(wl.x), __float_as_uint(wl.y)},
                                 {__float_as_uint(wl.z), __float_as_uint(wl.w)}};
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        const int r0 = (warp + u) * kHaloCols + 16 * grp + g + v;
        const float4 h0 = *reinterpret_cast<const float4*>(hi + swz64(r0, t4));
        const float4 h1 = *reinterpret_cast<const float4*>(hi + swz64(r0 + 8, t4));
        const float4 l0 = *reinterpret_cast<const float4*>(halo_lo + swz64(r0, t4));
        const float4 l1 = *reinterpret_cast<const float4*>(halo_lo + swz64(r0 + 8, t4));
        const uint32_t ah0[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                                 __float_as_uint(h0.y), __float_as_uint(h1.y)};
        const uint32_t al0[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                                 __float_as_uint(l0.y), __float_as_uint(l1.y)};
        const uint32_t ah1[4] = {__float_as_uint(h0.z), __float_as_uint(h1.z),
                                 __float_as_uint(h0.w), __float_as_uint(h1.w)};
        const uint32_t al1[4] = {__float_as_uint(l0.z), __float_as_uint(l1.z),
                                 __float_as_uint(l0.w), __float_as_uint(l1.w)};
        mr::mma_3xtf32(acc[grp], ah0, al0, bh[0], bl[0]);
        mr::mma_3xtf32(acc[grp], ah1, al1, bh[1], bl[1]);
      }
    }
    __syncthreads();  // the slice's buffers and weights are free
  }

  if (t4 < 2) {
#pragma unroll
    for (int grp = 0; grp < 2; ++grp)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = 2 * t4 + e;
          if (ch < 3)
            os[(warp * kHeadCols + 16 * grp + g + 8 * h) * 3 + ch] = tanhf(acc[grp][2 * h + e]);
        }
  }
  __syncthreads();

  // Warp w writes tile row w: 16-byte stores for a whole, aligned row.
  const int y = y0 + warp;
  if (y >= p.H) return;
  const int nx = min(kHeadCols, p.W - x0);
  float* dst = p.out + ((size_t)(b * p.H + y) * p.W + x0) * 3;
  const float* src = os + warp * kHeadCols * 3;
  if (nx == kHeadCols && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    if (lane < kHeadCols * 3 * 4 / 16)
      reinterpret_cast<float4*>(dst)[lane] = reinterpret_cast<const float4*>(src)[lane];
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

// A 4-D tensor map of bf16 or f32 elements, dims innermost first, dense
// strides, zeros outside.
template <typename T>
bool map_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
            const uint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4] = {1, 1, 1, 1};
  uint64_t stride = sizeof(T);
  for (int i = 0; i < 4; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    stride *= dims[i];
    if (i < 3) gstride[i] = stride;
  }
  constexpr CUtensorMapDataType kType =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, kType, 4, const_cast<void*>(base), gdim, gstride, bdim, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Geometry {
  int rows, cols, tiles_y, tiles_x, channels;  // channels: the TMA box's depth
};

// The conv kernel of a storage type: bf16 (conv_tc, K slices of BK
// channels) or f32 (conv_tf32, 16; the weights come as hi and lo parts).
template <typename T, int MODE, int BN, int MW, int BK>
struct Conv {
  using S = TcShape<MODE, BN, MW, BK>;
  static constexpr int kParts = 1;
  static auto kernel() { return conv_tc<MODE, BN, MW, BK>; }
};
template <int MODE, int BN, int MW, int BK>
struct Conv<float, MODE, BN, MW, BK> {
  static_assert(BK == 16, "f32 K slices are 16 channels");
  using S = Tf32Shape<MODE, BN, MW>;
  static constexpr int kParts = 2;
  static auto kernel() { return conv_tf32<MODE, BN, MW>; }
};

// One conv: input map over [B, H, W, cin] (box BK x cols x rows x 1),
// weight map over [phases x parts][n_gemm][taps][cin] (box BK x 1 x BN/2
// x 1; parts: 1 in bf16, hi and lo in f32).
template <typename T, int MODE, int BN, int MW, int BK>
cudaError_t launch_conv(const void* in, const void* wt, const float* aff, const T* res, T* out,
                        int B, int H, int W, int cin, int n_gemm, int c_out, const Geometry& geo,
                        int sms, cudaStream_t s) {
  using K = Conv<T, MODE, BN, MW, BK>;
  using S = typename K::S;
  constexpr int kTaps = MODE == kUpPhase ? 4 : 9;
  constexpr CUtensorMapSwizzle kSwizzle =
      S::kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (geo.rows * geo.cols != S::kBM || geo.tiles_y * geo.rows < H ||
      geo.tiles_x * geo.cols < W || geo.channels != BK)
    return cudaErrorInvalidValue;
  const int phases = MODE == kUpPhase ? 4 : 1;
  CUtensorMap in_map, wt_map;
  if (!map_4d<T>(&in_map, in, {(uint64_t)cin, (uint64_t)W, (uint64_t)H, (uint64_t)B},
                 {BK, (uint32_t)geo.cols, (uint32_t)geo.rows, 1}, kSwizzle) ||
      !map_4d<T>(&wt_map, wt,
                 {(uint64_t)cin, kTaps, (uint64_t)n_gemm, (uint64_t)(phases * K::kParts)},
                 {BK, 1, BN / kCluster, 1}, kSwizzle))
    return cudaErrorInvalidValue;
  TcArgs<T> a{aff, res, out, H, W, cin, n_gemm, c_out, geo.rows, geo.cols, geo.tiles_y,
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
    cudaError_t err =
        cudaFuncSetAttribute(K::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(kCluster * sms / 2);
    err = cudaOccupancyMaxActiveClusters(&max_clusters, K::kernel(), &cfg);
    if (err != cudaSuccess) return err;
    if (max_clusters < 1) return cudaErrorInvalidConfiguration;
  }
  // Persistent: as many clusters as the card holds at once.
  cfg.gridDim = dim3(kCluster * (a.total < max_clusters ? a.total : max_clusters));
  return cudaLaunchKernelEx(&cfg, K::kernel(), in_map, wt_map, a);
}

// The head kernel of a storage type and its halo slice: bf16 64 channels
// (128-byte swizzle), f32 16 (64-byte).
template <typename T>
cudaError_t launch_head(const void* up, const void* w_rgb, void* rgb_out, int B, int H, int W,
                        int C, const Geometry& head, cudaStream_t s) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kCh = kF32 ? kHeadChF : kHeadCh;
  constexpr int kSmem = kF32 ? kHeadSmemF : kHeadSmem;
  if (head.rows != kHeadRows || head.cols != kHeadCols || head.tiles_y * kHeadRows < 2 * H ||
      head.tiles_x * kHeadCols < 2 * W || head.channels != kCh)
    return cudaErrorInvalidValue;
  CUtensorMap up_map;
  if (!map_4d<T>(&up_map, up, {(uint64_t)C / 2, (uint64_t)2 * W, (uint64_t)2 * H, (uint64_t)B},
                 {kCh, kHaloCols, kHaloRows, 1},
                 kF32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const auto kernel = [] {
    if constexpr (kF32)
      return rgb_head_tf32;
    else
      return rgb_head_tc;
  }();
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  using Args = typename std::conditional<kF32, HeadArgsF, HeadArgs>::type;
  const Args a{static_cast<const T*>(w_rgb), static_cast<T*>(rgb_out), 2 * H, 2 * W, C / 2,
               head.tiles_y, head.tiles_x};
  kernel<<<B * head.tiles_y * head.tiles_x, kHeadThreads, kSmem, s>>>(up_map, a);
  return cudaGetLastError();
}

// The chain in storage type T: bf16 K slices of 64 (C -> 2C, upsample) and
// 32 (C -> C) channels, the fastest measured for each kind; f32 16.
template <typename T>
cudaError_t run(const T* x, int n_res, const void* const* w1, const void* const* a1,
                const void* const* w2, const void* const* a2, const void* w_up, const void* a_up,
                const void* w_rgb, void* up_out, void* rgb_out, void* scratch_y, void* scratch_h,
                int B, int H, int W, int C, const int* geometry, cudaStream_t s) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kBkGlu = kF32 ? 16 : 64, kBkRes = kF32 ? 16 : 32, kBkUp = kF32 ? 16 : 64;
  auto geo = [&](int i) {
    const int* g = geometry + 5 * i;
    return Geometry{g[0], g[1], g[2], g[3], g[4]};
  };
  const Geometry glu = geo(0), res = geo(1), up = geo(2), head = geo(3);
  static int sms = 0;  // the persistent grid: one block per SM
  cudaError_t err;
  int dev;
  if (sms == 0 &&
      ((err = cudaGetDevice(&dev)) != cudaSuccess ||
       (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess))
    return err;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  T* y = static_cast<T*>(scratch_y);
  T* hs = static_cast<T*>(scratch_h);
  const T* h = x;
  for (int r = 0; r < n_res; ++r) {
    // y = GLU(conv(h, k1) * s1 + b1): GEMM N = 2C (value/gate interleaved), C out.
    if ((err = launch_conv<T, kGlu3x3, 256, 1, kBkGlu>(h, w1[r], f(a1[r]), nullptr, y, B, H, W,
                                                      C, 2 * C, C, glu, sms, s)) != cudaSuccess)
      return err;
    // h = h + conv(y, k2) * s2 + b2 into scratch_h (in place after the first
    // block: each output's residual is read before that output is written).
    if ((err = launch_conv<T, kResidual3x3, 128, 2, kBkRes>(y, w2[r], f(a2[r]), h, hs, B, H, W,
                                                           C, C, C, res, sms, s)) != cudaSuccess)
      return err;
    h = hs;
  }
  // up = GLU(conv(nearest2x(h), k_up) * s + b): four subpixel phases.
  if ((err = launch_conv<T, kUpPhase, 128, 2, kBkUp>(h, w_up, f(a_up), nullptr,
                                                    static_cast<T*>(up_out), B, H, W, C, C,
                                                    C / 2, up, sms, s)) != cudaSuccess)
    return err;
  if (w_rgb != nullptr) return launch_head<T>(up_out, w_rgb, rgb_out, B, H, W, C, head, s);
  return cudaSuccess;
}

}  // namespace

// x: [B, H, W, C] contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); C a
// multiple of 16, n_res >= 1.  Weights as lay_out_operands (ops/kernels/
// reschain.py) gives them, each output channel's (tap, channel) run
// contiguous: w1[r]: [P][2C][9C], w2[r]: [P][C][9C], w_up: [4][P][C][4C]
// (the subpixel phase kernels), w_rgb: [P][3][9 * C/2] or null, with P = 1
// in bf16 and P = 2 (TF32 hi, lo) in f32, where the conv weights' input
// channels also come permuted in groups of 16 (the 4 x 4 transpose; not
// the head's).  a1[r]: f32 [2, 2C]; a2[r], a_up: f32 [2, C] (scale row,
// shift row).  The GLU convs' columns (w1, a1; w_up, a_up per phase) come
// in groups of 16: the values of 8 channels, then their gates, and every
// affine row is zero-padded to a multiple of 256 columns.  up_out:
// [B, 2H, 2W, C/2]; rgb_out: [B, 2H, 2W, 3] when w_rgb is given; scratch_y,
// scratch_h: [B, H, W, C] each.  x is not written.  geometry: rows, cols,
// tiles_y, tiles_x and the TMA box depth in channels of the tiles over
// [H, W] of the C -> 2C convs (128 pixels), the C -> C convs and the
// upsample phases (256 pixels), then of the RGB head over [2H, 2W]
// (tile_geometry in ops/kernels/reschain.py); a depth other than the
// kernel's is refused.  Every tensor starts on a 16-byte boundary.
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
    return (int)run<bf16>(static_cast<const bf16*>(x), n_res, w1, a1, w2, a2, w_up, a_up,
                          w_rgb, up_out, rgb_out, scratch_y, scratch_h, B, H, W, C, geometry, s);
  return (int)run<float>(static_cast<const float*>(x), n_res, w1, a1, w2, a2, w_up, a_up, w_rgb,
                         up_out, rgb_out, scratch_y, scratch_h, B, H, W, C, geometry, s);
}
