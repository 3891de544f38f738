// Train-mode batch normalisation of the generator, with the GLU or the
// residual add that follows it fused in: the forward statistics, the
// forward apply, the backward sums and the backward dx.
//
// No TPU kernel corresponds to it.  The JAX package leaves train-mode BN
// to XLA's fusions; t2igan/ops/image.py:242 phase_batch_stats is its
// account of the same statistics (flax's _compute_stats: f32 sums, the
// biased variance max(0, E[x^2] - E[x]^2)).  Composed of PyTorch ops the
// layer took ~22 kernels a direction and ~120-140 bytes of device memory
// an element it normalised.
//
// x is viewed as [rows, C]: a channels_last map [B, C, H, W] is [B*H*W, C]
// in memory, the fc BN's [B, F] is itself.  For channel c over the rows:
//
//   mean = sum(x) / n,  msq = sum(x^2) / n           (f32, / W across ranks)
//   var  = max(0, msq - mean^2),  rstd = 1 / sqrt(var + eps)
//   y    = (x - mean) * (weight * rstd) + bias       (f32)
//   out  = y | y[:, :C/2] * sigmoid(y[:, C/2:]) | y + residual, in x's dtype
//   running = 0.9 running + 0.1 batch               (mean and biased var)
//
// and backward, with x^ = (x - mean) * rstd and dy the gradient at y (through
// the GLU where there is one, recomputed from x):
//
//   sums  = [sum(dy), sum(dy x^)]  = [dbias, dweight]          (f32)
//   dx    = weight rstd (dy - sums0 / N - x^ sums1 / N)        (N all rows)
//
// the x^ term dropped where msq - mean^2 < 0 (the clamp passes no gradient).
//
// What bounds it: bytes.  A GLU'd element is read twice forward (stats,
// apply) and twice backward (sums, dx), with 1 byte out and 2 + 1 back per
// bf16 element, a few flops each.  At the train step's shapes (b16, GF_DIM
// 64) the 30 layers a step move ~7.6 GB at the least, 2.3 ms at 3.35 TB/s.
//
// Design:
//  * Every kernel views x as [rows, C] and gives each thread one 16-byte
//    column of channels (8 bf16 or 4 f32; with the GLU, the same column of
//    both halves).  A block of 256 threads covers up to 64 columns and
//    256 / columns rows at a time; the grid is (channel chunks, row strips),
//    sized by the wrapper from [rows, C] so that ~264 blocks (two an SM)
//    share the rows.  Loads are 16-byte vectors, four rows in flight.
//  * The per-channel factors (mean, rstd, scale, bias, ...) are formed once
//    a block from the f32 statistics into shared memory.
//  * The reductions (stats forward, sums backward) keep f32 sums in
//    registers, reduce a block's row lanes in a fixed order in shared
//    memory, and write one partial a row strip.  Of a channel chunk's
//    blocks, the one that arrives last (an atomic ticket) sums the strips
//    in a fixed order: the result is the same from run to run.  The ticket
//    is reset by that block, so launches that share it must be ordered
//    (one stream).
//  * The apply kernel updates the running statistics (the blocks of the
//    first row strip, once a channel); the statistics are all-reduced over
//    ranks between the two forward launches where the batch is global.
//
// C interface (loaded with ctypes): each function returns the cudaError_t
// of its launch, launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxCols = 64;      // 16-byte columns a block covers
constexpr int kUnroll = 4;        // rows a thread has in flight
constexpr int kBwdUnroll = 4;     // (backward: one block an SM at ~200 registers)
constexpr int kMaxStrips = 65535;
constexpr int kMaxChunks = 1024;  // channel chunks of a reducing launch

enum Epilogue { kNone = 0, kGlu = 1, kResidual = 2 };

// Tickets of the two reducing kernels (stats, backward sums), one a chunk.
__device__ unsigned int g_ticket[2][kMaxChunks];

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void unpack(const Raw& r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static Raw load(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static void unpack(const Raw& r, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(bf16* p, const float* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// Where a thread works: its 16-byte column and its row lane.  `half` is the
// channels a column index runs over (C, or C / 2 with the GLU).
struct Place {
  int lanes, lane, cb, col, width, r0, r1;
  bool active;
  __device__ Place(int rows, int half, int vec, int bc, int per_strip) {
    const int cols = half / vec;
    lanes = kThreads / bc;
    lane = threadIdx.x / bc;
    cb = threadIdx.x - lane * bc;
    col = blockIdx.x * bc + cb;
    width = bc * vec;
    r0 = blockIdx.y * per_strip;
    r1 = min(rows, r0 + per_strip);
    active = lane < lanes && col < cols;
  }
};

// mean, biased variance, rstd and whether the clamp let the variance
// through, from the f32 statistics [2, C], as the plain version takes them.
struct Factors {
  float mean, var, rstd;
  bool through;
  __device__ Factors(const float* stats, int C, int c, float eps) {
    mean = stats[c];
    const float raw = __fsub_rn(stats[C + c], __fmul_rn(mean, mean));
    through = raw >= 0.f;
    var = fmaxf(raw, 0.f);
    rstd = 1.f / sqrtf(var + eps);
  }
};

// The offset in [2][C] of entry i of a chunk's sums (stat, column half h,
// channel e of the block's width), or -1 past the last channel.
__device__ int chunk_entry(int i, int C, int half, int nh, int width) {
  const int stat = i / (nh * width), rem = i - stat * nh * width;
  const int h = rem / width, j = blockIdx.x * width + rem - h * width;
  return j < half ? stat * C + h * half + j : -1;
}

// The chunk's last block sums its channels' partials over the row strips of
// `part` [strips][2][C] in a fixed order: strips p, p + P, ... into eight
// sums, combined as a tree, then the P parts in order (through `red`, at
// least kThreads floats).  emit(offset, value) for each of its entries.
template <typename Emit>
__device__ void reduce_strips(const float* part, int strips, int C, int half, int nh, int width,
                              float* red, Emit emit) {
  const int m = 2 * nh * width;
  const int parts = max(1, min(strips, kThreads / m));
  for (int t = threadIdx.x; t < m * parts; t += kThreads) {
    const int p = t / m, off = chunk_entry(t - p * m, C, half, nh, width);
    float a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = 0.f;
    if (off >= 0) {
      const float* col = part + off;
      int s = p;
      for (; s + 7 * parts < strips; s += 8 * parts) {
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] += __ldcg(col + (size_t)(s + k * parts) * 2 * C);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (s + k * parts < strips) a[k] += __ldcg(col + (size_t)(s + k * parts) * 2 * C);
    }
    const float v = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
    if (parts > 1) red[t] = v;
    else if (off >= 0) emit(off, v);
  }
  if (parts > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int off = chunk_entry(i, C, half, nh, width);
      if (off < 0) continue;
      float v = 0.f;
      for (int p = 0; p < parts; ++p) v += red[p * m + i];
      emit(off, v);
    }
  }
}

// Writes a block's sums (acc[h][k] of column half h, element k) to its
// strip's partial row at [stat * C + channel]: the row lanes summed in order
// through `red`.
template <int V, int NH>
__device__ void block_partial(const Place& at, const float (&acc)[NH][V], float* red, float* row,
                              int half) {
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (at.lane < at.lanes) {
#pragma unroll
      for (int k = 0; k < V; ++k) red[at.lane * at.width + at.cb * V + k] = acc[h][k];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < at.width; e += kThreads) {
      const int j = blockIdx.x * at.width + e;
      if (j < half) {
        float v = 0.f;
        for (int l = 0; l < at.lanes; ++l) v += red[l * at.width + e];
        row[h * half + j] = v;
      }
    }
    __syncthreads();
  }
}

// Whether this block is the last of its chunk's column of row strips to
// finish its partial (after every thread's writes are fenced); the last one
// resets the chunk's ticket.
__device__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.y - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    if (threadIdx.x == 0) *ticket = 0;
  }
  return last;
}

// ---- forward: statistics ----

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bn_fw_stats_kernel(const T* __restrict__ x, float* __restrict__ part, float* __restrict__ stats,
                   int rows, int C, int bc, int per_strip, float n, float world) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[kThreads * V];
  const Place at(rows, C, V, bc, per_strip);
  float s[1][V], q[1][V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[0][k] = q[0][k] = 0.f;
  if (at.active) {
    const T* p = x + (size_t)at.col * V;
    for (int r = at.r0 + at.lane; r < at.r1; r += at.lanes * kUnroll) {
      typename Vec<T>::Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * at.lanes < at.r1) raw[u] = Vec<T>::load(p + (size_t)(r + u * at.lanes) * C);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * at.lanes >= at.r1) break;
        float v[V];
        Vec<T>::unpack(raw[u], v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[0][k] += v[k];
          q[0][k] = fmaf(v[k], v[k], q[0][k]);
        }
      }
    }
  }
  float* row = part + (size_t)blockIdx.y * 2 * C;
  block_partial<V, 1>(at, s, red, row, C);
  block_partial<V, 1>(at, q, red, row + C, C);
  if (!last_block(&g_ticket[0][blockIdx.x])) return;
  reduce_strips(part, gridDim.y, C, C, 1, at.width, red,
                [&](int i, float v) { stats[i] = v / n / world; });
}

// ---- forward: apply, with the running statistics' update ----

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
bn_fw_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   const float* __restrict__ weight, const float* __restrict__ bias,
                   float* __restrict__ running_mean, float* __restrict__ running_var,
                   const T* __restrict__ res, T* __restrict__ out, int rows, int C, int bc,
                   int per_strip, float eps) {
  constexpr int V = Vec<T>::N, NH = EPI == kGlu ? 2 : 1;
  __shared__ float fm[NH * kMaxCols * V], fs[NH * kMaxCols * V], fb[NH * kMaxCols * V];
  const int half = C / NH;
  const Place at(rows, half, V, bc, per_strip);
  for (int e = threadIdx.x; e < NH * at.width; e += kThreads) {
    const int h = e / at.width, j = blockIdx.x * at.width + e - h * at.width;
    if (j >= half) continue;
    const int c = h * half + j;
    const Factors f(stats, C, c, eps);
    fm[e] = f.mean;
    fs[e] = weight[c] * f.rstd;
    fb[e] = bias[c];
    if (blockIdx.y == 0) {
      running_mean[c] = 0.9f * running_mean[c] + 0.1f * f.mean;
      running_var[c] = 0.9f * running_var[c] + 0.1f * f.var;
    }
  }
  __syncthreads();
  if (!at.active) return;
  const int e0 = at.cb * V;
  const size_t in0 = (size_t)at.col * V;
  const int out_w = EPI == kGlu ? half : C;
  for (int r = at.r0 + at.lane; r < at.r1; r += at.lanes * kUnroll) {
    typename Vec<T>::Raw ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * at.lanes;
      if (rr >= at.r1) break;
      ra[u] = Vec<T>::load(x + (size_t)rr * C + in0);
      if constexpr (EPI == kGlu) rb[u] = Vec<T>::load(x + (size_t)rr * C + half + in0);
      if constexpr (EPI == kResidual) rb[u] = Vec<T>::load(res + (size_t)rr * C + in0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * at.lanes;
      if (rr >= at.r1) break;
      float a[V], b[V], o[V];
      Vec<T>::unpack(ra[u], a);
      if constexpr (EPI != kNone) Vec<T>::unpack(rb[u], b);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float ya = (a[k] - fm[e0 + k]) * fs[e0 + k] + fb[e0 + k];
        if constexpr (EPI == kGlu) {
          const int g = at.width + e0 + k;
          const float yg = (b[k] - fm[g]) * fs[g] + fb[g];
          o[k] = ya * (1.f / (1.f + expf(-yg)));
        } else if constexpr (EPI == kResidual) {
          o[k] = ya + b[k];
        } else {
          o[k] = ya;
        }
      }
      Vec<T>::store(out + (size_t)rr * out_w + in0, o);
    }
  }
}

// ---- backward ----

// The factors a backward block keeps in shared memory, for each of its
// channels: mean, rstd, weight * rstd, bias, and for dx the two sums over N.
struct BwdSmem {
  float mean[2 * kMaxCols * 8], rstd[2 * kMaxCols * 8], scale[2 * kMaxCols * 8],
      bias[2 * kMaxCols * 8], k1[2 * kMaxCols * 8], k2[2 * kMaxCols * 8];
};

template <bool GLU>
__device__ void bwd_factors(BwdSmem& f, const Place& at, const float* stats, const float* weight,
                            const float* bias, const float* sums, int C, float eps, float n) {
  constexpr int NH = GLU ? 2 : 1;
  const int half = C / NH;
  for (int e = threadIdx.x; e < NH * at.width; e += kThreads) {
    const int h = e / at.width, j = blockIdx.x * at.width + e - h * at.width;
    if (j >= half) continue;
    const int c = h * half + j;
    const Factors fc(stats, C, c, eps);
    f.mean[e] = fc.mean;
    f.rstd[e] = fc.rstd;
    f.scale[e] = weight[c] * fc.rstd;
    f.bias[e] = bias[c];
    if (sums != nullptr) {
      f.k1[e] = sums[c] / n;
      f.k2[e] = fc.through ? sums[C + c] / n : 0.f;
    }
  }
  __syncthreads();
}

// dy (the gradient at y) and x^ of one element of a row's column: with the
// GLU for both halves (ea, eg its channels in the block's factors), from x
// (a, b) and dout (d); else dy is dout.
struct Grad {
  float dy[2], xh[2];
};

template <bool GLU>
__device__ Grad grad_at(const BwdSmem& f, int ea, int eg, float a, float b, float d) {
  Grad g;
  g.xh[0] = (a - f.mean[ea]) * f.rstd[ea];
  if constexpr (GLU) {
    const float ya = (a - f.mean[ea]) * f.scale[ea] + f.bias[ea];
    const float yg = (b - f.mean[eg]) * f.scale[eg] + f.bias[eg];
    const float s = 1.f / (1.f + expf(-yg));
    g.dy[0] = d * s;
    g.dy[1] = d * ya * s * (1.f - s);
    g.xh[1] = (b - f.mean[eg]) * f.rstd[eg];
  } else {
    g.dy[0] = d;
  }
  return g;
}

template <typename T, bool GLU>
__global__ void __launch_bounds__(kThreads)
bn_bw_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                    const float* __restrict__ stats, const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ part,
                    float* __restrict__ sums, float* __restrict__ dweight,
                    float* __restrict__ dbias, int rows, int C, int bc, int per_strip, float eps) {
  constexpr int V = Vec<T>::N, NH = GLU ? 2 : 1;
  __shared__ BwdSmem f;
  __shared__ float red[kThreads * V];
  const int half = C / NH;
  const Place at(rows, half, V, bc, per_strip);
  bwd_factors<GLU>(f, at, stats, weight, bias, nullptr, C, eps, 1.f);
  float s[NH][V], q[NH][V];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int k = 0; k < V; ++k) s[h][k] = q[h][k] = 0.f;
  if (at.active) {
    const int e0 = at.cb * V;
    const size_t in0 = (size_t)at.col * V;
    for (int r = at.r0 + at.lane; r < at.r1; r += at.lanes * kBwdUnroll) {
      typename Vec<T>::Raw ra[kBwdUnroll], rb[kBwdUnroll], rd[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int rr = r + u * at.lanes;
        if (rr >= at.r1) break;
        ra[u] = Vec<T>::load(x + (size_t)rr * C + in0);
        if constexpr (GLU) rb[u] = Vec<T>::load(x + (size_t)rr * C + half + in0);
        rd[u] = Vec<T>::load(dout + (size_t)rr * half + in0);
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (r + u * at.lanes >= at.r1) break;
        float a[V], b[V], d[V];
        Vec<T>::unpack(ra[u], a);
        if constexpr (GLU) Vec<T>::unpack(rb[u], b);
        Vec<T>::unpack(rd[u], d);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const Grad g = grad_at<GLU>(f, e0 + k, at.width + e0 + k, a[k], GLU ? b[k] : 0.f, d[k]);
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            s[h][k] += g.dy[h];
            q[h][k] = fmaf(g.dy[h], g.xh[h], q[h][k]);
          }
        }
      }
    }
  }
  float* row = part + (size_t)blockIdx.y * 2 * C;
  block_partial<V, NH>(at, s, red, row, half);
  block_partial<V, NH>(at, q, red, row + C, half);
  if (!last_block(&g_ticket[1][blockIdx.x])) return;
  reduce_strips(part, gridDim.y, C, half, NH, at.width, red, [&](int i, float v) {
    sums[i] = v;
    if (i < C) dbias[i] = v;
    else dweight[i - C] = v;
  });
}

template <typename T, bool GLU>
__global__ void __launch_bounds__(kThreads)
bn_bw_dx_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                const float* __restrict__ stats, const float* __restrict__ weight,
                const float* __restrict__ bias, const float* __restrict__ sums,
                T* __restrict__ dx, int rows, int C, int bc, int per_strip, float eps, float n) {
  constexpr int V = Vec<T>::N, NH = GLU ? 2 : 1;
  __shared__ BwdSmem f;
  const int half = C / NH;
  const Place at(rows, half, V, bc, per_strip);
  bwd_factors<GLU>(f, at, stats, weight, bias, sums, C, eps, n);
  if (!at.active) return;
  const int e0 = at.cb * V;
  const size_t in0 = (size_t)at.col * V;
  for (int r = at.r0 + at.lane; r < at.r1; r += at.lanes * kBwdUnroll) {
    typename Vec<T>::Raw ra[kBwdUnroll], rb[kBwdUnroll], rd[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int rr = r + u * at.lanes;
      if (rr >= at.r1) break;
      ra[u] = Vec<T>::load(x + (size_t)rr * C + in0);
      if constexpr (GLU) rb[u] = Vec<T>::load(x + (size_t)rr * C + half + in0);
      rd[u] = Vec<T>::load(dout + (size_t)rr * half + in0);
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      const int rr = r + u * at.lanes;
      if (rr >= at.r1) break;
      float a[V], b[V], d[V], o[NH][V];
      Vec<T>::unpack(ra[u], a);
      if constexpr (GLU) Vec<T>::unpack(rb[u], b);
      Vec<T>::unpack(rd[u], d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const Grad g = grad_at<GLU>(f, e0 + k, at.width + e0 + k, a[k], GLU ? b[k] : 0.f, d[k]);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const int e = h * at.width + e0 + k;
          o[h][k] = f.scale[e] * (g.dy[h] - f.k1[e] - g.xh[h] * f.k2[e]);
        }
      }
#pragma unroll
      for (int h = 0; h < NH; ++h) Vec<T>::store(dx + (size_t)rr * C + h * half + in0, o[h]);
    }
  }
}

// ---- launches ----

// The grid of a [rows, C] launch whose threads take 16-byte columns of
// `half` channels: checks what the wrapper sized.
bool grid_of(int rows, int half, int vec, int bc, int per_strip, dim3* grid) {
  if (rows < 1 || half < vec || half % vec != 0 || bc < 1 || bc > kMaxCols || per_strip < 1)
    return false;
  const int cols = half / vec;
  if (bc > cols) return false;
  const long strips = ((long)rows + per_strip - 1) / per_strip;
  const int chunks = (cols + bc - 1) / bc;
  if (strips > kMaxStrips || chunks > kMaxChunks) return false;
  *grid = dim3(chunks, (unsigned)strips);
  return true;
}

template <typename T>
cudaError_t stats_launch(const void* x, void* part, void* stats, int rows, int C, int bc,
                         int per_strip, float n, float world, cudaStream_t s) {
  dim3 grid;
  if (!grid_of(rows, C, Vec<T>::N, bc, per_strip, &grid)) return cudaErrorInvalidValue;
  bn_fw_stats_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(part), static_cast<float*>(stats), rows, C,
      bc, per_strip, n, world);
  return cudaGetLastError();
}

template <typename T, int EPI>
cudaError_t apply_launch(const void* x, const void* stats, const void* weight, const void* bias,
                         void* rmean, void* rvar, const void* res, void* out, int rows, int C,
                         int bc, int per_strip, float eps, cudaStream_t s) {
  dim3 grid;
  if (!grid_of(rows, EPI == kGlu ? C / 2 : C, Vec<T>::N, bc, per_strip, &grid) ||
      (EPI == kGlu && C % 2 != 0) || (EPI == kResidual) != (res != nullptr))
    return cudaErrorInvalidValue;
  bn_fw_apply_kernel<T, EPI><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(rmean), static_cast<float*>(rvar), static_cast<const T*>(res),
      static_cast<T*>(out), rows, C, bc, per_strip, eps);
  return cudaGetLastError();
}

template <typename T, bool GLU>
cudaError_t reduce_launch(const void* x, const void* dout, const void* stats, const void* weight,
                          const void* bias, void* part, void* sums, void* dweight, void* dbias,
                          int rows, int C, int bc, int per_strip, float eps, cudaStream_t s) {
  dim3 grid;
  if (!grid_of(rows, GLU ? C / 2 : C, Vec<T>::N, bc, per_strip, &grid) || (GLU && C % 2 != 0))
    return cudaErrorInvalidValue;
  bn_bw_reduce_kernel<T, GLU><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const float*>(stats),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<float*>(part), static_cast<float*>(sums), static_cast<float*>(dweight),
      static_cast<float*>(dbias), rows, C, bc, per_strip, eps);
  return cudaGetLastError();
}

template <typename T, bool GLU>
cudaError_t dx_launch(const void* x, const void* dout, const void* stats, const void* weight,
                      const void* bias, const void* sums, void* dx, int rows, int C, int bc,
                      int per_strip, float eps, float n, cudaStream_t s) {
  dim3 grid;
  if (!grid_of(rows, GLU ? C / 2 : C, Vec<T>::N, bc, per_strip, &grid) || (GLU && C % 2 != 0))
    return cudaErrorInvalidValue;
  bn_bw_dx_kernel<T, GLU><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const float*>(stats),
      static_cast<const float*>(weight), static_cast<const float*>(bias),
      static_cast<const float*>(sums), static_cast<T*>(dx), rows, C, bc, per_strip, eps, n);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous on one device and 16-byte aligned; x [rows, C] (and
// res, out, dx, dout in their widths) f32 (is_bf16 = 0) or bf16 (1); stats,
// sums [2, C], weight, bias, running statistics, dweight, dbias [C] f32;
// part [strips, 2, C] f32 with strips = ceil(rows / per_strip).  The grid
// (bc columns of 16 bytes a block, per_strip rows a strip) is the wrapper's
// (ops/kernels/batchnorm.py geometry).  epilogue: 0 none, 1 GLU over the
// channel halves (out [rows, C / 2]), 2 + res.

extern "C" int t2igan_bn_stats(const void* x, void* part, void* stats, int rows, int C, int bc,
                               int per_strip, float n, float world, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)stats_launch<bf16>(x, part, stats, rows, C, bc, per_strip, n, world, s);
  return (int)stats_launch<float>(x, part, stats, rows, C, bc, per_strip, n, world, s);
}

extern "C" int t2igan_bn_apply(const void* x, const void* stats, const void* weight,
                               const void* bias, void* rmean, void* rvar, const void* res,
                               void* out, int rows, int C, int bc, int per_strip, float eps,
                               int epilogue, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define T2IGAN_BN_APPLY(T, E) \
  apply_launch<T, E>(x, stats, weight, bias, rmean, rvar, res, out, rows, C, bc, per_strip, eps, s)
  switch (epilogue * 2 + (is_bf16 ? 1 : 0)) {
    case 0: return (int)T2IGAN_BN_APPLY(float, kNone);
    case 1: return (int)T2IGAN_BN_APPLY(bf16, kNone);
    case 2: return (int)T2IGAN_BN_APPLY(float, kGlu);
    case 3: return (int)T2IGAN_BN_APPLY(bf16, kGlu);
    case 4: return (int)T2IGAN_BN_APPLY(float, kResidual);
    case 5: return (int)T2IGAN_BN_APPLY(bf16, kResidual);
  }
#undef T2IGAN_BN_APPLY
  return (int)cudaErrorInvalidValue;
}

extern "C" int t2igan_bn_bwd_reduce(const void* x, const void* dout, const void* stats,
                                    const void* weight, const void* bias, void* part, void* sums,
                                    void* dweight, void* dbias, int rows, int C, int bc,
                                    int per_strip, float eps, int glu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define T2IGAN_BN_REDUCE(T, G)                                                              \
  reduce_launch<T, G>(x, dout, stats, weight, bias, part, sums, dweight, dbias, rows, C, bc, \
                      per_strip, eps, s)
  if (is_bf16) return (int)(glu ? T2IGAN_BN_REDUCE(bf16, true) : T2IGAN_BN_REDUCE(bf16, false));
  return (int)(glu ? T2IGAN_BN_REDUCE(float, true) : T2IGAN_BN_REDUCE(float, false));
#undef T2IGAN_BN_REDUCE
}

extern "C" int t2igan_bn_bwd_dx(const void* x, const void* dout, const void* stats,
                                const void* weight, const void* bias, const void* sums, void* dx,
                                int rows, int C, int bc, int per_strip, float eps, float n,
                                int glu, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define T2IGAN_BN_DX(T, G) \
  dx_launch<T, G>(x, dout, stats, weight, bias, sums, dx, rows, C, bc, per_strip, eps, n, s)
  if (is_bf16) return (int)(glu ? T2IGAN_BN_DX(bf16, true) : T2IGAN_BN_DX(bf16, false));
  return (int)(glu ? T2IGAN_BN_DX(float, true) : T2IGAN_BN_DX(float, false));
#undef T2IGAN_BN_DX
}

// cudaGetLastError of this library's runtime: a fault that a check after
// synchronising should find clean.
extern "C" int t2igan_bn_last_error() { return (int)cudaGetLastError(); }
