// Fused separable f32 blur (K2): f32 or uint8 planes in, f32 or uint8 out.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_blur.py:_kernel (its
// bf16x3 branch, the blocked float / custom-taps kernel, also in its
// pre_padded_col mode, 439-447 and 465: the sharded path's rows carry the
// caller's halo rows and are never reflected) and
// blur_algorithms_tpu/pallas_kernels/fused_dma.py:_tile_bf16x3 (K1's bf16x3
// tile body, "same numerics as fused_blur._kernel's bf16x3 path"). Both
// compute out = corr_cols(corr_rows(reflect101(x))) with any odd tap
// vectors, the TPU way: hi/lo bf16 split dots on the MXU, which give about
// f32 accuracy. This kernel computes the same correlations in plain f32 on
// the CUDA cores, one explicit fmaf per tap (the build passes --fmad=false
// for every source, which does not touch explicit fmaf calls), so it is at
// least as accurate as bf16x3. The orientation is correlation,
// out[j] = sum_t taps[t] * x[j - r + t], as in band_block_matrix.
//
// Per (plane, th x tw output tile), one block of 256 threads:
//   1. rows pass over the th + 2rh halo rows, G rows at a time: stage the
//      reflect-101 row segments (tw + 2rw values each; a thread keeps one
//      column and 8 loads in flight) in shared memory column-major (stride S per
//      column, S picked so that a warp's reads hit 32 distinct banks), then each thread computes R = 8 adjacent
//      outputs of one row with a sliding window of R registers: one shared
//      load and R fmaf per tap (the taps come four at a time in one
//      broadcast 16-byte load). The f32 intermediate (th + 2rh rows of tw,
//      row stride tw + 1) stays in shared memory;
//   2. cols pass: each thread computes RC = 16 adjacent output rows of one
//      column, again with a sliding register window: one shared load and
//      RC fmaf per tap;
//   3. store f32, or uint8 through clip(y + 0.5, 0, 255.5) and a truncating
//      cast (fused_blur.py:_store_u8, the same store as K1).
// A radius-0 axis has the single tap 1.0, and fmaf(1, x, 0) == x, so that
// pass is a copy without a separate code path. Reflect-101 is index math in
// the loader; no padded frame is built. Taps are read from shared memory.
//
// What bounds it on an H100: f32 arithmetic. At the main shape (12 planes of
// 2160x3840, sigma 10, r = 32) it needs 99.5 M outputs x 130 taps = 12.9 G
// multiply-adds = 25.9 GFLOP, 0.39 ms at the card's 67 TFLOP/s of f32,
// against 398 + 398 MB of device memory traffic, 0.24 ms at 3.35 TB/s. The
// design spends more than that: the rows pass recomputes the 2rh halo rows
// of every tile (1.5x at r = 32 with 128-row tiles), each tap costs a
// shared load beside the R or RC fmaf, and staging, index math and the
// two barriers per group of rows come on top. The register windows (R = 8,
// RC = 16) and the tile shape are the fastest of the variants in
// probes/k2_variants.py. The f32 intermediate takes 4 bytes a value, so at
// wide radii a tile holds few rows and the halo recompute dominates.
// Tensor cores (3xTF32 or bf16x3 wgmma), TMA staging and a two-pass split
// at wide radii are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 8;    // rows-pass outputs per thread (adjacent columns)
constexpr int kRC = 16;  // cols-pass outputs per thread (adjacent rows)
constexpr int kBatch = 8;  // staging loads in flight per thread

struct Geometry {
  int th, tw;  // output tile rows x cols
  int g, s;    // halo rows staged per group, staging column stride (floats)
  int smem;    // dynamic shared memory bytes
};

__host__ __device__ inline int round8(int n) { return (n + 7) & ~7; }
inline int round_rc(int n) { return (n + kRC - 1) / kRC * kRC; }

// Column stride of the staging buffer for G rows per group: a warp reads
// rows rr = lane % G of column blocks jb = lane / G at float offset
// jb * kR * S + rr, which covers the 32 banks once when kR * S = G mod 32
// (kR = 8); for G = 32 any S will do and an odd one keeps the staging
// writes conflict-free too.
inline int stage_stride(int g) { return g == 32 ? 33 : (g == 16 ? 18 : 9); }

inline int smem_bytes(int th, int tw, int g, int rh, int rw) {
  const int taps = round8(2 * rw + 1) + round8(2 * rh + 1);
  const int stage = stage_stride(g) * (tw + 2 * rw);
  const int inter = (th + 2 * rh) * (tw + 1);
  return 4 * (taps + stage + inter);
}

// Tall tiles amortise the 2rh halo rows that the rows pass recomputes per
// tile; fewer staged rows per group keep wide row radii in shared memory.
// The row tiles are then balanced over the frame: the fewest tiles of at
// most the target height, all of one height (a multiple of kRC). The
// breakpoints come from probes/k2_variants.py (PERF.md).
Geometry pick_geometry(int h, int rh, int rw, int smem_limit) {
  Geometry geo;
  geo.tw = rw <= 100 ? 64 : 32;
  geo.g = 32;
  int target = rh <= 100 ? 128 : (rh <= 400 ? 512 : 1024);
  target = target < round_rc(h) ? target : round_rc(h);
  while (smem_bytes(target, geo.tw, geo.g, rh, rw) > smem_limit) {
    if (geo.g > 8) {
      geo.g >>= 1;
    } else if (target > kRC) {
      target = round_rc(target / 2);
    } else {
      break;
    }
  }
  const int tiles = (h + target - 1) / target;
  geo.th = round_rc((h + tiles - 1) / tiles);
  geo.s = stage_stride(geo.g);
  geo.smem = smem_bytes(geo.th, geo.tw, geo.g, rh, rw);
  return geo;
}

// reflect-101 source index; exact for -(n-1) <= i <= 2(n-1), clamped
// beyond (only rows and columns that feed no stored output reach that far)
__device__ __forceinline__ int reflect101(int i, int n) {
  i = abs(i);
  i = i > n - 1 ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// acc[s] += sum_t w[t] * src[(t + s) * stride] for s < N, t < ntaps, with
// a circular window of N registers: each tap loads one new value. The tap
// loop runs in chunks of N so that every register index is static.
template <int N>  // N is a multiple of 4
__device__ __forceinline__ void correlate(const float* __restrict__ src,
                                          int stride,
                                          const float* __restrict__ w,
                                          int ntaps, float (&acc)[N]) {
  float win[N];
#pragma unroll
  for (int s = 0; s < N - 1; ++s) win[s] = src[s * stride];
  int t = 0;
  for (; t + N <= ntaps; t += N) {
    float wv[N];  // N taps in N / 4 broadcast 16-byte loads (w is 16-aligned)
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + t + q);
      wv[q] = v.x;
      wv[q + 1] = v.y;
      wv[q + 2] = v.z;
      wv[q + 3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      win[(u + N - 1) % N] = src[(t + u + N - 1) * stride];
#pragma unroll
      for (int s = 0; s < N; ++s) acc[s] = fmaf(wv[u], win[(u + s) % N], acc[s]);
    }
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (t + u < ntaps) {
      win[(u + N - 1) % N] = src[(t + u + N - 1) * stride];
      const float wt = w[t + u];
#pragma unroll
      for (int s = 0; s < N; ++s) acc[s] = fmaf(wt, win[(u + s) % N], acc[s]);
    }
  }
}

template <typename Tin, bool kOutU8>
__global__ void __launch_bounds__(kThreads)
fused_blur_f32_kernel(const Tin* __restrict__ x, void* __restrict__ out,
                      const float* __restrict__ taps_row,
                      const float* __restrict__ taps_col, int h, int w,
                      int rh, int rw, int th, int tw, int g, int s_stride,
                      int tiles_w, int pre) {
  extern __shared__ __align__(16) float smem[];
  const int nwr = 2 * rw + 1, nwc = 2 * rh + 1;
  const int hp = th + 2 * rh;   // halo rows of the tile
  const int cw = tw + 2 * rw;   // staged columns per row
  const int ys = tw + 1;        // intermediate row stride
  float* s_wr = smem;
  float* s_wc = s_wr + round8(nwr);
  float* s_x = s_wc + round8(nwc);
  float* s_y = s_x + s_stride * cw;

  const int tid = threadIdx.x;
  const int i0 = (blockIdx.x / tiles_w) * th;
  const int j0 = (blockIdx.x % tiles_w) * tw;
  // pre_padded_col: the plane has xh = h + 2rh rows, the caller's halo rows
  // on both sides, so halo row i (plane row i - rh of the output's frame)
  // is input row i + rh as it is, never reflected (past the last row only
  // for outputs that are not stored)
  const int xh = pre ? h + 2 * rh : h;
  const Tin* xp = x + static_cast<size_t>(blockIdx.y) * xh * w;

  for (int k = tid; k < nwr; k += kThreads) s_wr[k] = taps_row[k];
  for (int k = tid; k < nwc; k += kThreads) s_wc[k] = taps_col[k];

  // ---- rows pass: halo rows [r0, r0 + g) per group -> s_y ----
  const int ncb = tw / kR;           // column blocks per row
  const int gshift = __ffs(g) - 1;   // g is 8, 16 or 32
  // staging lanes: a thread keeps one column (columns kThreads apart when
  // cw > kThreads) and every rlanes-th row of the group, so neighbouring
  // threads read neighbouring columns and the index math is per column and
  // per row, not per element; a tile whose halo lies inside the frame
  // skips the reflection (per axis)
  const int rlanes = cw < kThreads ? kThreads / cw : 1;
  const int lane_r = tid / cw, lane_c = tid % cw;
  const int cstep = cw < kThreads ? cw : kThreads;
  const int roff = pre ? rh : 0;
  const bool interior_r = pre ? i0 + hp <= xh : i0 - rh >= 0 && i0 + hp - rh <= h;
  const bool interior_c = j0 - rw >= 0 && j0 + cw - rw <= w;
  for (int r0 = 0; r0 < hp; r0 += g) {
    const int nr = min(g, hp - r0);
    __syncthreads();  // the previous group is done with s_x
    if (lane_r < rlanes) {
      for (int c = lane_c; c < cw; c += cstep) {
        const int gj = interior_c ? j0 - rw + c : reflect101(j0 - rw + c, w);
        const Tin* col = xp + gj;
        float* dst = s_x + c * s_stride;
        for (int rr0 = lane_r; rr0 < nr; rr0 += rlanes * kBatch) {
          Tin v[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int rr = rr0 + b * rlanes;
            if (rr < nr) {
              const int i = i0 - rh + r0 + rr;
              const int src = interior_r ? i + roff
                                         : (pre ? min(i + rh, xh - 1) : reflect101(i, h));
              v[b] = col[static_cast<size_t>(src) * w];
            }
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int rr = rr0 + b * rlanes;
            if (rr < nr) dst[rr] = static_cast<float>(v[b]);
          }
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < (ncb << gshift); k += kThreads) {
      const int rr = k & (g - 1);
      const int c0 = (k >> gshift) * kR;
      if (rr >= nr) continue;
      float acc[kR];
#pragma unroll
      for (int s = 0; s < kR; ++s) acc[s] = 0.0f;
      correlate<kR>(s_x + c0 * s_stride + rr, s_stride, s_wr, nwr, acc);
      float* yrow = s_y + (r0 + rr) * ys + c0;
#pragma unroll
      for (int s = 0; s < kR; ++s) yrow[s] = acc[s];
    }
  }
  __syncthreads();

  // ---- cols pass: kRC output rows of one column per item ----
  const int nrb = th / kRC;
  for (int k = tid; k < nrb * tw; k += kThreads) {
    const int ib = k / tw;
    const int j = k - ib * tw;
    const int ii = ib * kRC;
    float acc[kRC];
#pragma unroll
    for (int s = 0; s < kRC; ++s) acc[s] = 0.0f;
    correlate<kRC>(s_y + ii * ys + j, ys, s_wc, nwc, acc);
    const int gj = j0 + j;
    if (gj >= w) continue;
#pragma unroll
    for (int s = 0; s < kRC; ++s) {
      const int gi = i0 + ii + s;
      if (gi >= h) break;
      const size_t o = static_cast<size_t>(blockIdx.y) * h * w +
                       static_cast<size_t>(gi) * w + gj;
      if (kOutU8) {
        const float v = fminf(fmaxf(__fadd_rn(acc[s], 0.5f), 0.0f), 255.5f);
        static_cast<uint8_t*>(out)[o] = static_cast<uint8_t>(__float2int_rz(v));
      } else {
        static_cast<float*>(out)[o] = acc[s];
      }
    }
  }
}

template <typename Tin, bool kOutU8>
int launch(const void* x, void* out, const void* taps_row,
           const void* taps_col, int planes, int h, int w, int rh, int rw,
           int pre, cudaStream_t stream) {
  int device = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry geo = pick_geometry(h, rh, rw, smem_limit);
  if (geo.smem > smem_limit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_blur_f32_kernel<Tin, kOutU8>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             geo.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (w + geo.tw - 1) / geo.tw;
  const int tiles_h = (h + geo.th - 1) / geo.th;
  dim3 grid(tiles_w * tiles_h, planes);
  kernel<<<grid, kThreads, geo.smem, stream>>>(
      static_cast<const Tin*>(x), out, static_cast<const float*>(taps_row),
      static_cast<const float*>(taps_col), h, w, rh, rw, geo.th, geo.tw,
      geo.g, geo.s, tiles_w, pre);
  return static_cast<int>(cudaGetLastError());
}

// ---- the single-axis wide form (the split's passes) ----
//
// Replaces the same _kernel with skip_rows / skip_cols (fused_blur.py:136-
// 215, one axis of radius 0: the two-pass split's single-axis kernels). The
// two-axis kernel above holds a tile's whole f32 intermediate and the staged
// halo in shared memory, which stops at r 600; a single-axis pass needs
// neither. The taps run in chunks of kAxisChunk, each chunk staging only the
// window slice it reads, and every thread keeps its accumulators in
// registers across the chunks, so the taps still arrive in ascending order,
// one fmaf each, at any radius (the plain version reproduces the rounding).
// Rows: one block per 8 rows x 256 columns, staged column-major (stride 9,
// as the rows pass above with G = 8), R = 8 outputs a thread. Columns: one
// block per 128 rows x 32 columns, staged row-major (stride 33), RC = 16
// outputs a thread. Shared memory is ~19 or ~36 KB plus the taps (32 KB at
// r 4096). Bound: f32 arithmetic, 2 (2r + 1) FLOP per output; each staged
// value is read from L2 about (2r + 1) (1 / 256 + 1 / chunk) times.

constexpr int kAxisChunk = 256;
constexpr int kAxisRowsG = 8, kAxisRowsTw = 256, kAxisRowsS = 9;
constexpr int kAxisColsTh = 128, kAxisColsTw = 32, kAxisColsS = kAxisColsTw + 1;
constexpr int kAxisColsChunk = 128;

template <typename Tin, bool kOutU8>
__device__ __forceinline__ void store_out(void* out, size_t o, float v) {
  if (kOutU8) {
    const float u = fminf(fmaxf(__fadd_rn(v, 0.5f), 0.0f), 255.5f);
    static_cast<uint8_t*>(out)[o] = static_cast<uint8_t>(__float2int_rz(u));
  } else {
    static_cast<float*>(out)[o] = v;
  }
}

template <typename Tin, bool kOutU8>
__global__ void __launch_bounds__(kThreads)
fused_axis_rows_kernel(const Tin* __restrict__ x, void* __restrict__ out,
                       const float* __restrict__ taps, int h, int w, int r,
                       int tiles_w) {
  extern __shared__ __align__(16) float smem[];
  const int ntaps = 2 * r + 1;
  float* s_t = smem;
  float* s_x = s_t + round8(ntaps);
  const int tid = threadIdx.x;
  const int i0 = (blockIdx.x / tiles_w) * kAxisRowsG;
  const int j0 = (blockIdx.x % tiles_w) * kAxisRowsTw;
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  const Tin* xp = x + plane;
  for (int k = tid; k < ntaps; k += kThreads) s_t[k] = taps[k];

  const int rr = tid % kAxisRowsG;
  const int c0 = (tid / kAxisRowsG) * kR;
  float acc[kR];
#pragma unroll
  for (int s = 0; s < kR; ++s) acc[s] = 0.0f;
  const int cols = kAxisRowsTw + kAxisChunk + kR;
  for (int k0 = 0; k0 < ntaps; k0 += kAxisChunk) {
    __syncthreads();  // the previous chunk is done with s_x
    for (int c = tid; c < cols; c += kThreads) {
      const int gj = reflect101(j0 - r + k0 + c, w);
      for (int q = 0; q < kAxisRowsG; ++q) {
        const int gi = min(i0 + q, h - 1);
        s_x[c * kAxisRowsS + q] =
            static_cast<float>(xp[static_cast<size_t>(gi) * w + gj]);
      }
    }
    __syncthreads();
    correlate<kR>(s_x + c0 * kAxisRowsS + rr, kAxisRowsS, s_t + k0,
                  min(kAxisChunk, ntaps - k0), acc);
  }
  const int gi = i0 + rr;
  if (gi >= h) return;
#pragma unroll
  for (int s = 0; s < kR; ++s) {
    const int gj = j0 + c0 + s;
    if (gj < w) store_out<Tin, kOutU8>(out, plane + static_cast<size_t>(gi) * w + gj, acc[s]);
  }
}

template <typename Tin, bool kOutU8>
__global__ void __launch_bounds__(kThreads)
fused_axis_cols_kernel(const Tin* __restrict__ x, void* __restrict__ out,
                       const float* __restrict__ taps, int h, int w, int r,
                       int tiles_w, int pre) {
  extern __shared__ __align__(16) float smem[];
  const int ntaps = 2 * r + 1;
  float* s_t = smem;
  float* s_y = s_t + round8(ntaps);
  const int tid = threadIdx.x;
  const int i0 = (blockIdx.x / tiles_w) * kAxisColsTh;
  const int j0 = (blockIdx.x % tiles_w) * kAxisColsTw;
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  // pre_padded_col: xh = h + 2r input rows, output row o reading input rows
  // o .. o + 2r as they are
  const int xh = pre ? h + 2 * r : h;
  const Tin* xp = x + static_cast<size_t>(blockIdx.y) * xh * w;
  for (int k = tid; k < ntaps; k += kThreads) s_t[k] = taps[k];

  const int j = tid % kAxisColsTw;
  const int ii = (tid / kAxisColsTw) * kRC;
  const int gjl = min(j0 + j, w - 1);
  float acc[kRC];
#pragma unroll
  for (int s = 0; s < kRC; ++s) acc[s] = 0.0f;
  const int rows = kAxisColsTh + kAxisColsChunk + kRC;
  for (int k0 = 0; k0 < ntaps; k0 += kAxisColsChunk) {
    __syncthreads();  // the previous chunk is done with s_y
    for (int q = tid / kAxisColsTw; q < rows; q += kThreads / kAxisColsTw) {
      const int gi = pre ? min(i0 + k0 + q, xh - 1) : reflect101(i0 - r + k0 + q, h);
      s_y[q * kAxisColsS + j] =
          static_cast<float>(xp[static_cast<size_t>(gi) * w + gjl]);
    }
    __syncthreads();
    correlate<kRC>(s_y + ii * kAxisColsS + j, kAxisColsS, s_t + k0,
                   min(kAxisColsChunk, ntaps - k0), acc);
  }
  const int gj = j0 + j;
  if (gj >= w) return;
#pragma unroll
  for (int s = 0; s < kRC; ++s) {
    const int gi = i0 + ii + s;
    if (gi >= h) break;
    store_out<Tin, kOutU8>(out, plane + static_cast<size_t>(gi) * w + gj, acc[s]);
  }
}

template <typename Tin, bool kOutU8>
int launch_axis(const void* x, void* out, const void* taps, int planes, int h,
                int w, int axis, int r, int pre, cudaStream_t stream) {
  int device = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool rows = axis == 1;
  const int stage = rows ? (kAxisRowsTw + kAxisChunk + kR) * kAxisRowsS
                         : (kAxisColsTh + kAxisColsChunk + kRC) * kAxisColsS;
  const int smem = 4 * (round8(2 * r + 1) + stage);
  if (smem > smem_limit || planes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tin* xs = static_cast<const Tin*>(x);
  const float* ts = static_cast<const float*>(taps);
  if (rows) {  // no column halo: pre_padded_col leaves a rows pass as it is
    const int tiles_w = (w + kAxisRowsTw - 1) / kAxisRowsTw;
    err = cudaFuncSetAttribute(fused_axis_rows_kernel<Tin, kOutU8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(tiles_w * ((h + kAxisRowsG - 1) / kAxisRowsG), planes);
    fused_axis_rows_kernel<Tin, kOutU8><<<grid, kThreads, smem, stream>>>(
        xs, out, ts, h, w, r, tiles_w);
  } else {
    const int tiles_w = (w + kAxisColsTw - 1) / kAxisColsTw;
    err = cudaFuncSetAttribute(fused_axis_cols_kernel<Tin, kOutU8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(tiles_w * ((h + kAxisColsTh - 1) / kAxisColsTh), planes);
    fused_axis_cols_kernel<Tin, kOutU8><<<grid, kThreads, smem, stream>>>(
        xs, out, ts, h, w, r, tiles_w, pre);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The single-axis wide form: x planes x h x w of float (in_u8 = 0) or uint8;
// out float (out_u8 = 0) or uint8; taps (2r + 1) float32 on the device;
// axis 1 correlates along w, axis 0 along h (the other axis is a copy).
// pre = 1 (axis 0): x has h + 2r rows per plane, the caller's halo rows, and
// output row o reads rows o .. o + 2r with no reflection.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int blur_fused_axis_f32(const void* x, void* out, const void* taps,
                                   int in_u8, int out_u8, int pre, int planes,
                                   int h, int w, int axis, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_u8) {
    return out_u8 ? launch_axis<uint8_t, true>(x, out, taps, planes, h, w, axis, r, pre, st)
                  : launch_axis<uint8_t, false>(x, out, taps, planes, h, w, axis, r, pre, st);
  }
  return out_u8 ? launch_axis<float, true>(x, out, taps, planes, h, w, axis, r, pre, st)
                : launch_axis<float, false>(x, out, taps, planes, h, w, axis, r, pre, st);
}

// x: planes x h x w of float (in_u8 = 0) or uint8 (in_u8 = 1), or planes x
// (h + 2rh) x w with the caller's halo rows (pre = 1, pre_padded_col: rows
// are read as they are, columns still reflect); out: planes x h x w of float
// (out_u8 = 0) or uint8 (out_u8 = 1); taps_row (2rw + 1) and taps_col
// (2rh + 1) are float32 on the device. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int blur_fused_f32(const void* x, void* out, const void* taps_row,
                              const void* taps_col, int in_u8, int out_u8,
                              int pre, int planes, int h, int w, int rh,
                              int rw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_u8) {
    return out_u8 ? launch<uint8_t, true>(x, out, taps_row, taps_col, planes,
                                          h, w, rh, rw, pre, st)
                  : launch<uint8_t, false>(x, out, taps_row, taps_col, planes,
                                           h, w, rh, rw, pre, st);
  }
  return out_u8 ? launch<float, true>(x, out, taps_row, taps_col, planes, h,
                                      w, rh, rw, pre, st)
                : launch<float, false>(x, out, taps_row, taps_col, planes, h,
                                       w, rh, rw, pre, st);
}
