// Fused separable Gaussian blur, uint8 -> uint8, exact int8 fixed point.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_dma.py:_kernel_direct
// with its int8 tile body (_rows_int8, _cols_int8, the u8 store of
// _compute_store). The JAX kernel's band matmuls are 1-D correlations with
// one integer tap vector per axis (every column of a quantised band matrix
// holds the same taps, shifted), so this kernel computes the same exact
// integer sums as direct correlations and rounds its f32 epilogue step by
// step the way XLA does: its output is bit-identical to the JAX kernel's.
//
// Per (plane, th x tw output tile), one block of 256 threads:
//   1. rows pass: for each of the th + 2rh halo rows (padded to a multiple
//      of 4), stage the reflect-101 row segment of tw + 2rw bytes in shared
//      memory recentred to int8 (x ^ 0x80 == x - 128), compute
//      R = sum_t q_row[t] * xc[j - rw + t] exactly in int32 as
//      128 * (q_hi dots) + (q_lo dots) with __dp4a, requantise
//      E = (R + 2^(s-1)) >> s and keep its base-128 digits e1, e0 in
//      shared memory, column-major;
//   2. cols pass: p1 = sum b_hi*e1, p23 = sum b_hi*e0 + b_lo*e1,
//      p4 = sum b_lo*e0 over the 2rh + 1 column taps, again with __dp4a on
//      four consecutive rows of a digit column;
//   3. epilogue: y = f32(p1)*c1 + f32(p23)*c2 + f32(p4)*c3 + 128 with
//      every product and sum rounded on its own (__fmul_rn/__fadd_rn, and
//      the build passes --fmad=false), then clip(y + 0.5, 0, 255.5) and a
//      truncating store.
// Reflect-101 is index math in the loader (i < 0 -> -i, i >= n ->
// 2(n-1) - i), which replaces the JAX form's edge strips and window splices.
//
// What bounds it on an H100: integer issue. At r = 32 every output needs
// about 2 * (1 + 2rh/th) * (2rw + 1) / 4 rows dp4a plus (2rh + 1) cols dp4a,
// and every input byte is read from L2 about (1 + 2rh/th)(1 + 2rw/tw)
// times; device memory traffic (1 byte in, 1 byte out per pixel) is far
// below the card's bandwidth. The design answers with dp4a (4 MACs per
// instruction), digit planes kept in shared memory so the 14-bit
// intermediate never leaves the SM, and tall tiles at wide radii to amortise
// the halo rows. Tensor-core int8 mma, TMA staging and persistence are left
// for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int th, tw, g;  // output tile rows x cols, halo rows staged per group
  int smem;       // dynamic shared memory bytes
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// digit-column stride in bytes: >= th + taps, an odd number of 4-byte words
// so that threads on neighbouring columns hit different banks
__host__ __device__ inline int digit_stride(int th, int rh) {
  int hp = th + round4(2 * rh + 1);
  return ((hp >> 2) & 1) ? hp : hp + 4;
}

inline int smem_bytes(int th, int tw, int g, int rh, int rw) {
  int t4w = round4(2 * rw + 1), t4h = round4(2 * rh + 1);
  int taps = 2 * t4w + 2 * t4h;                // int8 tap words, hi and lo
  int digits = 2 * tw * digit_stride(th, rh);  // e1 and e0 planes
  int stage = g * (tw + t4w);                  // staged recentred rows
  return taps + digits + stage;
}

// Tall tiles at wide radii amortise the 2rh halo rows of the rows pass;
// narrow tiles at wide row radii keep the digit planes in shared memory.
// The breakpoints are the fastest of nine measured shapes at 4K, r 32..598
// (PERF.md, "Tile policy"). The row tiles are then balanced over the frame: the
// fewest tiles of at most the target height, all of one height.
Geometry pick_geometry(int h, int rh, int rw, int smem_limit) {
  Geometry geo;
  geo.tw = rw <= 100 ? 64 : 32;
  geo.g = kThreads / (geo.tw / 4);
  int target = rh <= 100 ? 256 : (rh <= 400 ? 512 : 1024);
  while (target > 32 &&
         smem_bytes(target, geo.tw, geo.g, rh, rw) > smem_limit) {
    target >>= 1;
  }
  const int tiles = (h + target - 1) / target;
  geo.th = round4((h + tiles - 1) / tiles);
  geo.smem = smem_bytes(geo.th, geo.tw, geo.g, rh, rw);
  return geo;
}

// reflect-101 source index; exact for -(n-1) <= i <= 2(n-1), clamped
// beyond (only the padding rows/cols that meet zero taps reach that far)
__device__ __forceinline__ int reflect101(int i, int n) {
  i = abs(i);
  i = i > n - 1 ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// four int8 lanes starting k bytes into the 8-byte pair (lo, hi)
__device__ __forceinline__ int shifted(int lo, int hi, int k) {
  return __byte_perm(lo, hi, 0x3210 + 0x1111 * k);
}

__global__ void __launch_bounds__(kThreads)
fused_blur_int8_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                       const int* __restrict__ taps, int h, int w, int rh,
                       int rw, int rows_shift, float c1, float c2, float c3,
                       int th, int tw, int g, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t4w = round4(2 * rw + 1), t4h = round4(2 * rh + 1);
  const int nqw = t4w >> 2, nqh = t4h >> 2;  // tap words per axis
  const int hp = th + t4h;                   // digit rows per tile column
  const int cs = digit_stride(th, rh);
  const int sw = tw + t4w;                   // staged row width in bytes

  int* s_taps = reinterpret_cast<int*>(smem);  // q_hi, q_lo, b_hi, b_lo
  signed char* s_d1 = reinterpret_cast<signed char*>(s_taps + 2 * nqw + 2 * nqh);
  signed char* s_d0 = s_d1 + tw * cs;
  signed char* s_x = s_d0 + tw * cs;

  const int tid = threadIdx.x;
  const int i0 = (blockIdx.x / tiles_w) * th;
  const int j0 = (blockIdx.x % tiles_w) * tw;
  const uint8_t* xp = x + static_cast<size_t>(blockIdx.y) * h * w;
  uint8_t* op = out + static_cast<size_t>(blockIdx.y) * h * w;

  for (int k = tid; k < 2 * nqw + 2 * nqh; k += kThreads) s_taps[k] = taps[k];

  // ---- rows pass: halo rows [r0, r0 + g) per group -> digits e1, e0 ----
  const int ngrp = tw >> 2;  // 4-column output groups per row
  for (int r0 = 0; r0 < hp; r0 += g) {
    const int nr = min(g, hp - r0);
    __syncthreads();  // the previous group is done with s_x
    for (int c = tid; c < sw; c += kThreads) {
      const int gj = reflect101(j0 - rw + c, w);
      for (int rr = 0; rr < nr; ++rr) {
        const int gi = reflect101(i0 - rh + r0 + rr, h);
        s_x[rr * sw + c] =
            static_cast<signed char>(xp[static_cast<size_t>(gi) * w + gj] ^ 0x80);
      }
    }
    __syncthreads();
    for (int k = tid; k < nr * ngrp; k += kThreads) {
      const int rr = k / ngrp;
      const int c0 = (k - rr * ngrp) << 2;
      const int* xw = reinterpret_cast<const int*>(s_x + rr * sw + c0);
      int hi[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
      int cur = xw[0];
      for (int q = 0; q < nqw; ++q) {
        const int nxt = xw[q + 1];
        const int qh = s_taps[q], ql = s_taps[nqw + q];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int v = shifted(cur, nxt, s);
          hi[s] = __dp4a(v, qh, hi[s]);
          lo[s] = __dp4a(v, ql, lo[s]);
        }
        cur = nxt;
      }
      const int m = r0 + rr;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = hi[s] * 128 + lo[s];
        const int e = (r + (1 << (rows_shift - 1))) >> rows_shift;
        const int e1 = (e + 64) >> 7;
        s_d1[(c0 + s) * cs + m] = static_cast<signed char>(e1);
        s_d0[(c0 + s) * cs + m] = static_cast<signed char>(e - e1 * 128);
      }
    }
  }
  __syncthreads();

  // ---- cols pass: 4 output rows of one column per item ----
  const int* bhi = s_taps + 2 * nqw;
  const int* blo = bhi + nqh;
  const int nrg = th >> 2;
  for (int k = tid; k < nrg * tw; k += kThreads) {
    const int a = k / tw;
    const int j = k - a * tw;
    const int ii = a << 2;
    const int* d1 = reinterpret_cast<const int*>(s_d1 + j * cs + ii);
    const int* d0 = reinterpret_cast<const int*>(s_d0 + j * cs + ii);
    int p1[4] = {0, 0, 0, 0}, p23[4] = {0, 0, 0, 0}, p4[4] = {0, 0, 0, 0};
    int cur1 = d1[0], cur0 = d0[0];
    for (int q = 0; q < nqh; ++q) {
      const int nxt1 = d1[q + 1], nxt0 = d0[q + 1];
      const int bh = bhi[q], bl = blo[q];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int e1 = shifted(cur1, nxt1, s);
        const int e0 = shifted(cur0, nxt0, s);
        p1[s] = __dp4a(e1, bh, p1[s]);
        p23[s] = __dp4a(e1, bl, __dp4a(e0, bh, p23[s]));
        p4[s] = __dp4a(e0, bl, p4[s]);
      }
      cur1 = nxt1;
      cur0 = nxt0;
    }
    const int gj = j0 + j;
    if (gj >= w) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gi = i0 + ii + s;
      if (gi >= h) break;
      float y = __fadd_rn(__fmul_rn(__int2float_rn(p1[s]), c1),
                          __fmul_rn(__int2float_rn(p23[s]), c2));
      y = __fadd_rn(y, __fmul_rn(__int2float_rn(p4[s]), c3));
      y = __fadd_rn(y, 128.0f);
      const float v = fminf(fmaxf(__fadd_rn(y, 0.5f), 0.0f), 255.5f);
      op[static_cast<size_t>(gi) * w + gj] =
          static_cast<uint8_t>(__float2int_rz(v));
    }
  }
}

}  // namespace

// taps: int32 words [q_hi (nqw) | q_lo (nqw) | b_hi (nqh) | b_lo (nqh)], each
// word four int8 taps, tap 4k + u in byte u, zero-padded to a multiple of 4.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int blur_fused_u8_int8(const void* x, void* out, const void* taps,
                                  int planes, int h, int w, int rh, int rw,
                                  int rows_shift, float c1, float c2, float c3,
                                  void* stream) {
  int device = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&smem_limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry geo = pick_geometry(h, rh, rw, smem_limit);
  if (geo.smem > smem_limit) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fused_blur_int8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             geo.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (w + geo.tw - 1) / geo.tw;
  const int tiles_h = (h + geo.th - 1) / geo.th;
  dim3 grid(tiles_w * tiles_h, planes);
  fused_blur_int8_kernel<<<grid, kThreads, geo.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
      static_cast<const int*>(taps), h, w, rh, rw, rows_shift, c1, c2, c3,
      geo.th, geo.tw, geo.g, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* blur_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
