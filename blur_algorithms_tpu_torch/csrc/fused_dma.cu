// Fused separable Gaussian blur of uint8 planes (K1): the int8, hybrid and
// bf16 rungs of the precision ladder.
//
// 1. The int8 rung, uint8 -> uint8, exact int8 fixed point.
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
// 2. The hybrid and bf16 rungs (blur_fused_u8_bf16cols), uint8 -> uint8 or
// f32.
//
// Replaces: the same kernel's _tile_hybrid (fused_dma.py:1306) and
// _tile_bf16 (:1415) bodies. Hybrid: the int8 rung's exact rows sum R
// (__dp4a, as above, without the requantisation: the JAX body folds the
// shift into its output scale), y = bf16(f32(R)) kept in shared memory in
// the bytes E's digit planes take in the int8 rung, then acc = sum_t
// bf16(c_t) * y[t] in f32 and out = fma(acc, 1 / (127 * 2^s), 128). bf16:
// the reflect-101 rows staged as bf16 (uint8 values are exact there), y =
// bf16(sum_t bf16(r_t) * x[t]) in f32, then out = sum_t bf16(c_t) * y[t];
// no epilogue. A bf16 x bf16 product is exact in f32, so with every sum
// taken in ascending tap order (__fmaf_rn) the result is the plain
// version's (cuda_kernels/fused_dma.py) bit for bit, and the JAX body's
// wherever XLA sums its dots in that order. Tiles and row groups as in the int8 rung; each item is 4 outputs
// of one row (rows) or of one column (cols) with an 8-value register window
// read as two 8-byte words of bf16.
//
// What bounds them on an H100: the instruction rate, as the int8 rung. The
// hybrid cols pass runs one
// f32 FMA per tap and output (the int8 rung: one __dp4a plus digit
// shuffles), the bf16 rows pass one FMA per tap where the int8 rows run
// two __dp4a per four taps. The f32 rate outside the tensor cores
// (67 TFLOP/s) is the bound the design is held against; bf16 wgmma is later
// work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_bf16.h>
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

// the three bodies: the int8 rung, and the bf16-cols kernel's two rungs
enum Body { kInt8 = 0, kHybrid = 1, kBf16 = 2 };

inline int smem_bytes(int th, int tw, int g, int rh, int rw, int body) {
  int t4w = round4(2 * rw + 1), t4h = round4(2 * rh + 1);
  if (body == kInt8) {
    int taps = 2 * t4w + 2 * t4h;                // int8 tap words, hi and lo
    int digits = 2 * tw * digit_stride(th, rh);  // e1 and e0 planes
    int stage = g * (tw + t4w);                  // staged recentred rows
    return taps + digits + stage;
  }
  // f32 column taps, then the rows taps: int8 words (hybrid) or f32 (bf16)
  int taps = 4 * t4h + (body == kBf16 ? 4 : 2) * t4w;
  int plane = 2 * tw * digit_stride(th, rh);             // bf16 y
  int stage = (body == kBf16 ? 2 : 1) * g * (tw + t4w);  // bf16 or int8 rows
  return taps + plane + stage;
}

// Tall tiles at wide radii amortise the 2rh halo rows of the rows pass;
// narrow tiles at wide row radii keep the digit planes in shared memory.
// The breakpoints are the fastest of nine measured shapes at 4K, r 32..598
// (PERF.md, "Tile policy"). The row tiles are then balanced over the frame: the
// fewest tiles of at most the target height, all of one height.
Geometry pick_geometry(int h, int rh, int rw, int smem_limit, int body) {
  Geometry geo;
  geo.tw = rw <= 100 ? 64 : 32;
  geo.g = kThreads / (geo.tw / 4);
  int target = rh <= 100 ? 256 : (rh <= 400 ? 512 : 1024);
  while (target > 32 &&
         smem_bytes(target, geo.tw, geo.g, rh, rw, body) > smem_limit) {
    target >>= 1;
  }
  const int tiles = (h + target - 1) / target;
  geo.th = round4((h + tiles - 1) / tiles);
  geo.smem = smem_bytes(geo.th, geo.tw, geo.g, rh, rw, body);
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

__device__ __forceinline__ unsigned short to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// eight consecutive bf16 values, two 8-byte words, as f32 (element 0 is the
// low half of a.x)
__device__ __forceinline__ void unpack8(uint2 a, uint2 b, float v[8]) {
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
  v[4] = __uint_as_float(b.x << 16);
  v[5] = __uint_as_float(b.x & 0xffff0000u);
  v[6] = __uint_as_float(b.y << 16);
  v[7] = __uint_as_float(b.y & 0xffff0000u);
}

// acc[s] += t[u] * v[u + s], taps u in ascending order: 4 outputs, 4 taps
__device__ __forceinline__ void fma_window(const float4 t, const float v[8],
                                           float acc[4]) {
  const float tq[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[s] = __fmaf_rn(tq[u], v[u + s], acc[s]);
  }
}

template <bool kBf16Rows, bool kOutU8>
__global__ void __launch_bounds__(kThreads)
fused_blur_bf16cols_kernel(const uint8_t* __restrict__ x, void* __restrict__ out,
                           const int* __restrict__ row_taps,
                           const float* __restrict__ col_taps, int h, int w,
                           int rh, int rw, float scale, int th, int tw, int g,
                           int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t4w = round4(2 * rw + 1), t4h = round4(2 * rh + 1);
  const int nqw = t4w >> 2, nqh = t4h >> 2;  // tap groups of 4 per axis
  const int hp = th + t4h;                   // y rows per tile column
  const int cs = digit_stride(th, rh);       // y column stride (elements)
  const int sw = tw + t4w;                   // staged row width (elements)
  const int rt_words = kBf16Rows ? t4w : 2 * nqw;

  float* s_ct = reinterpret_cast<float*>(smem);  // column taps
  int* s_rt = reinterpret_cast<int*>(s_ct + t4h);  // rows taps
  unsigned short* s_y = reinterpret_cast<unsigned short*>(s_rt + rt_words);
  unsigned char* s_x = reinterpret_cast<unsigned char*>(s_y + tw * cs);

  const int tid = threadIdx.x;
  const int i0 = (blockIdx.x / tiles_w) * th;
  const int j0 = (blockIdx.x % tiles_w) * tw;
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  const uint8_t* xp = x + plane;

  for (int k = tid; k < t4h; k += kThreads) s_ct[k] = col_taps[k];
  for (int k = tid; k < rt_words; k += kThreads) s_rt[k] = row_taps[k];

  // ---- rows pass: halo rows [r0, r0 + g) per group -> bf16 y ----
  const int ngrp = tw >> 2;
  for (int r0 = 0; r0 < hp; r0 += g) {
    const int nr = min(g, hp - r0);
    __syncthreads();  // the previous group is done with s_x
    for (int c = tid; c < sw; c += kThreads) {
      const int gj = reflect101(j0 - rw + c, w);
      for (int rr = 0; rr < nr; ++rr) {
        const int gi = reflect101(i0 - rh + r0 + rr, h);
        const uint8_t v = xp[static_cast<size_t>(gi) * w + gj];
        if (kBf16Rows) {
          reinterpret_cast<unsigned short*>(s_x)[rr * sw + c] =
              to_bf16(static_cast<float>(v));
        } else {
          s_x[rr * sw + c] = v ^ 0x80;
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < nr * ngrp; k += kThreads) {
      const int rr = k / ngrp;
      const int c0 = (k - rr * ngrp) << 2;
      float y[4];
      if (kBf16Rows) {
        const uint2* xw = reinterpret_cast<const uint2*>(
            reinterpret_cast<const unsigned short*>(s_x) + rr * sw + c0);
        const float4* rt = reinterpret_cast<const float4*>(s_rt);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        uint2 cur = xw[0];
        for (int q = 0; q < nqw; ++q) {
          const uint2 nxt = xw[q + 1];
          float v[8];
          unpack8(cur, nxt, v);
          fma_window(rt[q], v, acc);
          cur = nxt;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) y[s] = acc[s];
      } else {
        const int* xw = reinterpret_cast<const int*>(s_x + rr * sw + c0);
        int hi[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
        int cur = xw[0];
        for (int q = 0; q < nqw; ++q) {
          const int nxt = xw[q + 1];
          const int qh = s_rt[q], ql = s_rt[nqw + q];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int v = shifted(cur, nxt, s);
            hi[s] = __dp4a(v, qh, hi[s]);
            lo[s] = __dp4a(v, ql, lo[s]);
          }
          cur = nxt;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) y[s] = __int2float_rn(hi[s] * 128 + lo[s]);
      }
      const int m = r0 + rr;
#pragma unroll
      for (int s = 0; s < 4; ++s) s_y[(c0 + s) * cs + m] = to_bf16(y[s]);
    }
  }
  __syncthreads();

  // ---- cols pass: 4 output rows of one column per item ----
  const float4* ct = reinterpret_cast<const float4*>(s_ct);
  const int nrg = th >> 2;
  for (int k = tid; k < nrg * tw; k += kThreads) {
    const int a = k / tw;
    const int j = k - a * tw;
    const int ii = a << 2;
    const uint2* d = reinterpret_cast<const uint2*>(s_y + j * cs + ii);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint2 cur = d[0];
    for (int q = 0; q < nqh; ++q) {
      const uint2 nxt = d[q + 1];
      float v[8];
      unpack8(cur, nxt, v);
      fma_window(ct[q], v, acc);
      cur = nxt;
    }
    const int gj = j0 + j;
    if (gj >= w) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gi = i0 + ii + s;
      if (gi >= h) break;
      const float y = kBf16Rows ? acc[s] : __fmaf_rn(acc[s], scale, 128.0f);
      const size_t o = plane + static_cast<size_t>(gi) * w + gj;
      if (kOutU8) {
        const float v = fminf(fmaxf(__fadd_rn(y, 0.5f), 0.0f), 255.5f);
        static_cast<uint8_t*>(out)[o] = static_cast<uint8_t>(__float2int_rz(v));
      } else {
        static_cast<float*>(out)[o] = y;
      }
    }
  }
}

int smem_limit(int* limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

}  // namespace

// taps: int32 words [q_hi (nqw) | q_lo (nqw) | b_hi (nqh) | b_lo (nqh)], each
// word four int8 taps, tap 4k + u in byte u, zero-padded to a multiple of 4.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int blur_fused_u8_int8(const void* x, void* out, const void* taps,
                                  int planes, int h, int w, int rh, int rw,
                                  int rows_shift, float c1, float c2, float c3,
                                  void* stream) {
  int limit = 0;
  const int lerr = smem_limit(&limit);
  if (lerr) return lerr;
  const Geometry geo = pick_geometry(h, rh, rw, limit, kInt8);
  if (geo.smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_blur_int8_kernel,
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

// K1's hybrid (bf16_rows = 0) and bf16 (bf16_rows = 1) bodies. row_taps:
// hybrid, int32 words [q_hi (nqw) | q_lo (nqw)] as for the int8 rung; bf16,
// float [t4w], the bf16-rounded row taps. col_taps: float [t4h], the
// bf16-rounded column taps. Both zero-padded to a multiple of 4. out: uint8
// (out_u8 = 1) or float. scale: the hybrid epilogue's 1 / (127 * 2^s).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int blur_fused_u8_bf16cols(const void* x, void* out,
                                      const void* row_taps,
                                      const void* col_taps, int planes, int h,
                                      int w, int rh, int rw, int bf16_rows,
                                      int out_u8, float scale, void* stream) {
  int limit = 0;
  const int lerr = smem_limit(&limit);
  if (lerr) return lerr;
  const Geometry geo = pick_geometry(h, rh, rw, limit, bf16_rows ? kBf16 : kHybrid);
  if (geo.smem > limit || planes > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = bf16_rows
      ? (out_u8 ? fused_blur_bf16cols_kernel<true, true>
                : fused_blur_bf16cols_kernel<true, false>)
      : (out_u8 ? fused_blur_bf16cols_kernel<false, true>
                : fused_blur_bf16cols_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (w + geo.tw - 1) / geo.tw;
  const int tiles_h = (h + geo.th - 1) / geo.th;
  dim3 grid(tiles_w * tiles_h, planes);
  kernel<<<grid, kThreads, geo.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), out, static_cast<const int*>(row_taps),
      static_cast<const float*>(col_taps), h, w, rh, rw, scale, geo.th, geo.tw,
      geo.g, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* blur_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
