// The int8 forms of the two-pass wide-radius split: a rows-only pass over
// uint8 planes and a cols-only pass over its int16 intermediate E.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_blur.py:_kernel_int8
// in its split forms: skip_cols with out_e32 (pass 1, int16 E out), skip_cols
// without it (pass 1, f32 R / Sr + 128 out, where pass 2 cannot run int8),
// and in_e32 (pass 2, E in, uint8 or f32 out). The JAX kernel contracts
// each window with int8 band matrices on the MXU; every column of a
// quantised band matrix holds the same integer taps, shifted, so the band
// dots are 1-D correlations with the taps q = 128 * q_hi + q_lo, as in K1
// (csrc/fused_dma.cu), and these kernels compute the same exact integers:
//
//   rows:  R = sum_t q[t] * (x[j - rw + t] - 128), exact in int32 as
//          128 * (q_hi dots) + (q_lo dots) with __dp4a;
//          E = (R + 2^(s-1)) >> s (an arithmetic shift, written out), int16,
//          or fma(f32(R), f32(1 / Sr), 128) in f32 (one rounding, as XLA
//          contracts the JAX kernel's R * (1 / Sr) + 128);
//   cols:  E = 128 * e1 + e0 with e1 = (E + 64) >> 7; p1 = sum b_hi * e1,
//          p23 = sum b_hi * e0 + b_lo * e1, p4 = sum b_lo * e0 with __dp4a
//          on four consecutive rows of a digit column; then K1's epilogue
//          p1 * c1 + p23 * c2 + p4 * c3 + 128 (int8_epilogue: for the
//          uint8 store each product and sum rounded on its own, and the
//          store clip(y + 0.5, 0, 255.5) truncated; for the f32 store
//          fma(p4, c3, fma(p23, c2, p1 * c1)) + 128, as XLA compiles the
//          JAX expression in interpret mode on an FMA host; --fmad=false
//          keeps nvcc from contracting anything else).
// The result is bit-equal to the JAX kernel's and to the plain versions
// (cuda_kernels/fused_split.py). Reflect-101 is index math in the loaders
// (the JAX wrapper pads E by reflect before pass 2). Both cols passes also
// take E with the caller's halo rows (pre = 1: the JAX e32="in" with
// pre_padded_col=True, fused_blur.py:1080-1084, the sharded path's haloed
// split): h + 2rh rows a plane, read as they are, never reflected.
//
// The hybrid pass 2 (fused_split_cols_hybrid) replaces the same kernel's
// hybrid_cols branch (fused_blur.py:282-298, epilogue :339-340): E rounded
// once, y = bf16(f32(E)), acc = sum_t bf16(c_t) * y[t] in f32 in ascending
// tap order (one __fmaf_rn a tap; a bf16 product is exact in f32), out =
// fma(acc, f32(1 / 127), 128). It is bit-equal to its plain version; the
// JAX kernel sums one partial product per neighbour block and then adds the
// blocks, so it agrees with that to a couple of f32 ulps.
//
// Layout. Rows: one block of 256 threads per 4 rows x 256 columns; the four
// reflect-101 row segments of 256 + 2rw bytes sit in shared memory recentred
// to int8, each thread computes 4 adjacent outputs of one row. Cols: one
// block per 128 rows x 32 columns; the column taps run in chunks of 128, and
// each chunk stages the 128 + 128 + 4 rows it needs as base-128 digit planes
// in shared memory (column-major, an odd number of words per column so that
// a warp's 32 columns hit 32 banks); each thread keeps 4 groups of 4 rows of
// one column, 48 int32 sums in registers, across the chunks. Shared memory
// stays ~34 KB (cols) and <= 51 KB (rows) up to r 4096. The hybrid cols
// pass has the int8 cols pass's blocks, chunks and staging, with one bf16
// plane in place of the two digit planes and f32 taps (~50 KB at r 4096);
// each thread keeps 16 f32 sums and runs an 8-value register window read
// as two 8-byte words.
//
// What bounds it on an H100: integer issue, as K1. Per output the rows pass
// costs (2rw + 1) / 2 dp4a and the cols pass (2rh + 1) dp4a, against 1 byte
// in, 2 + 2 bytes of E and 1 byte out in device memory. The split trades K1's
// recomputed halo rows (a (th + 2rh) / th factor on the rows pass) for the
// round trip of E; the cols chunks re-read E from L2 about
// 2 (2rh + 1) / 128 times per output. Tensor-core int8 mma is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsTw = 256;  // rows pass: output columns per block
constexpr int kRowsG = 4;     // rows pass: rows per block
constexpr int kColsTh = 128;  // cols pass: output rows per block
constexpr int kColsTw = 32;   // cols pass: output columns per block
constexpr int kChunk = 128;   // cols pass: taps per staged chunk
constexpr int kGroups = kColsTh / 4 / (kThreads / kColsTw);  // row groups per thread

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// staged digit rows per column: chunk + tile + 4, an odd number of words
__host__ __device__ inline int cols_stride() {
  const int hp = kColsTh + kChunk + 4;
  return ((hp >> 2) & 1) ? hp : hp + 4;
}

__device__ __forceinline__ int reflect101(int i, int n) {
  i = abs(i);
  i = i > n - 1 ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// The input row that halo row i (output row i + rh's window start, -rh <=
// i) reads in a cols pass: reflect-101 into the h rows, or, with the
// caller's halo rows (pre_padded_col: xh = h + 2rh rows), row i + rh as it
// is (clamped past the last row, which only the zero padding taps reach).
__device__ __forceinline__ int src_row(int i, int h, int rh, int xh, int pre) {
  return pre ? min(i + rh, xh - 1) : reflect101(i, h);
}

// K1's int8 epilogue p1*c1 + p23*c2 + p4*c3 + 128 (the JAX _cols_int8
// expression), as in csrc/fused_dma.cu: kOutU8 rounds each product and sum
// on its own; the f32 store contracts two multiply-adds, as XLA compiles
// the expression on an FMA host.
template <bool kOutU8>
__device__ __forceinline__ float int8_epilogue(int p1, int p23, int p4, float c1, float c2,
                                               float c3) {
  float y;
  if (kOutU8) {
    y = __fadd_rn(__fmul_rn(__int2float_rn(p1), c1), __fmul_rn(__int2float_rn(p23), c2));
    y = __fadd_rn(y, __fmul_rn(__int2float_rn(p4), c3));
  } else {
    y = __fmaf_rn(__int2float_rn(p23), c2, __fmul_rn(__int2float_rn(p1), c1));
    y = __fmaf_rn(__int2float_rn(p4), c3, y);
  }
  return __fadd_rn(y, 128.0f);
}

// floor(v / 2^s): an arithmetic right shift, spelled out for negative v
__device__ __forceinline__ int asr(int v, int s) {
  return v >= 0 ? (v >> s) : ~((~v) >> s);
}

__device__ __forceinline__ int shifted(int lo, int hi, int k) {
  return __byte_perm(lo, hi, 0x3210 + 0x1111 * k);
}

__global__ void __launch_bounds__(kThreads)
split_rows_int8_kernel(const uint8_t* __restrict__ x, void* __restrict__ out,
                       const int* __restrict__ taps, int h, int w, int rw,
                       int out_e32, int rows_shift, float inv_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t4w = round4(2 * rw + 1), nqw = t4w >> 2;
  const int sw = kRowsTw + t4w;
  int* s_taps = reinterpret_cast<int*>(smem);  // q_hi | q_lo words
  signed char* s_x = reinterpret_cast<signed char*>(s_taps + 2 * nqw);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kRowsTw, i0 = blockIdx.y * kRowsG;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const uint8_t* xp = x + plane;

  for (int k = tid; k < 2 * nqw; k += kThreads) s_taps[k] = taps[k];
  for (int c = tid; c < sw; c += kThreads) {
    const int gj = reflect101(j0 - rw + c, w);
    for (int rr = 0; rr < kRowsG; ++rr) {
      const int gi = min(i0 + rr, h - 1);
      s_x[rr * sw + c] =
          static_cast<signed char>(xp[static_cast<size_t>(gi) * w + gj] ^ 0x80);
    }
  }
  __syncthreads();

  const int rr = tid / (kRowsTw / 4);
  const int c0 = (tid % (kRowsTw / 4)) << 2;
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
  const int gi = i0 + rr;
  if (gi >= h) return;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int gj = j0 + c0 + s;
    if (gj >= w) break;
    const int r = hi[s] * 128 + lo[s];
    const size_t o = plane + static_cast<size_t>(gi) * w + gj;
    if (out_e32) {
      static_cast<int16_t*>(out)[o] =
          static_cast<int16_t>(asr(r + (1 << (rows_shift - 1)), rows_shift));
    } else {
      static_cast<float*>(out)[o] =
          __fmaf_rn(__int2float_rn(r), inv_scale, 128.0f);
    }
  }
}

template <bool kOutU8>
__global__ void __launch_bounds__(kThreads)
split_cols_int8_kernel(const int16_t* __restrict__ e, void* __restrict__ out,
                       const int* __restrict__ taps, int h, int w, int rh,
                       int pre, float c1, float c2, float c3) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t4h = round4(2 * rh + 1), nqh = t4h >> 2;
  const int cs = cols_stride();
  int* s_taps = reinterpret_cast<int*>(smem);  // b_hi | b_lo words
  signed char* s_d1 = reinterpret_cast<signed char*>(s_taps + 2 * nqh);
  signed char* s_d0 = s_d1 + kColsTw * cs;
  const int tid = threadIdx.x;
  const int tiles_w = (w + kColsTw - 1) / kColsTw;
  const int i0 = (blockIdx.x / tiles_w) * kColsTh;
  const int j0 = (blockIdx.x % tiles_w) * kColsTw;
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  const int xh = pre ? h + 2 * rh : h;  // rows of an input plane
  const int16_t* ep = e + static_cast<size_t>(blockIdx.y) * xh * w;

  for (int k = tid; k < 2 * nqh; k += kThreads) s_taps[k] = taps[k];
  const int j = tid % kColsTw;       // this thread's column
  const int a = tid / kColsTw;       // its first row group
  int p1[kGroups][4], p23[kGroups][4], p4[kGroups][4];
#pragma unroll
  for (int m = 0; m < kGroups; ++m) {
#pragma unroll
    for (int s = 0; s < 4; ++s) p1[m][s] = p23[m][s] = p4[m][s] = 0;
  }
  const int gjl = min(j0 + j, w - 1);  // staging column of this lane
  const int rows = kColsTh + kChunk + 4;
  for (int k0 = 0; k0 < t4h; k0 += kChunk) {
    __syncthreads();  // the previous chunk is done with the digit planes
    for (int rr = a; rr < rows; rr += kThreads / kColsTw) {
      const int gi = src_row(i0 - rh + k0 + rr, h, rh, xh, pre);
      const int v = ep[static_cast<size_t>(gi) * w + gjl];
      const int e1 = asr(v + 64, 7);
      s_d1[j * cs + rr] = static_cast<signed char>(e1);
      s_d0[j * cs + rr] = static_cast<signed char>(v - e1 * 128);
    }
    __syncthreads();
    const int nq = min(kChunk, t4h - k0) >> 2;
    const int* bhi = s_taps + (k0 >> 2);
    const int* blo = s_taps + nqh + (k0 >> 2);
#pragma unroll
    for (int m = 0; m < kGroups; ++m) {
      const int ii = (a + m * (kThreads / kColsTw)) << 2;
      const int* d1 = reinterpret_cast<const int*>(s_d1 + j * cs + ii);
      const int* d0 = reinterpret_cast<const int*>(s_d0 + j * cs + ii);
      int cur1 = d1[0], cur0 = d0[0];
      for (int q = 0; q < nq; ++q) {
        const int nxt1 = d1[q + 1], nxt0 = d0[q + 1];
        const int bh = bhi[q], bl = blo[q];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int e1 = shifted(cur1, nxt1, s);
          const int e0 = shifted(cur0, nxt0, s);
          p1[m][s] = __dp4a(e1, bh, p1[m][s]);
          p23[m][s] = __dp4a(e1, bl, __dp4a(e0, bh, p23[m][s]));
          p4[m][s] = __dp4a(e0, bl, p4[m][s]);
        }
        cur1 = nxt1;
        cur0 = nxt0;
      }
    }
  }
  const int gj = j0 + j;
  if (gj >= w) return;
#pragma unroll
  for (int m = 0; m < kGroups; ++m) {
    const int ii = (a + m * (kThreads / kColsTw)) << 2;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gi = i0 + ii + s;
      if (gi >= h) break;
      const float y = int8_epilogue<kOutU8>(p1[m][s], p23[m][s], p4[m][s], c1, c2, c3);
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

// eight consecutive bf16 values, two 8-byte words, as f32
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

template <bool kOutU8>
__global__ void __launch_bounds__(kThreads)
split_cols_hybrid_kernel(const int16_t* __restrict__ e, void* __restrict__ out,
                         const float* __restrict__ taps, int h, int w, int rh,
                         int pre, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t4h = round4(2 * rh + 1);
  const int cs = cols_stride();
  float* s_taps = reinterpret_cast<float*>(smem);  // bf16-rounded column taps
  unsigned short* s_y = reinterpret_cast<unsigned short*>(s_taps + t4h);
  const int tid = threadIdx.x;
  const int tiles_w = (w + kColsTw - 1) / kColsTw;
  const int i0 = (blockIdx.x / tiles_w) * kColsTh;
  const int j0 = (blockIdx.x % tiles_w) * kColsTw;
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  const int xh = pre ? h + 2 * rh : h;  // rows of an input plane
  const int16_t* ep = e + static_cast<size_t>(blockIdx.y) * xh * w;

  for (int k = tid; k < t4h; k += kThreads) s_taps[k] = taps[k];
  const int j = tid % kColsTw;  // this thread's column
  const int a = tid / kColsTw;  // its first row group
  float acc[kGroups][4];
#pragma unroll
  for (int m = 0; m < kGroups; ++m) {
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[m][s] = 0.0f;
  }
  const int gjl = min(j0 + j, w - 1);  // staging column of this lane
  const int rows = kColsTh + kChunk + 4;
  for (int k0 = 0; k0 < t4h; k0 += kChunk) {
    __syncthreads();  // the previous chunk is done with the y plane
    for (int rr = a; rr < rows; rr += kThreads / kColsTw) {
      const int gi = src_row(i0 - rh + k0 + rr, h, rh, xh, pre);
      const float v = static_cast<float>(ep[static_cast<size_t>(gi) * w + gjl]);
      s_y[j * cs + rr] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
    __syncthreads();
    const int nq = min(kChunk, t4h - k0) >> 2;
    const float4* ct = reinterpret_cast<const float4*>(s_taps + k0);
#pragma unroll
    for (int m = 0; m < kGroups; ++m) {
      const int ii = (a + m * (kThreads / kColsTw)) << 2;
      const uint2* d = reinterpret_cast<const uint2*>(s_y + j * cs + ii);
      uint2 cur = d[0];
      for (int q = 0; q < nq; ++q) {
        const uint2 nxt = d[q + 1];
        float v[8];
        unpack8(cur, nxt, v);
        const float4 t = ct[q];
        const float tq[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            acc[m][s] = __fmaf_rn(tq[u], v[u + s], acc[m][s]);
          }
        }
        cur = nxt;
      }
    }
  }
  const int gj = j0 + j;
  if (gj >= w) return;
#pragma unroll
  for (int m = 0; m < kGroups; ++m) {
    const int ii = (a + m * (kThreads / kColsTw)) << 2;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gi = i0 + ii + s;
      if (gi >= h) break;
      const float y = __fmaf_rn(acc[m][s], scale, 128.0f);
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

// x: planes x h x w uint8; out: the same shape of int16 E (out_e32 = 1) or
// float (fma(R, inv_scale, 128)). taps: int32 words [q_hi | q_lo], four int8
// taps a word, zero-padded to a multiple of 4. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int fused_split_rows_int8(const void* x, void* out, const void* taps,
                                     int planes, int h, int w, int rw,
                                     int out_e32, int rows_shift,
                                     float inv_scale, void* stream) {
  int limit = 0;
  int err = smem_limit(&limit);
  if (err) return err;
  const int t4w = round4(2 * rw + 1);
  const int smem = 2 * t4w + kRowsG * (kRowsTw + t4w);
  if (smem > limit || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t cerr = cudaFuncSetAttribute(
      split_rows_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  dim3 grid((w + kRowsTw - 1) / kRowsTw, (h + kRowsG - 1) / kRowsG, planes);
  split_rows_int8_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), out, static_cast<const int*>(taps), h, w,
      rw, out_e32, rows_shift, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

// e: planes x h x w int16 E, or planes x (h + 2rh) x w with the caller's
// halo rows (pre = 1, pre_padded_col: rows read as they are); out: planes x
// h x w uint8 (out_u8 = 1) or float. taps: int32 words [b_hi | b_lo] as
// above. Returns the cudaError_t of the launch.
extern "C" int fused_split_cols_int8(const void* e, void* out, const void* taps,
                                     int planes, int h, int w, int rh,
                                     int out_u8, int pre, float c1, float c2,
                                     float c3, void* stream) {
  int limit = 0;
  int err = smem_limit(&limit);
  if (err) return err;
  const int t4h = round4(2 * rh + 1);
  const int smem = 2 * t4h + 2 * kColsTw * cols_stride();
  if (smem > limit || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((w + kColsTw - 1) / kColsTw) * ((h + kColsTh - 1) / kColsTh);
  dim3 grid(tiles, planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = out_u8 ? split_cols_int8_kernel<true> : split_cols_int8_kernel<false>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const int16_t*>(e), out,
                                       static_cast<const int*>(taps), h, w, rh,
                                       pre, c1, c2, c3);
  return static_cast<int>(cudaGetLastError());
}

// The hybrid pass 2. e: planes x h x w int16 E, or planes x (h + 2rh) x w
// (pre = 1, as above); out: planes x h x w uint8 (out_u8 = 1) or float. taps: float [t4h], the bf16-rounded column taps zero-padded to a
// multiple of 4; scale: f32(1 / 127). Returns the cudaError_t of the launch.
extern "C" int fused_split_cols_hybrid(const void* e, void* out, const void* taps,
                                       int planes, int h, int w, int rh,
                                       int out_u8, int pre, float scale,
                                       void* stream) {
  int limit = 0;
  int err = smem_limit(&limit);
  if (err) return err;
  const int t4h = round4(2 * rh + 1);
  const int smem = 4 * t4h + 2 * kColsTw * cols_stride();
  if (smem > limit || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((w + kColsTw - 1) / kColsTw) * ((h + kColsTh - 1) / kColsTh);
  dim3 grid(tiles, planes);
  auto kernel = out_u8 ? split_cols_hybrid_kernel<true> : split_cols_hybrid_kernel<false>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(e), out, static_cast<const float*>(taps), h, w,
      rh, pre, scale);
  return static_cast<int>(cudaGetLastError());
}
