// Box blur by prefix sums (K4): `passes` sliding means of width 2r + 1 along
// one axis of uint8 or f32 planes, f32 or uint8 out.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/box_blur_pallas.py:_kernel
// (reached from box_blur_pallas_axis). For each line along the axis, the
// reflect-101-padded line of n + 2 * passes * r values is averaged `passes`
// times by a window of 2r + 1, shrinking by 2r each pass, so that n values
// remain: out[i] = sum_{t <= 2r} in[i + t] / (2r + 1). The TPU kernel scans
// 128-lane chunks with triangular matmuls on the MXU; here there is no
// matrix unit to feed, and the work is a few additions per value.
//
// Two kernels, one per axis layout:
//   * rows (the contiguous axis): one block per (line, tile of outputs).
//     The tile's input span (tile + 2 * passes * r values, reflect-101 by
//     index in the loader) sits in shared memory as f32; each pass computes
//     the exclusive prefix sum P of the span in float64 (a block scan, 256
//     values per round: warp shuffles, then the eight warp totals), and
//     writes (P[i + 2r + 1] - P[i]) * (1 / (2r + 1)) rounded to f32 back
//     over the span.
//   * lines (the column axis, read in place; also the rows of a span too
//     long for shared memory): one thread per line, walking along it with a
//     float64 running window sum (add the entering value, store, subtract
//     the leaving one); neighbouring threads own neighbouring columns, so
//     every load and store of a warp is coalesced. Passes before the last
//     write their f32 line to a scratch buffer the same thread reads back
//     in the next pass (two buffers in turn for three or more passes).
// Every window sum is a difference of float64 prefixes, or a float64
// running sum: exact for integer data, and for f32 data within ~1e-12 of
// the exact sum at any line length, so the f32 prefix drift of long lines
// (sums to ~6e6, where f32 spacing is 0.5) never arises. Each pass rounds
// its mean to f32, as the TPU kernel does; the uint8 store is
// clip(floor(x + 0.5), 0, 255).
//
// What bounds it on an H100: device memory. The work is O(1) per value and
// pass whatever the radius; a uint8 batch moves 1 byte in and 4 out on the
// rows axis, 4 in and 1 out on the columns axis. The rows kernel reads each
// input once (plus the 2 * passes * r halo of a tile when a line is split);
// the lines kernel reads each value twice per pass (entering and leaving,
// the second usually from L2) and writes and re-reads the f32 scratch of
// the passes before the last. Loads go 8 at a time to keep memory busy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // loads in flight per thread in the lines kernel

// reflect-101 source index, exact for -(n-1) <= i <= 2(n-1) (the padding
// is clamped to n - 1 on the host)
__device__ __forceinline__ int reflect101(int i, int n) {
  i = abs(i);
  i = i > n - 1 ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ uint8_t store_u8(float v) {
  v = fminf(fmaxf(floorf(__fadd_rn(v, 0.5f)), 0.0f), 255.0f);
  return static_cast<uint8_t>(__float2int_rz(v));
}

__device__ __forceinline__ float window_mean(double sum, double inv_w) {
  return __double2float_rn(__dmul_rn(sum, inv_w));
}

template <typename Tin, bool kOutU8>
__global__ void __launch_bounds__(kThreads)
box_rows_kernel(const Tin* __restrict__ x, void* __restrict__ out, int n,
                int r, int passes, int pad, int tile, int tiles,
                double inv_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int span_max = tile + 2 * pad;
  double* s_p = reinterpret_cast<double*>(smem);  // span_max + 1 prefixes
  double* s_warp = s_p + span_max + 1;             // warp totals
  float* s_x = reinterpret_cast<float*>(s_warp + kWarps);

  const int line = blockIdx.x / tiles;
  const int o0 = (blockIdx.x - line * tiles) * tile;
  const int nout = min(tile, n - o0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tin* src = x + static_cast<size_t>(line) * n;

  int len = nout + 2 * pad;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    s_x[j] = static_cast<float>(src[reflect101(o0 + j - pad, n)]);
  }
  const int w = 2 * r + 1;
  for (int p = 0; p < passes; ++p) {
    __syncthreads();  // s_x holds this pass's input
    if (threadIdx.x == 0) s_p[0] = 0.0;
    double carry = 0.0;
    for (int base = 0; base < len; base += kThreads) {
      const int j = base + threadIdx.x;
      double v = j < len ? static_cast<double>(s_x[j]) : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v = __dadd_rn(v, t);
      }
      if (lane == 31) s_warp[warp] = v;
      __syncthreads();
      double before = 0.0, total = 0.0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        const double s = s_warp[k];
        if (k < warp) before = __dadd_rn(before, s);
        total = __dadd_rn(total, s);
      }
      if (j < len) s_p[j + 1] = __dadd_rn(carry, __dadd_rn(before, v));
      carry = __dadd_rn(carry, total);
      __syncthreads();  // s_warp is rewritten next round; s_p is complete
    }
    const int m = len - 2 * r;
    for (int i = threadIdx.x; i < m; i += kThreads) {
      s_x[i] = window_mean(__dsub_rn(s_p[i + w], s_p[i]), inv_w);
    }
    len = m;
  }
  __syncthreads();
  const size_t o = static_cast<size_t>(line) * n + o0;
  for (int i = threadIdx.x; i < nout; i += kThreads) {
    if (kOutU8) {
      static_cast<uint8_t*>(out)[o + i] = store_u8(s_x[i]);
    } else {
      static_cast<float*>(out)[o + i] = s_x[i];
    }
  }
}

// Element i of line l of plane q lies at q * plane + l * line + i * elem.
struct Strides {
  long long plane;
  int line, elem;
};

template <typename Tin, bool kOutU8>
__global__ void __launch_bounds__(kThreads)
box_lines_kernel(const Tin* __restrict__ x, void* __restrict__ out,
                 float* __restrict__ scratch0, float* __restrict__ scratch1,
                 int lines_per_plane, int nlines, int n, int r, int passes,
                 int pad, Strides xs, Strides ss, double inv_w) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= nlines) return;
  const int plane = g / lines_per_plane;
  const int l = g - plane * lines_per_plane;
  const size_t xb = plane * xs.plane + static_cast<size_t>(l) * xs.line;
  const size_t sb = plane * ss.plane + static_cast<size_t>(l) * ss.line;
  const int w = 2 * r + 1;
  int len = n + 2 * pad;
  for (int p = 0; p < passes; ++p) {
    const int m = len - 2 * r;
    const bool first = p == 0, last = p == passes - 1;
    const float* in_s = (p & 1) ? scratch0 : scratch1;
    float* out_s = (p & 1) ? scratch1 : scratch0;
    auto in = [&](int j) -> double {
      if (first) {
        return static_cast<double>(
            x[xb + static_cast<size_t>(reflect101(j - pad, n)) * xs.elem]);
      }
      return static_cast<double>(in_s[sb + static_cast<size_t>(j) * ss.elem]);
    };
    auto emit = [&](int i, double sum) {
      const float v = window_mean(sum, inv_w);
      if (!last) {
        out_s[sb + static_cast<size_t>(i) * ss.elem] = v;
      } else if (kOutU8) {
        static_cast<uint8_t*>(out)[xb + static_cast<size_t>(i) * xs.elem] = store_u8(v);
      } else {
        static_cast<float*>(out)[xb + static_cast<size_t>(i) * xs.elem] = v;
      }
    };
    double s = 0.0;
    int t = 0;
    for (; t + kBatch <= w - 1; t += kBatch) {
      double a[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) a[b] = in(t + b);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) s = __dadd_rn(s, a[b]);
    }
    for (; t < w - 1; ++t) s = __dadd_rn(s, in(t));
    int i = 0;
    for (; i + kBatch <= m; i += kBatch) {
      double enter[kBatch], leave[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        enter[b] = in(i + b + w - 1);
        leave[b] = in(i + b);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        s = __dadd_rn(s, enter[b]);
        emit(i + b, s);
        s = __dsub_rn(s, leave[b]);
      }
    }
    for (; i < m; ++i) {
      s = __dadd_rn(s, in(i + w - 1));
      emit(i, s);
      s = __dsub_rn(s, in(i));
    }
    len = m;
  }
}

template <typename Tin, bool kOutU8>
int launch(const void* x, void* out, void* scratch0, void* scratch1,
           int planes, int h, int w, int axis, int r, int passes, int tile,
           int scratch_len, cudaStream_t stream) {
  const int pad = passes * r;
  const double inv_w = 1.0 / static_cast<double>(2 * r + 1);
  if (axis == 1 && tile > 0) {
    const int tiles = (w + tile - 1) / tile;
    const long long blocks = static_cast<long long>(planes) * h * tiles;
    const int span = tile + 2 * pad;
    const int smem = (span + 1 + kWarps) * 8 + span * 4;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = box_rows_kernel<Tin, kOutU8>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const Tin*>(x), out, w, r, passes, pad, tile, tiles, inv_w);
    return static_cast<int>(cudaGetLastError());
  }
  // lines kernel: the column axis (axis 0), or rows too long for a tile
  const bool cols = axis == 0;
  const int n = cols ? h : w;
  const int per_plane = cols ? w : h;
  const Strides xs = cols ? Strides{static_cast<long long>(h) * w, 1, w}
                          : Strides{static_cast<long long>(h) * w, w, 1};
  const Strides ss =
      cols ? Strides{static_cast<long long>(scratch_len) * w, 1, w}
           : Strides{static_cast<long long>(h) * scratch_len, scratch_len, 1};
  const long long nlines = static_cast<long long>(planes) * per_plane;
  if (nlines > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((nlines + kThreads - 1) / kThreads);
  box_lines_kernel<Tin, kOutU8><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), out, static_cast<float*>(scratch0),
      static_cast<float*>(scratch1), per_plane, static_cast<int>(nlines), n,
      r, passes, pad, xs, ss, inv_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: planes x h x w of uint8 (in_u8 = 1) or float; out: the same shape of
// uint8 (out_u8 = 1) or float. axis 1 blurs along w, axis 0 along h; r is
// the clamped per-pass radius (>= 1) and the line is padded by passes * r.
// tile > 0 (axis 1 only) runs the rows kernel with tiles of that many
// outputs; otherwise the lines kernel, whose passes before the last use
// scratch0 / scratch1 (f32, scratch_len values per line; see the wrapper).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int box_scan_axis(const void* x, void* out, void* scratch0,
                             void* scratch1, int in_u8, int out_u8,
                             int planes, int h, int w, int axis, int r,
                             int passes, int tile, int scratch_len,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_u8) {
    return out_u8 ? launch<uint8_t, true>(x, out, scratch0, scratch1, planes, h,
                                          w, axis, r, passes, tile, scratch_len, st)
                  : launch<uint8_t, false>(x, out, scratch0, scratch1, planes,
                                           h, w, axis, r, passes, tile,
                                           scratch_len, st);
  }
  return out_u8 ? launch<float, true>(x, out, scratch0, scratch1, planes, h, w,
                                      axis, r, passes, tile, scratch_len, st)
                : launch<float, false>(x, out, scratch0, scratch1, planes, h,
                                       w, axis, r, passes, tile, scratch_len, st);
}
