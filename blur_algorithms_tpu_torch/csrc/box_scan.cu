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
// Two kernels, one per axis layout; both keep enough independent work in
// flight to run at the card's memory rate, not at the latency of a chain:
//   * rows (the contiguous axis): one block per (line, tile of outputs). The
//     tile's input span (tile + 2 * passes * r values, reflect-101 by index,
//     at most 256 * 63) is staged through shared memory into registers: each
//     thread owns a contiguous run of ceil(span / 256) values, made odd so
//     that a warp's float64 accesses at that stride fall on distinct banks
//     (kRun = 7, 15, 23, 31 or 63 by the span). A pass is a serial sum over
//     the run, one block-wide exclusive scan of the 256 run totals (warp
//     shuffles, then the eight warp totals), the run's prefixes P into one
//     array in shared memory (the only one: 8 bytes a value), and the window
//     means (P[i + 2r + 1] - P[i]) * (1 / (2r + 1)) rounded to f32 back into
//     the run's registers: two barriers a pass. Over uint8 the first pass
//     sums in int32 (the same integers; conversions to and from float64 run
//     at a quarter of the float64 rate, so the pass converts only its
//     means), the others in float64: 0.605 ms against 0.637 for float64
//     throughout on 12 planes of 2160 x 3840 at support 800, 0.055 against
//     0.059 on 3 of 1080 x 1920 (NVIDIA H100 80GB HBM3, 700 W, the two
//     bodies in turns by probes/k4_variants.py). The outputs leave through
//     shared memory in coalesced rows.
//   * lines (the column axis, read in place; also the rows of a span longer
//     than 256 * 63): a block of 32 warps walks strips of 16 neighbouring
//     lines (16 lanes of a warp on two 32-byte sectors of f32 a step) and
//     all their passes, a persistent grid of one block an SM, so that the
//     strips in flight (16 x (n + 2 passes r) values each and their f32
//     scratch, ~57 MB at the headline shape) mostly stay in L2 while a
//     block reads them again. Each pass cuts the line's outputs into
//     segments of `seg` values (line_segment), 64 at once a block (two a warp), about one
//     round in the first pass. A
//     segment's first window sum comes from the segment totals of the
//     pass's input, kept in shared memory: the window [kS, kS + 2r + 1) is
//     the totals of segments k .. ub - 1 less the few values past its end
//     (or the totals to ub - 2 plus the values of the last segment it
//     reaches), and seg = ceil((2r + 1) / q) leaves fewer than q of those.
//     From there a float64 running sum walks the segment, 8 values entering
//     and 8 leaving in flight a thread; the values a segment sees leaving
//     are those segment k + q sees entering a few steps earlier, so the
//     second read usually hits L1. A pass writes its outputs' segment
//     totals for the next pass as it emits them (the first pass's are
//     read), and a pass before the last writes its f32 line to a scratch
//     buffer; the block synchronises before the next pass reads either (two
//     buffers in turn for three or more passes). Strips of 8 or 32 lines,
//     8 or 16 warps a block, or two to four blocks an SM ran 7-70% slower
//     at the headline shape.
// Every window sum is a difference of float64 prefixes, or a float64 sum of
// segment totals and a float64 running sum: exact for integer data (the
// first pass over uint8), and for f32 data within ~1e-12 of the exact sum at
// any line length, so the f32 prefix drift of long lines (sums to ~6e6,
// where f32 spacing is 0.5) never arises. Each pass rounds its mean to f32,
// as the TPU kernel does; the uint8 store is clip(floor(x + 0.5), 0, 255).
//
// What bounds it on an H100: device memory. The work is O(1) per value and
// pass whatever the radius; a uint8 batch moves 1 byte in and 4 out on the
// rows axis, 4 in and 1 out on the columns axis (0.149 ms an axis for 12
// planes of 2160 x 3840 at 3.35 TB/s). The rows kernel reads each input once
// (plus the 2 * passes * r halo of a tile when a line is split); the lines
// kernel reads its first pass's input twice (the segment totals, then the
// running sums; the second read from L2) and writes and re-reads the f32
// scratch of the passes before the last. Conversions between f32 and float64
// run at a quarter of the float64 rate (16 a cycle an SM): the lines kernel
// does four a value and pass, which bounds it near 0.3 ms an axis at the
// headline shape.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the lines kernel: a block of 32 warps takes strips of kLineCols lines (64
// bytes of f32 a step: two sectors), two segments a warp in flight, 64 a
// block; a persistent grid of one block an SM keeps the strips it walks
// (kLineCols x (n + 2 passes r) values and their scratch) mostly in L2
constexpr int kLineCols = 16;
constexpr int kLineWarps = 32;
constexpr int kLineThreads = 32 * kLineWarps;
constexpr int kLineSegs = kLineWarps * 32 / kLineCols;
// two sets of float64 totals of up to kLineMaxSegs segments a line for the
// strip's lines fill the default 48 KB of shared memory
constexpr int kLineMaxSegs = 48 * 1024 / (2 * kLineCols * 8);
constexpr int kLineBlocksPerSm = 1;
constexpr int kLineBatch = 8;  // window steps loaded at once

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

// exact int -> double for 0 <= v < 2^31 (an or and a subtraction, not a
// conversion: those run at a quarter of the float64 rate)
__device__ __forceinline__ double int_to_double(int v) {
  return __dsub_rn(__hiloint2double(0x43300000, v), 4503599627370496.0);
}

// One block per (line, tile): the span in registers as runs of `run` values
// a thread (run odd, so that a warp's float64 accesses at stride run fall on
// distinct banks). Over uint8 the first pass runs in int32 (every sum an
// integer below 2^31: the same bits as float64), the others in float64.
template <typename Tin, bool kOutU8, int kRun>
__global__ void __launch_bounds__(kThreads, kRun <= 31 ? 3 : 1)
box_rows_kernel(const Tin* __restrict__ x, void* __restrict__ out, int n,
                int r, int passes, int pad, int tile, int tiles,
                double inv_w) {
  constexpr bool kInt = sizeof(Tin) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int span_max = tile + 2 * pad;
  double* s_p = reinterpret_cast<double*>(smem);  // span_max + 1 prefixes
  int* s_pi = reinterpret_cast<int*>(smem);       // ... as int32 in an int pass
  double* s_warp = s_p + span_max + 1;             // warp totals
  float* s_x = reinterpret_cast<float*>(smem);     // the span, then the outputs (over s_p)

  const int line = blockIdx.x / tiles;
  const int o0 = (blockIdx.x - line * tiles) * tile;
  const int nout = min(tile, n - o0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tin* src = x + static_cast<size_t>(line) * n;

  int len = nout + 2 * pad;
#pragma unroll 8
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const Tin v = src[reflect101(o0 + j - pad, n)];
    s_x[j] = kInt ? __int_as_float(static_cast<int>(v)) : static_cast<float>(v);
  }
  __syncthreads();
  // this thread's run: span values [a, a + run)
  const int run = ((len + kThreads - 1) / kThreads) | 1;
  const int a = threadIdx.x * run;
  float v[kRun];  // the run's values (int bits in an int pass)
#pragma unroll
  for (int k = 0; k < kRun; ++k) v[k] = (k < run && a + k < len) ? s_x[a + k] : 0.0f;
  const int w = 2 * r + 1;
  for (int p = 0; p < passes; ++p) {
    const bool ip = kInt && p == 0;
    const int m = len - 2 * r;
    // the run's total and its exclusive prefix over the block (warp
    // shuffles, then the warp totals)
    if (ip) {
      int tot = 0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) tot += k < run ? __float_as_int(v[k]) : 0;
      int inc = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      if (lane == 31) reinterpret_cast<int*>(s_warp)[warp] = inc;
      __syncthreads();  // the warp totals; every thread is done with s_x
      int q = inc - tot;
      for (int k = 0; k < warp; ++k) q += reinterpret_cast<int*>(s_warp)[k];
      if (threadIdx.x == 0) s_pi[0] = 0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (k < run && a + k < len) {
          q += __float_as_int(v[k]);
          s_pi[a + k + 1] = q;
        }
      }
      __syncthreads();  // s_pi is complete
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (k < run) {
          const int i = a + k;
          v[k] = i < m ? window_mean(int_to_double(s_pi[i + w] - s_pi[i]), inv_w) : 0.0f;
        }
      }
    } else {
      double tot = 0.0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (k < run) tot = __dadd_rn(tot, static_cast<double>(v[k]));
      }
      double inc = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc = __dadd_rn(inc, t);
      }
      double exc = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) exc = 0.0;
      if (lane == 31) s_warp[warp] = inc;
      __syncthreads();  // the warp totals; every thread is done with s_x / the last s_p
      double before = 0.0;
      for (int k = 0; k < warp; ++k) before = __dadd_rn(before, s_warp[k]);
      double q = __dadd_rn(before, exc);
      if (threadIdx.x == 0) s_p[0] = 0.0;
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (k < run && a + k < len) {
          q = __dadd_rn(q, static_cast<double>(v[k]));
          s_p[a + k + 1] = q;
        }
      }
      __syncthreads();  // s_p is complete
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        if (k < run) {
          const int i = a + k;
          v[k] = i < m ? window_mean(__dsub_rn(s_p[i + w], s_p[i]), inv_w) : 0.0f;
        }
      }
    }
    len = m;
  }
  __syncthreads();  // every thread is done with s_p: stage the outputs
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (k < run && a + k < nout) s_x[a + k] = v[k];
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
__global__ void __launch_bounds__(kLineThreads)
box_lines_kernel(const Tin* __restrict__ x, void* __restrict__ out,
                 float* __restrict__ scratch0, float* __restrict__ scratch1,
                 int lines_per_plane, int nlines, int n, int r, int passes,
                 int pad, Strides xs, Strides ss, double inv_w, int seg,
                 int nseg_max) {
  extern __shared__ __align__(16) double s_tot[];  // [2][nseg_max][kLineCols] segment totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = lane % kLineCols;                        // this lane's line of the strip
  const int slot = warp * (32 / kLineCols) + lane / kLineCols;  // its segment of a round
  const int w = 2 * r + 1;
  const int nstrips = (nlines + kLineCols - 1) / kLineCols;
  for (int strip = blockIdx.x; strip < nstrips; strip += gridDim.x) {
    const int g = strip * kLineCols + col;
    const bool live = g < nlines;  // the lanes past the last line walk it and store nothing
    const int gl = live ? g : nlines - 1;
    const int plane = gl / lines_per_plane;
    const int l = gl - plane * lines_per_plane;
    const size_t xb = plane * xs.plane + static_cast<size_t>(l) * xs.line;
    const size_t sb = plane * ss.plane + static_cast<size_t>(l) * ss.line;
    double* tot = s_tot;
    double* next = s_tot + nseg_max * kLineCols;
    int len = n + 2 * pad;
    __syncthreads();  // the last strip is done with the totals
    {  // the first pass's segment totals, read from the reflect-101 line
      const int nseg = (len + seg - 1) / seg;
      for (int u = slot; u < nseg; u += kLineSegs) {
        const int t1 = min(u * seg + seg, len);
        double s = 0.0;
        for (int t = u * seg; t < t1; t += kLineBatch) {
          float vals[kLineBatch];
#pragma unroll
          for (int b = 0; b < kLineBatch; ++b) {
            vals[b] = t + b < t1 ? static_cast<float>(x[xb + static_cast<size_t>(
                                                          reflect101(t + b - pad, n)) * xs.elem])
                                 : 0.0f;
          }
#pragma unroll
          for (int b = 0; b < kLineBatch; ++b) s = __dadd_rn(s, static_cast<double>(vals[b]));
        }
        tot[u * kLineCols + col] = s;
      }
    }
    for (int p = 0; p < passes; ++p) {
      __syncthreads();  // this pass's totals and input scratch are complete
      const int m = len - 2 * r;
      const bool first = p == 0, last = p == passes - 1;
      const float* in_s = (p & 1) ? scratch0 : scratch1;
      float* out_s = (p & 1) ? scratch1 : scratch0;
      auto in = [&](int j) -> float {
        if (first) {
          return static_cast<float>(x[xb + static_cast<size_t>(reflect101(j - pad, n)) * xs.elem]);
        }
        return in_s[sb + static_cast<size_t>(j) * ss.elem];
      };
      const int nout = (m + seg - 1) / seg;
      for (int k = slot; k < nout; k += kLineSegs) {
        const int start = k * seg, stop = min(start + seg, m);
        // the window sum at start: segment totals k .. ub - 1 less the values
        // [end, top), or totals k .. ub - 2 plus the values [(ub - 1) seg, end)
        const int end = start + w, ub = (end + seg - 1) / seg, top = min(ub * seg, len);
        const bool cut = top - end <= end - (ub - 1) * seg;
        double wsum = 0.0, part = 0.0;
        for (int u = k; u < (cut ? ub : ub - 1); ++u) {
          wsum = __dadd_rn(wsum, tot[u * kLineCols + col]);
        }
        for (int t = cut ? end : (ub - 1) * seg; t < (cut ? top : end); ++t) {
          part = __dadd_rn(part, static_cast<double>(in(t)));
        }
        wsum = cut ? __dsub_rn(wsum, part) : __dadd_rn(wsum, part);
        double nt = 0.0;  // the next pass's total of this segment
        for (int i = start; i < stop; i += kLineBatch) {
          float enter[kLineBatch], leave[kLineBatch];
#pragma unroll
          for (int b = 0; b < kLineBatch; ++b) {
            const int j = min(i + b, stop - 1);
            enter[b] = in(min(j + w, len - 1));
            leave[b] = in(j);
          }
#pragma unroll
          for (int b = 0; b < kLineBatch; ++b) {
            if (i + b < stop) {
              const float v = window_mean(wsum, inv_w);
              const size_t oi = static_cast<size_t>(i + b);
              if (!last) {
                nt = __dadd_rn(nt, static_cast<double>(v));
                if (live) out_s[sb + oi * ss.elem] = v;
              } else if (live && kOutU8) {
                static_cast<uint8_t*>(out)[xb + oi * xs.elem] = store_u8(v);
              } else if (live) {
                static_cast<float*>(out)[xb + oi * xs.elem] = v;
              }
              wsum = __dsub_rn(__dadd_rn(wsum, static_cast<double>(enter[b])),
                               static_cast<double>(leave[b]));
            }
          }
        }
        if (!last) next[k * kLineCols + col] = nt;
      }
      double* t = tot;
      tot = next;
      next = t;
      len = m;
    }
  }
}

template <typename Tin, bool kOutU8, int kRun>
int launch_rows(const void* x, void* out, int planes, int h, int w, int r,
                int passes, int pad, int tile, double inv_w, cudaStream_t stream) {
  const int tiles = (w + tile - 1) / tile;
  const long long blocks = static_cast<long long>(planes) * h * tiles;
  const int span = tile + 2 * pad;
  const int smem = (span + 1 + kWarps) * 8;
  if (blocks > 0x7fffffffLL || ((span + kThreads - 1) / kThreads | 1) > kRun) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = box_rows_kernel<Tin, kOutU8, kRun>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const Tin*>(x), out, w, r, passes, pad, tile, tiles, inv_w);
  return static_cast<int>(cudaGetLastError());
}

// Outputs per segment of the lines kernel for lines of n values at per-pass
// radius r: about one round of the block's kLineSegs segments in the first
// pass, ceil((2r + 1) / q) where the window spans q of them (a segment's
// first window sum is then q segment totals less fewer than q values), and
// no more than kLineMaxSegs segments a line. Mirrored for the CPU model by
// cuda_kernels/box_blur.py:_line_segment.
int line_segment(int n, int r, int passes) {
  const int span = n + 2 * passes * r;
  const int target = std::max(32, (span - 2 * r + kLineSegs - 1) / kLineSegs);
  const int w = 2 * r + 1;
  const int seg = w >= target ? (w + w / target - 1) / (w / target) : target;
  return std::max(seg, (span + kLineMaxSegs - 1) / kLineMaxSegs);
}

template <typename Tin, bool kOutU8>
int launch(const void* x, void* out, void* scratch0, void* scratch1,
           int planes, int h, int w, int axis, int r, int passes, int tile,
           int scratch_len, cudaStream_t stream) {
  const int pad = passes * r;
  const double inv_w = 1.0 / static_cast<double>(2 * r + 1);
  if (axis == 1 && tile > 0) {
    const int run = ((tile + 2 * pad + kThreads - 1) / kThreads) | 1;
    if (run <= 7) {
      return launch_rows<Tin, kOutU8, 7>(x, out, planes, h, w, r, passes, pad, tile, inv_w, stream);
    }
    if (run <= 15) {
      return launch_rows<Tin, kOutU8, 15>(x, out, planes, h, w, r, passes, pad, tile, inv_w, stream);
    }
    if (run <= 23) {
      return launch_rows<Tin, kOutU8, 23>(x, out, planes, h, w, r, passes, pad, tile, inv_w, stream);
    }
    if (run <= 31) {
      return launch_rows<Tin, kOutU8, 31>(x, out, planes, h, w, r, passes, pad, tile, inv_w, stream);
    }
    return launch_rows<Tin, kOutU8, 63>(x, out, planes, h, w, r, passes, pad, tile, inv_w, stream);
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
  const int seg = line_segment(n, r, passes);
  const int nseg_max = (n + 2 * pad + seg - 1) / seg;  // <= kLineMaxSegs
  const int smem = 2 * nseg_max * kLineCols * 8;
  if (nlines > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long strips = (nlines + kLineCols - 1) / kLineCols;
  const int blocks = static_cast<int>(std::min<long long>(strips, kLineBlocksPerSm * sms));
  box_lines_kernel<Tin, kOutU8><<<blocks, kLineThreads, smem, stream>>>(
      static_cast<const Tin*>(x), out, static_cast<float*>(scratch0),
      static_cast<float*>(scratch1), per_plane, static_cast<int>(nlines), n,
      r, passes, pad, xs, ss, inv_w, seg, nseg_max);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: planes x h x w of uint8 (in_u8 = 1) or float; out: the same shape of
// uint8 (out_u8 = 1) or float. axis 1 blurs along w, axis 0 along h; r is
// the clamped per-pass radius (>= 1) and the line is padded by passes * r.
// tile > 0 (axis 1 only) runs the rows kernel with tiles of that many
// outputs (tile + 2 passes r <= 256 * 63); otherwise the lines kernel,
// whose passes before the last use scratch0 / scratch1 (f32, scratch_len
// values per line; see the wrapper). Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int box_scan_axis(const void* x, void* out, void* scratch0,
                             void* scratch1, int in_u8, int out_u8,
                             int planes, int h, int w, int axis, int r,
                             int passes, int tile, int scratch_len,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_u8) {
    return out_u8 ? launch<uint8_t, true>(x, out, scratch0, scratch1, planes, h, w, axis, r,
                                          passes, tile, scratch_len, st)
                  : launch<uint8_t, false>(x, out, scratch0, scratch1, planes, h, w, axis, r,
                                           passes, tile, scratch_len, st);
  }
  return out_u8 ? launch<float, true>(x, out, scratch0, scratch1, planes, h, w, axis, r,
                                      passes, tile, scratch_len, st)
                : launch<float, false>(x, out, scratch0, scratch1, planes, h, w, axis, r,
                                       passes, tile, scratch_len, st);
}
