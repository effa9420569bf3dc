// Fused separable Gaussian blur of uint8 planes (K1): the int8, hybrid and
// bf16 rungs of the precision ladder, in five staging forms that share the
// three bodies.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_dma.py:_kernel_direct
// (1023; the direct form) and the same file's _kernel_strip (285; the strip
// form K1s), _kernel (223) and _kernel_pipe (899; the assembled form K1a
// and its pipelined variant) and _kernel_resident (604; the rows-resident
// form K1r), with their tile bodies _tile_int8 (1242), _tile_hybrid (1306)
// and _tile_bf16 (1415); and the assembly kernels A5 and A4 that feed K1a
// (_assemble_padded and _assemble_padded_prepad, at the end of this file).
// K1a on A4's frame is the JAX rows_prepadded mode (blur_fused_haloed_dma,
// 2589): the caller's halo rows sit where A5 puts reflected rows, so the
// kernel is the same.
//
// The bodies (device functions rows_pass and cols_pass below):
//
// - int8, uint8 -> uint8 or f32, exact int8 fixed point (_rows_int8, _cols_int8):
//   the JAX band matmuls are 1-D correlations with one integer tap vector
//   per axis, so the rows pass computes R = sum_t q_row[t] * xc[j - rw + t]
//   on the recentred input (x ^ 0x80 == x - 128) exactly in int32 as
//   128 * (q_hi dots) + (q_lo dots) with __dp4a, requantises
//   E = (R + 2^(s-1)) >> s and keeps its base-128 digits e1, e0 in shared
//   memory, column-major; the cols pass sums p1 = sum b_hi*e1, p23 = sum
//   b_hi*e0 + b_lo*e1, p4 = sum b_lo*e0 over the 2rh + 1 column taps with
//   __dp4a on four consecutive rows of a digit column; the epilogue
//   y = f32(p1)*c1 + f32(p23)*c2 + f32(p4)*c3 + 128 (int8_epilogue), then
//   clip(y + 0.5, 0, 255.5) and a truncating store, or y itself as f32
//   (the JAX _compute_store with out_u8=False, which the sharded path asks
//   for). For the uint8 store every product and sum is rounded on its own
//   (__fmul_rn/__fadd_rn, and the build passes --fmad=false), the form
//   the card's earlier certification ran. The f32 store rounds as XLA
//   compiles the JAX expression when the kernel is interpreted on an FMA
//   host, two multiply-adds contracted: fma(p4, c3, fma(p23, c2,
//   p1 * c1)) + 128. Both stores are bit-identical to the JAX kernel run
//   in interpret mode.
// - hybrid: the int8 rows sum R without the requantisation (the JAX body
//   folds the shift into its output scale), y = bf16(f32(R)) kept in the
//   bytes E's digit planes take, then acc = sum_t bf16(c_t) * y[t] in f32
//   and out = fma(acc, 1 / (127 * 2^s), 128).
// - bf16: the rows staged as bf16 (uint8 values are exact there),
//   y = bf16(sum_t bf16(r_t) * x[t]) in f32, then out = sum_t bf16(c_t) *
//   y[t]; no epilogue. A bf16 x bf16 product is exact in f32, so with every
//   sum taken in ascending tap order (__fmaf_rn) the hybrid and bf16 results
//   are the plain versions' (cuda_kernels/fused_dma.py) bit for bit.
//
// Each rows item is 4 outputs of one row, each cols item 4 outputs of one
// column; the tap windows are read as consecutive 4-byte (int8) or 8-byte
// (bf16, two per 8 values) words. Taps are zero-padded to a multiple of 4:
// the padding rows and columns a tile stages meet zero taps, so every form
// computes every output from the same terms in the same order and all five
// are bit-identical.
//
// The forms differ only in the loader and in where the rows output lives.
// One block of 256 threads per:
//
// - direct (K1), (plane, th x tw output tile): stages the th + 2rh halo rows
//   in groups of g rows, each row segment of tw + 2rw bytes gathered with
//   reflect-101 index math (i < 0 -> -i, i >= n -> 2(n-1) - i), which
//   replaces the JAX form's edge strips and window splices.
// - strip (K1s), (plane, row strip): walks the strip's column windows left
//   to right with the whole (th + 2rh) x (tw + 2rw) window staged, and
//   carries its last 2rw columns to the next window (a shared-memory move,
//   tw columns at a time), so each input byte of the strip is read from
//   global memory once; reflect-101 of the columns matters only at the
//   first and last windows. A strip of a 4K row at r 32 (96 x 3840 B) does
//   not fit a block's 227 KB, which is why the window walks and not the
//   strip.
// - assembled (K1a), (plane, tile): reads plain rectangles of A5's padded
//   frame (the frame at (rh, rw), rows 16-byte aligned, so every window
//   starts on a 16-byte boundary) with 16-byte cp.async, no index math,
//   two row groups in flight while the rows pass runs on the group before
//   (one where three buffers do not fit). The JAX form keeps n_slots - 1
//   windows in flight; a block here holds one window's digits, and the
//   card hides the rest with other blocks. The pipelined variant (int8)
//   walks `seg` windows of a strip per block and runs window j's rows pass
//   and window j-1's cols pass between the same barriers, on
//   double-buffered digit planes (_kernel_pipe).
// - resident (K1r), (plane, column window): walks down the frame th new
//   rows a step, with the rows output of the last th + 2rh rows resident in
//   a ring of R = th + t4h rows (digit planes for int8, bf16 y for hybrid),
//   so every rows value is computed once; rows below t4h + 4 are mirrored
//   past R, so each cols item reads its t4h + 4 rows contiguously. Every
//   column of the window is rows-passed (the last window past w too).
//
// What bounds them on an H100: integer and FMA issue, not bytes. At r 32 a
// direct tile does (1 + 2rh/th) rows passes per output (about 1.28x) and
// reads each input byte (1 + 2rh/th)(1 + 2rw/tw) times from L2; device
// memory traffic (1 byte in, 1 byte out per pixel) is far below the card's
// bandwidth. The forms attack the redundant parts: K1r the repeated rows
// work (2.5x at r 332), K1s and K1a the loader's repeated reads and index
// math. K1s and K1r trade blocks for it (one per strip, one per column
// window), so the card sees fewer, longer blocks; which form wins where is
// measured (chip_smoke.py phase 15) and routed by utils/hw.py.
//
// The loaders' probe (B3, csrc/probes/fetch_rate.cu) includes this file
// with FUSED_DMA_LOADERS_ONLY defined: the helpers and loaders above the
// bodies (load_rows, convert, issue_group) and nothing else, so that it
// times the staging code K1 runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kNoRing = INT_MAX;

enum Body { kInt8 = 0, kHybrid = 1, kBf16 = 2 };
enum Form { kDirect = 0, kStrip = 1, kAssembled = 2, kPipelined = 3, kResident = 4 };

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// plane column stride in elements for `rows` rows (a multiple of 4): an odd
// number of 4-row words, so threads on neighbouring columns hit different
// banks
__host__ __device__ inline int odd_words(int rows) {
  return ((rows >> 2) & 1) ? rows : rows + 4;
}

// Shared memory of one block, in bytes: taps, the rows-output plane(s), the
// staged input, and the assembled forms' `slots` raw cp.async buffers of a
// row group each at a 16-byte offset (int8 and hybrid recentre a buffer in
// place and read it as their stage; bf16 converts it into its stage). The
// wrappers (cuda_kernels/fused_dma.py, layout_bytes) size the tiles with
// the same formula and pass their total, which the launch checks.
struct Layout {
  int taps, plane, nplanes, stage, raw_off, total, cs;
};

__host__ __device__ inline Layout make_layout(int form, int body, int th, int tw,
                                              int rh, int rw, int slots) {
  Layout L;
  const int t4w = round4(2 * rw + 1), t4h = round4(2 * rh + 1);
  const int g = kThreads / (tw >> 2);
  const int sw = tw + t4w;
  const int es = body == kBf16 ? 2 : 1;
  L.taps = body == kInt8 ? 2 * t4w + 2 * t4h : 4 * t4h + (body == kBf16 ? 4 : 2) * t4w;
  L.cs = odd_words(form == kResident ? th + 2 * t4h + 4 : th + t4h);
  L.plane = 2 * tw * L.cs;
  L.nplanes = form == kPipelined ? 2 : 1;
  const bool raw = form == kAssembled || form == kPipelined;
  L.stage = (form == kStrip ? th + t4h : (raw && body != kBf16 ? 0 : g)) * sw * es;
  const int end = L.taps + L.nplanes * L.plane + L.stage;
  L.raw_off = raw ? round16(end) : end;
  L.total = raw ? L.raw_off + slots * g * round16(sw) : end;
  return L;
}

struct K1Params {
  const uint8_t* x;      // input planes (the padded frame for K1a)
  void* out;             // output planes, h x w
  const int* taps_i;     // int8: q_hi|q_lo|b_hi|b_lo words; else the row taps
  const float* taps_f;   // hybrid, bf16: the column taps
  int h, w, rh, rw;      // frame and support radii
  int th, tw, nbh, nbw;  // tile and tile counts
  int seg, nseg;         // K1a: windows per block, blocks per row strip
  int slots;             // K1a: raw row-group buffers (2 or 3), slots - 1 in flight
  int xh, xw;            // rows and row length of an input plane
  int rows_shift;
  float c1, c2, c3, scale;  // int8 epilogue; hybrid scale
};

struct Smem {
  const int* ti;    // int8: all taps; hybrid: rows taps; bf16: rows taps (f32 bits)
  const float* ct;  // hybrid, bf16: column taps
  unsigned char* plane[2];
  unsigned char* stage;
  unsigned char* raw;
};

template <int B>
__device__ __forceinline__ Smem carve(unsigned char* smem, const Layout& L, const K1Params& p) {
  const int t4w = round4(2 * p.rw + 1), t4h = round4(2 * p.rh + 1);
  const int nqw = t4w >> 2, nqh = t4h >> 2;
  Smem s;
  if (B == kInt8) {
    int* ti = reinterpret_cast<int*>(smem);
    for (int k = threadIdx.x; k < 2 * nqw + 2 * nqh; k += kThreads) ti[k] = p.taps_i[k];
    s.ti = ti;
    s.ct = nullptr;
  } else {
    float* ct = reinterpret_cast<float*>(smem);
    int* ti = reinterpret_cast<int*>(smem + 4 * t4h);
    for (int k = threadIdx.x; k < t4h; k += kThreads) ct[k] = p.taps_f[k];
    for (int k = threadIdx.x; k < (B == kBf16 ? t4w : 2 * nqw); k += kThreads) {
      ti[k] = p.taps_i[k];
    }
    s.ti = ti;
    s.ct = ct;
  }
  s.plane[0] = smem + L.taps;
  s.plane[1] = s.plane[0] + L.plane;
  s.stage = smem + L.taps + L.nplanes * L.plane;
  s.raw = smem + L.raw_off;
  return s;
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

// ---- the loaders' staging: int8 recentred, or bf16 ----

template <int B>
__device__ __forceinline__ void put_stage(unsigned char* stage, int k, uint8_t v) {
  if (B == kBf16) {
    reinterpret_cast<unsigned short*>(stage)[k] = to_bf16(static_cast<float>(v));
  } else {
    stage[k] = v ^ 0x80;
  }
}

// rows [row0, row0 + nr) x columns [col0 + c_begin, col0 + c_end) of the
// plane, reflect-101, into staged rows of sw elements; threads over columns
template <int B>
__device__ __forceinline__ void load_rows(unsigned char* stage, int sw, const uint8_t* xp,
                                          int h, int w, int row0, int col0, int nr,
                                          int c_begin, int c_end) {
  for (int c = c_begin + threadIdx.x; c < c_end; c += kThreads) {
    const int gj = reflect101(col0 + c, w);
    for (int rr = 0; rr < nr; ++rr) {
      const int gi = reflect101(row0 + rr, h);
      put_stage<B>(stage, rr * sw + c, xp[static_cast<size_t>(gi) * w + gj]);
    }
  }
}

// the same for ncols (a divisor of kThreads) columns from c_begin: each
// thread one column, kThreads / ncols rows at a time
template <int B>
__device__ __forceinline__ void load_columns(unsigned char* stage, int sw, const uint8_t* xp,
                                             int h, int w, int row0, int col0, int nr,
                                             int c_begin, int ncols) {
  const int c = c_begin + threadIdx.x % ncols;
  const int gc = col0 + c;
  const int gj = gc >= 0 && gc < w ? gc : reflect101(gc, w);
  for (int rr = threadIdx.x / ncols; rr < nr; rr += kThreads / ncols) {
    const int gi = reflect101(row0 + rr, h);
    put_stage<B>(stage, rr * sw + c, xp[static_cast<size_t>(gi) * w + gj]);
  }
}

// nr raw byte rows (stride swa) -> staged rows: bf16 into `stage` (stride
// sw), int8 and hybrid recentred in place
template <int B>
__device__ __forceinline__ void convert(unsigned char* raw, int swa, unsigned char* stage,
                                        int sw, int nr) {
  const int nw = sw >> 2;
  for (int e = threadIdx.x; e < nr * nw; e += kThreads) {
    const int rr = e / nw;
    const int q = e - rr * nw;
    unsigned* src = reinterpret_cast<unsigned*>(raw + rr * swa) + q;
    const unsigned v = *src;
    if (B == kBf16) {
      uint2 o;
      o.x = to_bf16(static_cast<float>(v & 0xff)) |
            (static_cast<unsigned>(to_bf16(static_cast<float>((v >> 8) & 0xff))) << 16);
      o.y = to_bf16(static_cast<float>((v >> 16) & 0xff)) |
            (static_cast<unsigned>(to_bf16(static_cast<float>(v >> 24))) << 16);
      reinterpret_cast<uint2*>(reinterpret_cast<unsigned short*>(stage) + rr * sw)[q] = o;
    } else {
      *src = v ^ 0x80808080u;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The assembled forms' loader: row group t of a block's run of `total`
// groups, ngr a window (window win at column (jw0 + win) * tw of the padded
// frame plane fp, xw bytes a row; its rows from row i0), by 16-byte
// cp.async into buffer t % slots of `raw` (g rows of swa bytes), then one
// commit group (empty past the last group).
__device__ __forceinline__ void issue_group(unsigned char* raw, const uint8_t* fp, int xw,
                                            int i0, int jw0, int tw, int hp, int g, int swa,
                                            int ngr, int total, int slots, int t) {
  if (t < total) {
    const int win = t / ngr;
    const int r0 = (t - win * ngr) * g;
    const int nr = min(g, hp - r0);
    const int nch = swa >> 4;
    unsigned char* dst = raw + (t % slots) * g * swa;
    const uint8_t* src =
        fp + static_cast<size_t>(i0 + r0) * xw + static_cast<size_t>(jw0 + win) * tw;
    for (int e = threadIdx.x; e < nr * nch; e += kThreads) {
      const int rr = e / nch;
      const int q = e - rr * nch;
      cp_async16(dst + rr * swa + (q << 4), src + static_cast<size_t>(rr) * xw + (q << 4));
    }
  }
  cp_async_commit();
}

#ifndef FUSED_DMA_LOADERS_ONLY

// ---- the bodies ----

// Rows pass of nr staged rows (stride sw elements), staged row rr being
// rows-output row m0 + rr, which goes to plane row (m0 + rr) % ring and, for
// a row below `mirror`, also to that row + ring.
template <int B>
__device__ __forceinline__ void rows_pass(const unsigned char* stage, int sw, int nr, int m0,
                                          int tw, int nqw, const Smem& s, int rows_shift,
                                          unsigned char* plane, int cs, int ring,
                                          int mirror) {
  const int ngrp = tw >> 2;  // 4-column output groups per row
  for (int k = threadIdx.x; k < nr * ngrp; k += kThreads) {
    const int rr = k / ngrp;
    const int c0 = (k - rr * ngrp) << 2;
    int m = m0 + rr;
    if (m >= ring) m -= (m / ring) * ring;
    if (B == kBf16) {
      const uint2* xw = reinterpret_cast<const uint2*>(
          reinterpret_cast<const unsigned short*>(stage) + rr * sw + c0);
      const float4* rt = reinterpret_cast<const float4*>(s.ti);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      uint2 cur = xw[0];
      for (int q = 0; q < nqw; ++q) {
        const uint2 nxt = xw[q + 1];
        float v[8];
        unpack8(cur, nxt, v);
        fma_window(rt[q], v, acc);
        cur = nxt;
      }
      unsigned short* y = reinterpret_cast<unsigned short*>(plane);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned short b = to_bf16(acc[u]);
        y[(c0 + u) * cs + m] = b;
        if (m < mirror) y[(c0 + u) * cs + m + ring] = b;
      }
    } else {
      const int* xw = reinterpret_cast<const int*>(stage + rr * sw + c0);
      int hi[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
      int cur = xw[0];
      for (int q = 0; q < nqw; ++q) {
        const int nxt = xw[q + 1];
        const int qh = s.ti[q], ql = s.ti[nqw + q];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = shifted(cur, nxt, u);
          hi[u] = __dp4a(v, qh, hi[u]);
          lo[u] = __dp4a(v, ql, lo[u]);
        }
        cur = nxt;
      }
      if (B == kInt8) {
        signed char* d1 = reinterpret_cast<signed char*>(plane);
        signed char* d0 = d1 + tw * cs;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = hi[u] * 128 + lo[u];
          const int e = (r + (1 << (rows_shift - 1))) >> rows_shift;
          const int e1 = (e + 64) >> 7;
          const signed char v1 = static_cast<signed char>(e1);
          const signed char v0 = static_cast<signed char>(e - e1 * 128);
          d1[(c0 + u) * cs + m] = v1;
          d0[(c0 + u) * cs + m] = v0;
          if (m < mirror) {
            d1[(c0 + u) * cs + m + ring] = v1;
            d0[(c0 + u) * cs + m + ring] = v0;
          }
        }
      } else {
        unsigned short* y = reinterpret_cast<unsigned short*>(plane);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned short b = to_bf16(__int2float_rn(hi[u] * 128 + lo[u]));
          y[(c0 + u) * cs + m] = b;
          if (m < mirror) y[(c0 + u) * cs + m + ring] = b;
        }
      }
    }
  }
}

// The int8 body's f32 epilogue p1*c1 + p23*c2 + p4*c3 + 128 (the JAX
// _cols_int8 expression). kOutU8: each product and sum rounded on its own,
// the form the uint8 store has always had. Else (the f32 store) two of the
// multiply-adds contracted, as XLA compiles the expression on an FMA host,
// so the f32 value is bit-equal to the JAX kernel in interpret mode.
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

// Cols pass and store of items [k_begin, k_end) of a th x tw tile whose
// output row 0 reads from plane row b0 (modulo ring, b0 < ring): 4 output
// rows of one column per item, the tile's rows at (i0, j0) of the output.
template <int B, bool kOutU8>
__device__ __forceinline__ void cols_pass(const unsigned char* plane, int cs, int nqw, int nqh,
                                          const Smem& s, const K1Params& p, int k_begin,
                                          int k_end, int b0, int ring, int i0, int j0) {
  const int tw = p.tw;
  const size_t plane_off = static_cast<size_t>(blockIdx.y) * p.h * p.w;
  for (int k = k_begin + threadIdx.x; k < k_end; k += kThreads) {
    const int a = k / tw;
    const int j = k - a * tw;
    const int ii = a << 2;
    const int gj = j0 + j;
    if (gj >= p.w || i0 + ii >= p.h) continue;
    int pos = b0 + ii;
    if (pos >= ring) pos -= ring;
    float out[4];
    if (B == kInt8) {
      const int* bhi = s.ti + 2 * nqw;
      const int* blo = bhi + nqh;
      const signed char* e1p = reinterpret_cast<const signed char*>(plane);
      const int* d1 = reinterpret_cast<const int*>(e1p + j * cs + pos);
      const int* d0 = reinterpret_cast<const int*>(e1p + tw * cs + j * cs + pos);
      int p1[4] = {0, 0, 0, 0}, p23[4] = {0, 0, 0, 0}, p4[4] = {0, 0, 0, 0};
      int cur1 = d1[0], cur0 = d0[0];
      for (int q = 0; q < nqh; ++q) {
        const int nxt1 = d1[q + 1], nxt0 = d0[q + 1];
        const int bh = bhi[q], bl = blo[q];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e1 = shifted(cur1, nxt1, u);
          const int e0 = shifted(cur0, nxt0, u);
          p1[u] = __dp4a(e1, bh, p1[u]);
          p23[u] = __dp4a(e1, bl, __dp4a(e0, bh, p23[u]));
          p4[u] = __dp4a(e0, bl, p4[u]);
        }
        cur1 = nxt1;
        cur0 = nxt0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        out[u] = int8_epilogue<kOutU8>(p1[u], p23[u], p4[u], p.c1, p.c2, p.c3);
      }
    } else {
      const float4* ct = reinterpret_cast<const float4*>(s.ct);
      const uint2* d = reinterpret_cast<const uint2*>(
          reinterpret_cast<const unsigned short*>(plane) + j * cs + pos);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      uint2 cur = d[0];
      for (int q = 0; q < nqh; ++q) {
        const uint2 nxt = d[q + 1];
        float v[8];
        unpack8(cur, nxt, v);
        fma_window(ct[q], v, acc);
        cur = nxt;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        out[u] = B == kBf16 ? acc[u] : __fmaf_rn(acc[u], p.scale, 128.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int gi = i0 + ii + u;
      if (gi >= p.h) break;
      const size_t o = plane_off + static_cast<size_t>(gi) * p.w + gj;
      if (kOutU8) {
        const float v = fminf(fmaxf(__fadd_rn(out[u], 0.5f), 0.0f), 255.5f);
        static_cast<uint8_t*>(p.out)[o] = static_cast<uint8_t>(__float2int_rz(v));
      } else {
        static_cast<float*>(p.out)[o] = out[u];
      }
    }
  }
}

// ---- the forms ----

template <int B, bool kOutU8>
__global__ void __launch_bounds__(kThreads) k1_direct(K1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(kDirect, B, p.th, p.tw, p.rh, p.rw, 0);
  const Smem s = carve<B>(smem, L, p);
  const int t4w = round4(2 * p.rw + 1), t4h = round4(2 * p.rh + 1);
  const int hp = p.th + t4h, sw = p.tw + t4w, g = kThreads / (p.tw >> 2);
  const int i0 = (blockIdx.x / p.nbw) * p.th;
  const int j0 = (blockIdx.x % p.nbw) * p.tw;
  const uint8_t* xp = p.x + static_cast<size_t>(blockIdx.y) * p.h * p.w;
  for (int r0 = 0; r0 < hp; r0 += g) {
    const int nr = min(g, hp - r0);
    __syncthreads();  // the previous group is done with the stage
    load_rows<B>(s.stage, sw, xp, p.h, p.w, i0 - p.rh + r0, j0 - p.rw, nr, 0, sw);
    __syncthreads();
    rows_pass<B>(s.stage, sw, nr, r0, p.tw, t4w >> 2, s, p.rows_shift, s.plane[0], L.cs,
                 kNoRing, 0);
  }
  __syncthreads();
  cols_pass<B, kOutU8>(s.plane[0], L.cs, t4w >> 2, t4h >> 2, s, p, 0, (p.th >> 2) * p.tw, 0,
                       kNoRing, i0, j0);
}

template <int B, bool kOutU8>
__global__ void __launch_bounds__(kThreads) k1_strip(K1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(kStrip, B, p.th, p.tw, p.rh, p.rw, 0);
  const Smem s = carve<B>(smem, L, p);
  const int t4w = round4(2 * p.rw + 1), t4h = round4(2 * p.rh + 1);
  const int hp = p.th + t4h, sw = p.tw + t4w, es = B == kBf16 ? 2 : 1;
  const int row_words = sw * es / 4, tw_words = p.tw * es / 4;
  const int i0 = blockIdx.x * p.th;
  const uint8_t* xp = p.x + static_cast<size_t>(blockIdx.y) * p.h * p.w;
  int* sw4 = reinterpret_cast<int*>(s.stage);
  for (int jw = 0; jw < p.nbw; ++jw) {
    const int j0 = jw * p.tw;
    if (jw == 0) {
      load_rows<B>(s.stage, sw, xp, p.h, p.w, i0 - p.rh, j0 - p.rw, hp, 0, sw);
    } else {
      // carry the window's last t4w columns to its front, tw columns at a
      // time in ascending order (source and target of one move are apart
      // by tw, so they never overlap)
      for (int c = 0; c < t4w; c += p.tw) {
        const int n = min(p.tw, t4w - c) * es / 4;
        const int cw = c * es / 4;
        for (int e = threadIdx.x; e < hp * n; e += kThreads) {
          const int rr = e / n;
          const int q = cw + e - rr * n;
          sw4[rr * row_words + q] = sw4[rr * row_words + q + tw_words];
        }
        __syncthreads();
      }
      load_columns<B>(s.stage, sw, xp, p.h, p.w, i0 - p.rh, j0 - p.rw, hp, t4w, p.tw);
    }
    __syncthreads();  // the window is staged; the last cols pass is done
    rows_pass<B>(s.stage, sw, hp, 0, p.tw, t4w >> 2, s, p.rows_shift, s.plane[0], L.cs,
                 kNoRing, 0);
    __syncthreads();
    cols_pass<B, kOutU8>(s.plane[0], L.cs, t4w >> 2, t4h >> 2, s, p, 0, (p.th >> 2) * p.tw,
                         0, kNoRing, i0, j0);
  }
}

template <int B, bool kOutU8, bool kPipe>
__global__ void __launch_bounds__(kThreads) k1_assembled(K1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L =
      make_layout(kPipe ? kPipelined : kAssembled, B, p.th, p.tw, p.rh, p.rw, p.slots);
  const Smem s = carve<B>(smem, L, p);
  const int t4w = round4(2 * p.rw + 1), t4h = round4(2 * p.rh + 1);
  const int nqw = t4w >> 2, nqh = t4h >> 2;
  const int hp = p.th + t4h, sw = p.tw + t4w, swa = round16(sw);
  const int g = kThreads / (p.tw >> 2);
  const int ngr = (hp + g - 1) / g;  // row groups per window
  const int i0 = (blockIdx.x / p.nseg) * p.th;
  const int jw0 = (blockIdx.x % p.nseg) * p.seg;
  const int nwin = min(p.seg, p.nbw - jw0);
  const int total = nwin * ngr;
  const int items = (p.th >> 2) * p.tw;
  // the frame holds the plane at (rh, rw): window (i0, j0)'s staged rows
  // and columns start at frame row i0 and column j0
  const uint8_t* fp = p.x + static_cast<size_t>(blockIdx.y) * p.xh * p.xw;

  auto issue = [&](int t) {
    issue_group(s.raw, fp, p.xw, i0, jw0, p.tw, hp, g, swa, ngr, total, p.slots, t);
  };

  for (int t = 0; t < p.slots - 1; ++t) issue(t);
  for (int t = 0; t < total; ++t) {
    const int win = t / ngr;
    const int gr = t - win * ngr;
    const int r0 = gr * g;
    const int nr = min(g, hp - r0);
    if (p.slots == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // group t landed; the stage and the next slot are free
    issue(t + p.slots - 1);
    unsigned char* raw = s.raw + (t % p.slots) * g * swa;
    convert<B>(raw, swa, s.stage, sw, nr);
    __syncthreads();
    rows_pass<B>(B == kBf16 ? s.stage : raw, B == kBf16 ? sw : swa, nr, r0, p.tw, nqw, s,
                 p.rows_shift, s.plane[kPipe ? (win & 1) : 0], L.cs, kNoRing, 0);
    const int j0 = (jw0 + win) * p.tw;
    if (kPipe) {
      // a slice of the previous window's cols pass beside this group's rows
      if (win > 0) {
        const int per = (items + ngr - 1) / ngr;
        cols_pass<B, kOutU8>(s.plane[(win - 1) & 1], L.cs, nqw, nqh, s, p, gr * per,
                             min(items, (gr + 1) * per), 0, kNoRing, i0, j0 - p.tw);
      }
    } else if (gr == ngr - 1) {
      __syncthreads();
      cols_pass<B, kOutU8>(s.plane[0], L.cs, nqw, nqh, s, p, 0, items, 0, kNoRing, i0, j0);
    }
  }
  if (kPipe) {
    __syncthreads();
    cols_pass<B, kOutU8>(s.plane[(nwin - 1) & 1], L.cs, nqw, nqh, s, p, 0, items, 0, kNoRing,
                         i0, (jw0 + nwin - 1) * p.tw);
  }
  cp_async_wait<0>();
}

template <int B, bool kOutU8>
__global__ void __launch_bounds__(kThreads) k1_resident(K1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(kResident, B, p.th, p.tw, p.rh, p.rw, 0);
  const Smem s = carve<B>(smem, L, p);
  const int t4w = round4(2 * p.rw + 1), t4h = round4(2 * p.rh + 1);
  const int ring = p.th + t4h, mirror = t4h + 4;
  const int sw = p.tw + t4w, g = kThreads / (p.tw >> 2);
  const int j0 = blockIdx.x * p.tw;
  const uint8_t* xp = p.x + static_cast<size_t>(blockIdx.y) * p.h * p.w;
  int m_next = 0;  // rows-output rows [0, m_next) were computed
  for (int i = 0; i < p.nbh; ++i) {
    const int target = i * p.th + ring;  // this step's window ends here
    for (int r0 = m_next; r0 < target; r0 += g) {
      const int nr = min(g, target - r0);
      __syncthreads();  // the stage, and the ring rows this group replaces, are free
      load_rows<B>(s.stage, sw, xp, p.h, p.w, r0 - p.rh, j0 - p.rw, nr, 0, sw);
      __syncthreads();
      rows_pass<B>(s.stage, sw, nr, r0, p.tw, t4w >> 2, s, p.rows_shift, s.plane[0], L.cs,
                   ring, mirror);
    }
    m_next = target;
    __syncthreads();
    cols_pass<B, kOutU8>(s.plane[0], L.cs, t4w >> 2, t4h >> 2, s, p, 0, (p.th >> 2) * p.tw,
                         (i * p.th) % ring, ring, i * p.th, j0);
  }
}

template <int B, bool kOutU8>
int launch(int form, const K1Params& p, int planes, int smem, cudaStream_t stream) {
  void (*kernel)(K1Params) = nullptr;
  dim3 grid(1, planes);
  switch (form) {
    case kDirect:
      kernel = k1_direct<B, kOutU8>;
      grid.x = p.nbh * p.nbw;
      break;
    case kStrip:
      kernel = k1_strip<B, kOutU8>;
      grid.x = p.nbh;
      break;
    case kAssembled:
      kernel = k1_assembled<B, kOutU8, false>;
      grid.x = p.nbh * p.nseg;
      break;
    case kPipelined:
      if constexpr (B == kInt8) {
        kernel = k1_assembled<B, kOutU8, true>;
        grid.x = p.nbh * p.nseg;
      }
      break;
    case kResident:
      if constexpr (B != kBf16) {
        kernel = k1_resident<B, kOutU8>;
        grid.x = p.nbw;
      }
      break;
    default:
      break;
  }
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- A5 ----
//
// The reflect-101 padded frame that K1's assembled form reads.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_dma.py:_assemble_padded
// (1672) -> _assemble_kernel (1640), five HBM->HBM copies per plane (the
// frame's aligned bulk, and the top, bottom, left and right edge strips
// that _topbot_strips (1489) and _lr_borders (1525) build with XLA).
//
// Writes uint8 planes (bc, h, w) into (bc, hp, wp) with the plane at offset
// (orh, orw): padded element (r, c) is x[refl(r - orh), refl(c - orw)] where
// -min(rh, h - 1) <= r - orh < h + min(rh, h - 1) and the same for the
// columns with rw, and zero elsewhere (the JAX frame's alignment slack and
// clamped reflection), refl being reflect-101. One thread per 16-byte chunk
// of a padded row: a chunk inside the plane's columns is four aligned
// 4-byte loads (five when the source is not 4-byte aligned) funnel-shifted
// with __byte_perm into one 16-byte store, with no index math; only the
// chunks that meet the edge strips or the slack gather their bytes one by
// one through reflect-101.
//
// A4 (assemble_padded_prepad_u8 below) replaces the same file's
// _assemble_padded_prepad (1738) -> _assemble_kernel4 (1708), four copies
// per plane for a shard whose row halos the caller supplied: the same
// function with no row border, so it is this kernel launched with rh = 0
// and orh = 0 (rows [0, hs) read as they are, the rest zero).
//
// What bounds it on an H100: bytes. It reads each input byte about once
// (the edge strips again, a few percent at r 32 on 4K) and writes hp x wp
// bytes per plane: at the copy's 3.35 TB/s a 4K batch of 12 planes is
// about 0.06 ms. The design keeps every store 16 bytes wide and coalesced,
// and every load aligned.

__global__ void __launch_bounds__(kThreads)
assemble_padded_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ v, int h, int w,
                       int rb, int rcb, int orh, int orw, int hp, int wp) {
  const int chunks = wp >> 4;
  const long long n = static_cast<long long>(hp) * chunks;
  const uint8_t* xp = x + static_cast<size_t>(blockIdx.y) * h * w;
  uint4* vp = reinterpret_cast<uint4*>(v + static_cast<size_t>(blockIdx.y) * hp * wp);
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(e / chunks);
    const int k = static_cast<int>(e - static_cast<long long>(r) * chunks);
    const int ri = r - orh;
    const int c0 = (k << 4) - orw;  // plane column of the chunk's first byte
    uint4 val = make_uint4(0, 0, 0, 0);
    if (ri >= -rb && ri < h + rb) {
      const uint8_t* row = xp + static_cast<size_t>(reflect101(ri, h)) * w;
      if (c0 >= 0 && c0 + 16 <= w) {
        const uintptr_t a = reinterpret_cast<uintptr_t>(row + c0);
        const unsigned* src = reinterpret_cast<const unsigned*>(a & ~uintptr_t(3));
        const int sel = 0x3210 + 0x1111 * static_cast<int>(a & 3);
        const unsigned w0 = src[0], w1 = src[1], w2 = src[2], w3 = src[3];
        const unsigned w4 = (a & 3) ? src[4] : 0u;
        val.x = __byte_perm(w0, w1, sel);
        val.y = __byte_perm(w1, w2, sel);
        val.z = __byte_perm(w2, w3, sel);
        val.w = __byte_perm(w3, w4, sel);
      } else {
        unsigned q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int c = c0 + b;
          if (c >= -rcb && c < w + rcb) {
            q[b >> 2] |= static_cast<unsigned>(row[reflect101(c, w)]) << (8 * (b & 3));
          }
        }
        val = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
    vp[e] = val;
  }
}

int smem_limit(int* limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

#endif  // FUSED_DMA_LOADERS_ONLY

}  // namespace

#ifndef FUSED_DMA_LOADERS_ONLY

// K1 in one of its forms (0 direct, 1 strip, 2 assembled, 3 pipelined,
// 4 resident) with one of its bodies (0 int8, 1 hybrid, 2 bf16), uint8
// planes -> uint8 (out_u8 = 1) or float, the epilogue's value before the
// uint8 store (int8: p1*c1 + p23*c2 + p4*c3 + 128).
// taps_i: int8, int32 words [q_hi (nqw) | q_lo (nqw) | b_hi (nqh) |
// b_lo (nqh)], each word four int8 taps, tap 4k + u in byte u; hybrid, the
// rows words [q_hi | q_lo]; bf16, float [t4w] row taps. taps_f: hybrid and
// bf16, float [t4h] column taps. All zero-padded to a multiple of 4.
// (th, tw): the tile (th a multiple of 4; tw 32, 64 or 128); seg, slots:
// windows per block and raw row-group buffers (2 or 3) of the assembled
// forms. (xh, xw): the planes' rows and row length (the padded frame's for
// the assembled forms: the plane at (rh, rw), xw a multiple of 16). smem:
// the wrapper's shared-memory bytes, which must equal this file's layout.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int blur_fused_u8_k1(int form, int body, int out_u8, const void* x, void* out,
                                const void* taps_i, const void* taps_f, int planes, int h,
                                int w, int rh, int rw, int th, int tw, int seg, int slots,
                                int xh, int xw, int smem, int rows_shift, float c1, float c2,
                                float c3, float scale, void* stream) {
  const bool tw_ok = tw == 32 || tw == 64 || tw == 128;
  if (form < kDirect || form > kResident || body < kInt8 || body > kBf16 || !tw_ok ||
      th < 4 || th % 4 || seg < 1 || planes < 1 || planes > 65535 || rh < 1 || rw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool asm_form = form == kAssembled || form == kPipelined;
  if (asm_form && slots != 2 && slots != 3) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(form, body, th, tw, rh, rw, asm_form ? slots : 0);
  int limit = 0;
  const int lerr = smem_limit(&limit);
  if (lerr) return lerr;
  if (L.total != smem || smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  K1Params p;
  p.x = static_cast<const uint8_t*>(x);
  p.out = out;
  p.taps_i = static_cast<const int*>(taps_i);
  p.taps_f = static_cast<const float*>(taps_f);
  p.h = h;
  p.w = w;
  p.rh = rh;
  p.rw = rw;
  p.th = th;
  p.tw = tw;
  p.nbh = (h + th - 1) / th;
  p.nbw = (w + tw - 1) / tw;
  p.seg = seg;
  p.nseg = (p.nbw + seg - 1) / seg;
  p.slots = asm_form ? slots : 0;
  p.xh = h;
  p.xw = w;
  if (asm_form) {
    const int t4w = round4(2 * rw + 1), t4h = round4(2 * rh + 1);
    if (xh < p.nbh * th + t4h || xw % 16 || xw < (p.nbw - 1) * tw + round16(tw + t4w) ||
        (form == kPipelined && seg < 2)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.xh = xh;
    p.xw = xw;
  }
  p.rows_shift = rows_shift;
  p.c1 = c1;
  p.c2 = c2;
  p.c3 = c3;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == kInt8) {
    return out_u8 ? launch<kInt8, true>(form, p, planes, smem, st)
                  : launch<kInt8, false>(form, p, planes, smem, st);
  }
  if (body == kHybrid) {
    return out_u8 ? launch<kHybrid, true>(form, p, planes, smem, st)
                  : launch<kHybrid, false>(form, p, planes, smem, st);
  }
  return out_u8 ? launch<kBf16, true>(form, p, planes, smem, st)
                : launch<kBf16, false>(form, p, planes, smem, st);
}

// uint8 planes (planes, h, w) -> (planes, hp, wp) reflect-101 padded at
// (orh, orw) with zero slack; wp a multiple of 16, orh >= min(rh, h - 1),
// orw >= min(rw, w - 1). Returns the cudaError_t of the launch (0 = launched).
extern "C" int assemble_padded_u8(const void* x, void* out, int planes, int h, int w, int rh,
                                  int rw, int orh, int orw, int hp, int wp, void* stream) {
  const int rb = rh < h - 1 ? rh : h - 1;
  const int rcb = rw < w - 1 ? rw : w - 1;
  if (planes < 1 || planes > 65535 || h < 1 || w < 1 || rh < 0 || rw < 0 || wp % 16 ||
      hp < 1 || orh < rb || orw < rcb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long chunks = static_cast<long long>(hp) * (wp >> 4);
  long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  dim3 grid(static_cast<unsigned>(blocks), planes);
  assemble_padded_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), h, w, rb, rcb, orh, orw, hp,
      wp);
  return static_cast<int>(cudaGetLastError());
}

// A4: uint8 rows-prepadded shards (planes, hs, w), whose hs rows already
// carry the caller's row halos, -> (planes, hp, wp) with the shard at (0,
// orw), reflect-101 columns and zero slack: A5's kernel with no row border
// (rh = 0, orh = 0), where its row reflection is the identity (0 <= r < hs).
// wp a multiple of 16, orw >= min(rw, w - 1). Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int assemble_padded_prepad_u8(const void* x, void* out, int planes, int hs, int w,
                                         int rw, int orw, int hp, int wp, void* stream) {
  return assemble_padded_u8(x, out, planes, hs, w, 0, rw, 0, orw, hp, wp, stream);
}

extern "C" const char* blur_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // FUSED_DMA_LOADERS_ONLY
