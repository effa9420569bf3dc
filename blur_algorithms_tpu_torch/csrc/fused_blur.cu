// Fused separable f32 blur (K2) and its single-axis wide form: f32 or uint8
// planes in, f32 or uint8 out, as 3xTF32 band products on the tensor cores.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_blur.py:_kernel (its
// bf16x3 branch, the blocked float / custom-taps kernel, also in its
// pre_padded_col mode, 439-447 and 465: the sharded path's rows carry the
// caller's halo rows and are never reflected; and with skip_rows / skip_cols,
// one axis of radius 0: the two-pass split's single-axis kernels) and
// blur_algorithms_tpu/pallas_kernels/fused_dma.py:_tile_bf16x3 (K1's bf16x3
// tile body, "same numerics as fused_blur._kernel's bf16x3 path"). They
// compute out = corr_cols(corr_rows(reflect101(x))) with any odd tap vectors,
// correlation out[j] = sum_t taps[t] * x[j - r + t], as in band_block_matrix.
// The TPU runs each pass as a band matrix product on the MXU in hi/lo bf16
// split dots (rows pass 183-190, cols pass 204-209, the band matrices split
// once on the host, as_mat 480-488). Here each pass is a band matrix product
// on the H100's TF32 tensor cores, split the same way with tf32 halves:
//
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, D (16 x 8) += A B:
//   A (16 x 8) holds 16 lines (rows of the image in a rows pass, columns in a
//   cols pass) x 8 window positions along the correlated axis; B (8 x 8) is
//   the band, B[k][n] = taps[8s + k - n] at k-step s, for 8 consecutive
//   outputs n. Output block b of a line reads window positions 8 (b + s) + k
//   at step s, so one A fragment serves the blocks b and steps s with b + s
//   equal: a warp keeps the A fragments of kNB consecutive window steps in
//   registers (a ring of kNB, advanced by one load a step) and issues the
//   kNB output blocks of every step against them. The band of step s is the
//   same for every block: each lane reads its two taps a step from the
//   zero-padded tables in shared memory. S = (2r + 15) / 8 steps cover the
//   taps of all 8 outputs: (8 + 2r) / (2r + 1) multiply-adds per tap, 1.11x
//   at r 32, 1.003x at r 1330.
//
// 3xTF32: x = hi + lo with hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi),
// split in registers as the A fragments load (the rows pass's f32 result in
// K2's shared memory too); the taps likewise, Thi and Tlo, split once on the
// host (cuda_kernels/fused_blur.py:tc_table, which the CPU tests read). Three
// products, hi Thi + hi Tlo + lo Thi, each exact in the tensor core; lo Tlo
// (2^-22 of a product) is dropped. uint8 input is exact in tf32 (lo = 0) and
// takes two products, as the JAX kernel's uint8 rows pass does (188-190).
// The tensor core adds a step's products to its accumulator in its own order
// and rounding (which may truncate), so the accumulators are kept small: each
// step's hi Thi goes into a fresh accumulator, added by IEEE adds (round to
// nearest) to a sum of the last 16 steps that then joins the running total;
// hi Tlo + lo Thi, about 2^-11 of the sum, accumulate apart in the tensor
// core and join the total at the end. About 21 bits a product:
// 4e-5 to 2e-4 from the exact correlation at 0..255 scale for unit-gain taps
// from r 32 to r 3994. The plain version (blur_fused_f32_ref) rounds tap by
// tap; the kernels are held to it within 1e-3 * max|x| / 255 (f32) and 1
// count (uint8), the single-axis form at wide radii to its float64 mode
// (the f32 one drifts past that limit by itself at r 3994). A radius-0 axis
// of K2 is a copy, with no product.
//
// Windows are staged in shared memory, f32, by 16-byte cp.async where the
// four values lie inside the frame (f32 input, rows a multiple of 4 values),
// with reflect-101 index math per value elsewhere (uint8 input: one 4-byte
// load a slot). Along a row the staged window starts 16-byte aligned and the
// A reads carry the offset. The pitches put the A reads of a warp on 32
// banks: line-major windows (positions contiguous, rows passes) have a pitch
// of 4 mod 8 floats, position-major ones (cols passes) 8 mod 32.
//
// The single-axis form (blur_fused_axis_f32; the f32 split's two passes and
// the haloed split's pre-padded pass 2): a block of 8 warps, one item (16
// lines x 32 outputs) a warp: rows 16 image rows x 256 columns a tile, cols
// 32 columns x 128 rows. The window streams through shared memory in chunks
// of at most kMaxChunk steps; a chunk holds the 8 x chunk + 248 (rows) or
// + 120 (cols) positions its items read, and the A ring and the sums stay in registers
// across chunks, so r up to 4096 fits (the tables take 66 KB at r 4096).
// Blocks are persistent (as many as fit on the SMs at once, over all tiles)
// and keep the next chunk's cp.async copies in flight while the products of
// this one run (kDepth buffers; a third buffer measured no faster at r 32
// and slower past it, where it halves the chunk; probes/k2_variants.py).
// K2 (blur_fused_f32): a block per th x tw output tile. The rows pass runs
// the same band product over the th + 8 Sh - 8 halo rows into a tile-sized
// f32 intermediate in shared memory; the cols pass then reads it with (tw /
// 16) x (th / 32) items. To r 16 on both axes a 128 x 64 tile's whole
// window is one group and one chunk, the warps looping over its items;
// past that the halo rows go g at a time, the window in chunks as above,
// th 128 and tw 64 where they fit and smaller tiles at wide radii (tw 32,
// th 64 at r 600, with one or two rows-pass items: slow there, where the
// split serves on the H100). A persistent K2 that staged the next tile's
// window during this one's products measured slower (PERF.md).
//
// What bounds them on an H100 (12 planes of 2160 x 3840): a single-axis pass
// at r 32 moves 398 MB in and 398 MB out, 0.238 ms at 3.35 TB/s, against the
// function's 3 x 2 x (2r + 1) TF32 operations an output, 39 GFLOP, 0.078 ms
// at 495 TFLOP/s: bytes. At r 1330 the operations bound (6.42 ms both axes).
// The band products do 8 S / (2r + 1) times those (1.11x at r 32, 3.2x at
// r 2); K2 at sigma 10 recomputes the 8 Sh - 8 halo rows of its rows pass
// per tile (1.5x at th 128). mma.sync runs below the wgmma rate (the B1
// probe), and windows re-read from L2 (TN + 8 S) / TN times a pass.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 4;                // output blocks of 8 an item: the A ring
constexpr int kFold = 4;              // groups of kNB steps a fold of mid into tot
constexpr int kItemN = 8 * kNB;       // outputs an item along the correlated axis
constexpr int kMaxChunk = 32;         // window steps staged a chunk
constexpr int kDepth = 2;             // single-axis window buffers: chunks in flight + 1
// single-axis tiles, lines x outputs (8 items of 16 lines x kItemN outputs)
constexpr int kRowsLines = 16, kRowsOut = 256;
constexpr int kColsLines = 32, kColsOut = 128;
constexpr int kColsPitch = kColsLines + 8;  // floats a staged window row, cols form

// k-steps of a radius-r band and the length of one half of its tap table:
// hi at [0, L), lo at [L, 2L), tap t at 7 + t, zero elsewhere
__host__ __device__ inline int band_steps(int r) { return (2 * r + 15) / 8; }
__host__ __device__ inline int table_len(int r) { return 8 * band_steps(r) + 8; }

// a line-major pitch (floats) of at least n, 4 mod 8: 16-byte rows whose A
// reads (8 lines x 4 positions a warp) fall on 32 banks
inline int line_pitch(int n) {
  int p = (n + 3) & ~3;
  return (p & 7) ? p : p + 4;
}

// window steps staged a chunk: all of them where they fit in kMaxChunk, a
// multiple of kNB (the A ring's static slots) otherwise
inline int chunk_steps(int steps, int cap) {
  const int all = (steps + kNB - 1) / kNB * kNB;
  return all < cap ? all : cap;
}

__device__ __forceinline__ int reflect101(int i, int n) {
  i = abs(i);
  i = i > n - 1 ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// The plane row that window row i (relative to the output frame, -r <= i)
// reads: reflect-101 into the h rows, or with the caller's halo rows
// (pre_padded_col: xh = h + 2r rows) row i + r as it is (clamped past the
// last row, which only the zero padding taps reach).
__device__ __forceinline__ int src_row(int i, int h, int r, int xh, int pre) {
  return pre ? min(i + r, xh - 1) : reflect101(i, h);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a (16 x 8 tf32, row) * b (8 x 8 tf32, col), f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One item's state: the sum of the steps' hi Thi products in two levels
// (mid: the steps since the last fold; tot: the folds before), the small
// products (hi Tlo + lo Thi), and the A ring (hi and lo halves).
struct Band {
  float tot[kNB][4], mid[kNB][4], low[kNB][4];
  unsigned hi[kNB][4], lo[kNB][4];
};

// The A fragment at p, the element (line g, position tig) of its step:
// a0 (g, tig), a1 (g + 8, tig), a2 (g, tig + 4), a3 (g + 8, tig + 4), split
// into tf32 halves (kLo: f32 data; uint8 data is exact in tf32).
template <bool kLo>
__device__ __forceinline__ void load_a(const float* p, int sm8, int sk4, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  const float v[4] = {p[0], p[sm8], p[sk4], p[sm8 + sk4]};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    hi[q] = tf32_rna(v[q]);
    if (kLo) lo[q] = tf32_rna(__fsub_rn(v[q], __uint_as_float(hi[q])));
  }
}

// Steps [s0, s1) of an item whose window (this chunk's, based at step s0)
// has A element (line g, position tig) of step s0 at a, lines sm and
// positions sk floats apart; tb points at the tables' entry 7 + tig - g.
// s0 is a multiple of kNB, so that step s's ring slot (s + b) % kNB is
// static in the unrolled loop; the first chunk (s0 = 0) starts the sums and
// loads the first kNB - 1 fragments of the ring. Each step's hi Thi product
// goes into a fresh accumulator and joins mid by an IEEE add; mid joins tot
// every kFold x kNB steps, so that tot takes S / 16 roundings at the sum's
// scale (the plain version takes 2r + 1: at r 3994 it is itself 1e-3 from
// the exact sum at 0..255 scale, these kernels 2e-4).
template <bool kLo>
__device__ __forceinline__ void band_chunk(Band& st, const float* a, int sm, int sk,
                                           const float* tb, int tlen, int s0, int s1) {
  const int sm8 = 8 * sm, sk4 = 4 * sk, sk8 = 8 * sk;
  if (s0 == 0) {
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
#pragma unroll
      for (int q = 0; q < 4; ++q) st.tot[b][q] = st.mid[b][q] = st.low[b][q] = 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kNB - 1; ++b) load_a<kLo>(a + b * sk8, sm8, sk4, st.hi[b], st.lo[b]);
  }
  for (int sg = s0; sg < s1; sg += kNB) {
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const int s = sg + j;
      if (s < s1) {
        const int in = (j + kNB - 1) % kNB;
        load_a<kLo>(a + (s - s0 + kNB - 1) * sk8, sm8, sk4, st.hi[in], st.lo[in]);
        const unsigned th0 = __float_as_uint(tb[8 * s]), th1 = __float_as_uint(tb[8 * s + 4]);
        const unsigned tl0 = __float_as_uint(tb[tlen + 8 * s]);
        const unsigned tl1 = __float_as_uint(tb[tlen + 8 * s + 4]);
#pragma unroll
        for (int b = 0; b < kNB; ++b) {
          const int slot = (j + b) % kNB;
          float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(step, st.hi[slot], th0, th1);
          mma_tf32(st.low[b], st.hi[slot], tl0, tl1);
          if (kLo) mma_tf32(st.low[b], st.lo[slot], th0, th1);
#pragma unroll
          for (int q = 0; q < 4; ++q) st.mid[b][q] = __fadd_rn(st.mid[b][q], step[q]);
        }
      }
    }
    if ((sg / kNB) % kFold == kFold - 1) {
#pragma unroll
      for (int b = 0; b < kNB; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          st.tot[b][q] = __fadd_rn(st.tot[b][q], st.mid[b][q]);
          st.mid[b][q] = 0.0f;
        }
      }
    }
  }
}

// the item's result, D element q of output block b (c0, c1: line g, outputs
// 2 tig and 2 tig + 1; c2, c3: line g + 8)
__device__ __forceinline__ float band_out(const Band& st, int b, int q) {
  return __fadd_rn(__fadd_rn(st.tot[b][q], st.mid[b][q]), st.low[b][q]);
}

__device__ __forceinline__ uint8_t store_u8(float y) {
  const float v = fminf(fmaxf(__fadd_rn(y, 0.5f), 0.0f), 255.5f);
  return static_cast<uint8_t>(__float2int_rz(v));
}

template <bool kOutU8>
__device__ __forceinline__ void store_one(void* out, size_t o, float v) {
  if (kOutU8) {
    static_cast<uint8_t*>(out)[o] = store_u8(v);
  } else {
    static_cast<float*>(out)[o] = v;
  }
}

// two neighbouring outputs of one row at o (even), o + 1 (if pair)
template <bool kOutU8>
__device__ __forceinline__ void store_pair(void* out, size_t o, float v0, float v1, bool pair,
                                           bool even_w) {
  if (pair && even_w) {
    if (kOutU8) {
      *reinterpret_cast<uint16_t*>(static_cast<uint8_t*>(out) + o) =
          static_cast<uint16_t>(store_u8(v0) | (store_u8(v1) << 8));
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
    }
  } else {
    store_one<kOutU8>(out, o, v0);
    if (pair) store_one<kOutU8>(out, o + 1, v1);
  }
}

// four values of one plane row at columns c .. c + 3 (c a multiple of 4)
// into dst as f32: one 16-byte cp.async (f32) or 4-byte load (uint8) where
// all four lie inside the row and vec holds, else one reflect-101 (reflect)
// or clamped load each
template <typename Tin>
__device__ __forceinline__ void stage4(float* dst, const Tin* row, int c, int w, bool vec,
                                       bool reflect) {
  if (vec && c >= 0 && c + 4 <= w) {
    if constexpr (std::is_same<Tin, float>::value) {
      cp_async16(dst, reinterpret_cast<const float*>(row) + c);
    } else {
      const uchar4 v = *reinterpret_cast<const uchar4*>(row + c);
      *reinterpret_cast<float4*>(dst) = make_float4(v.x, v.y, v.z, v.w);
    }
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = reflect ? reflect101(c + e, w) : min(c + e, w - 1);
      v[e] = static_cast<float>(row[cc]);
    }
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// A line-major window: lines l < nl (plane rows src_row(row0 + l, ...)),
// slots of 4 columns from column c0 (a multiple of 4), nslots a line, at
// dst + l * pitch + 4 * slot.
template <typename Tin>
__device__ __forceinline__ void stage_lines(float* dst, int pitch, int nl, int nslots,
                                            const Tin* xp, int w, int c0, int row0, int h,
                                            int r, int xh, int pre, bool vec) {
  for (int k = threadIdx.x; k < nl * nslots; k += kThreads) {
    const int l = k / nslots, q = k - l * nslots;
    const Tin* row = xp + static_cast<size_t>(src_row(row0 + l, h, r, xh, pre)) * w;
    stage4<Tin>(dst + l * pitch + 4 * q, row, c0 + 4 * q, w, vec, true);
  }
}

// A position-major window: window rows p < np (plane rows src_row(row0 + p,
// ...)) x kColsLines columns from j0 (clamped past w), at dst + p * pitch.
template <typename Tin>
__device__ __forceinline__ void stage_rows(float* dst, int np, const Tin* xp, int w, int j0,
                                           int row0, int h, int r, int xh, int pre, bool vec) {
  constexpr int kSlots = kColsLines / 4;
  for (int k = threadIdx.x; k < np * kSlots; k += kThreads) {
    const int p = k / kSlots, q = k - p * kSlots;
    const Tin* row = xp + static_cast<size_t>(src_row(row0 + p, h, r, xh, pre)) * w;
    stage4<Tin>(dst + p * kColsPitch + 4 * q, row, j0 + 4 * q, w, vec, false);
  }
}

__device__ __forceinline__ void copy_table(float* dst, const float* src, int n) {
  for (int k = threadIdx.x; k < n / 4; k += kThreads) {
    reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(src)[k];
  }
}

template <typename Tin>
__device__ __forceinline__ bool vec_ok(const Tin* x, int w) {
  return ((reinterpret_cast<uintptr_t>(x) & (std::is_same<Tin, float>::value ? 15 : 3)) |
          (w & 3)) == 0;
}

// ---- K2: rows pass into the shared f32 intermediate, then the cols pass ----

struct Geometry {
  int th, tw;  // output tile rows x cols
  int g;       // halo rows a rows-pass group
  int cs;      // rows-pass window steps a chunk
  int px, py;  // pitches of the rows-pass window and the intermediate (floats)
  int hp;      // halo rows: th + 8 Sh - 8
  int smem;    // dynamic shared memory bytes
};

Geometry geometry(int th, int tw, int g, int cap, int rh, int rw) {
  Geometry geo;
  geo.th = th;
  geo.tw = tw;
  geo.g = g;
  geo.cs = chunk_steps(band_steps(rw), cap);
  geo.px = rw ? line_pitch(8 * std::min(geo.cs, band_steps(rw)) + tw - 8 + 3) : 0;
  geo.py = tw + 8;
  geo.hp = th + 8 * band_steps(rh) - 8;
  geo.smem = 4 * (2 * table_len(rw) + 2 * table_len(rh) + geo.hp * geo.py +
                  (rw ? g * geo.px : 0));
  return geo;
}

// At small radii, one group of all the halo rows of a 128 x 64 tile where
// its rows-pass window is one chunk and two blocks fit an SM (budget): the
// warps then loop over its items, with three barriers a tile. Else the
// first shape that fits, largest first: a taller tile amortises the 2rh
// halo rows the rows pass recomputes, a wider one the window's 2rw columns;
// more staged rows give the rows pass more items (g / 16 x tw / 32).
Geometry pick_geometry(int rh, int rw, int limit, int budget) {
  const Geometry one = geometry(128, 64, (128 + 8 * band_steps(rh) - 8 + 15) & ~15, kMaxChunk,
                                rh, rw);
  if (one.cs >= band_steps(rw) && one.smem <= budget) return one;
  for (int tw : {64, 32}) {
    for (int th : {128, 64, 32}) {
      for (int g : {64, 32, 16}) {
        for (int cap = kMaxChunk; cap >= kNB; cap /= 2) {
          const Geometry geo = geometry(th, tw, g, cap, rh, rw);
          if (geo.smem <= limit) return geo;
        }
      }
    }
  }
  return geometry(32, 32, 16, kNB, rh, rw);
}

template <typename Tin, bool kOutU8>
__global__ void __launch_bounds__(kThreads, 2)
fused_blur_f32_kernel(const Tin* __restrict__ x, void* __restrict__ out,
                      const float* __restrict__ tab_row, const float* __restrict__ tab_col,
                      int h, int w, int rh, int rw, int th, int tw, int g, int cs, int px,
                      int tiles_w, int pre) {
  constexpr bool kLo = std::is_same<Tin, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int lw = table_len(rw), lh = table_len(rh);
  const int sw = band_steps(rw), sh = band_steps(rh);
  const int py = tw + 8, hp = th + 8 * sh - 8;
  float* s_tr = smem;
  float* s_tc = s_tr + 2 * lw;
  float* s_y = s_tc + 2 * lh;   // hp x py: the rows pass's result
  float* s_x = s_y + hp * py;   // g x px: a group's window chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gl = lane >> 2, tig = lane & 3;
  const int i0 = (blockIdx.x / tiles_w) * th;
  const int j0 = (blockIdx.x % tiles_w) * tw;
  // pre_padded_col: the plane has xh = h + 2rh rows, the caller's halo rows
  const int xh = pre ? h + 2 * rh : h;
  const Tin* xp = x + static_cast<size_t>(blockIdx.y) * xh * w;
  const bool vec = vec_ok(x, w);
  copy_table(s_tr, tab_row, 2 * lw);
  copy_table(s_tc, tab_col, 2 * lh);

  // ---- rows pass: halo rows [g0, g0 + g) a group -> s_y ----
  if (rw == 0) {  // a copy
    for (int k = tid; k < hp * tw; k += kThreads) {
      const int i = k / tw, c = k - i * tw;
      const int gi = src_row(i0 - rh + i, h, rh, xh, pre);
      s_y[i * py + c] = static_cast<float>(xp[static_cast<size_t>(gi) * w + min(j0 + c, w - 1)]);
    }
  } else {
    const int cgroups = tw / kItemN;
    const int jb = j0 - rw;  // plane column of window position 0
    // the items' D fragments -> the intermediate's rows g0 + 16 lg ..
    auto put = [&](const Band& st, int g0, int lg, int og) {
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int i = g0 + 16 * lg + gl + 8 * hv;
        if (i >= hp) continue;
#pragma unroll
        for (int b = 0; b < kNB; ++b) {
          *reinterpret_cast<float2*>(s_y + i * py + og * kItemN + 8 * b + 2 * tig) =
              make_float2(band_out(st, b, 2 * hv), band_out(st, b, 2 * hv + 1));
        }
      }
    };
    for (int g0 = 0; g0 < hp && cs >= sw; g0 += g) {  // one chunk: warps loop over items
      const int nl = min(g, hp - g0);
      const int delta = jb & 3;
      __syncthreads();  // the previous group is done with s_x
      stage_lines<Tin>(s_x, px, nl, (8 * sw + tw - 8 + delta + 3) / 4, xp, w, jb - delta,
                       i0 - rh + g0, h, rh, xh, pre, vec);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      for (int it = warp; it < ((nl + 15) / 16) * cgroups; it += kWarps) {
        const int lg = it / cgroups, og = it % cgroups;
        Band st;
        band_chunk<kLo>(st, s_x + (16 * lg + gl) * px + delta + og * kItemN + tig, px, 1,
                        s_tr + 7 + tig - gl, lw, 0, sw);
        put(st, g0, lg, og);
      }
    }
    // chunked: one item a warp (g / 16 x cgroups <= kWarps), its sums
    // across the chunks in registers
    const int items = (g / 16) * cgroups;
    const int lg = warp / cgroups, og = warp % cgroups;
    for (int g0 = 0; g0 < hp && cs < sw; g0 += g) {
      Band st;
      for (int c0 = 0; c0 < sw; c0 += cs) {
        const int c1 = min(c0 + cs, sw);
        const int delta = (jb + 8 * c0) & 3;  // staged from column jb + 8 c0 - delta
        const int np = 8 * (c1 - c0) + tw - 8;
        __syncthreads();  // the previous chunk is done with s_x
        stage_lines<Tin>(s_x, px, min(g, hp - g0), (np + delta + 3) / 4, xp, w,
                         jb + 8 * c0 - delta, i0 - rh + g0, h, rh, xh, pre, vec);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        if (warp < items) {
          band_chunk<kLo>(st, s_x + (16 * lg + gl) * px + delta + og * kItemN + tig, px, 1,
                          s_tr + 7 + tig - gl, lw, c0, c1);
        }
      }
      if (warp < items) put(st, g0, lg, og);
    }
  }
  __syncthreads();

  // ---- cols pass: items of 16 columns x 32 output rows ----
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  if (rh == 0) {  // a copy
    for (int k = tid; k < th * tw; k += kThreads) {
      const int i = k / tw, c = k - i * tw;
      if (i0 + i < h && j0 + c < w) {
        store_one<kOutU8>(out, plane + static_cast<size_t>(i0 + i) * w + j0 + c, s_y[i * py + c]);
      }
    }
    return;
  }
  const int lgroups = tw / 16;
  for (int it = warp; it < lgroups * (th / kItemN); it += kWarps) {
    const int lg = it % lgroups, og = it / lgroups;
    Band st;
    band_chunk<true>(st, s_y + (og * kItemN + tig) * py + 16 * lg + gl, 1, py,
                     s_tc + 7 + tig - gl, lh, 0, sh);
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int gj = j0 + 16 * lg + gl + 8 * hv;
      if (gj >= w) continue;
#pragma unroll
      for (int b = 0; b < kNB; ++b) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gi = i0 + og * kItemN + 8 * b + 2 * tig + e;
          if (gi < h) {
            store_one<kOutU8>(out, plane + static_cast<size_t>(gi) * w + gj,
                              band_out(st, b, 2 * hv + e));
          }
        }
      }
    }
  }
}

template <typename Tin, bool kOutU8>
int launch(const void* x, void* out, const void* tab_row, const void* tab_col, int planes,
           int h, int w, int rh, int rw, int pre, cudaStream_t stream) {
  int device = 0, limit = 0, per_sm = 0;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const Geometry geo = pick_geometry(rh, rw, limit, per_sm / 2 - 1024);
  if (geo.smem > limit || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_blur_f32_kernel<Tin, kOutU8>;
  cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int tiles_w = (w + geo.tw - 1) / geo.tw;
  const int tiles_h = (h + geo.th - 1) / geo.th;
  dim3 grid(tiles_w * tiles_h, planes);
  kernel<<<grid, kThreads, geo.smem, stream>>>(
      static_cast<const Tin*>(x), out, static_cast<const float*>(tab_row),
      static_cast<const float*>(tab_col), h, w, rh, rw, geo.th, geo.tw, geo.g, geo.cs, geo.px,
      tiles_w, pre);
  return static_cast<int>(cudaGetLastError());
}

// ---- the single-axis wide form (the split's passes) ----
//
// One kernel for both axes. kRows: kRowsLines image rows x kRowsOut columns
// a tile, the window along each row staged line-major; else kColsLines
// columns x kColsOut output rows, the window down the columns staged
// position-major (pre_padded_col: xh = h + 2r input rows, output row o
// reading input rows o .. o + 2r as they are). A block is persistent: it
// takes the tiles blockIdx.x, + gridDim.x, ... (over planes x tiles), each
// in chunks of cs window steps, and keeps kDepth - 1 chunks staging ahead
// (cp.async into kDepth window buffers, waited for only when their turn
// comes) while its warps run the products of the current one.
template <typename Tin, bool kOutU8, bool kRows>
__global__ void __launch_bounds__(kThreads, 2)
fused_axis_kernel(const Tin* __restrict__ x, void* __restrict__ out,
                  const float* __restrict__ tab, int planes, int h, int w, int r,
                  int tiles_w, int tiles, int cs, int buf, int pre) {
  constexpr bool kLo = std::is_same<Tin, float>::value;
  extern __shared__ __align__(16) float smem[];
  const int tlen = table_len(r), steps = band_steps(r);
  const int nchunks = (steps + cs - 1) / cs, work = planes * tiles;
  constexpr int kLines = kRows ? kRowsLines : kColsLines;
  constexpr int kOut = kRows ? kRowsOut : kColsOut;
  const int pitch = kRows ? buf / kLines : kColsPitch;
  float* s_t = smem;
  float* s_w = s_t + 2 * tlen;  // kDepth window buffers of buf floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane >> 2, tig = lane & 3;
  // warp -> item: line group lg, outputs og * kItemN ..
  constexpr int kCg = kOut / kItemN, kLgroups = kLines / 16;
  const int lg = kRows ? warp / kCg : warp % kLgroups;
  const int og = kRows ? warp % kCg : warp / kLgroups;
  const int xh = pre ? h + 2 * r : h;
  const bool vec = vec_ok(x, w);
  copy_table(s_t, tab, 2 * tlen);

  // tile t of a plane: its first line (i0 rows, j0 columns) and output
  auto origin = [&](int t, int& i0, int& j0) {
    i0 = (t / tiles_w) * (kRows ? kLines : kOut);
    j0 = (t % tiles_w) * (kRows ? kOut : kLines);
  };
  // stage chunk c of tile (plane-major over planes x tiles) into dst and
  // commit its copies as one group (an empty one past the block's last)
  auto stage = [&](int tile, int c, float* dst) {
    if (tile < work) {
      const int plane = tile / tiles;
      int i0, j0;
      origin(tile - plane * tiles, i0, j0);
      const int c0 = c * cs, np = 8 * (min(c0 + cs, steps) - c0) + kOut - 8;
      if (kRows) {
        const int jb = j0 - r + 8 * c0, delta = jb & 3;  // staged from column jb - delta
        stage_lines<Tin>(dst, pitch, kLines, (np + delta + 3) / 4,
                         x + static_cast<size_t>(plane) * h * w, w, jb - delta, i0, h, 0, h,
                         0, vec);
      } else {
        stage_rows<Tin>(dst, np, x + static_cast<size_t>(plane) * xh * w, w, j0,
                        i0 - r + 8 * c0, h, r, xh, pre, vec);
      }
    }
    cp_async_commit();
  };
  auto advance = [&](int& t, int& c) {
    if (++c == nchunks) {
      c = 0;
      t += gridDim.x;
    }
  };

  // the block's chunks in order, kDepth - 1 of them staged ahead
  int stile = blockIdx.x, sc = 0;
  for (int d = 0; d < kDepth - 1; ++d) {
    stage(stile, sc, s_w + d * buf);
    advance(stile, sc);
  }
  int tile = blockIdx.x, c = 0;
  Band st;
  for (int k = 0; tile < work; ++k) {
    cp_async_wait<kDepth - 2>();
    __syncthreads();  // chunk k landed; every warp is done with chunk k - 1's buffer
    stage(stile, sc, s_w + ((k + kDepth - 1) % kDepth) * buf);
    advance(stile, sc);
    const float* cur = s_w + (k % kDepth) * buf;
    const int plane = tile / tiles;
    int i0, j0;
    origin(tile - plane * tiles, i0, j0);
    const int c0 = c * cs, c1 = min(c0 + cs, steps);
    if (kRows) {
      const int delta = (j0 - r + 8 * c0) & 3;
      band_chunk<kLo>(st, cur + (16 * lg + gl) * pitch + delta + og * kItemN + tig, pitch, 1,
                      s_t + 7 + tig - gl, tlen, c0, c1);
    } else {
      band_chunk<kLo>(st, cur + (og * kItemN + tig) * kColsPitch + 16 * lg + gl, 1, kColsPitch,
                      s_t + 7 + tig - gl, tlen, c0, c1);
    }
    if (c1 == steps) {  // the tile's last chunk: store its outputs
      const size_t base = static_cast<size_t>(plane) * h * w;
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int line = 16 * lg + gl + 8 * hv;
#pragma unroll
        for (int b = 0; b < kNB; ++b) {
          const int o = og * kItemN + 8 * b + 2 * tig;
          if (kRows) {
            const int gi = i0 + line, gj = j0 + o;
            if (gi < h && gj < w) {
              store_pair<kOutU8>(out, base + static_cast<size_t>(gi) * w + gj,
                                 band_out(st, b, 2 * hv), band_out(st, b, 2 * hv + 1),
                                 gj + 1 < w, (w & 1) == 0);
            }
          } else {
            const int gj = j0 + line;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int gi = i0 + o + e;
              if (gi < h && gj < w) {
                store_one<kOutU8>(out, base + static_cast<size_t>(gi) * w + gj,
                                  band_out(st, b, 2 * hv + e));
              }
            }
          }
        }
      }
    }
    advance(tile, c);
  }
}

// Shared memory of the single-axis form at chunks of cs steps: the band
// table and kDepth window buffers (the floats of one in *buf).
inline int axis_smem(bool rows, int r, int cs, int* buf) {
  const int np = 8 * std::min(cs, band_steps(r)) + (rows ? kRowsOut : kColsOut) - 8;
  *buf = rows ? kRowsLines * line_pitch(np + 3) : np * kColsPitch;
  return 4 * (2 * table_len(r) + kDepth * *buf);
}

template <typename Tin, bool kOutU8, bool kRows>
int launch_axis_kernel(const Tin* x, void* out, const float* tab, int planes, int h, int w,
                       int r, int pre, cudaStream_t stream) {
  int device = 0, limit = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the largest chunk whose buffers let two blocks share an SM, else the
  // largest that fits one
  const int steps = band_steps(r);
  int cs = 0, buf = 0, smem = 0;
  for (int fit : {per_sm / 2 - 1024, limit}) {
    for (int cap = kMaxChunk; cap >= kNB && !cs; cap /= 2) {
      const int n = chunk_steps(steps, cap);
      smem = axis_smem(kRows, r, n, &buf);
      if (smem <= fit) cs = n;
    }
    if (cs) break;
  }
  if (!cs || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_axis_kernel<Tin, kOutU8, kRows>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tw = kRows ? kRowsOut : kColsLines, th = kRows ? kRowsLines : kColsOut;
  const int tiles_w = (w + tw - 1) / tw, tiles = tiles_w * ((h + th - 1) / th);
  const long long work = static_cast<long long>(planes) * tiles;
  int per = 0;  // persistent: as many blocks as fit on the SMs at once
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (work > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(std::min<long long>(work, 1LL * std::max(per, 1) * sms));
  kernel<<<grid, kThreads, smem, stream>>>(x, out, tab, planes, h, w, r, tiles_w, tiles, cs,
                                           buf, pre);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, bool kOutU8>
int launch_axis(const void* x, void* out, const void* tab, int planes, int h, int w, int axis,
                int r, int pre, cudaStream_t stream) {
  const Tin* xs = static_cast<const Tin*>(x);
  const float* ts = static_cast<const float*>(tab);
  // a rows pass has no column halo: pre_padded_col leaves it as it is
  return axis == 1 ? launch_axis_kernel<Tin, kOutU8, true>(xs, out, ts, planes, h, w, r, 0, stream)
                   : launch_axis_kernel<Tin, kOutU8, false>(xs, out, ts, planes, h, w, r, pre,
                                                            stream);
}

}  // namespace

// The single-axis wide form: x planes x h x w of float (in_u8 = 0) or uint8;
// out float (out_u8 = 0) or uint8; taps: the band table of the axis's 2r + 1
// taps (cuda_kernels/fused_blur.py:tc_table: hi then lo tf32 halves, 8 S + 8
// floats each, tap t at 7 + t) on the device; axis 1 correlates along w,
// axis 0 along h (the other axis is a copy). pre = 1 (axis 0): x has h + 2r
// rows per plane, the caller's halo rows, and output row o reads rows o ..
// o + 2r with no reflection. Returns the cudaError_t of the launch (0 =
// launched).
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
// (out_u8 = 0) or uint8 (out_u8 = 1); taps_row and taps_col are the band
// tables (as above) of the 2rw + 1 and 2rh + 1 taps on the device. Returns
// the cudaError_t of the launch (0 = launched).
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
