// The int8 forms of the two-pass wide-radius split: a rows-only pass over
// uint8 planes and two cols-only passes over its int16 intermediate E.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_blur.py:_kernel_int8
// in its split forms: skip_cols with out_e32 (pass 1, int16 E out), skip_cols
// without it (pass 1, f32 R / Sr + 128 out, where pass 2 cannot run int8),
// in_e32 (pass 2, E in, uint8 or f32 out) and hybrid_cols (the hybrid pass
// 2, fused_blur.py:282-298, epilogue :339-340). Both cols passes also take
// E with the caller's halo rows (pre = 1: the JAX e32="in" with
// pre_padded_col=True, fused_blur.py:1080-1084, the sharded path's haloed
// split): h + 2rh rows a plane, read as they are, never reflected.
// Reflect-101 is index math in the loaders (the JAX wrapper pads E by
// reflect before pass 2).
//
// The rows pass (split_rows_int8_kernel) computes what the JAX kernel's
// int8 band products do (fused_blur.py:301-318, the band blocks of
// band_block_matrix): R = sum_t q[t] * (x[j - rw + t] - 128) with q = 128 *
// q_hi + q_lo, exact in int32; E = asr(R + 2^(s-1), s) as int16, or
// fma(f32(R), f32(1 / Sr), 128) as f32 (one rounding, as XLA contracts the
// JAX kernel's R * (1 / Sr) + 128). It runs as a band product on the int8
// tensor cores, mma.sync.m16n8k32.row.col.s32.s8.u8.s32: A (16 x 32, s8) is
// the band of one digit, A[m][k] = q[32s + k - m] for 16 output columns and
// k-step s; B (32 x 8, u8) is 8 image rows x 32 window columns of the raw
// bytes, fed by ldmatrix (one B fragment feeds the q_hi and the q_lo
// product). The band depends only on 32s + k - m, so every 16-column block
// of outputs starts its k-steps at its own first window column and reads the
// same A fragments: four byte-shifted copies of each digit's taps in shared
// memory make each A register one aligned 32-bit load. x is multiplied raw
// (u8) and the recentring is one subtraction, R = 128 (hi - 128 Q_hi) + lo -
// 128 Q_lo, with Q the taps' sum; every product and sum is an exact integer,
// so any order gives the same bits. The taps get (-rw) mod 16 leading zeros,
// so that every window starts 16-byte aligned: interior segments are
// cp.async copies of 16 bytes, segments past the frame's edge the two
// aligned words they mirror, byte-reversed with __byte_perm; reflect-101
// byte loads are left for rows that are not 16-byte aligned and windows
// past one reflection. Block: 8 warps, 64 image rows x 128 output columns, a warp one
// 16-column block x all 64 rows (16 mma per k-step: 8 n-blocks x 2 digits);
// the window streams through a 1024-column ring in chunks of 256 (8
// k-steps), two chunks ahead of the products; the outputs go out through
// shared memory in coalesced rows.
//
// The int8 cols pass (split_cols_int8_kernel): E = 128 * e1 + e0 with e1 =
// asr(E + 64, 7); p1 = sum b_hi * e1, p23 = sum b_hi * e0 + b_lo * e1, p4 =
// sum b_lo * e0 over the column taps (the JAX kernel's three digit products
// against the column band, fused_blur.py:322-334); then K1's epilogue p1 * c1
// + p23 * c2 + p4 * c3 + 128 (int8_epilogue: for the uint8 store each
// product and sum rounded on its own, and the store clip(y + 0.5, 0, 255.5)
// truncated; for the f32 store fma(p4, c3, fma(p23, c2, p1 * c1)) + 128, as
// XLA compiles the JAX expression in interpret mode on an FMA host;
// --fmad=false keeps nvcc from contracting anything else). It runs as a band
// product along the columns on the int8 tensor cores,
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32: A (16 x 32) is the band of one tap
// digit, A[m][k] = b[32s + k - m] for 16 output rows and k-step s, from the
// four byte-shifted tap copies (the rows pass's, with no leading zeros); B (32
// x 8) is one E digit, 32 input rows x 8 columns. Four products a step (p23
// takes two); every product and sum is an exact integer (p1 < 2^23, p23 <
// 2^27, p4 < 2^26), so the order is free and the pass is bit-equal to the JAX
// kernel and to its plain version at any tiling. A .col B register holds 4
// consecutive k, here 4 input rows of one column, and E is row-major int16
// (ldmatrix.trans moves 16-bit elements only), so the digits are split and
// transposed on their way into shared memory: each thread fetches 4 rows x 8
// columns of E with 16-byte cp.async into its own staging slots, computes
// both digits of two columns a 32-bit word at once (bit tricks on E + 64,
// split_digits), gathers each column's 4 rows into one word a digit with
// __byte_perm, and stores the words into column-major digit planes
// ([column][row] bytes, 784 bytes a column); non-transposed ldmatrix then
// gives the B fragments. Only the row index is reflected (src_row, in the
// loader). Block: 16 warps, 256 output rows x 32 columns, a warp two 16-row
// blocks x two 8-column blocks (16 mma a k-step: 2 x 2 x 4; the two blocks'
// windows are 16 rows apart, so ldmatrix x4 per n-block and step brings the
// two new 16-row matrices of each digit and the third carries over; 8 warps
// of four 8-column blocks held 192 registers a thread and ran 5% slower).
// The first 256 threads fetch and convert the window. The
// window streams through a 768-row ring in chunks of 256 rows (8 k-steps),
// one chunk in flight into the staging slots and one converted ahead of the
// products; E is re-read from L2 (256 + 2rh + 16) / 256 times, ~7.6 at r 831.
// The outputs go out through shared memory in coalesced rows.
//
// The hybrid pass 2 (split_cols_hybrid_kernel): y = bf16(f32(E)), acc =
// sum_t bf16(c_t) * y[t] in f32, out = fma(acc, f32(1 / 127), 128). It runs
// as a band product along the columns on the bf16 tensor cores,
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: A (16 x 16) is the band of
// the column taps, B (16 x 8) 16 input rows x 8 columns of y, fed by
// ldmatrix.trans. The tensor core sums a k-step's 16 products in its own
// order and rounding, so an output's f32 result depends on how its taps are
// grouped into k-steps; the grouping depends only on the output row's own
// taps, never on where its tile or its shard starts: one m16 fragment holds
// the 16 output rows i, i + 16, ..., i + 240, and its k-step s reads the 16
// input rows from i - rh + 16s, so output row i + 16m takes, at step s, the
// taps [16 (s - m), 16 (s - m) + 16) of its own tap index: the aligned groups
// of 16 taps, added to its sum in ascending order, group g at the same
// position of the step in every tile. So a shard's pre-padded pass 2 is
// bit-equal to the single-card call on the same rows, and a change of tile
// shape or origin changes no result. The A fragment of step s is
// block-Toeplitz (row m holds tap group s - m) and is the same for every
// fragment: it comes from the zero-padded bf16 tap groups in shared memory
// (12 words a group, so that a load's 8 groups hit 32 banks). Block: 8 warps, 256
// output rows (16 fragments) x 64 columns; a warp takes fragments f and f +
// 8, whose B fragments share 8 input rows (12 ldmatrix matrices per 16 mma
// a step). E (int16) is fetched a chunk of 128 rows at a time with cp.async
// into a staging buffer, two chunks ahead, converted to bf16 once per
// element into a 384-row ring, and read from there. Within 2e-2 at 0..255
// scale of its plain version (which sums tap by tap in ascending order) on
// the f32 store and 1 count on the uint8 store: ~2 f32 ulps of |acc| <=
// 16384 a step, over <= ~530 steps at r 4094, over 127.
//
// What bounds them on an H100 (12 planes 2160 x 3840, r 831): the rows
// pass's 2 digits x 2 x 1663 int8 operations an output (0.335 ms at 1,979
// TOP/s) against 1 byte in and 2 bytes of E out (0.089 ms); its band wastes
// (32 * steps) / (2rw + 1), ~1.02 at r 831. The int8 cols pass's 4 digit
// products x 2 x 1663 an output (0.669 ms) against 2 bytes of E in and 1 out
// (0.089 ms); its band wastes (32 * steps) / (2rh + 1), ~1.03 at r 831. The hybrid pass 2's 2 x 1663
// bf16 operations an output (0.335 ms at 989 TFLOP/s) against E in and 1
// byte out (0.089 ms); its fragments waste (16 * (groups + 15)) / (2rh + 1),
// ~1.14 at r 831 and ~3.6 at r 49, and re-read E from L2 (256 + 2rh) / 256
// times. Both stream their windows from L2 through shared memory; the
// products are issued as mma.sync, whose rate on Hopper is below wgmma's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the int8 cols pass: 16 warps of 32 output rows (two m16 blocks) x half
// the kColsTw columns (two n8 blocks)
constexpr int kColsNb = 2;                  // n blocks a warp
constexpr int kColsThreads = 512;
constexpr int kColsTh = 256;                // output rows per block
constexpr int kColsTw = 32;                 // output columns per block
constexpr int kColsLoad = 256;              // window rows per staged chunk (8 k-steps)
constexpr int kColsRing = 3 * kColsLoad;    // ring rows: three chunks
constexpr int kColsPitch = kColsRing + 16;  // bytes per digit column: ldmatrix rows on 8 bank groups
constexpr int kColsPlane = kColsTw * kColsPitch + 192;  // bytes per digit plane
constexpr int kColsStage = 80;              // staging bytes per thread: 4 rows x 16, on 8 bank groups

// the rows pass: 8 warps of one 16-column block x all kRowsTr rows
constexpr int kRowsTn = 128;                // output columns per block
constexpr int kRowsTr = 64;                 // image rows per block: 8 n-blocks of 8
constexpr int kRowsLoad = 256;              // window columns per staged chunk (8 k-steps)
constexpr int kRowsRing = 4 * kRowsLoad;    // ring columns: four chunks
constexpr int kRowsPitch = kRowsRing + 16;  // bytes per staged row: ldmatrix rows on 8 bank groups

// the hybrid pass 2: 16 fragments (rows f + 16m) x 8 n-blocks; a warp takes f and f + 8
constexpr int kHybTh = 256;             // output rows per block
constexpr int kHybTw = 64;              // output columns per block
constexpr int kHybLoad = 128;           // window rows per staged chunk (8 k-steps)
constexpr int kHybRing = 3 * kHybLoad;  // ring rows: three chunks
constexpr int kHybPitch = kHybTw + 8;   // bf16 per ring row (144 bytes): ldmatrix rows on 8 bank groups
constexpr int kHybGroupWords = 12;      // words per tap group of 16 bf16: 8 consecutive groups on 32 banks

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The rows pass's k-steps: the taps get delta = (-rw) mod 16 leading zeros
// (the window then starts 16-byte aligned) and run in steps of 32 window
// columns: row m of a 16-column block reads taps 32s + k - m, so steps
// cover delta + 2rw + 1 taps for every m. Each digit keeps four copies of
// its taps, copy c word i = taps [4i + c - 16, 4i + c - 13] (after the
// delta zeros), of `words` words each, a count = 8 (mod 32) so that the
// four copies fall on different banks.
struct RowsGeometry {
  int delta, steps, words;
};

__host__ __device__ inline RowsGeometry rows_geometry(int rw) {
  RowsGeometry g;
  g.delta = (16 - rw % 16) % 16;
  g.steps = (g.delta + 2 * rw + 1 + 15 + 31) / 32;
  const int need = 8 * g.steps + 4;
  g.words = need + ((8 - need) % 32 + 32) % 32;
  return g;
}

__host__ __device__ inline int rows_smem(int rw) {
  return kRowsTr * kRowsPitch + 2 * 4 * 4 * rows_geometry(rw).words;
}

// The int8 cols pass's k-steps: row m of a 16-row block reads taps 32s + k
// - m, so steps cover 2rh + 1 taps for every m. Each digit keeps four copies
// of its taps, copy c word i = taps [4i + c - 16, 4i + c - 13], of `words`
// words each, a count = 8 (mod 32) so that the four copies fall on
// different banks (the rows pass's copies with delta = 0).
__host__ __device__ inline RowsGeometry cols_geometry(int rh) {
  RowsGeometry g;
  g.delta = 0;
  g.steps = (2 * rh + 1 + 15 + 31) / 32;
  const int need = 8 * g.steps + 4;
  g.words = need + ((8 - need) % 32 + 32) % 32;
  return g;
}

__host__ __device__ inline int cols_smem(int rh) {
  // the two digit planes, the staging buffer, the tap copies
  return 2 * kColsPlane + kThreads * kColsStage + 2 * 4 * 4 * cols_geometry(rh).words;
}

// byte offset of column j in a digit plane: 784 bytes a column (ldmatrix's
// eight columns on eight bank groups), each group of 8 columns 64 bytes
// past the one before (the staging writes of a warp, two neighbouring
// groups, on 32 banks)
__device__ __forceinline__ int cols_col(int j) { return j * kColsPitch + ((j >> 3) << 6); }

// The hybrid pass 2's tap groups of 16 and k-steps: fragment row m takes
// group s - m at step s, for groups 0 .. hyb_groups - 1.
__host__ __device__ inline int hyb_groups(int rh) { return (2 * rh + 1 + 15) / 16; }

__host__ __device__ inline int hyb_smem(int rh) {
  // the bf16 ring, the int16 staging chunk, the tap groups -15 .. groups + 14
  return kHybRing * kHybPitch * 2 + kHybLoad * kHybTw * 2 +
         (hyb_groups(rh) + 30) * kHybGroupWords * 4;
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

__device__ __forceinline__ uint8_t store_u8(float y) {
  const float v = fminf(fmaxf(__fadd_rn(y, 0.5f), 0.0f), 255.5f);
  return static_cast<uint8_t>(__float2int_rz(v));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 32 s8, row) * b (32 x 8 u8, col), s32
__device__ __forceinline__ void mma_s8u8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// two int16 (the low and high halves of v) -> two bf16, the first low
__device__ __forceinline__ unsigned bf16x2_of_i16x2(unsigned v) {
  const float lo = static_cast<float>(static_cast<int16_t>(v & 0xffffu));
  const float hi = static_cast<float>(static_cast<int16_t>(v >> 16));
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

__global__ void __launch_bounds__(kThreads, 2)
split_rows_int8_kernel(const uint8_t* __restrict__ x, void* __restrict__ out,
                       const int* __restrict__ taps, int h, int w, int rw,
                       int out_e32, int rows_shift, float inv_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RowsGeometry geo = rows_geometry(rw);
  unsigned char* s_x = smem;  // the window ring: kRowsTr rows x kRowsRing columns
  unsigned* s_q = reinterpret_cast<unsigned*>(smem + kRowsTr * kRowsPitch);  // [digit][copy][word]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kRowsTn, i0 = blockIdx.y * kRowsTr;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const uint8_t* xp = x + plane;
  const int gc0 = j0 - rw - geo.delta;  // image column of window column 0
  const int nload = (kRowsTn - 16 + 32 * geo.steps + kRowsLoad - 1) / kRowsLoad;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | static_cast<uintptr_t>(w)) & 15) == 0;

  // window columns [256c, 256c + 256) of the block's rows into the ring,
  // one commit group
  auto load = [&](int c) {
    if (c < nload) {
      for (int k = tid; k < kRowsTr * (kRowsLoad / 16); k += kThreads) {
        const int rr = k >> 4;
        const int wc = c * kRowsLoad + ((k & 15) << 4);
        const uint8_t* src = xp + static_cast<size_t>(min(i0 + rr, h - 1)) * w;
        unsigned char* dst = s_x + rr * kRowsPitch + (wc & (kRowsRing - 1));
        const int gc = gc0 + wc;
        if (vec && gc >= 0 && gc + 16 <= w) {
          cp_async16(smem_u32(dst), src + gc);
        } else if (vec && gc < 0 && gc >= 16 - w) {
          // left of the frame: x[-gc - k], k = 0..15, reversed out of the
          // aligned words at -gc - 16 and -gc
          const uint4 a = *reinterpret_cast<const uint4*>(src - gc - 16);
          const uint4 b = *reinterpret_cast<const uint4*>(src - gc);
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(__byte_perm(a.w, b.x, 0x1234), __byte_perm(a.z, a.w, 0x1234),
                         __byte_perm(a.y, a.z, 0x1234), __byte_perm(a.x, a.y, 0x1234));
        } else if (vec && gc >= w && gc <= 2 * w - 32) {
          // right of it: x[2(w - 1) - gc - k], out of the aligned words at
          // 2w - 32 - gc and 2w - 16 - gc
          const uint4 a = *reinterpret_cast<const uint4*>(src + 2 * w - 32 - gc);
          const uint4 b = *reinterpret_cast<const uint4*>(src + 2 * w - 16 - gc);
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(__byte_perm(b.z, b.w, 0x3456), __byte_perm(b.y, b.z, 0x3456),
                         __byte_perm(b.x, b.y, 0x3456), __byte_perm(a.w, b.x, 0x3456));
        } else {
          unsigned v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            unsigned word = 0;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              word |= static_cast<unsigned>(src[reflect101(gc + 4 * q + b, w)]) << (8 * b);
            }
            v[q] = word;
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    cp_async_commit();
  };
  load(0);
  load(1);

  // the four shifted copies of each digit's taps (after delta zeros): word
  // i of copy c starts at tap 4i + c - 16 - delta = 4 (i + wb) + rb + c, so
  // the three tap words from i + wb cover the four copies' word i
  const int nqw = round4(2 * rw + 1) >> 2;
  const int wb = (-16 - geo.delta) >> 2, rb = (-16 - geo.delta) & 3;
  for (int i = tid; i < geo.words; i += kThreads) {
    unsigned tw[2][3];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int wi = i + wb + k;
        tw[d][k] = (wi >= 0 && wi < nqw) ? static_cast<unsigned>(taps[d * nqw + wi]) : 0u;
      }
    }
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = rb + c;  // 0..6: words t >> 2 and (t >> 2) + 1 of the three
        const bool up = t >= 4;
        s_q[(4 * d + c) * geo.words + i] =
            __funnelshift_r(up ? tw[d][1] : tw[d][0], up ? tw[d][2] : tw[d][1], 8 * (t & 3));
      }
    }
  }
  // Q = sum q = 128 sum q_hi + sum q_lo (every lane of every warp)
  int qsum = 0;
  for (int k = lane; k < 2 * nqw; k += 32) {
    qsum += __dp4a(taps[k], 0x01010101, 0) * (k < nqw ? 128 : 1);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) qsum += __shfl_xor_sync(0xffffffffu, qsum, o);

  // A: row m = g of the block, taps 32s + 4 tig - g (+ 0, -8, +16, +8 for
  // the four registers), all in the copy (4 tig - g) mod 4
  const int g = lane >> 2, tig = lane & 3;
  const int b0 = 4 * tig - g + 16;
  const unsigned* qh = s_q + (b0 & 3) * geo.words + (b0 >> 2);
  const unsigned* ql = qh + 4 * geo.words;
  // B: ldmatrix x4 of rows 16p + (0..15) at columns 16 warp + 32s + (0, 16)
  const int lrow = ((lane >> 4) << 3) + (lane & 7);
  const int lcol = 16 * warp + (((lane >> 3) & 1) << 4);
  const unsigned xa = smem_u32(s_x) + lrow * kRowsPitch;
  int acc_h[8][4], acc_l[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int v = 0; v < 4; ++v) acc_h[n][v] = acc_l[n][v] = 0;
  }
  const int nch = (geo.steps + 7) / 8;
  for (int ch = 0; ch < nch; ++ch) {
    load(ch + 2);         // into the ring slot chunk ch - 1 held
    cp_async_wait<1>();   // chunks ch and ch + 1 landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    const int s_end = min(8 * ch + 8, geo.steps);
    for (int s = 8 * ch; s < s_end; ++s) {
      const unsigned ah[4] = {qh[8 * s], qh[8 * s - 2], qh[8 * s + 4], qh[8 * s + 2]};
      const unsigned al[4] = {ql[8 * s], ql[8 * s - 2], ql[8 * s + 4], ql[8 * s + 2]};
      const unsigned xs = xa + ((lcol + 32 * s) & (kRowsRing - 1));
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unsigned b[4];
        ldsm_x4(xs + p * 16 * kRowsPitch, b);
        mma_s8u8(acc_h[2 * p], ah, b[0], b[1]);
        mma_s8u8(acc_l[2 * p], al, b[0], b[1]);
        mma_s8u8(acc_h[2 * p + 1], ah, b[2], b[3]);
        mma_s8u8(acc_l[2 * p + 1], al, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: stage the outputs there

  // R = 128 (hi - 128 Q_hi) + (lo - 128 Q_lo), exact modulo 2^32
  const unsigned off = 128u * static_cast<unsigned>(qsum);
  constexpr int kPitchE = kRowsTn + 8, kPitchF = kRowsTn + 4;
  int16_t* s_e = reinterpret_cast<int16_t*>(smem);
  float* s_f = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int rr = 8 * n + 2 * tig + (v & 1);
      const int cc = 16 * warp + g + 8 * (v >> 1);
      const int r = static_cast<int>(128u * static_cast<unsigned>(acc_h[n][v]) +
                                     static_cast<unsigned>(acc_l[n][v]) - off);
      if (out_e32) {
        s_e[rr * kPitchE + cc] = static_cast<int16_t>(asr(r + (1 << (rows_shift - 1)), rows_shift));
      } else {
        s_f[rr * kPitchF + cc] = __fmaf_rn(__int2float_rn(r), inv_scale, 128.0f);
      }
    }
  }
  __syncthreads();
  for (int k = tid; k < kRowsTr * kRowsTn; k += kThreads) {
    const int rr = k / kRowsTn, cc = k % kRowsTn;
    const int gi = i0 + rr, gj = j0 + cc;
    if (gi >= h || gj >= w) continue;
    const size_t o = plane + static_cast<size_t>(gi) * w + gj;
    if (out_e32) {
      static_cast<int16_t*>(out)[o] = s_e[rr * kPitchE + cc];
    } else {
      static_cast<float*>(out)[o] = s_f[rr * kPitchF + cc];
    }
  }
}

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32
__device__ __forceinline__ void mma_s8s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four rows of two int16 columns (v[i]: row i, the first column low) ->
// for each column, the word of its four rows' base-128 digits, row i in
// byte i: d1 = e1 = asr(E + 64, 7), d0 = e0 = E - 128 e1 (as bytes). With t
// = E + 64 (offset by 2^15 a half so that no carry crosses the halves),
// e1's byte is bits 7..14 of t and e0's is E's low byte with bit 7 flipped
// where bit 7 of t is set; __byte_perm gathers byte 0 (or 2) of each row.
__device__ __forceinline__ void split_digits(const unsigned (&v)[4], unsigned (&d1)[2],
                                             unsigned (&d0)[2]) {
  unsigned a1[4], a0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned t = (v[i] ^ 0x80008000u) + 0x00400040u;
    a1[i] = t >> 7;
    a0[i] = v[i] ^ (t & 0x00800080u);
  }
  const unsigned h1 = __byte_perm(a1[0], a1[1], 0x6240), l1 = __byte_perm(a1[2], a1[3], 0x6240);
  const unsigned h0 = __byte_perm(a0[0], a0[1], 0x6240), l0 = __byte_perm(a0[2], a0[3], 0x6240);
  d1[0] = __byte_perm(h1, l1, 0x5410);
  d1[1] = __byte_perm(h1, l1, 0x7632);
  d0[0] = __byte_perm(h0, l0, 0x5410);
  d0[1] = __byte_perm(h0, l0, 0x7632);
}

template <bool kOutU8>
__global__ void __launch_bounds__(kColsThreads)
split_cols_int8_kernel(const int16_t* __restrict__ e, void* __restrict__ out,
                       const int* __restrict__ taps, int h, int w, int rh,
                       int pre, float c1, float c2, float c3) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RowsGeometry geo = cols_geometry(rh);
  unsigned char* s_d = smem;  // digit planes e1 | e0: [column][ring row] bytes
  unsigned char* s_stage = smem + 2 * kColsPlane;  // per thread: 4 rows x 8 int16
  unsigned* s_q = reinterpret_cast<unsigned*>(s_stage + kThreads * kColsStage);  // [digit][copy][word]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mg = warp & 7, ng = (warp >> 3) * kColsNb;  // rows 32 mg .., n blocks ng ..
  const bool stager = tid < kThreads;  // the first 256 threads fetch and convert
  const int tiles_w = (w + kColsTw - 1) / kColsTw;
  const int i0 = (blockIdx.x / tiles_w) * kColsTh;
  const int j0 = (blockIdx.x % tiles_w) * kColsTw;
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  const int xh = pre ? h + 2 * rh : h;  // rows of an input plane
  const int16_t* ep = e + static_cast<size_t>(blockIdx.y) * xh * w;
  // window rows the warps read: 32 mg + 32 s + (0..47)
  const int nload = (32 * geo.steps + kColsTh - 16 + kColsLoad - 1) / kColsLoad;
  const bool vec = ((reinterpret_cast<uintptr_t>(e) & 15) | (w & 7)) == 0;

  // A thread fetches and converts rows 4 qd .. 4 qd + 3 x columns 8 cs ..
  // 8 cs + 7 of each chunk (lanes l and l ^ 1 on one 32-byte sector).
  const int cs = (lane & 1) + 2 * (warp & 1);
  const int qd = (lane >> 1) + 16 * (warp >> 1);
  const int gjf = j0 + 8 * cs;
  unsigned char* st = s_stage + tid * kColsStage;

  // window rows [256c, 256c + 256) (window row 0: the input row of output
  // row i0's first tap) as int16 into this thread's staging slots
  auto fetch = [&](int c) {
    if (stager && c < nload) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int16_t* src = ep + static_cast<size_t>(src_row(
                                      i0 - rh + c * kColsLoad + 4 * qd + i, h, rh, xh, pre)) * w;
        if (vec && gjf + 8 <= w) {
          cp_async16(smem_u32(st + 16 * i), src + gjf);
        } else {
          int16_t* dst = reinterpret_cast<int16_t*>(st + 16 * i);
#pragma unroll
          for (int q = 0; q < 8; ++q) dst[q] = src[min(gjf + q, w - 1)];
        }
      }
    }
    cp_async_commit();
  };
  // this thread's slots (only its own copies need to have landed) as digit
  // words into ring slot c mod 3
  auto convert = [&](int c) {
    cp_async_wait<0>();
    if (stager && c < nload) {
      unsigned v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 u = *reinterpret_cast<const uint4*>(st + 16 * i);
        v[0][i] = u.x;
        v[1][i] = u.y;
        v[2][i] = u.z;
        v[3][i] = u.w;
      }
      const int rr = (c % 3) * kColsLoad + 4 * qd;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unsigned d1[2], d0[2];
        split_digits(v[p], d1, d0);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = cols_col(8 * cs + 2 * p + u) + rr;
          *reinterpret_cast<unsigned*>(s_d + col) = d1[u];
          *reinterpret_cast<unsigned*>(s_d + kColsPlane + col) = d0[u];
        }
      }
    }
  };
  fetch(0);

  // the four shifted copies of each digit's taps: word i of copy c starts
  // at tap 4i + c - 16, so the tap words i - 4 and i - 3 cover it
  const int nqw = round4(2 * rh + 1) >> 2;
  for (int i = tid; i < geo.words; i += kColsThreads) {
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int wi = i - 4;
      const unsigned lo = (wi >= 0 && wi < nqw) ? static_cast<unsigned>(taps[d * nqw + wi]) : 0u;
      const unsigned hi =
          (wi + 1 >= 0 && wi + 1 < nqw) ? static_cast<unsigned>(taps[d * nqw + wi + 1]) : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) s_q[(4 * d + c) * geo.words + i] = __funnelshift_r(lo, hi, 8 * c);
    }
  }
  convert(0);
  fetch(1);
  convert(1);
  fetch(2);
  __syncthreads();

  // A: row m = g of a block, taps 32s + 4 tig - g (+ 0, -8, +16, +8 for the
  // four registers), all in the copy (4 tig - g) mod 4
  const int g = lane >> 2, tig = lane & 3;
  const int b0 = 4 * tig - g + 16;
  const unsigned* qh = s_q + (b0 & 3) * geo.words + (b0 >> 2);
  const unsigned* ql = qh + 4 * geo.words;
  // B of n-block n: 16 window rows x columns 8n .. 8n + 7 of a digit plane
  // a matrix. Block 0 of the warp (rows 32 warp + 0..15) takes, at step s,
  // window rows 32 warp + 32s + (0..15) (M0) and + (16..31) (M1); block 1
  // takes M1 and M2 (+ 32..47), which is the next step's M0. ldmatrix x4 per
  // n-block and step: e1 M1, e1 M2, e0 M1, e0 M2 (lanes 8 mi + (0..7)).
  const int mi = lane >> 3;
  const unsigned sd = smem_u32(s_d);
  unsigned baddr[kColsNb], m0[kColsNb][2];
#pragma unroll
  for (int n = 0; n < kColsNb; ++n) {
    baddr[n] = sd + (mi >> 1) * kColsPlane + cols_col(8 * (ng + n) + (lane & 7));
  }
#pragma unroll
  for (int q = 0; q < kColsNb / 2; ++q) {  // M0 of step 0: e1, e0 of n-blocks 2q and 2q + 1
    unsigned r[4];
    ldsm_x4(sd + (mi & 1) * kColsPlane +
                cols_col(8 * (ng + 2 * q + (mi >> 1)) + (lane & 7)) + 32 * mg, r);
    m0[2 * q][0] = r[0];
    m0[2 * q][1] = r[1];
    m0[2 * q + 1][0] = r[2];
    m0[2 * q + 1][1] = r[3];
  }
  int acc[2][kColsNb][3][4];  // [m block][n block][p1, p23, p4][fragment]
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int n = 0; n < kColsNb; ++n) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[b][n][k][v] = 0;
      }
    }
  }
  const bool active = i0 + 32 * mg < h;  // a ragged last tile leaves warps idle
  int roff = 32 * mg + 16 + 16 * (mi & 1);  // ring row of this lane's matrix at step 0
  const int nch = (geo.steps + 7) / 8;
  for (int ch = 0; ch < nch; ++ch) {
    const int s_end = min(8 * ch + 8, geo.steps);
    if (active) {
      for (int s = 8 * ch; s < s_end; ++s) {
        const unsigned ah[4] = {qh[8 * s], qh[8 * s - 2], qh[8 * s + 4], qh[8 * s + 2]};
        const unsigned al[4] = {ql[8 * s], ql[8 * s - 2], ql[8 * s + 4], ql[8 * s + 2]};
        const int rs = roff >= kColsRing ? roff - kColsRing : roff;
#pragma unroll
        for (int n = 0; n < kColsNb; ++n) {
          unsigned b[4];
          ldsm_x4(baddr[n] + rs, b);
          mma_s8s8(acc[0][n][0], ah, m0[n][0], b[0]);
          mma_s8s8(acc[1][n][0], ah, b[0], b[1]);
          mma_s8s8(acc[0][n][1], ah, m0[n][1], b[2]);
          mma_s8s8(acc[1][n][1], ah, b[2], b[3]);
          mma_s8s8(acc[0][n][2], al, m0[n][1], b[2]);
          mma_s8s8(acc[1][n][2], al, b[2], b[3]);
          mma_s8s8(acc[0][n][1], al, m0[n][0], b[0]);
          mma_s8s8(acc[1][n][1], al, b[0], b[1]);
          m0[n][0] = b[1];
          m0[n][1] = b[3];
        }
        roff = rs + 32;
      }
    } else {
      roff += 32 * (s_end - 8 * ch);
    }
    convert(ch + 2);  // into the ring slot chunk ch - 1 held
    __syncthreads();
    fetch(ch + 3);    // the staging slots are free
  }
  cp_async_wait<0>();

  // the epilogue through shared memory (the ring is free), then coalesced
  // rows of 32 columns
  constexpr int kPitchU8 = kColsTw + 4, kPitchF = kColsTw + 4;
  uint8_t* s_u8 = smem;
  float* s_f = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int n = 0; n < kColsNb; ++n) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int rr = 32 * mg + 16 * b + g + 8 * (v >> 1);
        const int cc = 8 * (ng + n) + 2 * tig + (v & 1);
        const float y = int8_epilogue<kOutU8>(acc[b][n][0][v], acc[b][n][1][v],
                                              acc[b][n][2][v], c1, c2, c3);
        if (kOutU8) {
          s_u8[rr * kPitchU8 + cc] = store_u8(y);
        } else {
          s_f[rr * kPitchF + cc] = y;
        }
      }
    }
  }
  __syncthreads();
  const int rows = min(kColsTh, h - i0), cols = min(kColsTw, w - j0);
  for (int k = tid; k < rows * kColsTw; k += kColsThreads) {
    const int rr = k / kColsTw, cc = k % kColsTw;
    if (cc >= cols) continue;
    const size_t o = plane + static_cast<size_t>(i0 + rr) * w + j0 + cc;
    if (kOutU8) {
      static_cast<uint8_t*>(out)[o] = s_u8[rr * kPitchU8 + cc];
    } else {
      static_cast<float*>(out)[o] = s_f[rr * kPitchF + cc];
    }
  }
}

template <bool kOutU8>
__global__ void __launch_bounds__(kThreads, 2)
split_cols_hybrid_kernel(const int16_t* __restrict__ e, void* __restrict__ out,
                         const float* __restrict__ taps, int h, int w, int rh,
                         int pre, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = hyb_groups(rh), steps = groups + 15;
  unsigned char* s_y = smem;  // the bf16 ring: kHybRing rows x kHybPitch
  int16_t* s_raw = reinterpret_cast<int16_t*>(smem + kHybRing * kHybPitch * 2);
  unsigned* s_c = reinterpret_cast<unsigned*>(smem + kHybRing * kHybPitch * 2 +
                                              kHybLoad * kHybTw * 2);  // [group + 15][12 words]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_w = (w + kHybTw - 1) / kHybTw;
  const int i0 = (blockIdx.x / tiles_w) * kHybTh;
  const int j0 = (blockIdx.x % tiles_w) * kHybTw;
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  const int xh = pre ? h + 2 * rh : h;  // rows of an input plane
  const int16_t* ep = e + static_cast<size_t>(blockIdx.y) * xh * w;
  const int nload = (16 * steps + 15 + kHybLoad - 1) / kHybLoad;
  const bool vec = ((reinterpret_cast<uintptr_t>(e) & 15) | (w & 7)) == 0;

  // window rows [128c, 128c + 128) (window row 0: the input row of output
  // row i0's first tap) as int16 into the staging chunk; convert() then
  // writes them as bf16 into the ring. Each thread converts the elements it
  // fetched, so only its own copies need to have landed.
  auto fetch = [&](int c) {
    for (int k = tid; k < kHybLoad * (kHybTw / 8); k += kThreads) {
      const int rr = k >> 3, gj = j0 + ((k & 7) << 3);
      const int16_t* src = ep + static_cast<size_t>(src_row(i0 - rh + c * kHybLoad + rr, h, rh,
                                                            xh, pre)) * w;
      int16_t* dst = s_raw + rr * kHybTw + ((k & 7) << 3);
      if (vec && gj + 8 <= w) {
        cp_async16(smem_u32(dst), src + gj);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) dst[q] = src[min(gj + q, w - 1)];
      }
    }
    cp_async_commit();
  };
  auto convert = [&](int c) {
    cp_async_wait<0>();
    for (int k = tid; k < kHybLoad * (kHybTw / 8); k += kThreads) {
      const int rr = k >> 3;
      const uint4 v = *reinterpret_cast<const uint4*>(s_raw + rr * kHybTw + ((k & 7) << 3));
      const uint4 y = make_uint4(bf16x2_of_i16x2(v.x), bf16x2_of_i16x2(v.y),
                                 bf16x2_of_i16x2(v.z), bf16x2_of_i16x2(v.w));
      *reinterpret_cast<uint4*>(s_y + ((c * kHybLoad + rr) % kHybRing) * (2 * kHybPitch) +
                                ((k & 7) << 4)) = y;
    }
  };
  fetch(0);
  // the tap groups -15 .. groups + 14 (zero outside 0 .. groups - 1) as bf16
  // pairs, word p of stored group gs at 12 gs + p
  for (int k = tid; k < (groups + 30) * 8; k += kThreads) {
    const int gs = k >> 3, p = k & 7;
    const int t = 16 * (gs - 15) + 2 * p;
    const float c0 = (t >= 0 && t <= 2 * rh) ? taps[t] : 0.0f;
    const float c1 = (t + 1 >= 0 && t + 1 <= 2 * rh) ? taps[t + 1] : 0.0f;
    s_c[kHybGroupWords * gs + p] = bf16_bits(c0) | (bf16_bits(c1) << 16);
  }
  convert(0);
  if (nload > 1) {
    fetch(1);
    convert(1);
  }
  __syncthreads();

  const int g = lane >> 2, tig = lane & 3;
  const int f = warp;  // fragments f and f + 8
  // A: row m = g takes group s - g (stored at s - g + 15), row g + 8 group
  // s - g - 8, words tig and tig + 4 of each
  const unsigned* ca = s_c + kHybGroupWords * (15 - g) + tig;
  const unsigned ya = smem_u32(s_y);
  // B of fragment f at step s: rows f + 16s + (0..7) (x0) and + (8..15)
  // (x1); of fragment f + 8: x1 and rows f + 16s + (16..23) (x2, the next
  // step's x0). ldmatrix.trans x4 per pair of n-blocks: x1, x2, x1, x2.
  unsigned x0[8];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    unsigned r[4];
    ldsm_x4_t(ya + (f + (lane & 7)) * (2 * kHybPitch) + 16 * (4 * q + (lane >> 3)), r);
#pragma unroll
    for (int v = 0; v < 4; ++v) x0[4 * q + v] = r[v];
  }
  const int lrow = f + 8 + (((lane >> 3) & 1) << 3) + (lane & 7);
  const int lcol = (lane >> 4) << 4;
  float acc[2][8][4];
#pragma unroll
  for (int fi = 0; fi < 2; ++fi) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[fi][n][v] = 0.0f;
    }
  }
  const int nch = (steps + 7) / 8;
  for (int ch = 0; ch < nch; ++ch) {
    const bool more = ch + 2 < nload;
    if (more) fetch(ch + 2);
    const int s_end = min(8 * ch + 8, steps);
    for (int s = 8 * ch; s < s_end; ++s) {
      const unsigned* cs = ca + kHybGroupWords * s;
      const unsigned a[4] = {cs[0], cs[-8 * kHybGroupWords], cs[4], cs[4 - 8 * kHybGroupWords]};
      const unsigned yr = ya + ((lrow + 16 * s) % kHybRing) * (2 * kHybPitch) + lcol;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned r[4];
        ldsm_x4_t(yr + 32 * q, r);
        mma_bf16(acc[0][2 * q], a, x0[2 * q], r[0]);
        mma_bf16(acc[1][2 * q], a, r[0], r[1]);
        mma_bf16(acc[0][2 * q + 1], a, x0[2 * q + 1], r[2]);
        mma_bf16(acc[1][2 * q + 1], a, r[2], r[3]);
        x0[2 * q] = r[1];
        x0[2 * q + 1] = r[3];
      }
    }
    if (more) convert(ch + 2);  // into the ring slot chunk ch - 1 held
    __syncthreads();
  }

  // fragment row m: output row i0 + f' + 16m; columns 8n + 2 tig, + 1
#pragma unroll
  for (int fi = 0; fi < 2; ++fi) {
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int gi = i0 + f + 8 * fi + 16 * (g + 8 * hv);
      if (gi >= h) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int gj = j0 + 8 * n + 2 * tig;
        if (gj >= w) continue;
        const float y0 = __fmaf_rn(acc[fi][n][2 * hv], scale, 128.0f);
        const float y1 = __fmaf_rn(acc[fi][n][2 * hv + 1], scale, 128.0f);
        const size_t o = plane + static_cast<size_t>(gi) * w + gj;
        const bool pair = gj + 1 < w;
        if (kOutU8) {
          uint8_t* op = static_cast<uint8_t*>(out) + o;
          if (pair && !(w & 1)) {
            *reinterpret_cast<uint16_t*>(op) =
                static_cast<uint16_t>(store_u8(y0) | (store_u8(y1) << 8));
          } else {
            op[0] = store_u8(y0);
            if (pair) op[1] = store_u8(y1);
          }
        } else {
          float* op = static_cast<float*>(out) + o;
          if (pair && !(w & 1)) {
            *reinterpret_cast<float2*>(op) = make_float2(y0, y1);
          } else {
            op[0] = y0;
            if (pair) op[1] = y1;
          }
        }
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
  const int smem = rows_smem(rw);
  if (smem > limit || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t cerr = cudaFuncSetAttribute(
      split_rows_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  dim3 grid((w + kRowsTn - 1) / kRowsTn, (h + kRowsTr - 1) / kRowsTr, planes);
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
  const int smem = cols_smem(rh);
  if (smem > limit || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((w + kColsTw - 1) / kColsTw) * ((h + kColsTh - 1) / kColsTh);
  dim3 grid(tiles, planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = out_u8 ? split_cols_int8_kernel<true> : split_cols_int8_kernel<false>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  kernel<<<grid, kColsThreads, smem, st>>>(static_cast<const int16_t*>(e), out,
                                       static_cast<const int*>(taps), h, w, rh,
                                       pre, c1, c2, c3);
  return static_cast<int>(cudaGetLastError());
}

// The hybrid pass 2. e: planes x h x w int16 E, or planes x (h + 2rh) x w
// (pre = 1, as above); out: planes x h x w uint8 (out_u8 = 1) or float.
// taps: float [t4h], the bf16-rounded column taps zero-padded to a multiple
// of 4; scale: f32(1 / 127). Returns the cudaError_t of the launch.
extern "C" int fused_split_cols_hybrid(const void* e, void* out, const void* taps,
                                       int planes, int h, int w, int rh,
                                       int out_u8, int pre, float scale,
                                       void* stream) {
  int limit = 0;
  int err = smem_limit(&limit);
  if (err) return err;
  const int smem = hyb_smem(rh);
  if (smem > limit || planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((w + kHybTw - 1) / kHybTw) * ((h + kHybTh - 1) / kHybTh);
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
