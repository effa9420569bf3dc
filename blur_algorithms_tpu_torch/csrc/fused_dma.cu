// Fused separable Gaussian blur of uint8 planes (K1): the int8, hybrid and
// bf16 rungs of the precision ladder, in five staging forms that share the
// bodies.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_dma.py:_kernel_direct
// (1023; the direct form) and the same file's _kernel_strip (285; the strip
// form K1s), _kernel (223) and _kernel_pipe (899; the assembled form K1a
// and its pipelined variant) and _kernel_resident (604; the rows-resident
// form K1r), with their tile bodies _rows_int8 (1200), _cols_int8 (1262),
// _tile_hybrid (1306) and _tile_bf16 (1415); and the assembly kernels A5
// and A4 that feed K1a (_assemble_padded and _assemble_padded_prepad, at
// the end of this file; A4 reads the shard's rows in place, from up to
// three row segments). K1a on A4's frame is the JAX rows_prepadded mode
// (blur_fused_haloed_dma, 2589): the caller's halo rows sit where A5 puts
// reflected rows, so the kernel is the same.
//
// The three bodies are band products on the tensor cores, as the JAX bodies
// are band matmuls on the MXU (the two-pass split's passes,
// csrc/fused_split.cu, share the design):
//
// - rows pass (both bodies, rows_mma): R = sum_t q[t] * (x[j - rw + t] -
//   128), q = 128 q_hi + q_lo, on mma.sync.m16n8k32.row.col.s32.s8.u8.s32.
//   A (16 x 32, s8) is the band of one tap digit, A[m][k] = q[32s + k - m]
//   for 16 output columns and k-step s, from four byte-shifted copies of
//   each digit's taps in shared memory (each A register one aligned 32-bit
//   load); B (32 x 8, u8) is 8 staged rows x 32 window columns of the RAW
//   bytes, fed by ldmatrix. The recentring is one subtraction, R = 128 (hi
//   - 128 Q_hi) + lo - 128 Q_lo (Q the digits' sums), exact in int32. The
//   accumulator (output column m, row n) goes straight into the rows-output
//   plane: int8, the base-128 digits e1 = (E + 64) >> 7, e0 = E - 128 e1 of
//   E = (R + 2^(s-1)) >> s in column-major digit planes; hybrid, y =
//   bf16(f32(R)) in a row-major plane.
// - int8 cols pass (cols_int8_mma): p1 = sum b_hi e1, p23 = sum b_hi e0 +
//   b_lo e1, p4 = sum b_lo e0 as four digit products on
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32, A the band of one column-tap
//   digit (the rows pass's copies with no leading zeros), B 32 plane rows x
//   8 columns of one digit: the digits are column-major, so non-transposed
//   ldmatrix gives the .col fragment. A warp takes two 16-row blocks whose
//   windows are 16 rows apart, so a step's ldmatrix x4 brings two new
//   16-row matrices of each digit and the third carries over. Then the
//   epilogue y = f32(p1)*c1 + f32(p23)*c2 + f32(p4)*c3 + 128
//   (int8_epilogue), and clip(y + 0.5, 0, 255.5) truncated, or y itself as
//   f32 (the JAX _compute_store with out_u8=False, which the sharded path
//   asks for). For the uint8 store every product and sum of the epilogue
//   is rounded on its own (__fmul_rn/__fadd_rn, and the build passes
//   --fmad=false); the f32 store rounds as XLA compiles the JAX expression
//   when the kernel is interpreted on an FMA host, fma(p4, c3, fma(p23, c2,
//   p1 * c1)) + 128. Every product and sum before it is an exact integer,
//   so both stores are bit-identical to the plain version and to the JAX
//   kernel in interpret mode, in every form and at every tiling.
// - hybrid cols pass (cols_hybrid_mma): acc = sum_t bf16(c_t) y[t] in f32
//   on mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, out = fma(acc, 1 /
//   (127 * 2^s), 128). The tensor core sums a k-step's 16 products in its
//   own order and rounding, so an output's f32 result depends on how its
//   taps are grouped into k-steps. Every output row sums its taps in the
//   aligned groups of 16 of its OWN tap index, [16 g, 16 g + 16), tap t at
//   lane t - 16 g, in ascending g: a fragment's 8 n-rows are output rows
//   f + 16 n (16 apart), A (16 x 16) is 16 columns x the 16 plane rows from
//   f + 16 s (ldmatrix.trans of the row-major y), and B the
//   block-Toeplitz taps, B[k][n] = c[16 (s - n) + k], the same for every
//   fragment, so row f + 16 n takes group s - n at step s. Nothing depends
//   on where a tile, a strip window, K1r's ring step or a shard starts: all
//   five forms are bit-identical to each other, and K1a on A4's caller rows
//   to the single-card call. Against the plain version
//   (blur_fused_u8_hybrid_ref, tap by tap in ascending order) it agrees
//   within 2e-2 at 0..255 scale on the f32 store and 1 count on the uint8
//   store, the contract of the split's hybrid pass 2.
// - bf16 rows pass (rows_bf16_mma): y = bf16(sum_t bf16(r_t) * x[j - rw +
//   t]) on mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, A (16 x 16) the band
//   of the bf16 row taps from the host's table (two copies, one for each
//   parity of a tap pair's first index, so each A register is one aligned
//   32-bit load), B (16 x 8) the staged RAW bytes of 8 rows converted to bf16
//   as the fragment is built (one 32-bit load of 4 window bytes a lane;
//   every byte is exact in bf16). A lane's k = 2 tig, 2 tig + 1 take window
//   bytes 4 tig, 4 tig + 1 and k = 2 tig + 8, + 9 bytes 4 tig + 2, + 3; the
//   table pairs the taps the same way. The f32 sum depends on which taps
//   share a k-step, so every form groups them alike: a k-step is 16 window
//   bytes starting on a 16-byte boundary of the IMAGE row (delta leading
//   zero taps in all three forms; the assembled form, whose frame holds
//   the plane at column rw, reads its staged bytes delta to the left, the
//   bytes before its window meeting zero taps). y goes into the hybrid
//   body's row-major bf16 plane.
// - bf16 cols pass: the hybrid body's (cols_hybrid_mma) on the bf16 column
//   taps, with no epilogue: out = acc. Against the plain version
//   (blur_fused_u8_bf16_ref, both sums tap by tap in ascending order) the
//   rows sum changes order, and where y lies within that sum's rounding of a
//   bf16 rounding boundary it can round to the other bf16 neighbour (a step
//   of 1.0 for y in [128, 256)), which moves every output that reads it by
//   that step times its tap: the bound is 2e-2 at 0..255 scale plus, for
//   each output, its taps times the steps of those y it reads
//   (cuda_kernels/fused_dma.py, bf16_bound), on the f32 store; 1 count on
//   the uint8 store. Its forms are bit-identical to each other.
//
// The forms differ only in the loader and in where the rows output lives.
// One block of 256 threads per:
//
// - direct (K1), (plane, th x tw output tile): stages its round16(th + 2rh)
//   window rows in groups of stage_rows(tw) rows, two groups in flight. The rows
//   taps get (-rw) mod 16 leading zeros, so every window starts on a
//   16-byte boundary of the image row: interior segments are 16-byte
//   cp.async copies, segments past the frame's edge the two aligned words
//   they mirror, byte-reversed with __byte_perm; reflect-101 byte loads are
//   left for rows that are not 16-byte aligned and windows past one
//   reflection (load_window). Rows are reflect-101 index math.
// - strip (K1s), (plane, row strip): walks the strip's column windows left
//   to right with the whole window staged, and carries its last columns to
//   the next window (16-byte shared-memory moves), so each input byte of the
//   strip is read from global memory once.
// - assembled (K1a), (plane, tile): reads plain rectangles of A5's padded
//   frame (the plane at (rh, rw), rows 16-byte aligned, so every window
//   starts on a 16-byte boundary with no leading zero taps) with 16-byte
//   cp.async, no index math, slots - 1 row groups in flight, the bytes
//   staged as they are. The pipelined variant (int8) walks `seg` windows of
//   a strip per block and runs window j's rows pass and a slice of window
//   j-1's cols pass between the same barriers, on double-buffered planes.
// - resident (K1r), (plane, column window): walks down the frame th new
//   rows a step, the rows output of the last round16(th + 2rh) rows
//   resident in a ring of as many rows, so every rows value is computed
//   once. The ring's length and every chunk a cols fragment reads are
//   multiples of 16 rows, so no fragment straddles the wrap.
//
// What bounds them on an H100: bytes would, 1 in and 1 out a pixel (0.0594
// ms for 12 planes of 2160 x 3840), and the band products are ~0.03 ms at
// the tensor cores' int8 and bf16 peaks at r 32 (the bf16 rows pass twice
// the hybrid's: bf16 mma at half the int8 rate, and a conversion a byte a
// fragment). The design keeps the rest
// off the path: the loader is 16-byte copies (no recentring), the
// fragments come from shared memory by ldmatrix, the tap copies make every
// A register one load. What is left is the halo (a direct tile stages (1 +
// 2rh/th) rows and computes their rows pass), the band's zero taps (the
// int8 passes round to 32 a step, the hybrid cols pass reads groups + 7
// steps of 16 for `groups` tap groups: ~2.9x the taps at r 32), mma.sync's
// rate below wgmma's, and latency: measured on an NVIDIA H100 80GB HBM3 at
// 700 W (probes/k1_tc_ablation.py), the hybrid direct form takes 0.44 ms
// at r 32 on that batch, its loader alone 0.09-0.17, rows pass alone
// 0.18, cols pass alone 0.26, the parts overlapping; on a dp 2 x sp 2
// shard K1a takes 0.14 ms, each part alone nearly as long and the blocks
// with none of them (setup, barriers, loops) half of it: its 1,800 blocks'
// latency, not one unit, sets it.
//
// The loaders' probe (B3, csrc/probes/fetch_rate.cu) includes this file
// with FUSED_DMA_LOADERS_ONLY defined: the helpers, layouts and loaders
// above the bodies and nothing else, so that it times the staging code K1
// runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the int8 and hybrid forms' blocks an SM, for the registers' launch bound:
// hybrid 3 (80 registers a thread, a few spilled words; 0.4445 against
// 0.4916 ms uncapped for K1 hybrid direct at 4K r 32), int8 2 (its cols
// pass keeps 48 accumulators; capped at 80 it spills up to 208 bytes and
// ran slower), probes/k1_tc_ablation.py on an H100
template <int B>
constexpr int kTcBlocks = B == 0 ? 2 : 3;
constexpr int kNoRing = 0;

enum Body { kInt8 = 0, kHybrid = 1, kBf16 = 2 };
enum Form { kDirect = 0, kStrip = 1, kAssembled = 2, kPipelined = 3, kResident = 4 };

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// the least odd multiple of 16 bytes >= n: eight rows at that stride fall
// on eight different bank groups (ldmatrix's eight row addresses)
__host__ __device__ inline int odd16(int n) {
  n = round16(n);
  return (n >> 4) & 1 ? n : n + 16;
}

// words of each of a digit's four shifted tap copies for `steps` k-steps:
// 8 a step and 4 more, a count = 8 (mod 32) so the four copies fall on
// different banks
__host__ __device__ inline int copy_words(int steps) {
  const int need = 8 * steps + 4;
  return need + ((8 - need) % 32 + 32) % 32;
}

// words of each of the bf16 rows taps' two copies for `steps` k-steps of
// 16: 8 a step and 16 more, a count = 16 (mod 32) so the two copies' words
// a load reads fall on different banks
__host__ __device__ inline int bf16_words(int steps) {
  const int need = 8 * steps + 16;
  return need + ((16 - need) % 32 + 32) % 32;
}

// ---- the layouts: the wrappers (cuda_kernels/fused_dma.py, layout_bytes)
// size the tiles with the same formulas and pass their total, which the
// launch checks ----

// Rows a staged group of the int8 and hybrid bodies: 4096 / tw (four rows
// units of 16 columns x 8 rows a warp), halved while two groups would pass
// kStageBudget, down to one unit a warp (1024 / tw).
constexpr int kStageBudget = 48 * 1024;

__host__ __device__ inline int stage_rows(int tw, int sp) {
  int g = 4096 / tw;
  while (g > 1024 / tw && 2 * g * sp > kStageBudget) g >>= 1;
  return g;
}

// A body's block: the rows-output plane(s), the stage, the tap tables.
struct TcLayout {
  int delta;   // leading zero rows taps: the window's first column is 16-byte aligned
  int rsteps;  // rows k-steps of 32 window columns (bf16: of 16)
  int csteps;  // int8 cols k-steps of 32 plane rows
  int groups;  // hybrid column tap groups of 16
  int sw;      // window bytes a staged row: tw - 16 + 32 rsteps (bf16: 16 rsteps)
  int sp;      // stage pitch
  int g;       // rows a staged group (stage_rows)
  int rows;    // window rows the rows pass computes: round16(th + 2rh); K1r's ring
  int pr;      // plane rows the cols pass reads
  int cs;      // int8: bytes a digit column; hybrid: bytes a y row
  int rwords;  // words of each rows tap copy (four a digit; bf16: two copies)
  int cwords;  // int8: words of each cols tap copy; hybrid: words of the tap groups
  int plane, nplanes, stage, taps, total;
};

__host__ __device__ inline TcLayout tc_layout(int form, int body, int th, int tw, int rh, int rw,
                                              int slots) {
  TcLayout L;
  const bool framed = form == kAssembled || form == kPipelined;
  // bf16 groups its rows taps by image column in every form (its f32 sums)
  L.delta = framed && body != kBf16 ? 0 : (16 - rw % 16) % 16;
  L.rsteps = body == kBf16 ? (L.delta + 2 * rw + 1 + 15 + 15) / 16
                           : (L.delta + 2 * rw + 1 + 15 + 31) / 32;
  L.csteps = (2 * rh + 1 + 15 + 31) / 32;
  L.groups = (2 * rh + 1 + 15) / 16;
  L.sw = tw - 16 + (body == kBf16 ? 16 : 32) * L.rsteps;
  L.sp = odd16(L.sw);
  L.g = stage_rows(tw, L.sp);
  L.rows = round16(th + 2 * rh);
  if (form == kResident) {
    L.pr = L.rows;
  } else if (body == kInt8) {
    L.pr = imax(L.rows, round_up(th, 32) - 16 + 32 * L.csteps);
  } else {
    L.pr = imax(L.rows, round_up(th, 128) + 16 * L.groups);
  }
  if (body == kInt8) {
    L.cs = odd16(L.pr);
    L.plane = 2 * tw * L.cs;
  } else {
    L.cs = 2 * tw + 16;
    L.plane = L.pr * L.cs;
  }
  L.nplanes = form == kPipelined ? 2 : 1;
  L.stage = form == kStrip ? L.rows * L.sp : (framed ? slots : 2) * L.g * L.sp;
  L.rwords = body == kBf16 ? bf16_words(L.rsteps) : copy_words(L.rsteps);
  L.cwords = body == kInt8 ? copy_words(L.csteps) : 12 * (L.groups + 14);
  L.taps = round16(16 + 4 * ((body == kBf16 ? 2 : 8) * L.rwords +
                             (body == kInt8 ? 8 * L.cwords : L.cwords)));
  L.total = L.nplanes * L.plane + L.stage + L.taps;
  return L;
}

// reflect-101 source index; exact for -(n-1) <= i <= 2(n-1), clamped
// beyond (only the padding rows/cols that meet zero taps reach that far)
__device__ __forceinline__ int reflect101(int i, int n) {
  i = abs(i);
  i = i > n - 1 ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned short to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the loaders: raw bytes ----

// Window rows [0, nr) (image rows reflect-101 of row0 + rr) x window bytes
// [c_begin, c_end) (multiples of 16) of a plane, window byte c being image
// column gc0 + c, into staged rows of pitch sp. With `vec` (the planes and
// their rows 16-byte aligned) and gc0 a multiple of 16, every segment lies
// wholly inside the row or wholly past one edge: inside, a 16-byte
// cp.async; past an edge within one reflection, the two aligned words it
// mirrors, byte-reversed; else reflect-101 byte loads.
__device__ __forceinline__ void load_window(unsigned char* st, int sp, const uint8_t* xp, int h,
                                            int w, int row0, int nr, int gc0, int c_begin,
                                            int c_end, bool vec) {
  const int nseg = (c_end - c_begin) >> 4;
  for (int k = threadIdx.x; k < nr * nseg; k += kThreads) {
    const int rr = k / nseg;
    const int c = c_begin + ((k - rr * nseg) << 4);
    const uint8_t* src = xp + static_cast<size_t>(reflect101(row0 + rr, h)) * w;
    unsigned char* dst = st + rr * sp + c;
    const int gc = gc0 + c;
    if (vec && gc >= 0 && gc + 16 <= w) {
      cp_async16(dst, src + gc);
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

// The assembled forms' loader: nr rows x sw bytes of the padded frame from
// `src` (xw bytes a row, 16-byte aligned) into staged rows of pitch sp, by
// 16-byte cp.async.
__device__ __forceinline__ void load_rect(unsigned char* st, int sp, const uint8_t* src, int xw,
                                          int nr, int sw) {
  const int nch = sw >> 4;
  for (int e = threadIdx.x; e < nr * nch; e += kThreads) {
    const int rr = e / nch;
    const int q = e - rr * nch;
    cp_async16(st + rr * sp + (q << 4), src + static_cast<size_t>(rr) * xw + (q << 4));
  }
}

#ifndef FUSED_DMA_LOADERS_ONLY

struct K1Params {
  const uint8_t* x;      // input planes (the padded frame for K1a)
  void* out;             // output planes, h x w
  const int* taps_i;     // the host's tap tables (tc_carve)
  int h, w, rh, rw;      // frame and support radii
  int th, tw, nbh, nbw;  // tile and tile counts
  int seg, nseg;         // K1a: windows per block, blocks per row strip
  int slots;             // K1a: raw row-group buffers (2 or 3), slots - 1 in flight
  int xh, xw;            // rows and row length of an input plane
  int rows_shift;
  float c1, c2, c3, scale;  // int8 epilogue; hybrid scale
};

// ---- the tensor-core bodies ----

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned addr, unsigned (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32
__device__ __forceinline__ void mma_s8s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
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

struct TcSmem {
  unsigned char* plane[2];
  unsigned char* stage;
  const unsigned* qoff;  // 128 Q: the recentring of the raw-byte rows product
  const unsigned* rq;    // rows tap copies: [digit][copy][rwords]
  const unsigned* cq;    // int8: cols tap copies [digit][copy][cwords]; hybrid: tap groups
};

// Carve the block's shared memory and start the copy of its tap tables:
// the host builds them once a plan (cuda_kernels/fused_dma.py,
// tc_tables), L.taps bytes [qoff, 0, 0, 0 | rows copies | cols copies or
// tap groups], and every block copies them with 16-byte cp.async, left
// uncommitted so that the first row group's commit covers them (they are
// there after the first wait and barrier). The copies: word i of copy c of
// a digit holds its taps [4i + c - 16 - delta, 4i + c - 13 - delta], one
// byte each (bf16: word i of copy c holds the bf16 pair of taps 2i + c - 32
// - delta and the next, the first in the low half); the tap groups -7 ..
// groups + 6 are bf16 pairs, word q of stored group gs at 12 gs + q. The
// bf16 y plane's rows past the rows pass's are zeroed: the cols pass reads
// them against zero taps, and an uninitialised word could be a NaN.
template <int B>
__device__ __forceinline__ TcSmem tc_carve(unsigned char* smem, const TcLayout& L,
                                           const K1Params& p) {
  TcSmem s;
  s.plane[0] = smem;
  s.plane[1] = smem + L.plane;
  s.stage = smem + L.nplanes * L.plane;
  unsigned char* tab = s.stage + L.stage;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(p.taps_i);
  for (int k = threadIdx.x; k < L.taps >> 4; k += kThreads) {
    cp_async16(tab + (k << 4), src + (k << 4));
  }
  if (B != kInt8) {
    for (int n = 0; n < L.nplanes; ++n) {
      uint4* tail = reinterpret_cast<uint4*>(s.plane[n] + L.rows * L.cs);
      for (int k = threadIdx.x; k < ((L.pr - L.rows) * L.cs) >> 4; k += kThreads) {
        tail[k] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  s.qoff = reinterpret_cast<const unsigned*>(tab);
  s.rq = s.qoff + 4;
  s.cq = s.rq + (B == kBf16 ? 2 : 8) * L.rwords;
  return s;
}

// four raw bytes v (window bytes 4 tig .. 4 tig + 3 of a staged row) as the
// bf16 rows pass's B fragment: b0 = (byte 0, byte 1) for k = 2 tig, 2 tig +
// 1, b1 = (byte 2, byte 3) for k = 2 tig + 8, + 9. 2^23 + byte as an f32,
// less 2^23, is the byte exactly, and so is its bf16.
__device__ __forceinline__ void bytes_bf16(unsigned v, unsigned& b0, unsigned& b1) {
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + i)), 8388608.0f);
  }
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(b0) : "f"(f[1]), "f"(f[0]));
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(b1) : "f"(f[3]), "f"(f[2]));
}

// The bf16 body's rows pass, as rows_mma: a unit is 16 output columns x 8
// rows; A (row g of the 16 output columns, k-step s of 16 window bytes) is
// read from the table copy of the lane's parity, B from 4 staged bytes a
// lane. kFramed: the assembled form's staged byte b is window byte b +
// delta (its window starts at the frame's tile column), so B is read delta
// bytes to the left, as two aligned words and a funnel shift.
template <bool kFramed>
__device__ __forceinline__ void rows_bf16_mma(const TcSmem& s, const TcLayout& L, int tw,
                                              const unsigned char* st, int nr, int m0,
                                              int ring, unsigned char* plane) {
  constexpr int kNb = 4;  // n-blocks a warp at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // A: row m = g, k-step s: the pairs of taps 16 s + 4 tig - g - delta (+0,
  // -8, +2, -6 for the four registers), word (that + 32 + delta) / 2 of the
  // copy of its parity
  const int base = 4 * tig - g + 32;
  const unsigned* q = s.rq + (base & 1) * L.rwords + (base >> 1);
  const int mbs = tw >> 4;  // 2, 4 or 8: a divisor of kWarps
  const int mb = warp % mbs, nstride = kWarps / mbs;
  const int nbs = nr >> 3;
  const int rbase = ring ? m0 % ring : m0;
  const int back = kFramed ? (-L.delta) & ~3 : 0;  // aligned word at or before the bytes
  const int shift = kFramed ? 8 * ((-L.delta) & 3) : 0;
  const unsigned char* xb = st + g * L.sp + 16 * mb + 4 * tig + back;
  for (int nb0 = warp / mbs; nb0 < nbs; nb0 += kNb * nstride) {
    float acc[kNb][4];
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[k][v] = 0.0f;
    }
    for (int st16 = 0; st16 < L.rsteps; ++st16) {
      const unsigned* q8 = q + 8 * st16;
      const unsigned a[4] = {q8[0], q8[-4], q8[1], q8[-3]};
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        const int nb = nb0 + k * nstride;
        if (nb < nbs) {
          const unsigned* w = reinterpret_cast<const unsigned*>(xb + 8 * nb * L.sp + 16 * st16);
          const unsigned v = kFramed ? __funnelshift_r(w[0], w[1], shift) : w[0];
          unsigned b0, b1;
          bytes_bf16(v, b0, b1);
          mma_bf16(acc[k], a, b0, b1);
        }
      }
    }
    // accumulator v: output column 16 mb + g + 8 (v >> 1), staged row 8 nb
    // + 2 tig + (v & 1), as rows_mma's
#pragma unroll
    for (int n = 0; n < kNb; ++n) {
      const int nb = nb0 + n * nstride;
      if (nb >= nbs) break;
      int m = rbase + 8 * nb + 2 * tig;
      if (ring && m >= ring) m -= ring;
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        unsigned short* y =
            reinterpret_cast<unsigned short*>(plane + m * L.cs) + 16 * mb + g + 8 * hv;
        y[0] = to_bf16(acc[n][2 * hv]);
        y[L.cs >> 1] = to_bf16(acc[n][2 * hv + 1]);
      }
    }
  }
}

// Rows pass of staged rows [0, nr) (nr a multiple of 8; pitch L.sp, window
// column 0 at byte 0), staged row rr being rows-output row m0 + rr (m0 a
// multiple of 8), which goes to plane row (m0 + rr) mod ring (ring 0: no
// ring). A unit is 16 output columns x 8 rows (one n-block); a warp keeps
// one 16-column block and takes up to four n-blocks at once, which share
// each step's A fragments. kFramed: the assembled forms' stage (the bf16
// body reads it delta bytes to the left).
template <int B, bool kFramed = false>
__device__ __forceinline__ void rows_mma(const TcSmem& s, const TcLayout& L, int tw,
                                         int rows_shift, const unsigned char* st, int nr,
                                         int m0, int ring, unsigned char* plane) {
  if constexpr (B == kBf16) {
    rows_bf16_mma<kFramed>(s, L, tw, st, nr, m0, ring, plane);
    return;
  }
  constexpr int kNb = 4;  // n-blocks a warp at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // A: row m = g of the block, taps 32s + 4 tig - g (+ 0, -8, +16, +8 for
  // the four registers), all in the copy (4 tig - g) mod 4
  const int bq = 4 * tig - g + 16;
  const unsigned* qh = s.rq + (bq & 3) * L.rwords + (bq >> 2);
  const unsigned* ql = qh + 4 * L.rwords;
  // B: ldmatrix x2 of rows 8 nb + (0..7) at window columns 16 mb + 32 s +
  // (0, 16)
  const int mbs = tw >> 4;  // 2, 4 or 8: a divisor of kWarps
  const int mb = warp % mbs, nstride = kWarps / mbs;
  const int nbs = nr >> 3;
  const int base = ring ? m0 % ring : m0;
  const unsigned xa = smem_u32(st) + (lane & 7) * L.sp + 16 * mb + (((lane >> 3) & 1) << 4);
  for (int nb0 = warp / mbs; nb0 < nbs; nb0 += kNb * nstride) {
    int acc_h[kNb][4], acc_l[kNb][4];
#pragma unroll
    for (int k = 0; k < kNb; ++k) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc_h[k][v] = acc_l[k][v] = 0;
    }
    for (int st8 = 0; st8 < L.rsteps; ++st8) {
      const unsigned* h8 = qh + 8 * st8;
      const unsigned* l8 = ql + 8 * st8;
      const unsigned ah[4] = {h8[0], h8[-2], h8[4], h8[2]};
      const unsigned al[4] = {l8[0], l8[-2], l8[4], l8[2]};
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        const int nb = nb0 + k * nstride;
        if (nb < nbs) {
          unsigned b[2];
          ldsm_x2(xa + 8 * nb * L.sp + 32 * st8, b);
          mma_s8u8(acc_h[k], ah, b[0], b[1]);
          mma_s8u8(acc_l[k], al, b[0], b[1]);
        }
      }
    }
    // accumulator v: output column 16 mb + g + 8 (v >> 1), staged row 8 nb
    // + 2 tig + (v & 1); the two rows of a pair are neighbours in a plane
    // column and never straddle the ring (a multiple of 16 rows)
#pragma unroll
    for (int n = 0; n < kNb; ++n) {
      const int nb = nb0 + n * nstride;
      if (nb >= nbs) break;
      int m = base + 8 * nb + 2 * tig;
      if (ring && m >= ring) m -= ring;
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int col = 16 * mb + g + 8 * hv;
        int r[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // R = 128 (hi - 128 Q_hi) + (lo - 128 Q_lo), exact modulo 2^32
          r[e] = static_cast<int>(128u * static_cast<unsigned>(acc_h[n][2 * hv + e]) +
                                  static_cast<unsigned>(acc_l[n][2 * hv + e]) - *s.qoff);
        }
        if (B == kInt8) {
          unsigned d1 = 0, d0 = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ev = (r[e] + (1 << (rows_shift - 1))) >> rows_shift;
            const int e1 = (ev + 64) >> 7;
            d1 |= (static_cast<unsigned>(e1) & 0xffu) << (8 * e);
            d0 |= (static_cast<unsigned>(ev - e1 * 128) & 0xffu) << (8 * e);
          }
          *reinterpret_cast<unsigned short*>(plane + col * L.cs + m) =
              static_cast<unsigned short>(d1);
          *reinterpret_cast<unsigned short*>(plane + tw * L.cs + col * L.cs + m) =
              static_cast<unsigned short>(d0);
        } else {
          unsigned short* y = reinterpret_cast<unsigned short*>(plane + m * L.cs) + col;
          y[0] = to_bf16(__int2float_rn(r[0]));
          y[L.cs >> 1] = to_bf16(__int2float_rn(r[1]));
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

__device__ __forceinline__ uint8_t store_u8(float y) {
  const float v = fminf(fmaxf(__fadd_rn(y, 0.5f), 0.0f), 255.5f);
  return static_cast<uint8_t>(__float2int_rz(v));
}

// plane row of window row x from base b0 (b0 < ring), modulo the ring
__device__ __forceinline__ int ring_row(int x, int ring) {
  return ring && x >= ring ? x % ring : x;
}

// Units of the int8 cols pass of a th x tw tile: (row pairs of 32) x
// (column pairs of 16).
__host__ __device__ inline int int8_col_units(int th, int tw) {
  return ((th + 31) / 32) * (tw / 16);
}

// Int8 cols pass and store of units [u_begin, u_end) of the tile at (i0,
// j0), whose output row 0 reads from plane row b0 (modulo ring).
template <bool kOutU8>
__device__ __forceinline__ void cols_int8_mma(const TcSmem& s, const TcLayout& L,
                                              const K1Params& p, const unsigned char* plane,
                                              int u_begin, int u_end, int b0, int ring, int i0,
                                              int j0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, mi = lane >> 3;
  const int bq = 4 * tig - g + 16;
  const unsigned* qh = s.cq + (bq & 3) * L.cwords + (bq >> 2);
  const unsigned* ql = qh + 4 * L.cwords;
  const int nps = p.tw >> 4;
  const int dplane = p.tw * L.cs;  // bytes of a digit plane
  const size_t out_off = static_cast<size_t>(blockIdx.y) * p.h * p.w;
  const unsigned pl = smem_u32(plane);
  for (int u = u_begin + warp; u < u_end; u += kWarps) {
    const int rp = u / nps, np = u - rp * nps;
    const int ib = 32 * rp;
    if (ib >= p.th || i0 + ib >= p.h) continue;
    // this lane's column in each n-block (ldmatrix row address)
    const unsigned ca0 = pl + (16 * np + (lane & 7)) * L.cs;
    const unsigned ca1 = ca0 + 8 * L.cs;
    // M0 of step 0 (rows ib + 0..15): x4 of e1 n0, e0 n0, e1 n1, e0 n1
    unsigned m0[2][2];
    {
      unsigned r[4];
      ldsm_x4((mi >> 1 ? ca1 : ca0) + (mi & 1) * dplane + ring_row(b0 + ib, ring), r);
      m0[0][0] = r[0];
      m0[0][1] = r[1];
      m0[1][0] = r[2];
      m0[1][1] = r[3];
    }
    int acc[2][2][3][4];  // [m block][n block][p1, p23, p4][fragment]
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[b][n][k][v] = 0;
        }
      }
    }
    for (int st8 = 0; st8 < L.csteps; ++st8) {
      const unsigned* h8 = qh + 8 * st8;
      const unsigned* l8 = ql + 8 * st8;
      const unsigned ah[4] = {h8[0], h8[-2], h8[4], h8[2]};
      const unsigned al[4] = {l8[0], l8[-2], l8[4], l8[2]};
      // block 0 (rows ib + 0..15) reads M0 = rows ib + 32 s + (0..15) and
      // M1 (+ 16..31); block 1 reads M1 and M2 (+ 32..47), the next M0.
      // x4: e1 M1, e1 M2, e0 M1, e0 M2
      const int roff = ring_row(b0 + ib + 32 * st8 + 16 + 16 * (mi & 1), ring);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        unsigned b[4];
        ldsm_x4((n ? ca1 : ca0) + (mi >> 1) * dplane + roff, b);
        mma_s8s8(acc[0][n][0], ah, m0[n][0], b[0]);
        mma_s8s8(acc[1][n][0], ah, b[0], b[1]);
        mma_s8s8(acc[0][n][1], ah, m0[n][1], b[2]);
        mma_s8s8(acc[1][n][1], ah, b[2], b[3]);
        mma_s8s8(acc[0][n][1], al, m0[n][0], b[0]);
        mma_s8s8(acc[1][n][1], al, b[0], b[1]);
        mma_s8s8(acc[0][n][2], al, m0[n][1], b[2]);
        mma_s8s8(acc[1][n][2], al, b[2], b[3]);
        m0[n][0] = b[1];
        m0[n][1] = b[3];
      }
    }
    // fragment v: output row ib + 16 b + g + 8 (v >> 1), column 16 np + 8 n
    // + 2 tig + (v & 1)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int ii = ib + 16 * b + g + 8 * hv;
        const int gi = i0 + ii;
        if (ii >= p.th || gi >= p.h) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int gj = j0 + 16 * np + 8 * n + 2 * tig;
          if (gj >= p.w) continue;
          const float y0 = int8_epilogue<kOutU8>(acc[b][n][0][2 * hv], acc[b][n][1][2 * hv],
                                                 acc[b][n][2][2 * hv], p.c1, p.c2, p.c3);
          const float y1 = int8_epilogue<kOutU8>(acc[b][n][0][2 * hv + 1],
                                                 acc[b][n][1][2 * hv + 1],
                                                 acc[b][n][2][2 * hv + 1], p.c1, p.c2, p.c3);
          const size_t o = out_off + static_cast<size_t>(gi) * p.w + gj;
          const bool pair = gj + 1 < p.w;
          if (kOutU8) {
            uint8_t* op = static_cast<uint8_t*>(p.out) + o;
            if (pair && !(o & 1)) {
              *reinterpret_cast<uint16_t*>(op) =
                  static_cast<uint16_t>(store_u8(y0) | (store_u8(y1) << 8));
            } else {
              op[0] = store_u8(y0);
              if (pair) op[1] = store_u8(y1);
            }
          } else {
            float* op = static_cast<float*>(p.out) + o;
            if (pair && !(o & 1)) {
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
}

// The hybrid cols pass takes 16-column blocks four at a time (one tap
// fragment per step serves all four).
constexpr int kHybCb = 4;

// Units of the hybrid cols pass of a th x tw tile: (128-row blocks) x (8
// fragment pairs f, f + 8) x (runs of kHybCb 16-column blocks).
__host__ __device__ inline int hybrid_col_units(int th, int tw) {
  return ((th + 127) / 128) * 8 * ((tw / 16 + kHybCb - 1) / kHybCb);
}

// Hybrid (and bf16) cols pass and store of units [u_begin, u_end) of the tile at (i0,
// j0), whose output row 0 reads from plane row b0 (modulo ring). Fragment
// f of a 128-row block holds its output rows f + 16 n (n = 0..7); at step s
// it reads plane rows f + 16 s + (0..15) (A) against the taps of group s -
// n (B), so output row f + 16 n sums its tap groups 0, 1, ... in order,
// each at its own lanes. A warp takes fragments f and f + 8, which share 8
// of those 16 rows a step: X_j = rows f + 8 j + (0..7), f takes X_2s and
// X_2s+1, f + 8 takes X_2s+1 and X_2s+2 (the next step's X_2s); and up to
// kHybCb 16-column blocks, which share the step's B fragment.
template <int B, bool kOutU8>
__device__ __forceinline__ void cols_hybrid_mma(const TcSmem& s, const TcLayout& L,
                                                const K1Params& p, const unsigned char* plane,
                                                int u_begin, int u_end, int b0, int ring,
                                                int i0, int j0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int cbs = p.tw >> 4;
  const int runs = (cbs + kHybCb - 1) / kHybCb;
  const int steps = L.groups + 7;
  // B: column n = g takes group s - g (stored at s - g + 7), words tig and
  // tig + 4 (taps 2 tig, + 1 and 2 tig + 8, + 9 of the group)
  const unsigned* ct = s.cq + 12 * (7 - g) + tig;
  const size_t out_off = static_cast<size_t>(blockIdx.y) * p.h * p.w;
  const unsigned pl = smem_u32(plane);
  // ldmatrix.trans lanes: row (lane & 7) of matrix lane >> 3; matrices 0, 1
  // the 8 rows of X_2s+1 at columns +0, +8, matrices 2, 3 those of X_2s+2
  const int lr = ((lane >> 4) << 3) + (lane & 7);
  const int lc = 2 * 8 * ((lane >> 3) & 1);
  for (int u = u_begin + warp; u < u_end; u += kWarps) {
    const int run = u % runs;
    const int f = (u / runs) & 7;
    const int bk = u / (8 * runs);
    const int rb = 128 * bk + f;  // fragment f's first output row
    if (rb >= p.th || i0 + rb >= p.h) continue;
    const int cb0 = run * kHybCb;
    const unsigned ca = pl + 32 * cb0 + lc;
    const unsigned xa = ca + ring_row(b0 + rb + (lane & 7), ring) * L.cs;
    unsigned x0[kHybCb][2];
    float acc[kHybCb][2][4];
#pragma unroll
    for (int c = 0; c < kHybCb; ++c) {
      if (cb0 + c < cbs) ldsm_x2_t(xa + 32 * c, x0[c]);
#pragma unroll
      for (int fi = 0; fi < 2; ++fi) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[c][fi][v] = 0.0f;
      }
    }
    for (int st = 0; st < steps; ++st) {
      const unsigned bt0 = ct[12 * st], bt1 = ct[12 * st + 4];
      const unsigned ra = ca + ring_row(b0 + rb + 16 * st + 8 + lr, ring) * L.cs;
#pragma unroll
      for (int c = 0; c < kHybCb; ++c) {
        if (cb0 + c < cbs) {
          unsigned r[4];
          ldsm_x4_t(ra + 32 * c, r);
          const unsigned af[4] = {x0[c][0], x0[c][1], r[0], r[1]};
          const unsigned ag[4] = {r[0], r[1], r[2], r[3]};
          mma_bf16(acc[c][0], af, bt0, bt1);
          mma_bf16(acc[c][1], ag, bt0, bt1);
          x0[c][0] = r[2];
          x0[c][1] = r[3];
        }
      }
    }
    // fragment v: column 16 cb + g + 8 (v >> 1), output row rb + 8 fi + 16
    // (2 tig + (v & 1))
#pragma unroll
    for (int c = 0; c < kHybCb; ++c) {
      if (cb0 + c >= cbs) break;
#pragma unroll
      for (int fi = 0; fi < 2; ++fi) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int ii = rb + 8 * fi + 16 * (2 * tig + (v & 1));
          const int gi = i0 + ii, gj = j0 + 16 * (cb0 + c) + g + 8 * (v >> 1);
          if (ii >= p.th || gi >= p.h || gj >= p.w) continue;
          // hybrid: the scale and the recentring; bf16: the sum itself
          const float y =
              B == kBf16 ? acc[c][fi][v] : __fmaf_rn(acc[c][fi][v], p.scale, 128.0f);
          const size_t o = out_off + static_cast<size_t>(gi) * p.w + gj;
          if (kOutU8) {
            static_cast<uint8_t*>(p.out)[o] = store_u8(y);
          } else {
            static_cast<float*>(p.out)[o] = y;
          }
        }
      }
    }
  }
}

template <int B, bool kOutU8>
__device__ __forceinline__ void cols_mma(const TcSmem& s, const TcLayout& L, const K1Params& p,
                                         const unsigned char* plane, int u_begin, int u_end,
                                         int b0, int ring, int i0, int j0) {
  if (B == kInt8) {
    cols_int8_mma<kOutU8>(s, L, p, plane, u_begin, u_end, b0, ring, i0, j0);
  } else {
    cols_hybrid_mma<B, kOutU8>(s, L, p, plane, u_begin, u_end, b0, ring, i0, j0);
  }
}

template <int B>
__host__ __device__ inline int col_units(int th, int tw) {
  return B == kInt8 ? int8_col_units(th, tw) : hybrid_col_units(th, tw);
}

// Window rows [r_begin, r_end) (window row r: image row row0 + r,
// reflect-101; window byte c: image column gc0 + c) through the stage, two
// groups of L.g rows in flight, each rows-passed into `plane` (ring as in
// rows_mma). Ends on a barrier: the plane is complete and the stage free.
template <int B>
__device__ __forceinline__ void rows_through_stage(const TcSmem& s, const TcLayout& L,
                                                   const K1Params& p, const uint8_t* xp,
                                                   int row0, int gc0, bool vec, int r_begin,
                                                   int r_end, unsigned char* plane, int ring) {
  const int ngr = (r_end - r_begin + L.g - 1) / L.g;
  auto issue = [&](int t) {
    if (t < ngr) {
      const int r0 = r_begin + t * L.g;
      load_window(s.stage + (t & 1) * L.g * L.sp, L.sp, xp, p.h, p.w, row0 + r0,
                  min(L.g, r_end - r0), gc0, 0, L.sw, vec);
    }
    cp_async_commit();
  };
  issue(0);
  for (int t = 0; t < ngr; ++t) {
    issue(t + 1);        // into the buffer group t - 1 held
    cp_async_wait<1>();  // group t landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    const int r0 = r_begin + t * L.g;
    rows_mma<B>(s, L, p.tw, p.rows_shift, s.stage + (t & 1) * L.g * L.sp,
                min(L.g, r_end - r0), r0, ring, plane);
    __syncthreads();
  }
}

// the planes and their rows 16-byte aligned: the loaders' 16-byte paths
__device__ __forceinline__ bool vec_planes(const K1Params& p) {
  return ((reinterpret_cast<uintptr_t>(p.x) | static_cast<uintptr_t>(p.w)) & 15) == 0;
}

// ---- the forms ----

template <int B, bool kOutU8>
__global__ void __launch_bounds__(kThreads, kTcBlocks<B>) k1_direct(K1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L = tc_layout(kDirect, B, p.th, p.tw, p.rh, p.rw, 0);
  const TcSmem s = tc_carve<B>(smem, L, p);
  const int i0 = (blockIdx.x / p.nbw) * p.th;
  const int j0 = (blockIdx.x % p.nbw) * p.tw;
  const uint8_t* xp = p.x + static_cast<size_t>(blockIdx.y) * p.h * p.w;
  rows_through_stage<B>(s, L, p, xp, i0 - p.rh, j0 - p.rw - L.delta, vec_planes(p), 0, L.rows,
                        s.plane[0], kNoRing);
  cols_mma<B, kOutU8>(s, L, p, s.plane[0], 0, col_units<B>(p.th, p.tw), 0, kNoRing, i0, j0);
}

template <int B, bool kOutU8>
__global__ void __launch_bounds__(kThreads, kTcBlocks<B>) k1_strip(K1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L = tc_layout(kStrip, B, p.th, p.tw, p.rh, p.rw, 0);
  const TcSmem s = tc_carve<B>(smem, L, p);
  const int i0 = blockIdx.x * p.th;
  const uint8_t* xp = p.x + static_cast<size_t>(blockIdx.y) * p.h * p.w;
  const bool vec = vec_planes(p);
  const int carry = L.sw - p.tw;  // window bytes the next window keeps
  for (int jw = 0; jw < p.nbw; ++jw) {
    const int j0 = jw * p.tw;
    const int gc0 = j0 - p.rw - L.delta;
    if (jw == 0) {
      load_window(s.stage, L.sp, xp, p.h, p.w, i0 - p.rh, L.rows, gc0, 0, L.sw, vec);
    } else {
      // carry the window's last `carry` bytes to its front, tw at a time in
      // ascending order (source and target of one move are tw apart, so
      // they never overlap)
      for (int c = 0; c < carry; c += p.tw) {
        const int n = min(p.tw, carry - c) >> 4;
        for (int e = threadIdx.x; e < L.rows * n; e += kThreads) {
          const int rr = e / n;
          uint4* row = reinterpret_cast<uint4*>(s.stage + rr * L.sp + c);
          const int q = e - rr * n;
          row[q] = row[q + (p.tw >> 4)];
        }
        __syncthreads();
      }
      load_window(s.stage, L.sp, xp, p.h, p.w, i0 - p.rh, L.rows, gc0, carry, L.sw, vec);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the window is staged; the last cols pass is done
    rows_mma<B>(s, L, p.tw, p.rows_shift, s.stage, L.rows, 0, kNoRing, s.plane[0]);
    __syncthreads();
    cols_mma<B, kOutU8>(s, L, p, s.plane[0], 0, col_units<B>(p.th, p.tw), 0, kNoRing, i0, j0);
  }
}

template <int B, bool kOutU8, bool kPipe>
__global__ void __launch_bounds__(kThreads, kTcBlocks<B>) k1_assembled(K1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L =
      tc_layout(kPipe ? kPipelined : kAssembled, B, p.th, p.tw, p.rh, p.rw, p.slots);
  const TcSmem s = tc_carve<B>(smem, L, p);
  const int ngr = (L.rows + L.g - 1) / L.g;  // row groups per window
  const int i0 = (blockIdx.x / p.nseg) * p.th;
  const int jw0 = (blockIdx.x % p.nseg) * p.seg;
  const int nwin = min(p.seg, p.nbw - jw0);
  const int total = nwin * ngr;
  const int units = col_units<B>(p.th, p.tw);
  // the frame holds the plane at (rh, rw): window (i0, j0)'s staged rows
  // and columns start at frame row i0 and column j0
  const uint8_t* fp = p.x + static_cast<size_t>(blockIdx.y) * p.xh * p.xw;

  auto issue = [&](int t) {
    if (t < total) {
      const int win = t / ngr;
      const int r0 = (t - win * ngr) * L.g;
      load_rect(s.stage + (t % p.slots) * L.g * L.sp, L.sp,
                fp + static_cast<size_t>(i0 + r0) * p.xw + static_cast<size_t>(jw0 + win) * p.tw,
                p.xw, min(L.g, L.rows - r0), L.sw);
    }
    cp_async_commit();
  };

  for (int t = 0; t < p.slots - 1; ++t) issue(t);
  for (int t = 0; t < total; ++t) {
    const int win = t / ngr;
    const int gr = t - win * ngr;
    const int r0 = gr * L.g;
    if (p.slots == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // group t landed; the next slot and the plane are free
    issue(t + p.slots - 1);
    rows_mma<B, true>(s, L, p.tw, p.rows_shift, s.stage + (t % p.slots) * L.g * L.sp,
                      min(L.g, L.rows - r0), r0, kNoRing, s.plane[kPipe ? (win & 1) : 0]);
    const int j0 = (jw0 + win) * p.tw;
    if (kPipe) {
      // a slice of the previous window's cols pass beside this group's rows
      if (win > 0) {
        const int per = (units + ngr - 1) / ngr;
        cols_mma<B, kOutU8>(s, L, p, s.plane[(win - 1) & 1], gr * per,
                            min(units, (gr + 1) * per), 0, kNoRing, i0, j0 - p.tw);
      }
    } else if (gr == ngr - 1) {
      __syncthreads();
      cols_mma<B, kOutU8>(s, L, p, s.plane[0], 0, units, 0, kNoRing, i0, j0);
    }
  }
  if (kPipe) {
    __syncthreads();
    cols_mma<B, kOutU8>(s, L, p, s.plane[(nwin - 1) & 1], 0, units, 0, kNoRing, i0,
                        (jw0 + nwin - 1) * p.tw);
  }
  cp_async_wait<0>();
}

template <int B, bool kOutU8>
__global__ void __launch_bounds__(kThreads, kTcBlocks<B>) k1_resident(K1Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout L = tc_layout(kResident, B, p.th, p.tw, p.rh, p.rw, 0);
  const TcSmem s = tc_carve<B>(smem, L, p);
  const int ring = L.rows;
  const int j0 = blockIdx.x * p.tw;
  const uint8_t* xp = p.x + static_cast<size_t>(blockIdx.y) * p.h * p.w;
  const bool vec = vec_planes(p);
  const int units = col_units<B>(p.th, p.tw);
  for (int i = 0; i < p.nbh; ++i) {
    // rows-output rows [0, ring + i th) are computed once this step is
    // staged; the ring holds the last `ring` of them
    const int r_begin = i == 0 ? 0 : ring + (i - 1) * p.th;
    rows_through_stage<B>(s, L, p, xp, -p.rh, j0 - p.rw - L.delta, vec, r_begin,
                          ring + i * p.th, s.plane[0], ring);
    cols_mma<B, kOutU8>(s, L, p, s.plane[0], 0, units, (i * p.th) % ring, ring, i * p.th, j0);
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

// ---- A4 ----
//
// The frame K1a reads for a shard whose row halos the caller supplied.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fused_dma.py:
// _assemble_padded_prepad (1738) -> _assemble_kernel4 (1708), four HBM->HBM
// copies per plane of ONE rows-prepadded buffer, which shard_map hands the
// TPU kernel after jnp.concatenate([top, block, bot]) (the JAX
// parallel/sharded.py).
//
// Writes (planes, hp, wp): frame row r < hs (hs the segments' rows
// together) is source row r of the concatenation of up to three row
// segments, read where they lie, with reflect-101 columns of min(rw, w - 1)
// at column orw and zeros elsewhere; rows [hs, hp) are zero. A segment is a
// base pointer, a plane stride and a row stride (bytes, as 64-bit integers),
// its rows and a reversed flag: a reversed segment's row i is its source row
// rows - 1 - i (the reflect-101 halo at the frame's top or bottom edge, the
// shard's own rows 1..r or lo..lo+r, which PyTorch cannot view with a
// negative stride). So the sharded path hands over its block and its
// neighbours' edge rows as views and neither cuts nor concatenates.
//
// Mapping: a 2-D grid, planes in y and groups of kA4Warps frame rows in x;
// a warp takes one frame row, its lanes the row's 16-byte output chunks
// (lane, lane + 32, ...), kA4Unroll of them at a time with every load
// issued before the first store. A row's segment is two comparisons,
// uniform across the warp; no division anywhere. Every output chunk is one
// coalesced 16-byte store. Source column j0 = 16 k - orw of chunk k sits at a byte
// offset s = (row - orw) mod 16 from a 16-byte boundary, the same for the
// whole row: where the aligned granules [j0 - s, j0 - s + 32) lie inside the
// row (16 bytes where s = 0), the chunk is two aligned 16-byte loads
// funnel-shifted by s with __byte_perm (neighbouring lanes read
// neighbouring granules, so a warp reads each granule from memory once and
// its second use from L1); the few chunks left at each edge (the reflected
// columns, and the head and tail that no whole granule covers) gather byte
// by byte through reflect101; chunks wholly in the slack store zeros and
// read nothing. Every read lies inside a source row.
//
// What bounds it on an H100: bytes, each source byte read once and each
// frame byte written once; on a dp 2 x sp 2 shard of the 4K batch (6 planes
// of 1138 x 3840 -> 1184 x 3920) about 54 MB, 0.016 ms at 3.35 TB/s. Its
// device time is set by the bytes in flight: a lane's kA4Unroll chunks
// load together (a warp 2 KB, a CTA of 8 warps 16 KB), 888 CTAs there.

constexpr int kA4Warps = 8;
constexpr int kA4Unroll = 4;

struct A4Segment {
  const uint8_t* x;
  long long plane_stride;
  long long row_stride;
  int rows;
  int reversed;
};

struct A4Params {
  A4Segment seg[3];
  uint8_t* out;
  int end0, end1;  // frame rows [0, end0) from segment 0, [end0, end1) from 1, [end1, hs) from 2
  int hs, w, rcb, orw, hp, wp;
};

// bytes [s, s + 16) of the 32 bytes a, b (s in [0, 16))
__device__ __forceinline__ uint4 funnel16(uint4 a, uint4 b, int s) {
  const int sel = 0x3210 + 0x1111 * (s & 3);
  unsigned w0, w1, w2, w3, w4;
  switch (s >> 2) {
    case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; break;
    case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = b.x; w4 = b.y; break;
    case 2: w0 = a.z; w1 = a.w; w2 = b.x; w3 = b.y; w4 = b.z; break;
    default: w0 = a.w; w1 = b.x; w2 = b.y; w3 = b.z; w4 = b.w; break;
  }
  return make_uint4(__byte_perm(w0, w1, sel), __byte_perm(w1, w2, sel),
                    __byte_perm(w2, w3, sel), __byte_perm(w3, w4, sel));
}

__global__ void __launch_bounds__(kA4Warps * 32) assemble_rows_kernel(const A4Params p) {
  const int r = blockIdx.x * kA4Warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= p.hp) return;
  const int chunks = p.wp >> 4;
  uint4* dst = reinterpret_cast<uint4*>(p.out) +
               (static_cast<size_t>(blockIdx.y) * p.hp + r) * chunks;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (r >= p.hs) {
    for (int k = lane; k < chunks; k += 32) dst[k] = zero;
    return;
  }
  const int g = (r >= p.end0) + (r >= p.end1);
  const A4Segment s0 = p.seg[0], s1 = p.seg[1], s2 = p.seg[2];
  const uint8_t* x = g == 0 ? s0.x : g == 1 ? s1.x : s2.x;
  const long long ps = g == 0 ? s0.plane_stride : g == 1 ? s1.plane_stride : s2.plane_stride;
  const long long rs = g == 0 ? s0.row_stride : g == 1 ? s1.row_stride : s2.row_stride;
  const int rows = g == 0 ? s0.rows : g == 1 ? s1.rows : s2.rows;
  const int rev = g == 0 ? s0.reversed : g == 1 ? s1.reversed : s2.reversed;
  const int i = r - (g == 0 ? 0 : g == 1 ? p.end0 : p.end1);
  const uint8_t* row = x + static_cast<long long>(blockIdx.y) * ps +
                       static_cast<long long>(rev ? rows - 1 - i : i) * rs;
  const int w = p.w, rcb = p.rcb, orw = p.orw;
  const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(row) - orw) & 15);
  const int span = sh ? 32 : 16;
  // kA4Unroll chunks a lane at a time: their granule loads all issued
  // before the first store, so a warp keeps kA4Unroll x 512 bytes in flight
  for (int k0 = lane; k0 < chunks; k0 += 32 * kA4Unroll) {
    uint4 lo[kA4Unroll], hi[kA4Unroll];
#pragma unroll
    for (int u = 0; u < kA4Unroll; ++u) {
      const int j0 = ((k0 + 32 * u) << 4) - orw;  // source column of the chunk's first byte
      lo[u] = hi[u] = zero;
      if (k0 + 32 * u < chunks && j0 >= sh && j0 - sh + span <= w) {
        const uint4* a = reinterpret_cast<const uint4*>(row + j0 - sh);
        lo[u] = a[0];
        if (sh) hi[u] = a[1];
      }
    }
#pragma unroll
    for (int u = 0; u < kA4Unroll; ++u) {
      const int k = k0 + 32 * u;
      if (k >= chunks) break;
      const int j0 = (k << 4) - orw;
      uint4 val = zero;
      if (j0 >= sh && j0 - sh + span <= w) {
        val = sh ? funnel16(lo[u], hi[u], sh) : lo[u];
      } else if (j0 + 16 > -rcb && j0 < w + rcb) {
        unsigned q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int c = j0 + b;
          if (c >= -rcb && c < w + rcb) {
            q[b >> 2] |= static_cast<unsigned>(row[reflect101(c, w)]) << (8 * (b & 3));
          }
        }
        val = make_uint4(q[0], q[1], q[2], q[3]);
      }
      dst[k] = val;
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

#endif  // FUSED_DMA_LOADERS_ONLY

}  // namespace

#ifndef FUSED_DMA_LOADERS_ONLY

// K1 in one of its forms (0 direct, 1 strip, 2 assembled, 3 pipelined,
// 4 resident) with one of its bodies (0 int8, 1 hybrid, 2 bf16), uint8
// planes -> uint8 (out_u8 = 1) or float, the epilogue's value before the
// uint8 store (int8: p1*c1 + p23*c2 + p4*c3 + 128).
// taps_i: the tap tables of tc_carve (tc_layout's `taps` bytes, built by
// cuda_kernels/fused_dma.py tc_tables for this body and form family: the
// int8 and hybrid assembled forms' rows copies take no leading zeros);
// taps_f: unused (the bf16 body's column taps before its tables; pass NULL).
// (th, tw): the tile (tw 32, 64 or 128; th a multiple of 16); seg, slots:
// windows per block and raw row-group
// buffers (2 or 3) of the assembled forms. (xh, xw): the planes' rows and
// row length (the padded frame's for the assembled forms: the plane at
// (rh, rw), xw a multiple of 16). smem: the wrapper's shared-memory bytes,
// which must equal this file's layout (tc_layout).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int blur_fused_u8_k1(int form, int body, int out_u8, const void* x, void* out,
                                const void* taps_i, const void* taps_f, int planes, int h,
                                int w, int rh, int rw, int th, int tw, int seg, int slots,
                                int xh, int xw, int smem, int rows_shift, float c1, float c2,
                                float c3, float scale, void* stream) {
  (void)taps_f;
  const bool tw_ok = tw == 32 || tw == 64 || tw == 128;
  if (form < kDirect || form > kResident || body < kInt8 || body > kBf16 || !tw_ok ||
      th < 16 || th % 16 || seg < 1 || planes < 1 || planes > 65535 || rh < 1 || rw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool asm_form = form == kAssembled || form == kPipelined;
  if (asm_form && slots != 2 && slots != 3) return static_cast<int>(cudaErrorInvalidValue);
  const TcLayout T = tc_layout(form, body, th, tw, rh, rw, asm_form ? slots : 0);
  int limit = 0;
  const int lerr = smem_limit(&limit);
  if (lerr) return lerr;
  if (T.total != smem || smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  K1Params p;
  p.x = static_cast<const uint8_t*>(x);
  p.out = out;
  p.taps_i = static_cast<const int*>(taps_i);
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
    // the frame must hold every window the blocks read
    const int rows = (p.nbh - 1) * th + T.rows;
    const int cols = (p.nbw - 1) * tw + T.sw;
    if (xh < rows || xw % 16 || xw < cols || (form == kPipelined && seg < 2)) {
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

// A4: a shard's rows, whose hs rows already carry the caller's row halos,
// given as nseg (1 to 3) uint8 row segments of w bytes a row, `segs` 5
// int64 a segment (address, plane stride, row stride, rows, reversed), ->
// (planes, hp, wp) with the rows in segment order from (0, orw), reflect-101
// columns and zero slack, launched on `stream` of card `device` (made
// current for the launch where it is not). wp a multiple of 16, orw >=
// min(rw, w - 1). Returns the cudaError_t of the launch (0 = launched).
extern "C" int assemble_padded_prepad_rows_u8(void* out, int planes, int nseg,
                                              const void* segs, int w, int rw, int orw,
                                              int hp, int wp, int device, void* stream) {
  A4Params p;
  if (nseg < 1 || nseg > 3 || segs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  long long seg[15];  // copied out: the caller's table need not be 8-byte aligned
  memcpy(seg, segs, sizeof(long long) * 5 * nseg);
  long long hs = 0;
  for (int k = 0; k < 3; ++k) {
    const long long* s = seg + 5 * (k < nseg ? k : 0);
    const bool used = k < nseg;
    if (used && (s[0] == 0 || s[3] < 0 || s[3] > (1 << 30))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.seg[k].x = reinterpret_cast<const uint8_t*>(s[0]);
    p.seg[k].plane_stride = used ? s[1] : 0;
    p.seg[k].row_stride = used ? s[2] : 0;
    p.seg[k].rows = used ? static_cast<int>(s[3]) : 0;
    p.seg[k].reversed = used && s[4];
    hs += p.seg[k].rows;
  }
  const int rcb = rw < w - 1 ? rw : w - 1;
  if (planes < 1 || planes > 65535 || hs < 1 || hs > (1 << 30) || w < 1 || rw < 0 ||
      wp % 16 || wp < 16 || hp < 1 || orw < rcb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.out = static_cast<uint8_t*>(out);
  p.end0 = p.seg[0].rows;
  p.end1 = p.end0 + p.seg[1].rows;
  p.hs = static_cast<int>(hs);
  p.w = w;
  p.rcb = rcb;
  p.orw = orw;
  p.hp = hp;
  p.wp = wp;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((hp + kA4Warps - 1) / kA4Warps, planes);
  assemble_rows_kernel<<<grid, kA4Warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// A4 on one contiguous rows-prepadded buffer (planes, hs, w) on the current
// card: the one-segment case of assemble_padded_prepad_rows_u8.
extern "C" int assemble_padded_prepad_u8(const void* x, void* out, int planes, int hs, int w,
                                         int rw, int orw, int hp, int wp, void* stream) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long seg[5] = {static_cast<long long>(reinterpret_cast<uintptr_t>(x)),
                            static_cast<long long>(hs) * w, w, hs, 0};
  return assemble_padded_prepad_rows_u8(out, planes, 1, seg, w, rw, orw, hp, wp, device,
                                        stream);
}

extern "C" const char* blur_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // FUSED_DMA_LOADERS_ONLY
