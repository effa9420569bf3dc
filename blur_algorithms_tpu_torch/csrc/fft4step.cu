// FFT convolution of rows (K3 and K3f): f32 rows in, f32 rows out.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fft4step.py:_kernel (K3, rows
// already framed to the transform length n) and :_kernel_framed (K3f,
// unpadded rows of length dim, framed inside the kernel). Both compute, per
// pair of real rows (a, b), the circular correlation
//     y = IFFT(H . FFT(z)),  z = a + i b,  Re y -> row a, Im y -> row b,
// where H is the host-built correlation spectrum conj(fft(wrap_centered(
// taps, n))) / n: real for symmetric taps, complex otherwise. The kernel is
// real in space, so the two packed rows separate by linearity either way.
// K3f frames row t of the transform as reflect-101 of the row over
// [0, pad), the row over [pad, pad + dim), reflect-101 again up to
// 2 pad + dim, then zeros to n, and stores the interior [pad, pad + dim).
// K3 is the same entry with dim = n and pad = 0 (the framing is then the
// identity). The TPU kernel factors n = n1 * n2 and runs each DFT stage as a
// dense matmul on the MXU; on an H100 the CUDA cores do the FFT in f32.
//
// What bounds it on an H100: device memory. The traffic is one read and one
// write of the rows; the f32 work, ~10 n log2 n flops per pair of rows,
// takes under half that time at the card's f32 rate (chip_smoke.py prints
// both bounds, PERF.md the measured times).
//
// The design: one block per pair of rows, n / 32 threads, the FFT as a few
// high-radix passes held in registers, shared memory only between passes.
// The kernel is a template on n (17 lengths, 3 more in the cluster form
// below) and on whether it frames the
// rows (K3f) or reads them as they are (K3), so every stride, count and
// twiddle step is a constant and shared addresses fold into immediates.
//   n = Q * P: Q the odd part (1, 3, 5, ..., 15: the lengths are powers of
//   two 256..16384 and 1024 k for k = 5..16), P = R0 * 32^a, R0 in
//   {1, 2, 4, 8, 16}, a in {1, 2}. Forward passes, decimation in frequency:
//   radix Q (when Q > 1), radix R0 (when R0 > 1), then a radix-32 passes.
//   A pass of radix R over spans L = R s takes the R values x[base + m s]
//   (base = block L + j, j < s) into registers, runs their R-point DFT
//   there (a power of two as radix-2 butterflies with literal constants,
//   an odd radix against a table of Q roots), multiplies output q by
//   W_L^(q j) and writes it to base + q s: output in natural order at the
//   place it was read, so a pass needs no second buffer and one barrier.
//   The spectrum is left in digit-reversed order; the host stores H in that
//   order (cuda_kernels/fft4step.py:_kernel_bin_order), so nothing is
//   reordered. Inverse passes run in reverse order: conjugate twiddles,
//   then the conjugate DFT; they read the digit-reversed spectrum and leave
//   the row in natural order.
// What the design does about each cost of a shared-memory FFT:
//   1. Passes through shared memory: the last forward pass (radix 32 over
//      spans of 32, no twiddles) multiplies by H and runs the first inverse
//      pass in the same registers. The first forward pass reads the rows
//      straight from device memory (framing them on the way for K3f, which
//      never loads the zero tail) and the last inverse pass stores straight
//      to it. That leaves 4 exchanges through shared memory per pair of
//      rows (6 at n 6144 and 12288, which take a radix-2 or -4 pass beside
//      radix 3), each one 8-byte write and one 8-byte read of each value
//      (the row is kept as interleaved float2).
//   2. Bank conflicts: the row is stored padded, element i at i + (i >> 5).
//      Every pass but the middle one has stride s >= 32 (radix Q: s = P;
//      R0: s = P / R0 >= 32; a non-last radix-32 pass: s = 32), so a warp's
//      lanes take 32 consecutive, aligned positions; the middle pass reads
//      thread t's run 32 t + m at 33 t + m, a distinct bank pair for each
//      lane of a half-warp. No access conflicts.
//   3. Twiddles: W_n^e = Thi[e >> 7] * Tlo[e & 127], two tables of at most
//      128 entries (W_n^(128 h) and W_n^l) built on the host in float64,
//      rounded to f32 and kept in shared memory. Each twiddle of the radix-Q
//      and radix-R0 passes costs two shared loads and one f32 complex
//      product; that product adds at most 4 * 2^-24 to the distance from
//      the float64 root (two table roundings of 2^-25 in modulus each, two
//      rounding steps of the product), which
//      tests/test_torch_fft4step_passes.py holds. The radix-32 pass over
//      spans of 1024 reads W_1024^(q j) from a 1024-entry table that each
//      block fills from the same products when it starts (the same f32
//      values, one shared load each). The radix-2 butterflies inside a
//      pass use literal W_32 constants.
//   4. Overlap of memory and compute: the first pass issues all of a
//      thread's loads (2 R per butterfly, 64 at R = 32) before it computes,
//      and blocks on different SMs are out of phase, so the card keeps HBM
//      busy while other SMs compute. At n <= 8192 two or more blocks share
//      an SM (n / 32 threads of <= 128 registers, no spills; shared memory
//      8.25 n + 2176 bytes, and 8 KB more for the 1024-entry table), at
//      n 16384 one does. A persistent grid that prefetched the next pair's
//      rows into L2 while computing this one measured 12-25% slower on the
//      H100 (probes/k3_variants.py) and is not kept. Global accesses are 4-byte and
//      coalesced (a warp covers 128 contiguous bytes): they go straight into
//      the registers of the first pass, which a 16-byte form would have to
//      stage through shared memory.
//   5. The spectrum multiply happens in registers between the last forward
//      and the first inverse pass (item 1), H read as 16-byte loads.
// Past n 16384 (n = 32768, 65536, 131072: what transform_length plans past
// 16384 and the adjoint pads rows to), a complex row no longer fits one
// block's shared memory (256 KB at 32768). The cluster form
// (fft_conv_rows_cluster_kernel) takes a thread-block cluster of C = n / 16384
// CTAs (2, 4 or 8; 8 is the portable limit) per pair of rows: a first
// radix-C pass over stride 16384 reads the rows from device memory (framing
// them for K3f) and sends each output to the shared memory of the CTA owning
// its segment over distributed shared memory; each CTA then runs the
// length-16384 body above unchanged on its segment (passes, H, inverse
// passes) and leaves the result in its shared memory; the last inverse pass
// (radix C) reads its C values from the CTAs' segments and stores the rows.
// Cluster barriers stand between the three steps and before any CTA exits.
// Device-memory traffic stays one read and one write of the rows; each CTA
// holds what the n-16384 block holds, 9 KB more for the cluster pass's
// W_n tables (128 + n / 128 entries, as Tlo / Thi above).
// Tensor cores: not used. f32 accuracy would need 3xTF32 (~165 TFLOP/s of
// useful rate) or bf16x3 splits, and a dense pass as a matrix product costs
// 8 R flops a point against ~5 log2 R for the butterflies: radix-16 passes
// on mma would take ~2 ms for the n-16384 rows of a 4K batch, twice their
// bytes bound, where the butterflies' f32 work takes ~0.45 ms. The TPU's
// dense DFT matrices suit a machine whose vector unit is weak; the H100's
// CUDA cores are not.
//
// Ablation (the probe B2, csrc/probes/fft_ablation.cu): the body is a
// template on a mask of stages to leave out (Ablate, below). The kernels of
// this file are the body with mask 0, where every `if constexpr` on the mask
// keeps the stage, so they compile to the code they were without it. The
// probe includes this file with FFT4STEP_KERNELS_ONLY defined (no launch
// code, no C entries, no instantiation here) and instantiates the other
// masks at the lengths it runs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kE = 32;            // radix of the main passes; n / kE threads
constexpr int kMaxN = 16384;
constexpr int kMaxThreads = kMaxN / kE;
constexpr int kLo = 128;          // entries of the low twiddle table
constexpr int kTable = 2 * kLo + 16;  // Tlo, Thi (n / 128 used), W_Q

// Stages the ablation leaves out (timing only: any mask but 0 gives a wrong
// result). Without exchanges a pass takes its values from, and sums them
// into, one register a thread (`carry`) in place of shared memory, and the
// barriers between passes go; kIoOnly keeps the first pass's reads and the
// last pass's stores alone.
enum Ablate {
  kNoButterflies = 1,  // the radix-R DFTs of every pass (the TPU's dots)
  kNoTwiddles = 2,     // the twiddle products between passes
  kNoExchanges = 4,    // the shared-memory exchanges (the TPU's relayouts)
  kNoSpectrum = 8,     // the product by H in the middle pass
  kIoOnly = 16,        // reads and stores: no other pass, no other stage
};
constexpr int kAllStages = kNoButterflies | kNoTwiddles | kNoExchanges | kNoSpectrum;

__host__ __device__ constexpr int ilog2(int v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

__host__ __device__ constexpr int brev(int p, int r) {
  int q = 0;
  for (int b = 1; b < r; b <<= 1) {
    q = (q << 1) | (p & 1);
    p >>= 1;
  }
  return q;
}

__device__ __forceinline__ int sidx(int i) { return i + (i >> 5); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a * conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// d * W_32^k (conjugate root for the inverse), k < 16 known at compile time
// once the butterflies are unrolled
template <bool kInv>
__device__ __forceinline__ float2 rot32(float2 d, int k) {
  if (k == 0) return d;
  if (k == 8) return kInv ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
  // cos(2 pi k / 32), k = 0..8, rounded to f32
  const float c[9] = {1.0f, 0.980785251f, 0.923879504f, 0.831469595f,
                      0.707106769f, 0.555570245f, 0.382683426f,
                      0.195090324f, 0.0f};
  const float2 w = k < 8 ? make_float2(c[k], -c[8 - k])
                         : make_float2(-c[16 - k], -c[k - 8]);
  return kInv ? cmulc(d, w) : cmul(d, w);
}

// Radix-2 decimation-in-frequency stages of spans L, L / 2, ..., 2 over the
// R values a thread holds; leaves the R-point DFT in bit-reversed order.
template <int R, int L, bool kInv>
struct Dif {
  static __device__ __forceinline__ void run(float2 (&a)[R]) {
    constexpr int h = L / 2;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const int p = (i / h) * L + i % h;
      const float2 u = a[p], v = a[p + h];
      a[p] = cadd(u, v);
      a[p + h] = rot32<kInv>(csub(u, v), (i % h) * (32 / L));
    }
    Dif<R, h, kInv>::run(a);
  }
};

template <int R, bool kInv>
struct Dif<R, 1, kInv> {
  static __device__ __forceinline__ void run(float2 (&)[R]) {}
};

// In-place R-point DFT of a[0..R) in natural order: forward (W_R =
// exp(-2 pi i / R)) or inverse (conjugate roots, no 1 / R). wq holds W_Q^k
// for an odd radix.
template <int R, bool kInv>
__device__ __forceinline__ void dft(float2 (&a)[R], const float2* wq) {
  if constexpr ((R & (R - 1)) == 0) {
    Dif<R, R, kInv>::run(a);
    float2 t[R];
#pragma unroll
    for (int p = 0; p < R; ++p) t[brev(p, R)] = a[p];
#pragma unroll
    for (int p = 0; p < R; ++p) a[p] = t[p];
  } else {
    float2 y[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float2 acc = a[0];
#pragma unroll
      for (int m = 1; m < R; ++m) {
        const int k = (m * q) % R;
        const float2 w = wq[kInv ? (R - k) % R : k];
        acc.x = fmaf(a[m].x, w.x, fmaf(-a[m].y, w.y, acc.x));
        acc.y = fmaf(a[m].x, w.y, fmaf(a[m].y, w.x, acc.y));
      }
      y[q] = acc;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = y[q];
  }
}

struct Smem {
  float2* buf;  // padded complex row: element i at sidx(i)
  const float2* tlo;  // W_n^l, l < 128
  const float2* thi;  // W_n^(128 h), h < n / 128
  const float2* wq;   // W_Q^k, k < Q
  const float2* t1k;  // W_1024^x, x < 1024
};

struct Rows {
  const float* xa;
  const float* xb;
  float* oa;
  float* ob;
  bool has_b;
  int dim;
  int pad;
};

// W_n^e, 0 <= e < n
__device__ __forceinline__ float2 twiddle(const Smem& sm, int e) {
  return cmul(sm.thi[e >> 7], sm.tlo[e & (kLo - 1)]);
}

// reflect-101 framing of transform position t: the source column of the
// row, or -1 for the zero tail (pad <= dim - 1)
__device__ __forceinline__ int frame_source(int t, int dim, int pad) {
  const int u = t - pad;
  if (u < 0) return -u;
  if (u < dim) return u;
  if (u < dim + pad) return 2 * (dim - 1) - u;
  return -1;
}

// Position pos of the transform from the rows: reflect-101 framed (K3f) or
// as it is (K3, dim = n).
template <bool kFramed>
__device__ __forceinline__ float2 load_row(const Rows& io, int pos) {
  if constexpr (kFramed) {
    pos = frame_source(pos, io.dim, io.pad);
    if (pos < 0) return make_float2(0.0f, 0.0f);
  }
  return make_float2(__ldg(io.xa + pos), io.has_b ? __ldg(io.xb + pos) : 0.0f);
}

// Position pos of the result to the rows (K3f: the interior only).
template <bool kFramed>
__device__ __forceinline__ void store_row(const Rows& io, int pos, float2 v) {
  if constexpr (kFramed) {
    pos -= io.pad;
    if (pos < 0 || pos >= io.dim) return;
  }
  io.oa[pos] = v.x;
  if (io.has_b) io.ob[pos] = v.y;
}

__host__ __device__ constexpr int odd_part(int n) {
  while (n > 1 && (n & 1) == 0) n >>= 1;
  return n;
}

// The passes of length N: N = Q * R0 * 32^A, P = N / Q = 2^kP, T threads.
template <int N>
struct Plan {
  static constexpr int Q = odd_part(N);
  static constexpr int kP = ilog2(N / Q);
  static constexpr int A = kP >= 10 ? 2 : 1;
  static constexpr int R0Log2 = kP - 5 * A;
  static constexpr int R0 = 1 << R0Log2;
  static constexpr int T = N / kE;
  static constexpr bool kQ = Q > 1, kR = R0 > 1, kA = A == 2;
  static constexpr int kSmem = 8 * (N + N / 32) + 8 * kTable + (kA ? 8 * 1024 : 0);
};

// Butterfly b of a radix-R pass (fft_pass, below) over spans R << S_LOG2.
// Every such pass has a stride S of at least 32, so position base + m S
// sits at sidx(base) + m (S + S / 32).
template <int R, bool kInv, bool kIn, bool kOut, int S_LOG2, int TW_MUL, bool kFramed,
          int kMask>
__device__ __forceinline__ void butterfly(const Smem& sm, const Rows& io, int b,
                                          float2& carry) {
  static_assert(S_LOG2 >= 5, "a pass through shared memory has stride >= 32");
  constexpr int S = 1 << S_LOG2;
  constexpr int SS = S + (S >> 5);  // padded stride
  const int j = b & (S - 1);
  const int base = (((b >> S_LOG2) * R) << S_LOG2) + j;
  const int sbase = sidx(base);
  float2 a[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if constexpr (kIn)
      a[m] = load_row<kFramed>(io, base + m * S);
    else if constexpr ((kMask & kNoExchanges) != 0)
      a[m] = make_float2(carry.x + m, carry.y);
    else
      a[m] = sm.buf[sbase + m * SS];
  }
  constexpr bool kTw = (kMask & kNoTwiddles) == 0;
  // radix 32 runs over spans of 1024: W_1024^(q j), q j < 1024
  if constexpr (kInv && kTw) {
#pragma unroll
    for (int q = 1; q < R; ++q)
      a[q] = cmulc(a[q], R == kE ? sm.t1k[q * j] : twiddle(sm, q * j * TW_MUL));
  }
  if constexpr ((kMask & kNoButterflies) == 0) dft<R, kInv>(a, sm.wq);
  if constexpr (!kInv && kTw) {
#pragma unroll
    for (int q = 1; q < R; ++q)
      a[q] = cmul(a[q], R == kE ? sm.t1k[q * j] : twiddle(sm, q * j * TW_MUL));
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if constexpr (kOut)
      store_row<kFramed>(io, base + q * S, a[q]);
    else if constexpr ((kMask & kNoExchanges) != 0)
      carry = cadd(carry, a[q]);
    else
      sm.buf[sbase + q * SS] = a[q];
  }
}

// One pass of radix R over spans L = R << S_LOG2: butterflies b < COUNT
// (COUNT = N / R), b = threadIdx.x + k T. Forward: DFT, then W_L^(q j) =
// W_N^(q j TW_MUL), TW_MUL = N / L. Inverse: conjugate twiddles, then the
// conjugate DFT. Values come from and go to shared memory or the rows
// (kIn / kOut) at the same positions. A thread's butterflies of radix 8 and up run one after another (not
// unrolled: their registers would not fit twice).
template <int R, bool kInv, bool kIn, bool kOut, int S_LOG2, int TW_MUL, int COUNT, int T,
          bool kFramed, int kMask>
__device__ __forceinline__ void fft_pass(const Smem& sm, const Rows& io, float2& carry) {
  constexpr int K = (COUNT + T - 1) / T;
  if constexpr (R >= 8) {
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
      const int b = threadIdx.x + k * T;
      if (COUNT % T != 0 && b >= COUNT) break;
      butterfly<R, kInv, kIn, kOut, S_LOG2, TW_MUL, kFramed, kMask>(sm, io, b, carry);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int b = threadIdx.x + k * T;
      if (COUNT % T != 0 && b >= COUNT) break;
      butterfly<R, kInv, kIn, kOut, S_LOG2, TW_MUL, kFramed, kMask>(sm, io, b, carry);
    }
  }
}

// The last forward pass (radix 32 over spans of 32: no twiddles), the
// multiply by H and the first inverse pass, in one thread's registers:
// thread t owns positions 32 t .. 32 t + 31, at 33 t + m.
template <int kMask>
__device__ __forceinline__ void middle_pass(const Smem& sm, const float* __restrict__ h,
                                            int complex_h, float2& carry) {
  constexpr bool kX = (kMask & kNoExchanges) == 0, kD = (kMask & kNoButterflies) == 0;
  float2* row = sm.buf + (kE + 1) * threadIdx.x;
  float2 a[kE];
#pragma unroll
  for (int m = 0; m < kE; ++m) a[m] = kX ? row[m] : make_float2(carry.x + m, carry.y);
  if constexpr (kD) dft<kE, false>(a, nullptr);
  if constexpr ((kMask & kNoSpectrum) != 0) {
  } else if (complex_h) {
    const float4* h4 = reinterpret_cast<const float4*>(h) + threadIdx.x * (kE / 2);
#pragma unroll
    for (int k = 0; k < kE / 2; ++k) {
      const float4 v = __ldg(h4 + k);
      a[2 * k] = cmul(a[2 * k], make_float2(v.x, v.y));
      a[2 * k + 1] = cmul(a[2 * k + 1], make_float2(v.z, v.w));
    }
  } else {
    const float4* h4 = reinterpret_cast<const float4*>(h) + threadIdx.x * (kE / 4);
#pragma unroll
    for (int k = 0; k < kE / 4; ++k) {
      const float4 v = __ldg(h4 + k);
      const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[4 * k + u] = make_float2(a[4 * k + u].x * s[u], a[4 * k + u].y * s[u]);
    }
  }
  if constexpr (kD) dft<kE, true>(a, nullptr);
#pragma unroll
  for (int m = 0; m < kE; ++m) {
    if constexpr (kX)
      row[m] = a[m];
    else
      carry = cadd(carry, a[m]);
  }
}

// Blocks a thread count's SM holds at most: the kernels' launch bounds.
// At most 128 registers a thread: one 512-thread block an SM at n 16384,
// two 256-thread blocks at n 8192.
template <int N>
constexpr int kMinBlocks = N >= 1024 ? kMaxThreads / (N / kE) : 16;

// The passes of one length-N transform, from the first forward pass to the
// last inverse pass, with the stages of kMask left out (0: all of them).
// kRows: the first forward pass reads the rows and the last inverse pass
// stores them (one block a pair of rows); else both stay in shared memory
// (a segment of the cluster form, below).
template <int N, bool kFramed, int kMask, bool kRows>
__device__ __forceinline__ void passes(const Smem& sm, const Rows& io,
                                       const float* __restrict__ h, int complex_h) {
  using P = Plan<N>;
  constexpr int T = P::T, Q = P::Q, R0 = P::R0, kP = P::kP;
  constexpr bool kQ = P::kQ, kR = P::kR, kA = P::kA;
  // forward: the first pass reads the rows
  constexpr int M = (kMask & kIoOnly) != 0 ? kAllStages : kMask;
  constexpr bool kSync = (M & kNoExchanges) == 0, kMid = (kMask & kIoOnly) == 0;
  float2 carry = make_float2(0.0f, 0.0f);
  if constexpr (kQ) {
    fft_pass<Q, false, kRows, false, kP, 1, N / Q, T, kFramed, M>(sm, io, carry);
    if constexpr (kSync) __syncthreads();
  }
  if constexpr (kR && (kMid || !kQ)) {
    fft_pass<R0, false, !kQ && kRows, false, kP - P::R0Log2, Q, N / R0, T, kFramed, M>(
        sm, io, carry);
    if constexpr (kSync) __syncthreads();
  }
  if constexpr (kA && (kMid || (!kQ && !kR))) {
    fft_pass<kE, false, !kQ && !kR && kRows, false, 5, N / 1024, N / kE, T, kFramed, M>(
        sm, io, carry);
    if constexpr (kSync) __syncthreads();
  }
  if constexpr (kMid) {
    middle_pass<M>(sm, h, complex_h, carry);
    if constexpr (kSync) __syncthreads();
  }
  // inverse, in reverse order: the last pass stores the rows
  if constexpr (kA && (kMid || (!kQ && !kR))) {
    fft_pass<kE, true, false, !kQ && !kR && kRows, 5, N / 1024, N / kE, T, kFramed, M>(
        sm, io, carry);
    if constexpr ((kQ || kR) && kSync) __syncthreads();
  }
  if constexpr (kR && (kMid || !kQ)) {
    fft_pass<R0, true, false, !kQ && kRows, kP - P::R0Log2, Q, N / R0, T, kFramed, M>(
        sm, io, carry);
    if constexpr (kQ && kSync) __syncthreads();
  }
  if constexpr (kQ) fft_pass<Q, true, false, kRows, kP, 1, N / Q, T, kFramed, M>(sm, io, carry);
}

// The block's twiddle tables in shared memory after the padded row: the
// host's kTable entries, then (n / 32 >= 1024) W_1024^x filled from them.
template <int N>
__device__ __forceinline__ Smem load_tables(float2* smem2, const float2* __restrict__ tw) {
  constexpr int T = Plan<N>::T;
  float2* tab = smem2 + N + N / 32;
  for (int k = threadIdx.x; k < kTable; k += T) tab[k] = tw[k];
  const Smem sm{smem2, tab, tab + kLo, tab + 2 * kLo, tab + kTable};
  if constexpr (Plan<N>::kA) {
    __syncthreads();
    for (int k = threadIdx.x; k < 1024; k += T) tab[kTable + k] = twiddle(sm, k * (N / 1024));
  }
  return sm;
}

// The kernel's body with the stages of kMask left out (0: all of them).
// One block per complex row c: real rows c and c + half (a zero row rides
// along where c + half == rows). Rows in and out have length dim.
template <int N, bool kFramed, int kMask>
__device__ __forceinline__ void conv_rows(const float* __restrict__ x, float* __restrict__ out,
                                          const float2* __restrict__ tw,
                                          const float* __restrict__ h, int complex_h, int rows,
                                          int half, int dim, int pad) {
  extern __shared__ __align__(16) float2 smem2[];
  const Smem sm = load_tables<N>(smem2, tw);
  const int ra = blockIdx.x;
  const int rb = blockIdx.x + half;
  const bool has_b = rb < rows;
  const Rows io{x + static_cast<size_t>(ra) * dim, x + static_cast<size_t>(rb) * dim,
                out + static_cast<size_t>(ra) * dim, out + static_cast<size_t>(rb) * dim,
                has_b, dim, pad};
  __syncthreads();
  passes<N, kFramed, kMask, true>(sm, io, h, complex_h);
}

template <int N, bool kFramed>
__global__ void __launch_bounds__(N / kE, kMinBlocks<N>)
fft_conv_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const float2* __restrict__ tw,
                     const float* __restrict__ h, int complex_h, int rows,
                     int half, int dim, int pad) {
  conv_rows<N, kFramed, 0>(x, out, tw, h, complex_h, rows, half, dim, pad);
}

// ---- the cluster form: n = C * kMaxN, C in {2, 4, 8} ----

// Shared memory of a CTA of the cluster form: the length-kMaxN body's, then
// the cluster pass's two tables (W_n^l, l < 128; W_n^(128 h), h < n / 128).
template <int C>
constexpr int kClusterSmem = Plan<kMaxN>::kSmem + 8 * (kLo + C * kMaxN / kLo);

// Butterflies a thread of the cluster pass loads at once: 2 C values each
// (rows a and b), 16 loads in flight.
template <int C>
constexpr int kClusterUnroll = C >= 8 ? 1 : 8 / C;

// A cluster of C CTAs per pair of rows, CTA q owning segment q (positions
// [q M, (q + 1) M), M = kMaxN) of the transform in its shared memory.
// Forward: one radix-C pass over stride M reads the rows (framing them for
// K3f) and sends output q of butterfly j, times W_n^(q j), to position j of
// CTA q's segment over distributed shared memory; then each CTA runs the
// length-M body (passes<kMaxN, ..., false>) on its segment, multiplying by
// H's segment q (the host's bin order has the cluster digit first), and
// leaves the inverse in its shared memory; the inverse radix-C pass gathers
// position j of every CTA's segment, multiplies by conj(W_n^(q j)), runs the
// conjugate C-point DFT and stores the rows. The CTAs split each radix-C
// pass's M butterflies evenly. Device-memory traffic stays one read and one
// write of the rows.
template <int C, bool kFramed>
__global__ void __launch_bounds__(kMaxThreads, 1)
fft_conv_rows_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                             const float2* __restrict__ tw,
                             const float* __restrict__ h, int complex_h, int rows,
                             int half, int dim, int pad) {
  namespace cg = cooperative_groups;
  constexpr int M = kMaxN, T = kMaxThreads, N = C * M, B = M / C, U = kClusterUnroll<C>;
  static_assert(B % (T * U) == 0, "the cluster pass splits evenly");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) float2 smem2[];
  const Smem sm = load_tables<M>(smem2, tw);
  // the cluster pass's tables, after the body's and the W_1024 table
  float2* ctab = smem2 + M + M / 32 + kTable + 1024;
  for (int k = threadIdx.x; k < kLo + N / kLo; k += T) ctab[k] = tw[kTable + k];
  const int ra = blockIdx.x / C;
  const int rb = ra + half;
  const bool has_b = rb < rows;
  const Rows io{x + static_cast<size_t>(ra) * dim, x + static_cast<size_t>(rb) * dim,
                out + static_cast<size_t>(ra) * dim, out + static_cast<size_t>(rb) * dim,
                has_b, dim, pad};
  // every CTA of the cluster has started and filled its tables before any
  // CTA writes into its segment
  cluster.sync();

  // forward radix-C pass: rows -> the C segments
#pragma unroll 1
  for (int k = 0; k < B / (T * U); ++k) {
    float2 a[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = rank * B + threadIdx.x + (k * U + u) * T;
#pragma unroll
      for (int m = 0; m < C; ++m) a[u][m] = load_row<kFramed>(io, j + m * M);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = rank * B + threadIdx.x + (k * U + u) * T;
      dft<C, false>(a[u], nullptr);
      const int s = sidx(j);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int e = q * j;  // < N
        const float2 v = q ? cmul(a[u][q], cmul(ctab[kLo + (e >> 7)], ctab[e & (kLo - 1)]))
                           : a[u][0];
        cluster.map_shared_rank(smem2, q)[s] = v;
      }
    }
  }
  cluster.sync();

  // the length-M body on this CTA's segment, H's segment `rank`
  passes<M, kFramed, 0, false>(sm, io, h + static_cast<size_t>(complex_h ? 2 : 1) * rank * M,
                               complex_h);
  cluster.sync();

  // inverse radix-C pass: the C segments -> rows
#pragma unroll 1
  for (int k = 0; k < B / (T * U); ++k) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = rank * B + threadIdx.x + (k * U + u) * T;
      const int s = sidx(j);
      float2 a[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float2 v = cluster.map_shared_rank(smem2, q)[s];
        const int e = q * j;
        a[q] = q ? cmulc(v, cmul(ctab[kLo + (e >> 7)], ctab[e & (kLo - 1)])) : v;
      }
      dft<C, true>(a, nullptr);
#pragma unroll
      for (int m = 0; m < C; ++m) store_row<kFramed>(io, j + m * M, a[m]);
    }
  }
  // no CTA leaves while another still reads its segment
  cluster.sync();
}

}  // namespace

#ifndef FFT4STEP_KERNELS_ONLY

namespace {

template <int N, bool kFramed>
int launch_n(const float* x, float* out, const float2* tw, const float* h, int complex_h,
             int rows, int dim, int pad, cudaStream_t stream) {
  auto kernel = fft_conv_rows_kernel<N, kFramed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<N>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int half = (rows + 1) / 2;
  kernel<<<half, Plan<N>::T, Plan<N>::kSmem, stream>>>(x, out, tw, h, complex_h, rows,
                                                        half, dim, pad);
  return static_cast<int>(cudaGetLastError());
}

// The cluster form at n = C * kMaxN: clusters of C CTAs, one a pair of rows.
// A cluster that cannot be placed fails the launch (the error is returned).
template <int C, bool kFramed>
int launch_cluster(const float* x, float* out, const float2* tw, const float* h,
                   int complex_h, int rows, int dim, int pad, cudaStream_t stream) {
  auto kernel = fft_conv_rows_cluster_kernel<C, kFramed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem<C>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int half = (rows + 1) / 2;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(half) * C);
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = kClusterSmem<C>;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, out, tw, h, complex_h, rows, half, dim, pad);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the lengths the kernel takes: powers of two 256..16384, 1024 k for
// k = 5..16, and the cluster form's 32768, 65536 and 131072
int launch(const void* x, void* out, const void* tw, const void* h,
           int complex_h, int rows, int n, int dim, int pad, bool framed,
           cudaStream_t stream) {
  if (rows < 1 || dim < 1 || pad < 0 || pad > dim - 1 || dim + 2 * pad > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  const float2* t = static_cast<const float2*>(tw);
  const float* hs = static_cast<const float*>(h);
  switch (n) {
#define K3_CASE(NN) \
  case NN:                                                              \
    return framed ? launch_n<NN, true>(xs, os, t, hs, complex_h, rows, dim, pad, stream) \
                  : launch_n<NN, false>(xs, os, t, hs, complex_h, rows, dim, pad, stream);
    K3_CASE(256) K3_CASE(512) K3_CASE(1024) K3_CASE(2048) K3_CASE(4096)
    K3_CASE(8192) K3_CASE(16384)
    K3_CASE(5120) K3_CASE(6144) K3_CASE(7168) K3_CASE(9216) K3_CASE(10240)
    K3_CASE(11264) K3_CASE(12288) K3_CASE(13312) K3_CASE(14336) K3_CASE(15360)
#undef K3_CASE
#define K3_CLUSTER(C) \
  case C * kMaxN:                                                                         \
    return framed                                                                         \
        ? launch_cluster<C, true>(xs, os, t, hs, complex_h, rows, dim, pad, stream)      \
        : launch_cluster<C, false>(xs, os, t, hs, complex_h, rows, dim, pad, stream);
    K3_CLUSTER(2) K3_CLUSTER(4) K3_CLUSTER(8)
#undef K3_CLUSTER
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K3: rows x n floats already framed to the transform length -> rows x n.
// tw: the twiddle tables, 272 interleaved complex values: Tlo (W_n^l,
// l < 128), Thi (W_n^(128 h), h < n / 128, zero past it), W_Q^k (k < Q,
// zero past it); past n 16384 those of the body's length 16384, then the
// cluster pass's W_n^l (l < 128) and W_n^(128 h) (h < n / 128), 128 + n / 128
// more; h: the spectrum in the kernel's bin order, scaled by 1/n
// (n floats, or 2n interleaved when complex_h). Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int fft_conv_rows(const void* x, void* out, const void* tw,
                             const void* h, int complex_h, int rows, int n,
                             void* stream) {
  return launch(x, out, tw, h, complex_h, rows, n, n, 0, false,
                static_cast<cudaStream_t>(stream));
}

// K3f: rows x dim unpadded floats -> rows x dim, framed in the kernel with
// a reflect-101 pad of pad <= dim - 1 and zeros up to n.
extern "C" int fft_conv_rows_framed(const void* x, void* out, const void* tw,
                                    const void* h, int complex_h, int rows,
                                    int n, int dim, int pad, void* stream) {
  return launch(x, out, tw, h, complex_h, rows, n, dim, pad, true,
                static_cast<cudaStream_t>(stream));
}

#endif  // FFT4STEP_KERNELS_ONLY
