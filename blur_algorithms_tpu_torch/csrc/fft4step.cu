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
// The kernel is a template on n (17 lengths; the cluster forms below take
// 4 more, the staged form every power of two past them) and on whether it
// frames the rows (K3f) or reads them as they are (K3), so every stride,
// count and twiddle step is a constant and shared addresses fold into immediates.
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
// (fft_conv_rows_cluster_kernel) splits the transform over a thread-block
// cluster of C CTAs, CTA q holding segment q of M = n / C points
// (cluster_segment: 16384 at n 32768 and 131072, 8192 at 65536). Its design
// follows an ablation of PR 16's form (a radix-C pass over stride 16384
// into the segments over distributed shared memory, the whole 16384 body on
// each, a radix-C pass back by remote loads; probes/k3_cluster_variants.py,
// PERF.md): that form's body alone took 0.14 us a CTA on the card, about
// what the one-block 16384 form takes for everything, its cluster barriers
// 6-9% and its remote accesses 6-8%, with one CTA an SM to hide neither.
//   1. No pass of its own: the cluster's exchange is the first pass of the
//      transform, radix n / 1024 over stride 1024, which reads the rows
//      (framing them for K3f) and stores each output straight into its
//      segment's CTA; the segments run the body's radix-32 passes and the
//      middle pass, and the last inverse pass mirrors the first. Four
//      exchanges a point, as in the one-block form. A lane holds 32 values
//      of the first pass: at radix 64 and 128 a butterfly is split over 2
//      or 4 lanes of a warp that trade their radix-C outputs by shuffles
//      (cluster_forward, below).
//   2. Remote traffic only as stores: the inverse radix-32 pass keeps its
//      outputs in registers, waits until their slabs' readers are done
//      (item 3) and stores them straight into the slabs of the CTA that
//      runs their last pass, so no CTA loads from another, and none waits
//      for the others before it exits.
//   3. Receivers count their data: a remote store carries its 8 bytes to
//      the receiver's mbarrier (st.async ... complete_tx), which expects the
//      bytes its peers send, so a warp waits for its own sub-block of 1024
//      and the last pass for its slabs, not for every CTA of the cluster.
//      Between the exchanges a warp's passes touch its own sub-block only
//      (__syncwarp), and the slabs a CTA receives from the peers' warps k
//      lie in its own sub-block k, so before those warps store there they
//      wait for this CTA's warp k alone to have read it (one remote arrival
//      a peer on a per-sub-block mbarrier). One cluster barrier is left
//      (every CTA has started and set up its mbarriers), split: arrived at
//      early, waited on after the first pass's loads and DFTs.
//   4. The framed loads of the first pass hold no predicate (load_folded):
//      64 loads a thread are in flight, and per-load predicates spilled.
// Persistent clusters (each walking pairs of rows, tables loaded once)
// spilled 330-950 bytes a thread and ran 1.3-1.5x slower; a first pass that
// read the rows through L2 once a CTA (no forward exchange) ran 1.1-1.6x
// slower: neither is kept. Device-memory traffic stays one read and one
// write of the rows; a CTA holds its padded segment, the body's tables, the
// W_1024 table and the first pass's W_n tables (128 + n / 128 entries, as
// Tlo / Thi above; entry 8 e of the high one is W_(n/1024)^e), ~81 KB at M
// 8192 (two CTAs an SM) and ~155 KB at 16384.
// At n 262144 the wide cluster form (fft_conv_rows_wide_kernel, below): 16
// CTAs of 16384, a radix-16 pass into the segments and back, the whole
// one-block body on each, on persistent clusters; one read and one write
// of the rows. Past it, and at it on a card that places no cluster of 16
// (the wrapper asks cudaOccupancyMaxActiveClusters before the launch), the
// staged form (fft_conv_rows_staged_*, below):
// radix-8/16/32 passes over the segments of 16384 through a complex
// scratch buffer in device memory, each segment through the one-block body,
// the passes' adjoints back to the rows. No length cap but the C entries'
// int (2^30).
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
// probe includes this file with FFT4STEP_KERNELS_ONLY defined (no C
// entries, no instantiation here; the cluster form's launch templates stay,
// for the probe's segment variant) and instantiates the other masks at the
// lengths it runs, and PR 16's cluster form with its parts left out.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

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
// Not a stage left out: the first pass reads, and the last pass stores, one
// complex row (Rows::z) in place of the pair of real rows (the staged
// form's segment pass on its segment of scratch).
constexpr int kComplexIo = 32;

// What the ablation of the cluster form leaves out (timing only: any
// variant but 0 gives a wrong result; probes/fft_ablation.cu runs them).
enum ClusterVariant {
  kVLocal = 1,       // the exchanges go to this CTA's own shared memory (same pattern)
  kVNoBarriers = 2,  // the cluster barriers become this CTA's barriers (with kVLocal:
                     // no CTA then touches another's memory); PR 16's kernel: none
                     // after the first but the one before exit, unless kVLocal
  kVIoOnly = 4,      // PR 16's kernel: the radix-C pass's reads and the last stores alone
  kVBodyOnly = 8,    // PR 16's kernel: the length-16384 body alone, no radix-C pass, no rows
  kVPushBarriers = 16,  // the current kernel's pushes end at cluster barriers, not at the
                        // receivers' transaction counts
};

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
  float2* z;  // kComplexIo: the complex row read and stored in place
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
    if constexpr (kIn && (kMask & kComplexIo) != 0)
      a[m] = io.z[base + m * S];
    else if constexpr (kIn)
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
    if constexpr (kOut && (kMask & kComplexIo) != 0)
      io.z[base + q * S] = a[q];
    else if constexpr (kOut)
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

// ---- the cluster form: n = C * M, M = cluster_segment(n) ----

// The segment length of the cluster form at transform length n, the faster
// of the two on the card (probes/k3_cluster_variants.py): 16384 at n 32768
// and 131072 (clusters of 2 and 8, one CTA an SM), 8192 at 65536 (clusters
// of 8, two CTAs an SM; at 131072 that would take 16, past the portable
// cluster size).
__host__ __device__ constexpr int cluster_segment(int n) { return n == 65536 ? 8192 : kMaxN; }

// Shared memory of a CTA of the cluster form: its padded segment, the
// length-16384 body's tables (kTable entries), the W_1024 table, the first
// pass's W_n tables (W_n^l, l < 128; W_n^(128 h), h < n / 128), then the
// mbarriers (a sub-block of 1024's data and its peers' reads of theirs,
// and the slabs' data).
template <int M, int C>
constexpr int kClusterSmem =
    8 * (M + M / 32) + 8 * kTable + 8 * 1024 + 8 * (kLo + C * M / kLo) + 8 * (2 * M / 1024 + 1);

// The cluster's own barrier, split: every thread of every CTA arrives, then
// waits. arrive_release orders this thread's earlier shared-memory accesses
// (local and remote) before any thread's return from the matching wait.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The shared-memory address `addr` of this CTA in CTA `rank` of the cluster,
// and a store there (distributed shared memory; rank may be this CTA's).
__device__ __forceinline__ uint32_t dsmem_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void dsmem_store(uint32_t addr, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v.x), "f"(v.y)
               : "memory");
}

// One-shot mbarriers in shared memory (each completes one phase, parity 0)
// and the stores that complete their transactions from another CTA: the
// receiver expects the bytes its CTA's peers store into it, and a wait
// returns once they have all landed (acquire at cluster scope).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Waits until the phase completes; a wait that outlasts any correct run
// (2^22 polls) traps, so a lost transaction fails the launch, not the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar) : "memory");
    if (spins > (1 << 22)) __trap();
  }
}
// An arrival on another CTA's mbarrier, releasing this thread's earlier
// accesses (and, after a __syncwarp, its warp's) at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void dsmem_store_tx(uint32_t addr, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
      ::"r"(addr), "f"(v.x), "f"(v.y), "r"(bar) : "memory");
}

// The cluster barrier's halves and the map to another CTA's shared memory as
// a variant of the ablation has them: kVNoBarriers waits on this CTA's
// barrier in place of the cluster's (its arrive is nothing), kVLocal maps
// every CTA to this one.
template <int kVar>
__device__ __forceinline__ void cluster_sync_arrive() {
  if constexpr ((kVar & kVNoBarriers) == 0) cluster_arrive_release();
}
template <int kVar>
__device__ __forceinline__ void cluster_sync_wait() {
  if constexpr ((kVar & kVNoBarriers) == 0)
    cluster_wait();
  else
    __syncthreads();
}
template <int kVar>
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  if constexpr ((kVar & kVLocal) != 0)
    return addr;
  else
    return dsmem_map(addr, rank);
}

// v * (-i)^k, k < 4 known at run time: exact (swaps and sign changes)
__device__ __forceinline__ float2 quarter_turns(float2 v, int k) {
  const float2 r = (k & 1) ? make_float2(v.y, -v.x) : v;
  return (k & 2) ? make_float2(-r.x, -r.y) : r;
}

// Where the cluster form keeps what. A pair of rows is one transform of
// n = C M; position p = j + 1024 K (j < 1024, K < C R0 with R0 = M / 1024,
// K = m + R0 c: m < R0, c < C the segment). The transform's first pass is
// radix Rf = n / 1024 over stride 1024; its output (q, k) (the DFT's bin
// kk = q + C k, k < R0) lives at j + 1024 k of segment q. The first pass
// and the last (its adjoint) are split over a group of G = Rf / 32 lanes of
// one warp a butterfly j, so that a lane holds 32 values: lane `g` of the
// group takes m in [g MG, (g + 1) MG) (MG = R0 / G) for every c and the
// outputs q = QG g + e (QG = C / G), trading values with the group's other
// lanes by shuffles between its radix-C and its radix-R0 DFTs. CTA r's
// M / 32 threads take j in [r J, (r + 1) J), J = 1024 / C: thread t is
// warp w = t / 32, lane l, g = l / (32 / G), j = r J + w (32 / G) + l % (32 / G).
template <int M, int C>
struct ClusterMap {
  static constexpr int N = C * M, R0 = M / 1024, G = N / 32768, MG = R0 / G, QG = C / G;
  static constexpr int LG = 32 / G, J = 1024 / C, T = M / kE;
  static_assert(G * 32768 == N && MG * G == R0 && QG * G == C && C * MG == 32,
                "a lane holds 32 values of the first pass");
};

// The segments' slabs for the last inverse pass: CTA r holds, for each
// source segment q and output k, its J values j in [r J, (r + 1) J) as
// slab (q, k), at jl = j - r J of the q-th J values of its own sub-block k
// (positions k 1024 .. k 1024 + 1023: C J = 1024), so that only this CTA's
// warp k reads what a slab overwrites. Padded as sidx; free of bank
// conflicts both ways (tests/test_torch_fft4step_passes.py).
template <int M, int C>
__device__ __forceinline__ int slab_index(int q, int k, int jl) {
  return sidx(k * 1024 + q * ClusterMap<M, C>::J + jl);
}

// Position pos of the transform from the rows, as load_row, with no
// predicate held across the load (the cluster form's first pass issues 64
// loads a thread at once, and per-load predicates spilled): K3f's source
// column is folded into the row (reflect-101 at 0 and at dim - 1, then
// clamped at 0 past the reflected edge) and the zero tail is applied after
// the load as a factor 0 or 1 (a row holding a NaN or an infinity gives a
// transform of NaNs either way).
template <bool kFramed>
__device__ __forceinline__ float2 load_folded(const Rows& io, int pos) {
  if constexpr (!kFramed) {
    return load_row<false>(io, pos);
  } else {
    const int a = abs(pos - io.pad);
    const int src = max(0, (io.dim - 1) - abs((io.dim - 1) - a));
    const int inside = min(max(io.dim + 2 * io.pad - pos, 0), 1);
    const float keep = __int_as_float(inside * 0x3f800000);  // 1.0f or 0.0f
    return make_float2(__ldg(io.xa + src) * keep, io.has_b ? __ldg(io.xb + src) * keep : 0.0f);
  }
}

// The first forward pass of the cluster form (the note above): rows -> the
// C segments. The value of output (q, k) is the radix-Rf DFT's bin
// kk = q + C k times W_n^(kk j); lane g's radix-C DFTs take their input
// times W_G^(g c) so that its own outputs q = QG g + e come out at slots e
// (slot s holds q = (s + QG g) mod C), and its radix-R0 DFTs see m rotated
// by g MG (slot t holds m = (t + g MG) mod R0), which the outer twiddle
// undoes by W_G^(k g) (exponent k g n / G). It waits on the cluster barrier
// (every CTA has started and set up its mbarriers) only after its loads,
// radix-C DFTs and shuffles.
template <int M, int C, bool kFramed, int kVar>
__device__ __forceinline__ void cluster_forward(const float2* ctab, float2* buf, uint32_t seg,
                                                uint32_t bars, const Rows& io, int j, int g,
                                                int lane, int rank) {
  using CM = ClusterMap<M, C>;
  constexpr int G = CM::G, MG = CM::MG, QG = CM::QG, R0 = CM::R0, N = CM::N;
  float2 a[C][MG];
#pragma unroll
  for (int mi = 0; mi < MG; ++mi)
#pragma unroll
    for (int c = 0; c < C; ++c)
      a[c][mi] = load_folded<kFramed>(io, j + 1024 * (g * MG + mi) + M * c);
  // radix C over c; then W_Rf^(q m) = W_n^(1024 q m) = Thi[8 q m]
#pragma unroll
  for (int mi = 0; mi < MG; ++mi) {
    float2 v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = quarter_turns(a[c][mi], (g * c * (4 / G)) & 3);
    dft<C, false>(v, nullptr);
    const int m = g * MG + mi;
#pragma unroll
    for (int s = 0; s < C; ++s)
      a[s][mi] = cmul(v[s], ctab[kLo + 8 * ((s + QG * g) & (C - 1)) * m]);
  }
  // lane g takes slot t = d MG + mi of each of its outputs q = QG g + e from
  // lane (g + d) mod G, whose slot (e - QG d) mod C holds that q
  float2 w[QG][R0];
#pragma unroll
  for (int d = 0; d < G; ++d)
#pragma unroll
    for (int e = 0; e < QG; ++e)
#pragma unroll
      for (int mi = 0; mi < MG; ++mi) {
        const float2 v = a[(e - QG * d + C) & (C - 1)][mi];
        w[e][d * MG + mi] =
            d == 0 ? v
                   : make_float2(__shfl_sync(0xffffffffu, v.x, (lane + d * CM::LG) & 31),
                                 __shfl_sync(0xffffffffu, v.y, (lane + d * CM::LG) & 31));
      }
  cluster_sync_wait<kVar>();
  const int step = (C * j + g * (N / G)) & (N - 1);
#pragma unroll
  for (int e = 0; e < QG; ++e) {
    const int q = QG * g + e;
    dft<R0, false>(w[e], nullptr);
    // sidx(j + 1024 k) = sidx(j) + 1056 k; sub-block k's mbarrier is bars + 8 k
    const bool tx = (kVar & kVPushBarriers) == 0 && q != rank;
    const uint32_t dst = cluster_map<kVar>(seg, q) + 8 * sidx(j);
    const uint32_t bar = tx ? dsmem_map(bars, q) : 0;
#pragma unroll
    for (int k = 0; k < R0; ++k) {
      const int x = (q * j + k * step) & (N - 1);
      const float2 v = cmul(w[e][k], cmul(ctab[kLo + (x >> 7)], ctab[x & (kLo - 1)]));
      if constexpr ((kVar & kVPushBarriers) != 0)
        dsmem_store(dst + 8 * (1024 + 32) * k, v);
      else if (tx)
        dsmem_store_tx(dst + 8 * (1024 + 32) * k, v, bar + 8 * k);
      else
        buf[sidx(j) + (1024 + 32) * k] = v;
    }
  }
}

// The last inverse pass, the adjoint of the first: CTA r's slabs -> rows.
// Lane g conjugate-twiddles and inverse-DFTs (radix R0) its outputs
// q = QG g + e, which leaves slot t holding m = (t + g MG) mod R0 where the
// outer twiddle carries W_G^(-k g) (exponent k g n / G) besides W_n^(-kk j);
// the shuffles hand slot t = d MG + mi to lane (g + d) mod G as its slot
// (e - QG d) mod C (slot s holds q = (s + QG g) mod C); the inverse radix-C
// DFT over those slots, then W_G^(-g c), gives x at j + 1024 m + M c.
template <int M, int C, bool kFramed>
__device__ __forceinline__ void cluster_inverse(const float2* ctab, const float2* buf,
                                                const Rows& io, int j, int jl, int g, int lane) {
  using CM = ClusterMap<M, C>;
  constexpr int G = CM::G, MG = CM::MG, QG = CM::QG, R0 = CM::R0, N = CM::N;
  float2 w[QG][R0];
#pragma unroll
  for (int e = 0; e < QG; ++e)
#pragma unroll
    for (int k = 0; k < R0; ++k) w[e][k] = buf[slab_index<M, C>(QG * g + e, k, jl)];
  const int step = (C * j + g * (N / G)) & (N - 1);
#pragma unroll
  for (int e = 0; e < QG; ++e) {
    const int q = QG * g + e;
#pragma unroll
    for (int k = 0; k < R0; ++k) {
      const int x = (q * j + k * step) & (N - 1);
      w[e][k] = cmulc(w[e][k], cmul(ctab[kLo + (x >> 7)], ctab[x & (kLo - 1)]));
    }
    dft<R0, true>(w[e], nullptr);
  }
  // slot t = d MG + mi of output q = QG g + e goes back to lane (g + d) mod
  // G, as its slot (e - QG d) mod C: lane g takes it from lane (g - d) mod G
  float2 a[C][MG];
#pragma unroll
  for (int d = 0; d < G; ++d)
#pragma unroll
    for (int e = 0; e < QG; ++e)
#pragma unroll
      for (int mi = 0; mi < MG; ++mi) {
        const float2 v = w[e][d * MG + mi];
        a[(e - QG * d + C) & (C - 1)][mi] =
            d == 0 ? v
                   : make_float2(
                         __shfl_sync(0xffffffffu, v.x, (lane - d * CM::LG + 32) & 31),
                         __shfl_sync(0xffffffffu, v.y, (lane - d * CM::LG + 32) & 31));
      }
#pragma unroll
  for (int mi = 0; mi < MG; ++mi) {
    const int m = g * MG + mi;
    float2 v[C];
#pragma unroll
    for (int s = 0; s < C; ++s)
      v[s] = cmulc(a[s][mi], ctab[kLo + 8 * ((s + QG * g) & (C - 1)) * m]);
    dft<C, true>(v, nullptr);
#pragma unroll
    for (int c = 0; c < C; ++c)
      store_row<kFramed>(io, j + 1024 * m + M * c,
                         quarter_turns(v[c], (4 - ((g * c * (4 / G)) & 3)) & 3));
  }
}

// A cluster of C CTAs per pair of rows, CTA q owning segment q (positions
// [q M, (q + 1) M)) of the transform after the first pass:
//   1. the first pass (cluster_forward) reads the rows, framing them for
//      K3f, and stores each output into its segment's CTA (distributed
//      shared memory);
//   2. warp k, once its sub-block k is complete, runs the segment's own
//      passes there (radix 32 over spans of 1024, the middle pass with H's
//      segment q, the inverse radix-32 pass into registers);
//   3. once the peers' warps k have read their sub-blocks k (each tells
//      this CTA's warp k by a remote arrival before its inverse pass's
//      DFTs, which hide the wait), warp k stores its inverse pass's outputs
//      straight into the slabs of the CTA whose j they are;
//   4. the last pass (cluster_inverse) waits for its slabs, reads them and
//      stores the rows. Every transfer into a CTA ends at one of its own
//      waits, so none waits for the others before it exits.
// The data's completion is counted on mbarriers (the ablation's variants,
// kVPushBarriers: by cluster barriers after the pushes, the slab stores
// after a cluster barrier). At M 8192 two CTAs (of different clusters)
// share an SM; at 16384 one fills it.
template <int M, int C, bool kFramed, int kVar = 0>
__global__ void __launch_bounds__(M / kE, kMaxN / M)
fft_conv_rows_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                             const float2* __restrict__ tw,
                             const float* __restrict__ h, int complex_h, int rows,
                             int half, int dim, int pad) {
  static_assert((kVar & ~(kVLocal | kVNoBarriers | kVPushBarriers)) == 0 &&
                    ((kVar & (kVLocal | kVNoBarriers)) == 0 || (kVar & kVPushBarriers) != 0) &&
                    ((kVar & kVNoBarriers) == 0 || (kVar & kVLocal) != 0),
                "the current kernel's variants: 16, 17, 19");
  constexpr bool kTx = (kVar & kVPushBarriers) == 0;
  using CM = ClusterMap<M, C>;
  constexpr int T = CM::T, J = CM::J;
  const int rank = cluster_rank();
  extern __shared__ __align__(16) float2 smem2[];
  // the body's tables of length 16384 (the host's layout), W_1024 filled
  // from them, then W_n's
  float2* tab = smem2 + M + M / 32;
  for (int k = threadIdx.x; k < kTable; k += T) tab[k] = tw[k];
  const Smem sm{smem2, tab, tab + kLo, tab + 2 * kLo, tab + kTable};
  float2* ctab = tab + kTable + 1024;
  for (int k = threadIdx.x; k < kLo + CM::N / kLo; k += T) ctab[k] = tw[kTable + k];
  __syncthreads();
  for (int k = threadIdx.x; k < 1024; k += T) tab[kTable + k] = twiddle(sm, k * (kMaxN / 1024));
  // the mbarriers: sub-block k's data expects the 1024 - J values the other
  // CTAs store into it; its peers' reads, the C - 1 other CTAs' warps k
  // (one arrival each, once they have read their sub-block k); the slabs'
  // data, the (C - 1) R0 J values the other CTAs store there
  const uint32_t seg = static_cast<uint32_t>(__cvta_generic_to_shared(smem2));
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(ctab + kLo + CM::N / kLo));
  const uint32_t read_bars = bars + 8 * CM::R0, slab_bar = bars + 16 * CM::R0;
  if (kTx && threadIdx.x == 0) {
    for (int k = 0; k < CM::R0; ++k) {
      mbar_init(bars + 8 * k, 1);
      mbar_init(read_bars + 8 * k, C - 1);
    }
    mbar_init(slab_bar, 1);
    mbar_init_fence();
    for (int k = 0; k < CM::R0; ++k) mbar_expect_tx(bars + 8 * k, 8 * (1024 - J));
    mbar_expect_tx(slab_bar, 8 * (C - 1) * CM::R0 * J);
  }
  __syncthreads();
  if constexpr ((kVar & kVNoBarriers) == 0)
    cluster_arrive_release();  // this CTA has started: its segment may be written
  const int ra = static_cast<int>(blockIdx.x) / C;
  const int rb = ra + half;
  const Rows io{x + static_cast<size_t>(ra) * dim, x + static_cast<size_t>(rb) * dim,
                out + static_cast<size_t>(ra) * dim, out + static_cast<size_t>(rb) * dim,
                rb < rows, dim, pad};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / CM::LG;
  const int jl = warp * CM::LG + lane % CM::LG;
  const int j = rank * J + jl;

  cluster_forward<M, C, kFramed, kVar>(ctab, smem2, seg, bars, io, j, g, lane, rank);
  if constexpr (kTx) {
    __syncthreads();         // this CTA's own stores
    mbar_wait(bars + 8 * warp);  // the others' into sub-block `warp`, all this warp reads
    __syncwarp();
  } else {
    cluster_sync_arrive<kVar>();
    cluster_sync_wait<kVar>();
  }

  // warp w's passes read and write sub-block w alone (positions w 1024 ..
  // w 1024 + 1023): the radix-32 pass's butterflies w 32 + lane, the middle
  // pass's rows 32 t .. 32 t + 31, the inverse pass's butterflies
  float2 carry = make_float2(0.0f, 0.0f);
  fft_pass<kE, false, false, false, 5, M / 1024, M / kE, T, kFramed, 0>(sm, io, carry);
  __syncwarp();
  middle_pass<0>(sm, h + static_cast<size_t>(complex_h ? 2 : 1) * rank * M, complex_h, carry);
  __syncwarp();

  // the inverse radix-32 pass over spans of 1024: butterfly t of sub-block
  // k = warp, j32 = lane; output m is position k 1024 + lane + 32 m, whose
  // j = lane + 32 m belongs to CTA m / (32 / C)
  {
    const float2* b = sm.buf + sidx(warp * 1024 + lane);
    float2 v[kE];
#pragma unroll
    for (int m = 0; m < kE; ++m) v[m] = b[m * (kE + 1)];
    // this warp has read its sub-block: tell the peers' warps `warp`, whose
    // slabs go there (the ablation's variants: every CTA's reads, by the
    // cluster barrier)
    if constexpr (kTx) {
      __syncwarp();
      if (lane < C && lane != rank) mbar_arrive_remote(dsmem_map(read_bars + 8 * warp, lane));
    } else {
      cluster_sync_arrive<kVar>();
    }
#pragma unroll
    for (int q = 1; q < kE; ++q) v[q] = cmulc(v[q], sm.t1k[q * lane]);
    dft<kE, true>(v, nullptr);
    // the peers' warps `warp` have read their sub-blocks: the slabs may go
    if constexpr (kTx) {
      mbar_wait(read_bars + 8 * warp);
      __syncwarp();
    } else {
      cluster_sync_wait<kVar>();
    }
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if (kTx && r != rank) {
        const uint32_t dst = dsmem_map(seg, r), bar = dsmem_map(slab_bar, r);
#pragma unroll
        for (int mm = 0; mm < kE / C; ++mm)
          dsmem_store_tx(dst + 8 * slab_index<M, C>(rank, warp, lane + 32 * mm),
                         v[r * (kE / C) + mm], bar);
      } else if (kTx) {
#pragma unroll
        for (int mm = 0; mm < kE / C; ++mm)
          smem2[slab_index<M, C>(rank, warp, lane + 32 * mm)] = v[r * (kE / C) + mm];
      } else {
        const uint32_t dst = cluster_map<kVar>(seg, r);
#pragma unroll
        for (int mm = 0; mm < kE / C; ++mm)
          dsmem_store(dst + 8 * slab_index<M, C>(rank, warp, lane + 32 * mm),
                      v[r * (kE / C) + mm]);
      }
    }
  }
  if constexpr (kTx) {
    __syncthreads();  // this CTA's own slabs
    mbar_wait(slab_bar);  // and the others'
    __syncwarp();
  } else {
    cluster_sync_arrive<kVar>();
    cluster_sync_wait<kVar>();
  }

  cluster_inverse<M, C, kFramed>(ctab, smem2, io, j, jl, g, lane);
}

// The launch configuration of a cluster kernel: `blocks` CTAs in clusters
// of `c`, `threads` each, `smem` bytes of dynamic shared memory.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int c, int blocks, int threads, int smem, cudaStream_t stream) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of the cluster form at segment M and C CTAs the card
// holds at once (cudaOccupancyMaxActiveClusters), into *clusters.
template <int M, int C, bool kFramed>
int cluster_occupancy(int* clusters) {
  auto kernel = fft_conv_rows_cluster_kernel<M, C, kFramed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem<M, C>);
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch l(C, C, M / kE, kClusterSmem<M, C>, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg));
}

// The cluster form at segment M: a cluster of C CTAs a pair of rows. A
// cluster that cannot be placed fails the launch (the error is returned;
// nothing falls back to another form).
template <int M, int C, bool kFramed, int kVar = 0>
int launch_cluster(const float* x, float* out, const float2* tw, const float* h,
                   int complex_h, int rows, int dim, int pad, cudaStream_t stream) {
  auto kernel = fft_conv_rows_cluster_kernel<M, C, kFramed, kVar>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kClusterSmem<M, C>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int half = (rows + 1) / 2;
  ClusterLaunch l(C, half * C, M / kE, kClusterSmem<M, C>, stream);
  e = cudaLaunchKernelEx(&l.cfg, kernel, x, out, tw, h, complex_h, rows, half, dim, pad);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- the wide cluster form: n = 16 M = 262144, M = kMaxN ----
//
// A pair of rows on a cluster of 16 CTAs (past the portable 8: a size the
// H100 places 7 at once, one on each GPC of 16 or more SMs, so 112 of its
// 132 SMs work), CTA q holding segment q of M = 16384 points; nothing in
// device memory but one read and one write of the rows. It replaces the
// staged form (below) at this length, whose scratch buffer took 48 n bytes a
// pair of rows through device memory and whose segment pass ran at 2.75x
// its bytes (probes/k3_staged_variants.py). The cluster form above makes
// its first pass the exchange; at C 16 that takes G = 8 lanes a butterfly
// (4 consecutive j a lane group: 16-byte pieces of a row a load, 32-byte
// pieces a remote store), spilled 124-136 bytes a thread and ran 1.27x
// slower than the staged form. This form takes the split design instead:
//   1. a radix-16 pass over stride M: thread t of CTA r takes j = r B + t
//      + u T (B = M / 16 = 1024, T = 512, u < 2, one after the other),
//      loads x[j + m M] (m < 16; K3f framing the rows), runs the DFT and
//      stores output q times W_n^(q j) at position j of CTA q's segment,
//      lanes on consecutive j: 128 contiguous bytes of a row a load, 256 of
//      one CTA a remote store;
//   2. the body's passes of length M on each segment (H's segment q in the
//      middle pass);
//   3. the adjoint of the first pass: CTA r reads position j of every
//      segment (remote loads), conjugate-twiddles, runs the conjugate DFT
//      and stores the rows.
// What bounds it: the body, one 16384-point segment an SM at the one-block
// kernel's rate (~19 us, 7.5 ms of the adjoint's 6480 rows on 132 SMs), on
// 112 SMs, then the two exchanges over distributed shared memory (15/16 of
// the data each way) and the cluster barriers between the steps. Cluster
// barriers order the steps; the one at a pair's start is split, so that
// the pair's first loads and DFT run before the wait for the peers to have
// read the last pair's segments. The clusters are persistent: as many as
// the card places at once (cudaOccupancyMaxActiveClusters), each taking
// pairs c, c + clusters, ...; a cluster of 16 starts only on a GPC whose 16
// SMs are all free, and the tables load once. On the adjoint's rows one
// cluster a pair took 16.1 ms, persistent clusters 15.8, with the split
// barrier 15.3 (the copying staged form 20.2).

constexpr int kWideC = 16;  // CTAs of the wide cluster form
// its shared memory: the padded segment, the body's tables, the W_1024
// table and the first pass's W_n tables (128 + n / 128 entries)
constexpr int kWideSmem =
    8 * (kMaxN + kMaxN / 32) + 8 * kTable + 8 * 1024 + 8 * (kLo + kWideC * kMaxN / kLo);

__device__ __forceinline__ float2 dsmem_load(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

template <bool kFramed>
__global__ void __launch_bounds__(kMaxThreads, 1)
fft_conv_rows_wide_kernel(const float* __restrict__ x, float* __restrict__ out,
                          const float2* __restrict__ tw, const float* __restrict__ h,
                          int complex_h, int rows, int half, int dim, int pad) {
  constexpr int M = kMaxN, C = kWideC, N = C * M, T = kMaxThreads, B = M / C;
  static_assert(B == 2 * T, "a thread takes two positions j of its CTA");
  const int rank = cluster_rank();
  extern __shared__ __align__(16) float2 smem2[];
  float2* ctab = smem2 + M + M / 32 + kTable + 1024;
  for (int k = threadIdx.x; k < kLo + N / kLo; k += T) ctab[k] = tw[kTable + k];
  const Smem sm = load_tables<M>(smem2, tw);
  __syncthreads();
  const uint32_t seg = static_cast<uint32_t>(__cvta_generic_to_shared(smem2));
  const int clusters = static_cast<int>(gridDim.x) / C;
  const int j0 = rank * B + static_cast<int>(threadIdx.x);
  // the cluster's barrier at a pair's start, split: arrived at once a CTA
  // has read the last pair's segments, waited on after the next pair's
  // first loads and DFT
  cluster_arrive_release();  // this CTA has started
#pragma unroll 1
  for (int ra = static_cast<int>(blockIdx.x) / C; ra < half; ra += clusters) {
    const int rb = ra + half;
    const Rows io{x + static_cast<size_t>(ra) * dim, x + static_cast<size_t>(rb) * dim,
                  out + static_cast<size_t>(ra) * dim, out + static_cast<size_t>(rb) * dim,
                  rb < rows, dim, pad};
    // 1. rows -> the 16 segments, one position j of the thread at a time
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u * T;
      float2 a[C];
#pragma unroll
      for (int m = 0; m < C; ++m) a[m] = load_row<kFramed>(io, j + m * M);
      dft<C, false>(a, nullptr);
#pragma unroll
      for (int q = 1; q < C; ++q) {
        const int e = q * j;  // < N
        a[q] = cmul(a[q], cmul(ctab[kLo + (e >> 7)], ctab[e & (kLo - 1)]));
      }
      if (u == 0) cluster_wait();  // every CTA has started, or read the last pair
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (q == rank)
          smem2[sidx(j)] = a[q];
        else
          dsmem_store(dsmem_map(seg, q) + 8 * sidx(j), a[q]);
      }
    }
    cluster_arrive_release();
    cluster_wait();
    // 2. the segment's body of length M
    passes<M, kFramed, 0, false>(sm, io, h + static_cast<size_t>(complex_h ? 2 : 1) * rank * M,
                                 complex_h);
    cluster_arrive_release();
    cluster_wait();
    // 3. the 16 segments -> rows
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u * T;
      float2 a[C];
#pragma unroll
      for (int q = 0; q < C; ++q)
        a[q] = q == rank ? smem2[sidx(j)] : dsmem_load(dsmem_map(seg, q) + 8 * sidx(j));
      if (u == 1) cluster_arrive_release();  // this CTA has read the pair's segments
#pragma unroll
      for (int q = 1; q < C; ++q) {
        const int e = q * j;
        a[q] = cmulc(a[q], cmul(ctab[kLo + (e >> 7)], ctab[e & (kLo - 1)]));
      }
      dft<C, true>(a, nullptr);
#pragma unroll
      for (int m = 0; m < C; ++m) store_row<kFramed>(io, j + m * M, a[m]);
    }
  }
  cluster_wait();  // no CTA exits while a peer may still read its segment
}

// The wide form's kernel attributes: its shared memory and leave to place a
// cluster of 16.
template <bool kFramed>
cudaError_t wide_attributes() {
  auto kernel = fft_conv_rows_wide_kernel<kFramed>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// How many clusters of the wide form the current card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
template <bool kFramed>
int wide_occupancy(int* clusters) {
  auto kernel = fft_conv_rows_wide_kernel<kFramed>;
  cudaError_t err = wide_attributes<kFramed>();
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch l(kWideC, kWideC, kMaxThreads, kWideSmem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg));
}

// The wide cluster form at n 262144: min(pairs, the clusters the card holds
// at once) persistent clusters of 16 CTAs. On a card that places none the
// wrapper routes n 262144 to the staged form before the launch; the guard
// below returns an error should a launch come here all the same.
template <bool kFramed>
int launch_wide(const float* x, float* out, const float2* tw, const float* h, int complex_h,
                int rows, int dim, int pad, cudaStream_t stream) {
  int fit = 0;
  int e = wide_occupancy<kFramed>(&fit);
  if (e) return e;
  if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int half = (rows + 1) / 2;
  const int clusters = fit < half ? fit : half;
  auto kernel = fft_conv_rows_wide_kernel<kFramed>;
  ClusterLaunch l(kWideC, clusters * kWideC, kMaxThreads, kWideSmem, stream);
  e = static_cast<int>(
      cudaLaunchKernelEx(&l.cfg, kernel, x, out, tw, h, complex_h, rows, half, dim, pad));
  if (e) return e;
  return static_cast<int>(cudaGetLastError());
}

// ---- the staged form: n = P * M from 262144 on, M = kMaxN ----
//
// Past the 16 CTAs of the wide cluster form a pair of rows no longer fits
// the shared memory a cluster can join (at 262144 itself, on a card that
// places no cluster of 16, neither does it), so the transform is staged through
// a complex scratch buffer in device memory (n float2 a pair of rows, that
// is rows x n x 4 bytes, allocated by the wrapper):
//   1. the first passes: radix-R decimation-in-frequency passes over the P
//      segments, P = n / M = R_1 ... R_t, each R_i in {8, 16, 32}
//      (staged_digits: t = ceil(log2(P) / 5) digits, the first ones the
//      larger), a thread a butterfly, its R values in registers. The first
//      reads the rows (K3f framing them on the way, no load of the zero
//      tail) and writes scratch; each later one reads and writes scratch at
//      the same places. Output q of butterfly j of a pass over spans L is
//      multiplied by W_L^(q j) = W_n^(q j n / L);
//   2. the segment pass: each M-point segment of scratch through the
//      one-block body of length M (its radix-16 and radix-32 passes, H's
//      segment in the middle pass, the inverse passes), a block a segment,
//      the body's first pass reading the segment from scratch into its
//      registers and its last pass storing it back (kComplexIo);
//   3. the last passes: the first passes' adjoints in reverse order
//      (conjugate twiddles, then the conjugate DFT); the last stores Re to
//      row a and Im to row b (K3f: the interior [pad, pad + dim) alone).
// The spectrum is left in the digit-reversed order of the digits R_1 ..
// R_t, then the body's (cuda_kernels/fft4step.py:_radices), and H is stored
// in it. Positions inside a row are int (n <= 2^30, the C entries' int);
// offsets of a pair's row and scratch, and thread indices, are 64-bit.
// Twiddles: W_n^e = Thi[e >> 7] * Tlo[e & 127] read through the read-only
// cache from the host's tables (128 + n / 128 entries: 8320 at n 2^20), the
// same 4 * 2^-24 bound as the body's for any n (two table roundings and
// the product's two).
// The traffic: at t digits a pair of rows takes (32 t + 16) n bytes through
// scratch and rows: each digit's forward and inverse pass read and write n
// float2 each (the first digit's the rows on one side), the segment pass
// reads and writes scratch once more; 48 n at one digit, 3x the 16 n of one
// read and one write of the rows. On the H100 the radix-16 and radix-32
// passes run at 1.1-1.6x their bytes; the segment pass bounds the form: one
// block an SM (128 KB of shared memory, 512 threads of 128 registers), so
// nothing overlaps a block's memory traffic with its compute. The first
// segment pass copied its segment in, computed, and copied it out (2.75x
// its bytes, 11.2 of 20.2 ms on 6480 rows of 262144); this one reads and
// stores scratch from the body's first and last passes (kComplexIo), as the
// one-block kernel does its rows: 1.85x (7.5 ms). Waves of pairs sharing
// an L2-sized scratch buffer (8-64 MB) were slower at every size, their
// kernel boundaries costing more than L2 saved (probes/k3_staged_variants.py
// times both).

constexpr int kStagedThreads = 256;  // threads a block of a staged pass

// What a staged pass reads or writes besides scratch: the rows as they are
// (K3) or framed (K3f).
enum StagedIo { kScratchIo = 0, kRowsIo = 1, kFramedIo = 2 };

__host__ __device__ constexpr int staged_digit_count(int p_log2) { return (p_log2 + 4) / 5; }

// log2 of the i-th digit of P = 2^p_log2 (p_log2 >= 4): t digits of
// p_log2 / t bits, the first p_log2 % t of them one bit more
__host__ __device__ constexpr int staged_digit_log2(int p_log2, int i) {
  return p_log2 / staged_digit_count(p_log2) + (i < p_log2 % staged_digit_count(p_log2) ? 1 : 0);
}

// One radix-R pass of the staged form over spans 2^span_log2 (stride S =
// span / R) of every pair's length-n transform: thread t is butterfly
// b = t mod (n / R) of pair t / (n / R), j = b mod S, positions base + m S
// (base = (b / S) span + j). Forward: DFT, then W_n^(q j n / span);
// inverse: conjugate twiddles, then the conjugate DFT. kIo: the forward
// pass reads, the inverse pass stores, the rows in place of scratch.
template <int R, bool kInv, int kIo>
__global__ void __launch_bounds__(kStagedThreads)
fft_conv_rows_staged_pass_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 float2* __restrict__ scratch, const float2* __restrict__ tw,
                                 int rows, int half, int dim, int pad, int n_log2, int span_log2) {
  constexpr int kRLog2 = ilog2(R);
  const long long t = static_cast<long long>(blockIdx.x) * kStagedThreads + threadIdx.x;
  const int b_log2 = n_log2 - kRLog2;
  const long long pair = t >> b_log2;
  if (pair >= half) return;
  const int b = static_cast<int>(t & ((1LL << b_log2) - 1));
  const int s_log2 = span_log2 - kRLog2;
  const int s = 1 << s_log2;
  const int j = b & (s - 1);
  const int base = ((b >> s_log2) << span_log2) + j;
  const int tw_shift = n_log2 - span_log2;  // W_span^(q j) = W_n^((q j) << tw_shift)
  float2* z = scratch + (static_cast<size_t>(pair) << n_log2);
  const float2* tlo = tw;
  const float2* thi = tw + kLo;
  const int rb = static_cast<int>(pair) + half;
  const Rows io{x + static_cast<size_t>(pair) * dim, x + static_cast<size_t>(rb) * dim,
                out + static_cast<size_t>(pair) * dim, out + static_cast<size_t>(rb) * dim,
                rb < rows, dim, pad};
  float2 a[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    if constexpr (!kInv && kIo != kScratchIo)
      a[m] = load_row<kIo == kFramedIo>(io, base + m * s);
    else
      a[m] = z[base + m * s];
  }
  if constexpr (kInv) {
#pragma unroll
    for (int q = 1; q < R; ++q) {
      const int e = (q * j) << tw_shift;
      a[q] = cmulc(a[q], cmul(__ldg(thi + (e >> 7)), __ldg(tlo + (e & (kLo - 1)))));
    }
  }
  dft<R, kInv>(a, nullptr);
  if constexpr (!kInv) {
#pragma unroll
    for (int q = 1; q < R; ++q) {
      const int e = (q * j) << tw_shift;
      a[q] = cmul(a[q], cmul(__ldg(thi + (e >> 7)), __ldg(tlo + (e & (kLo - 1)))));
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if constexpr (kInv && kIo != kScratchIo)
      store_row<kIo == kFramedIo>(io, base + q * s, a[q]);
    else
      z[base + q * s] = a[q];
  }
}

// The segment pass: block c is segment c mod P of pair c / P, the body's
// passes from the first forward to the last inverse (H's segment in the
// middle pass) on it, the first pass reading its M complex values straight
// from scratch into registers and the last storing them back in place
// (kComplexIo), as the one-block kernel reads and stores its rows.
template <int M>
__global__ void __launch_bounds__(M / kE, 1)
fft_conv_rows_staged_segment_kernel(float2* __restrict__ scratch, const float2* __restrict__ tw,
                                    const float* __restrict__ h, int complex_h, int p_log2) {
  extern __shared__ __align__(16) float2 smem2[];
  const Smem sm = load_tables<M>(smem2, tw);
  const int seg = static_cast<int>(blockIdx.x & ((1u << p_log2) - 1));
  Rows io{};
  io.z = scratch + static_cast<size_t>(blockIdx.x) * M;
  __syncthreads();
  passes<M, false, kComplexIo, true>(sm, io, h + static_cast<size_t>(complex_h ? 2 : 1) * seg * M,
                                     complex_h);
}

template <int R, bool kInv, int kIo>
int launch_staged_pass(const float* x, float* out, float2* scratch, const float2* tw, int rows,
                       int half, int dim, int pad, int n_log2, int span_log2,
                       cudaStream_t stream) {
  const long long threads = static_cast<long long>(half) << (n_log2 - ilog2(R));
  const long long blocks = (threads + kStagedThreads - 1) / kStagedThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  fft_conv_rows_staged_pass_kernel<R, kInv, kIo>
      <<<static_cast<unsigned>(blocks), kStagedThreads, 0, stream>>>(
          x, out, scratch, tw, rows, half, dim, pad, n_log2, span_log2);
  return static_cast<int>(cudaGetLastError());
}

// One pass of radix 2^r_log2 (3, 4 or 5), its io as given.
template <bool kInv, int kIo>
int staged_pass(int r_log2, const float* x, float* out, float2* scratch, const float2* tw,
                int rows, int half, int dim, int pad, int n_log2, int span_log2,
                cudaStream_t stream) {
  switch (r_log2) {
    case 3: return launch_staged_pass<8, kInv, kIo>(x, out, scratch, tw, rows, half, dim, pad,
                                                    n_log2, span_log2, stream);
    case 4: return launch_staged_pass<16, kInv, kIo>(x, out, scratch, tw, rows, half, dim, pad,
                                                     n_log2, span_log2, stream);
    case 5: return launch_staged_pass<32, kInv, kIo>(x, out, scratch, tw, rows, half, dim, pad,
                                                     n_log2, span_log2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The staged form's first passes (forward, digit 0 first) or last passes
// (kInv: their adjoints, the last digit first) at n = 2^n_log2, p_log2 =
// n_log2 - log2(M); digit 0's pass reads or stores the rows. twn: W_n^l
// (l < 128), then W_n^(128 h) (h < n / 128).
template <bool kInv>
int staged_passes(bool framed, const float* x, float* out, float2* scratch, const float2* twn,
                  int rows, int n_log2, int p_log2, int dim, int pad, cudaStream_t stream) {
  const int half = (rows + 1) / 2;
  const int digits = staged_digit_count(p_log2);
  int span_log2 = kInv ? n_log2 - p_log2 : n_log2, e = 0;
  for (int k = 0; k < digits && !e; ++k) {
    const int i = kInv ? digits - 1 - k : k;
    const int r_log2 = staged_digit_log2(p_log2, i);
    if (kInv) span_log2 += r_log2;
    if (i > 0)
      e = staged_pass<kInv, kScratchIo>(r_log2, x, out, scratch, twn, rows, half, dim, pad,
                                        n_log2, span_log2, stream);
    else if (framed)
      e = staged_pass<kInv, kFramedIo>(r_log2, x, out, scratch, twn, rows, half, dim, pad,
                                       n_log2, span_log2, stream);
    else
      e = staged_pass<kInv, kRowsIo>(r_log2, x, out, scratch, twn, rows, half, dim, pad, n_log2,
                                     span_log2, stream);
    if (!kInv) span_log2 -= r_log2;
  }
  return e;
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

// The staged form at n = 2^n_log2 from 262144 on: the first passes, the
// segment pass, the last passes, in order on the stream. tw: the body's
// kTable entries, then W_n^l (l < 128) and W_n^(128 h) (h < n / 128).
int launch_staged(const float* x, float* out, const float2* tw, const float* h, int complex_h,
                  int rows, int n_log2, int dim, int pad, bool framed, float2* scratch,
                  cudaStream_t stream) {
  const int p_log2 = n_log2 - ilog2(kMaxN);
  if (p_log2 < 4 || n_log2 > 30) return static_cast<int>(cudaErrorInvalidValue);
  const float2* twn = tw + kTable;
  int e = staged_passes<false>(framed, x, out, scratch, twn, rows, n_log2, p_log2, dim, pad,
                               stream);
  if (e) return e;
  const long long segments = static_cast<long long>((rows + 1) / 2) << p_log2;
  if (segments > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto segment_kernel = fft_conv_rows_staged_segment_kernel<kMaxN>;
  cudaError_t err = cudaFuncSetAttribute(
      segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<kMaxN>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_kernel<<<static_cast<unsigned>(segments), kMaxThreads, Plan<kMaxN>::kSmem, stream>>>(
      scratch, tw, h, complex_h, p_log2);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  return staged_passes<true>(framed, x, out, scratch, twn, rows, n_log2, p_log2, dim, pad,
                             stream);
}

// the lengths the kernel takes: powers of two 256..16384, 1024 k for
// k = 5..16, the cluster form's 32768, 65536 and 131072, and the wide
// cluster form's 262144
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
#define K3_CLUSTER(NN)                                                                    \
  case NN:                                                                                \
    return framed ? launch_cluster<cluster_segment(NN), NN / cluster_segment(NN), true>(   \
                        xs, os, t, hs, complex_h, rows, dim, pad, stream)                 \
                  : launch_cluster<cluster_segment(NN), NN / cluster_segment(NN), false>( \
                        xs, os, t, hs, complex_h, rows, dim, pad, stream);
    K3_CLUSTER(32768) K3_CLUSTER(65536) K3_CLUSTER(131072)
#undef K3_CLUSTER
    case kWideC * kMaxN:
      return framed ? launch_wide<true>(xs, os, t, hs, complex_h, rows, dim, pad, stream)
                    : launch_wide<false>(xs, os, t, hs, complex_h, rows, dim, pad, stream);
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

// The clusters of the cluster form at transform length n (32768, 65536,
// 131072, or the wide form's 262144; framed: K3f's instantiation) the card
// holds at once, into *clusters. Returns the cudaError_t of the query.
extern "C" int fft_conv_rows_cluster_occupancy(int n, int framed, int* clusters) {
  switch (n) {
#define K3_OCC(NN)                                                                       \
  case NN:                                                                               \
    return framed                                                                        \
        ? cluster_occupancy<cluster_segment(NN), NN / cluster_segment(NN), true>(clusters) \
        : cluster_occupancy<cluster_segment(NN), NN / cluster_segment(NN), false>(clusters);
    K3_OCC(32768) K3_OCC(65536) K3_OCC(131072)
#undef K3_OCC
    case kWideC * kMaxN:
      return framed ? wide_occupancy<true>(clusters) : wide_occupancy<false>(clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3f: rows x dim unpadded floats -> rows x dim, framed in the kernel with
// a reflect-101 pad of pad <= dim - 1 and zeros up to n.
extern "C" int fft_conv_rows_framed(const void* x, void* out, const void* tw,
                                    const void* h, int complex_h, int rows,
                                    int n, int dim, int pad, void* stream) {
  return launch(x, out, tw, h, complex_h, rows, n, dim, pad, true,
                static_cast<cudaStream_t>(stream));
}

// K3 (framed 0: dim = n, pad = 0) or K3f (framed 1) in the staged form, at a
// power of two n from 262144 on (to 2^30). tw: the body's 272 table entries of
// length 16384, then W_n^l (l < 128) and W_n^(128 h) (h < n / 128); h: the
// spectrum in the staged form's bin order, scaled by 1/n; scratch:
// (rows + 1) / 2 x n float2 of device memory the launches overwrite. Returns
// the cudaError_t of the first launch that failed (0 = every pass launched).
extern "C" int fft_conv_rows_staged(const void* x, void* out, const void* tw, const void* h,
                                    int complex_h, int rows, int n, int dim, int pad,
                                    int framed, void* scratch, void* stream) {
  if (rows < 1 || dim < 1 || pad < 0 || pad > dim - 1 || dim + 2 * pad > n ||
      n < kWideC * kMaxN || (n & (n - 1)) != 0 || (!framed && (dim != n || pad != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_staged(static_cast<const float*>(x), static_cast<float*>(out),
                       static_cast<const float2*>(tw), static_cast<const float*>(h), complex_h,
                       rows, ilog2(n), dim, pad, framed != 0, static_cast<float2*>(scratch),
                       static_cast<cudaStream_t>(stream));
}

#endif  // FFT4STEP_KERNELS_ONLY
