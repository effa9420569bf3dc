// B2, where K3/K3f's time goes: the kernel with its stages left out one by
// one.
//
// Replaces: benchmarks/fft_mxu_ablation.py:make_kernel's _kernel (its
// pallas_call at :125), the TPU's four-step FFT with its dots (`nodot`),
// twiddle products (`notw`) and relayouts between stages (`norot`) turned
// off, alone and together; only the full kernel is a correct result.
//
// Here the kernel is csrc/fft4step.cu's own body (conv_rows), included with
// FFT4STEP_KERNELS_ONLY so that this file builds none of that file's 34
// production kernels, instantiated with a mask of the stages to leave out
// (fft4step.cu: Ablate): the butterflies (`nodot`), the twiddle products
// (`notw`), the shared-memory exchanges between passes (`norot`), the
// product by H, and `io_only` (the first pass's reads and the last pass's
// stores alone). Mask 0 is the production kernel's code. The TPU's `1dot`
// (one bf16 dot in place of the three of its bf16x3 split) has no
// counterpart: the FFT here is f32 on the CUDA cores, with no split dots.
//
// Instantiated at the lengths the probe runs: K3 at n 16384 (the JAX
// probe's default, and the rows of the sigma 400 adjoint on 4K frames) and
// 8192 (that adjoint's columns), K3f at n 6144 and 4096 (both axes of
// blur_u8 at sigma 250 on 4K frames).
//
// The cluster form (n 32768-131072) has an ablation of its own: PR 16's
// design of it (fft_cluster_pr16_kernel below, the yardstick the current
// fft_conv_rows_cluster_kernel is timed against in turns, never on a path:
// a radix-C pass over stride 16384 that writes each CTA's segment over
// distributed shared memory, the whole length-16384 body on each segment,
// a radix-C pass that reads the segments back over distributed shared
// memory, a cluster barrier between the steps and before exit) with a
// variant's parts left out (ClusterVariant): the exchanges through the
// CTA's own shared memory in place of the other CTAs' (the same accesses,
// a wrong result), no cluster barriers after the first, the radix-C
// pass's reads and the last stores alone, the body alone.
//
// The wide cluster form (n 262144) and the staged form past it have the
// copying staged form as their yardstick (fft_staged_yardstick below, never
// on a path): a scratch buffer of every pair in device memory and a
// segment pass that copies each segment into shared memory and back, as
// the staged form first ran at every length past 131072.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#define FFT4STEP_KERNELS_ONLY
#include "../fft4step.cu"

#include <cooperative_groups.h>

namespace {

template <int N, bool kFramed, int kMask>
__global__ void __launch_bounds__(N / kE, kMinBlocks<N>)
fft_ablation_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const float2* __restrict__ tw, const float* __restrict__ h,
                    int complex_h, int rows, int half, int dim, int pad) {
  conv_rows<N, kFramed, kMask>(x, out, tw, h, complex_h, rows, half, dim, pad);
}

template <int N, bool kFramed, int kMask>
int launch_mask(const float* x, float* out, const float2* tw, const float* h, int complex_h,
                int rows, int dim, int pad, cudaStream_t stream) {
  auto kernel = fft_ablation_kernel<N, kFramed, kMask>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Plan<N>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int half = (rows + 1) / 2;
  kernel<<<half, Plan<N>::T, Plan<N>::kSmem, stream>>>(x, out, tw, h, complex_h, rows, half,
                                                        dim, pad);
  return static_cast<int>(cudaGetLastError());
}

// the masks chip_smoke.py and the probe run (fft_mxu_ablation.MODES)
template <int N, bool kFramed>
int launch_length(int mask, const float* x, float* out, const float2* tw, const float* h,
                  int complex_h, int rows, int dim, int pad, cudaStream_t stream) {
  switch (mask) {
#define ABLATE_CASE(M) \
  case M:              \
    return launch_mask<N, kFramed, M>(x, out, tw, h, complex_h, rows, dim, pad, stream);
    ABLATE_CASE(0)
    ABLATE_CASE(kNoExchanges)
    ABLATE_CASE(kNoTwiddles)
    ABLATE_CASE(kNoExchanges | kNoTwiddles)
    ABLATE_CASE(kNoButterflies)
    ABLATE_CASE(kNoButterflies | kNoExchanges | kNoTwiddles)
    ABLATE_CASE(kNoSpectrum)
    ABLATE_CASE(kIoOnly)
#undef ABLATE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- PR 16's cluster form, with its parts left out ----

// Butterflies a thread of the radix-C pass loads at once: 2 C values each
// (rows a and b), 16 loads in flight.
template <int C>
constexpr int kPr16Unroll = C >= 8 ? 1 : 8 / C;

template <int C, bool kFramed, int kVar>
__global__ void __launch_bounds__(kMaxThreads, 1)
fft_cluster_pr16_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float2* __restrict__ tw, const float* __restrict__ h,
                        int complex_h, int rows, int half, int dim, int pad) {
  namespace cg = cooperative_groups;
  constexpr int M = kMaxN, T = kMaxThreads, N = C * M, B = M / C, U = kPr16Unroll<C>;
  constexpr bool kLocal = (kVar & kVLocal) != 0, kIo = (kVar & kVIoOnly) != 0;
  constexpr bool kPasses = (kVar & kVBodyOnly) == 0, kBody = !kIo;
  constexpr bool kMidSync = (kVar & kVNoBarriers) == 0 && !kIo;
  constexpr bool kExitSync = !((kVar & kVNoBarriers) != 0 && kLocal) && !kIo;
  static_assert(B % (T * U) == 0, "the cluster pass splits evenly");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) float2 smem2[];
  const Smem sm = load_tables<M>(smem2, tw);
  float2* ctab = smem2 + M + M / 32 + kTable + 1024;
  for (int k = threadIdx.x; k < kLo + N / kLo; k += T) ctab[k] = tw[kTable + k];
  const int ra = blockIdx.x / C;
  const int rb = ra + half;
  const bool has_b = rb < rows;
  const Rows io{x + static_cast<size_t>(ra) * dim, x + static_cast<size_t>(rb) * dim,
                out + static_cast<size_t>(ra) * dim, out + static_cast<size_t>(rb) * dim,
                has_b, dim, pad};
  cluster.sync();
  float2 carry = make_float2(0.0f, 0.0f);

  // forward radix-C pass: rows -> the C segments
  if constexpr (kPasses) {
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
        if constexpr (kIo) {
#pragma unroll
          for (int q = 0; q < C; ++q) carry = cadd(carry, a[u][q]);
          continue;
        }
        dft<C, false>(a[u], nullptr);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const int e = q * j;  // < N
          const float2 v = q ? cmul(a[u][q], cmul(ctab[kLo + (e >> 7)], ctab[e & (kLo - 1)]))
                             : a[u][0];
          if constexpr (kLocal)
            smem2[sidx((j + q * B) & (M - 1))] = v;
          else
            cluster.map_shared_rank(smem2, q)[sidx(j)] = v;
        }
      }
    }
  }
  if constexpr (kMidSync) cluster.sync();

  if constexpr (kBody)
    passes<M, kFramed, 0, false>(sm, io, h + static_cast<size_t>(complex_h ? 2 : 1) * rank * M,
                                 complex_h);
  if constexpr (kMidSync) cluster.sync();

  // inverse radix-C pass: the C segments -> rows
  if constexpr (kPasses) {
#pragma unroll 1
    for (int k = 0; k < B / (T * U); ++k) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = rank * B + threadIdx.x + (k * U + u) * T;
        float2 a[C];
#pragma unroll
        for (int q = 0; q < C; ++q) {
          if constexpr (kIo) {
            a[q] = make_float2(carry.x + q, carry.y);
            continue;
          }
          const float2 v = kLocal ? smem2[sidx((j + q * B) & (M - 1))]
                                  : cluster.map_shared_rank(smem2, q)[sidx(j)];
          const int e = q * j;
          a[q] = q ? cmulc(v, cmul(ctab[kLo + (e >> 7)], ctab[e & (kLo - 1)])) : v;
        }
        if constexpr (!kIo) dft<C, true>(a, nullptr);
#pragma unroll
        for (int m = 0; m < C; ++m) store_row<kFramed>(io, j + m * M, a[m]);
      }
    }
  }
  if constexpr (kExitSync) cluster.sync();
}

template <int C, bool kFramed, int kVar>
int launch_pr16(const float* x, float* out, const float2* tw, const float* h, int complex_h,
                int rows, int dim, int pad, cudaStream_t stream) {
  auto kernel = fft_cluster_pr16_kernel<C, kFramed, kVar>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem<kMaxN, C>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int half = (rows + 1) / 2;
  ClusterLaunch l(C, half * C, kMaxThreads, kClusterSmem<kMaxN, C>, stream);
  err = cudaLaunchKernelEx(&l.cfg, kernel, x, out, tw, h, complex_h, rows, half, dim, pad);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// every variant where the probe times them (K3 at C 2; K3f at C 2 and 4),
// variant 0 (PR 16's kernel) at every length
template <int C, bool kFramed>
int pr16_variant(int variant, const float* x, float* out, const float2* tw, const float* h,
                 int complex_h, int rows, int dim, int pad, cudaStream_t stream) {
  if (variant == 0)
    return launch_pr16<C, kFramed, 0>(x, out, tw, h, complex_h, rows, dim, pad, stream);
  if constexpr (C == 2 || (C == 4 && kFramed)) {
    switch (variant) {
#define CLUSTER_VARIANT(V) \
  case V:                  \
    return launch_pr16<C, kFramed, V>(x, out, tw, h, complex_h, rows, dim, pad, stream);
      CLUSTER_VARIANT(kVLocal)
      CLUSTER_VARIANT(kVNoBarriers)
      CLUSTER_VARIANT(kVLocal | kVNoBarriers)
      CLUSTER_VARIANT(kVIoOnly)
      CLUSTER_VARIANT(kVBodyOnly)
#undef CLUSTER_VARIANT
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// PR 16's cluster form of K3 (framed 0) or K3f (framed 1) at n 32768, 65536
// or 131072 with a ClusterVariant's parts left out (0: the whole kernel,
// a correct result); the other arguments as fft_conv_rows_framed's, the
// tables as the current kernel's, the spectrum in the bin order of
// segments of 16384. Returns the cudaError_t of the launch.
extern "C" int fft_cluster_ablation(int variant, int framed, const void* x, void* out,
                                    const void* tw, const void* h, int complex_h, int rows,
                                    int n, int dim, int pad, void* stream) {
  if (rows < 1 || dim < 1 || pad < 0 || pad > dim - 1 || dim + 2 * pad > n ||
      (!framed && (dim != n || pad != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  const float2* t = static_cast<const float2*>(tw);
  const float* hs = static_cast<const float*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n / kMaxN * (n % kMaxN == 0)) {
#define PR16_CASE(C)                                                                       \
  case C:                                                                                  \
    return framed ? pr16_variant<C, true>(variant, xs, os, t, hs, complex_h, rows, dim, pad, \
                                          st)                                              \
                  : pr16_variant<C, false>(variant, xs, os, t, hs, complex_h, rows, dim, pad, \
                                           st);
    PR16_CASE(2) PR16_CASE(4) PR16_CASE(8)
#undef PR16_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The clusters of PR 16's kernel (variant 0 only) at n the card holds at
// once, into *clusters (cudaOccupancyMaxActiveClusters).
extern "C" int fft_cluster_ablation_occupancy(int variant, int n, int framed, int* clusters) {
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (n / kMaxN * (n % kMaxN == 0)) {
#define PR16_OCC(C)                                                                     \
  case C: {                                                                             \
    auto kernel = framed ? fft_cluster_pr16_kernel<C, true, 0>                          \
                         : fft_cluster_pr16_kernel<C, false, 0>;                        \
    cudaError_t err = cudaFuncSetAttribute(                                             \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem<kMaxN, C>);   \
    if (err != cudaSuccess) return static_cast<int>(err);                               \
    ClusterLaunch l(C, C, kMaxThreads, kClusterSmem<kMaxN, C>, nullptr);                \
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg)); \
  }
    PR16_OCC(2) PR16_OCC(4) PR16_OCC(8)
#undef PR16_OCC
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The current cluster form (fft_conv_rows_cluster_kernel) with the other
// segment length: 8192 at n 32768 (K3 and K3f, clusters of 4, two CTAs an
// SM), 16384 at 65536 (K3f, clusters of 4, one CTA an SM); tried for the
// redesign, timed in turns. The spectrum is in that segment's bin order.
// Returns the cudaError_t of the launch.
extern "C" int fft_cluster_other_segment(int framed, const void* x, void* out, const void* tw,
                                         const void* h, int complex_h, int rows, int n, int dim,
                                         int pad, void* stream) {
  if (rows < 1 || dim < 1 || pad < 0 || pad > dim - 1 || dim + 2 * pad > n ||
      (!framed && (dim != n || pad != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  const float2* t = static_cast<const float2*>(tw);
  const float* hs = static_cast<const float*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 32768:
      return framed ? launch_cluster<8192, 4, true>(xs, os, t, hs, complex_h, rows, dim, pad, st)
                    : launch_cluster<8192, 4, false>(xs, os, t, hs, complex_h, rows, dim, pad,
                                                     st);
    case 65536:
      if (framed)
        return launch_cluster<kMaxN, 4, true>(xs, os, t, hs, complex_h, rows, dim, pad, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The current cluster form (fft_conv_rows_cluster_kernel at the kernels'
// segment) as a ClusterVariant: kVPushBarriers (16: its pushes end at
// cluster barriers, not at the receivers' transaction counts), with
// kVLocal (17: the exchanges to its own shared memory), and kVNoBarriers
// (19: the cluster barriers as this CTA's). K3 and K3f at n 32768, K3f at
// 65536. Returns the cudaError_t of the launch.
template <int kV>
int current_variant(int framed, const float* x, float* out, const float2* tw, const float* h,
                    int complex_h, int rows, int n, int dim, int pad, cudaStream_t st) {
  constexpr int M2 = cluster_segment(32768), M4 = cluster_segment(65536);
  if (n == 2 * kMaxN)
    return framed ? launch_cluster<M2, 32768 / M2, true, kV>(x, out, tw, h, complex_h, rows,
                                                            dim, pad, st)
                  : launch_cluster<M2, 32768 / M2, false, kV>(x, out, tw, h, complex_h, rows,
                                                             dim, pad, st);
  if (n == 4 * kMaxN && framed)
    return launch_cluster<M4, 65536 / M4, true, kV>(x, out, tw, h, complex_h, rows, dim, pad,
                                                   st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fft_cluster_current_ablation(int variant, int framed, const void* x, void* out,
                                            const void* tw, const void* h, int complex_h,
                                            int rows, int n, int dim, int pad, void* stream) {
  if (rows < 1 || dim < 1 || pad < 0 || pad > dim - 1 || dim + 2 * pad > n ||
      (!framed && (dim != n || pad != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  const float2* t = static_cast<const float2*>(tw);
  const float* hs = static_cast<const float*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kVPushBarriers:
      return current_variant<kVPushBarriers>(framed, xs, os, t, hs, complex_h, rows, n, dim,
                                             pad, st);
    case kVPushBarriers | kVLocal:
      return current_variant<kVPushBarriers | kVLocal>(framed, xs, os, t, hs, complex_h, rows,
                                                       n, dim, pad, st);
    case kVPushBarriers | kVLocal | kVNoBarriers:
      return current_variant<kVPushBarriers | kVLocal | kVNoBarriers>(
          framed, xs, os, t, hs, complex_h, rows, n, dim, pad, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3 (framed 0: rows x n already framed) or K3f (framed 1: rows x dim,
// framed in the kernel with a reflect-101 pad) with the stages of `mask`
// left out, at n 16384 or 8192 (K3) and 6144 or 4096 (K3f); the other
// arguments as fft_conv_rows_framed's. Returns the cudaError_t of the
// launch (0 = launched; another length or mask is cudaErrorInvalidValue).
extern "C" int fft_conv_rows_ablation(int mask, int framed, const void* x, void* out,
                                      const void* tw, const void* h, int complex_h, int rows,
                                      int n, int dim, int pad, void* stream) {
  if (rows < 1 || dim < 1 || pad < 0 || pad > dim - 1 || dim + 2 * pad > n ||
      (!framed && (dim != n || pad != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  const float2* t = static_cast<const float2*>(tw);
  const float* hs = static_cast<const float*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!framed && n == 16384)
    return launch_length<16384, false>(mask, xs, os, t, hs, complex_h, rows, dim, pad, st);
  if (!framed && n == 8192)
    return launch_length<8192, false>(mask, xs, os, t, hs, complex_h, rows, dim, pad, st);
  if (framed && n == 6144)
    return launch_length<6144, true>(mask, xs, os, t, hs, complex_h, rows, dim, pad, st);
  if (framed && n == 4096)
    return launch_length<4096, true>(mask, xs, os, t, hs, complex_h, rows, dim, pad, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

// The copying segment pass, the yardstick's: each segment copied from scratch
// into the padded shared row, the body's passes, and copied back (the
// package's kernel reads and stores it from the body's first and last
// passes).
template <int M>
__global__ void __launch_bounds__(M / kE, 1)
fft_staged_segment_copy_kernel(float2* __restrict__ scratch, const float2* __restrict__ tw,
                               const float* __restrict__ h, int complex_h, int p_log2) {
  extern __shared__ __align__(16) float2 smem2[];
  const Smem sm = load_tables<M>(smem2, tw);
  const int seg = static_cast<int>(blockIdx.x & ((1u << p_log2) - 1));
  float2* z = scratch + static_cast<size_t>(blockIdx.x) * M;
  for (int i = threadIdx.x; i < M; i += M / kE) sm.buf[sidx(i)] = z[i];
  __syncthreads();
  const Rows none{};
  passes<M, false, 0, false>(sm, none, h + static_cast<size_t>(complex_h ? 2 : 1) * seg * M,
                             complex_h);
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += M / kE) z[i] = sm.buf[sidx(i)];
}

}  // namespace

// The copying staged form of K3 (framed 0) or K3f (framed 1) at a power of two n
// past 131072: fft4step.cu's first passes, the copying segment pass, its last
// passes, through a full-size scratch buffer ((rows + 1) / 2 x n float2); the
// other arguments as fft_conv_rows_staged's. Returns the cudaError_t of the
// first launch that failed.
extern "C" int fft_staged_yardstick(int framed, const void* x, void* out, const void* tw,
                                    const void* h, int complex_h, int rows, int n, int dim,
                                    int pad, void* scratch, void* stream) {
  if (rows < 1 || dim < 1 || pad < 0 || pad > dim - 1 || dim + 2 * pad > n ||
      n <= 8 * kMaxN || (n & (n - 1)) != 0 || (!framed && (dim != n || pad != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_log2 = ilog2(n), p_log2 = n_log2 - ilog2(kMaxN);
  auto* xs = static_cast<const float*>(x);
  auto* os = static_cast<float*>(out);
  auto* t = static_cast<const float2*>(tw);
  auto* z = static_cast<float2*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  int e = staged_passes<false>(framed != 0, xs, os, z, t + kTable, rows, n_log2, p_log2, dim,
                               pad, st);
  if (e) return e;
  const long long segments = static_cast<long long>((rows + 1) / 2) << p_log2;
  if (segments > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto segment = fft_staged_segment_copy_kernel<kMaxN>;
  cudaError_t err = cudaFuncSetAttribute(segment, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Plan<kMaxN>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  segment<<<static_cast<unsigned>(segments), kMaxThreads, Plan<kMaxN>::kSmem, st>>>(
      z, t, static_cast<const float*>(h), complex_h, p_log2);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  return staged_passes<true>(framed != 0, xs, os, z, t + kTable, rows, n_log2, p_log2, dim, pad,
                             st);
}
