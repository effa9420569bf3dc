// The staged form of K3/K3f (csrc/fft4step.cu) one pass at a time, in
// waves, and the designs of n 262144 on clusters of 16 CTAs, for
// probes/k3_staged_variants.py.
//
// Compiled after a source in one translation unit: the probe writes a
// two-line file that includes an earlier commit's csrc/fft4step.cu (whole),
// or the current csrc/probes/fft_ablation.cu (fft4step.cu's kernels alone
// and the split cluster design, over a copy of fft4step.cu whose cluster
// form also takes G = 8 lanes a butterfly), then this one, and builds it
// with the package's nvcc flags. The part under FFT4STEP_KERNELS_ONLY is the
// current source's. Every entry returns the cudaError_t of its launch or
// query.

namespace {

template <bool kInv>
int parts_pass(int r_log2, int io, const float* x, float* out, float2* scratch,
               const float2* twn, int rows, int half, int dim, int pad, int n_log2,
               int span_log2, cudaStream_t stream) {
  switch (io) {
    case kScratchIo:
      return staged_pass<kInv, kScratchIo>(r_log2, x, out, scratch, twn, rows, half, dim, pad,
                                           n_log2, span_log2, stream);
    case kRowsIo:
      return staged_pass<kInv, kRowsIo>(r_log2, x, out, scratch, twn, rows, half, dim, pad,
                                        n_log2, span_log2, stream);
    case kFramedIo:
      return staged_pass<kInv, kFramedIo>(r_log2, x, out, scratch, twn, rows, half, dim, pad,
                                          n_log2, span_log2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kFramed>
int parts_occupancy16(int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(fft_conv_rows_cluster_kernel<kMaxN, 16, kFramed>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  return cluster_occupancy<kMaxN, 16, kFramed>(clusters);
}

}  // namespace

// One radix-2^r_log2 pass of the staged form over spans 2^span_log2 (io:
// 0 scratch, 1 the rows as they are, 2 framed; the forward pass reads them,
// the inverse pass stores them). tw: the host's tables, as the C entry
// fft_conv_rows_staged takes them.
extern "C" int parts_staged_pass(int r_log2, int inverse, int io, const void* x, void* out,
                                 void* scratch, const void* tw, int rows, int dim, int pad,
                                 int n_log2, int span_log2, void* stream) {
  const float2* twn = static_cast<const float2*>(tw) + kTable;
  const int half = (rows + 1) / 2;
  auto* xs = static_cast<const float*>(x);
  auto* os = static_cast<float*>(out);
  auto* z = static_cast<float2*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  return inverse ? parts_pass<true>(r_log2, io, xs, os, z, twn, rows, half, dim, pad, n_log2,
                                    span_log2, s)
                 : parts_pass<false>(r_log2, io, xs, os, z, twn, rows, half, dim, pad, n_log2,
                                     span_log2, s);
}

// The staged form's segment pass: every segment of 16384 of scratch
// through the one-block body.
extern "C" int parts_staged_segment(void* scratch, const void* tw, const void* h, int complex_h,
                                    int rows, int n_log2, void* stream) {
  const int p_log2 = n_log2 - ilog2(kMaxN);
  const long long segments = static_cast<long long>((rows + 1) / 2) << p_log2;
  auto kernel = fft_conv_rows_staged_segment_kernel<kMaxN>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Plan<kMaxN>::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(segments), kMaxThreads, Plan<kMaxN>::kSmem,
           static_cast<cudaStream_t>(stream)>>>(static_cast<float2*>(scratch),
                                                static_cast<const float2*>(tw),
                                                static_cast<const float*>(h), complex_h,
                                                p_log2);
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters of the cluster kernel at M 16384, C 16
// (a non-portable cluster size), with its launch's shared memory.
extern "C" int parts_cluster16_occupancy(int framed, int* clusters) {
  return framed ? parts_occupancy16<true>(clusters) : parts_occupancy16<false>(clusters);
}

#ifdef FFT4STEP_KERNELS_ONLY
// Built over csrc/probes/fft_ablation.cu (B2: fft4step.cu's kernels alone,
// and the split cluster design): three designs of n 262144 on clusters of 16
// CTAs (M 16384), each timed against the staged form and none kept: the
// cluster form's own (its first pass the exchange) with its parts left out,
// the split design's, and a wide form of the split design with pushes; and
// the staged form in waves of pairs sharing one scratch buffer (below).

namespace {

template <bool kFramed, int kVar>
int parts_variant16(bool unclustered, const float* x, float* out, const float2* tw,
                    const float* h, int complex_h, int rows, int dim, int pad,
                    cudaStream_t stream) {
  auto kernel = fft_conv_rows_cluster_kernel<kMaxN, 16, kFramed, kVar>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!unclustered)
    return launch_cluster<kMaxN, 16, kFramed, kVar>(x, out, tw, h, complex_h, rows, dim, pad,
                                                    stream);
  // every CTA its own cluster of 1 (rank 0): the same work with no gang
  // scheduling (a wrong result, timing only)
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kClusterSmem<kMaxN, 16>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int half = (rows + 1) / 2;
  ClusterLaunch l(1, half * 16, kMaxThreads, kClusterSmem<kMaxN, 16>, stream);
  e = cudaLaunchKernelEx(&l.cfg, kernel, x, out, tw, h, complex_h, rows, half, dim, pad);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFramed>
int parts_dispatch16(int variant, bool unclustered, const float* x, float* out,
                     const float2* tw, const float* h, int complex_h, int rows, int dim, int pad,
                     cudaStream_t stream) {
  switch (variant) {
    case 0:
      return parts_variant16<kFramed, 0>(unclustered, x, out, tw, h, complex_h, rows, dim, pad,
                                         stream);
    case kVPushBarriers:
      return parts_variant16<kFramed, kVPushBarriers>(unclustered, x, out, tw, h, complex_h,
                                                      rows, dim, pad, stream);
    case kVPushBarriers | kVLocal:
      return parts_variant16<kFramed, kVPushBarriers | kVLocal>(unclustered, x, out, tw, h,
                                                                complex_h, rows, dim, pad,
                                                                stream);
    case kVPushBarriers | kVLocal | kVNoBarriers:
      return parts_variant16<kFramed, kVPushBarriers | kVLocal | kVNoBarriers>(
          unclustered, x, out, tw, h, complex_h, rows, dim, pad, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- a wide cluster form: n = 16 M = 262144, M = kMaxN (timed, not kept)
//
// A cluster of 16 CTAs (past the portable 8: a size the H100 places, 7 at
// once on its GPCs of 16 or more SMs), CTA q holding segment q of M = 16384
// points. The cluster form's own design (fft4step.cu), whose first pass
// doubles as the exchange, needs G = 8 lanes a butterfly at C 16: 4
// consecutive j a lane group, so 16-byte pieces of a row per load and
// 32-byte pieces per remote store, and it spills 124-136 bytes a thread.
// This one takes the split design instead (a radix-16 pass over stride M, then
// the whole length-M body on each segment), with lanes on consecutive j,
// so that every warp's load or store of a row covers 128 contiguous bytes
// and every remote store 256 contiguous bytes of one CTA, and the cluster
// form's pushes and transaction counts in place of the split design's remote
// loads:
//   1. the first pass: thread t of CTA r takes j = r B + t + u T (B = M /
//      16 = 1024, T = 512 threads, u < 2): loads x[j + m M] (m < 16,
//      framing K3f's rows, 32 values), the radix-16 DFT, output q times
//      W_n^(q j), stored at position j of CTA q's segment (st.async counted
//      on q's mbarrier);
//   2. once its segment is complete (15 B values from its peers), the body's
//      passes of length M on it, H's segment q in the middle pass;
//   3. the adjoint of the first pass splits over the cluster: CTA q reads
//      the positions p = r B + t + u T that CTA r's last pass needs,
//      conjugate-twiddles them by W_n^(q p) and stores them into slab q of
//      CTA r (its positions q B .. q B + B - 1, counted on r's second
//      mbarrier); CTA r then runs the conjugate radix-16 DFT of each j it
//      owns over its 16 slabs and stores the rows.
// Two split cluster barriers: every CTA has started (arrived after its
// setup, waited on after the first pass's loads and DFTs), and every CTA
// has read what it sends back (arrived after those reads, waited on after
// their twiddles). Remote traffic is stores alone, so no CTA waits for the
// others before it exits.

// its shared memory: the padded segment, the body's tables, the W_1024
// table, the first pass's W_n tables (128 + n / 128 entries) and the two
// mbarriers
constexpr int kWidePushSmem = 8 * (kMaxN + kMaxN / 32) + 8 * kTable + 8 * 1024 +
                          8 * (kLo + kWideC * kMaxN / kLo) + 8 * 2;

template <bool kFramed>
__global__ void __launch_bounds__(kMaxThreads, 1)
fft_wide_push_kernel(const float* __restrict__ x, float* __restrict__ out,
                          const float2* __restrict__ tw, const float* __restrict__ h,
                          int complex_h, int rows, int half, int dim, int pad) {
  constexpr int M = kMaxN, C = kWideC, N = C * M, T = kMaxThreads, B = M / C;
  static_assert(B == 2 * T, "a thread takes two positions j of its CTA");
  const int rank = cluster_rank();
  extern __shared__ __align__(16) float2 smem2[];
  float2* ctab = smem2 + M + M / 32 + kTable + 1024;
  for (int k = threadIdx.x; k < kLo + N / kLo; k += T) ctab[k] = tw[kTable + k];
  const Smem sm = load_tables<M>(smem2, tw);
  // the segment's data (from the 15 peers' first passes) and the slabs'
  // (from their last passes' halves), B values from each peer
  const uint32_t seg = static_cast<uint32_t>(__cvta_generic_to_shared(smem2));
  const uint32_t seg_bar = static_cast<uint32_t>(__cvta_generic_to_shared(ctab + kLo + N / kLo));
  const uint32_t slab_bar = seg_bar + 8;
  if (threadIdx.x == 0) {
    mbar_init(seg_bar, 1);
    mbar_init(slab_bar, 1);
    mbar_init_fence();
    mbar_expect_tx(seg_bar, 8 * (C - 1) * B);
    mbar_expect_tx(slab_bar, 8 * (C - 1) * B);
  }
  __syncthreads();
  cluster_arrive_release();  // this CTA has started: its segment may be written
  const int ra = static_cast<int>(blockIdx.x) / C;
  const int rb = ra + half;
  const Rows io{x + static_cast<size_t>(ra) * dim, x + static_cast<size_t>(rb) * dim,
                out + static_cast<size_t>(ra) * dim, out + static_cast<size_t>(rb) * dim,
                rb < rows, dim, pad};
  const int j0 = rank * B + static_cast<int>(threadIdx.x);

  // 1. the first pass: rows -> the 16 segments
  {
    float2 a[2][C];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int m = 0; m < C; ++m) a[u][m] = load_folded<kFramed>(io, j0 + u * T + m * M);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      dft<C, false>(a[u], nullptr);
#pragma unroll
      for (int q = 1; q < C; ++q) {
        const int e = q * (j0 + u * T);  // < N
        a[u][q] = cmul(a[u][q], cmul(ctab[kLo + (e >> 7)], ctab[e & (kLo - 1)]));
      }
    }
    cluster_wait();
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const uint32_t dst = dsmem_map(seg, q), bar = dsmem_map(seg_bar, q);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (q == rank)
          smem2[sidx(j0 + u * T)] = a[u][q];
        else
          dsmem_store_tx(dst + 8 * sidx(j0 + u * T), a[u][q], bar);
      }
    }
  }
  __syncthreads();    // this CTA's own part of its segment
  mbar_wait(seg_bar);  // and the peers'
  __syncwarp();

  // 2. the segment's body of length M
  passes<M, kFramed, 0, false>(sm, io, h + static_cast<size_t>(complex_h ? 2 : 1) * rank * M,
                               complex_h);
  __syncthreads();

  // 3. the last pass's inputs: position p = r B + t + u T goes to slab
  // `rank` of CTA r, times conj(W_n^(rank p))
  {
    float2 v[2][C];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int r = 0; r < C; ++r) v[u][r] = smem2[sidx(r * B + threadIdx.x + u * T)];
    cluster_arrive_release();  // this CTA's segment is read: the slabs may come
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const int e = rank * (r * B + static_cast<int>(threadIdx.x) + u * T);  // < N
        v[u][r] = cmulc(v[u][r], cmul(ctab[kLo + (e >> 7)], ctab[e & (kLo - 1)]));
      }
    cluster_wait();
    const int slot = rank * B + static_cast<int>(threadIdx.x);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const uint32_t dst = dsmem_map(seg, r), bar = dsmem_map(slab_bar, r);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (r == rank)
          smem2[sidx(slot + u * T)] = v[u][r];
        else
          dsmem_store_tx(dst + 8 * sidx(slot + u * T), v[u][r], bar);
      }
    }
  }
  __syncthreads();     // this CTA's own slab
  mbar_wait(slab_bar);  // and the peers'
  __syncwarp();

  // the last pass: the conjugate radix-16 DFT of each j over the slabs
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float2 w[C];
#pragma unroll
    for (int q = 0; q < C; ++q) w[q] = smem2[sidx(q * B + threadIdx.x + u * T)];
    dft<C, true>(w, nullptr);
#pragma unroll
    for (int m = 0; m < C; ++m) store_row<kFramed>(io, j0 + u * T + m * M, w[m]);
  }
}

// The wide cluster form's kernel attributes: its shared memory and leave to
// place a cluster of 16.
template <bool kFramed>
cudaError_t wide_push_attributes() {
  auto kernel = fft_wide_push_kernel<kFramed>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWidePushSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// How many clusters of the wide form the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
template <bool kFramed>
int wide_push_occupancy(int* clusters) {
  auto kernel = fft_wide_push_kernel<kFramed>;
  cudaError_t err = wide_push_attributes<kFramed>();
  if (err != cudaSuccess) return static_cast<int>(err);
  ClusterLaunch l(kWideC, kWideC, kMaxThreads, kWidePushSmem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg));
}

// The wide cluster form at n 262144: a cluster of 16 CTAs a pair of rows. A
// cluster that cannot be placed fails the launch (the error is returned;
// nothing falls back to another form).
template <bool kFramed>
int launch_wide_push(const float* x, float* out, const float2* tw, const float* h, int complex_h,
                int rows, int dim, int pad, cudaStream_t stream) {
  auto kernel = fft_wide_push_kernel<kFramed>;
  cudaError_t e = wide_push_attributes<kFramed>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int half = (rows + 1) / 2;
  ClusterLaunch l(kWideC, half * kWideC, kMaxThreads, kWidePushSmem, stream);
  e = cudaLaunchKernelEx(&l.cfg, kernel, x, out, tw, h, complex_h, rows, half, dim, pad);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- the staged form in waves (timed, not kept)
//
// The L2 candidate: the pairs in waves whose scratch buffer (wave x n
// float2, reused by every wave) L2 may hold, each wave's first passes,
// segment pass and last passes in turn, the rows read and stored with the
// streaming hint (ld.global.cs / st.global.cs: evict first) so that they
// leave L2 to the scratch. fft4step.cu's pass kernel with a wave's first
// pair and pairs added, and its segment kernel.

template <bool kFramed>
__device__ __forceinline__ float2 load_row_streaming(const Rows& io, int pos) {
  if constexpr (kFramed) {
    pos = frame_source(pos, io.dim, io.pad);
    if (pos < 0) return make_float2(0.0f, 0.0f);
  }
  return make_float2(__ldcs(io.xa + pos), io.has_b ? __ldcs(io.xb + pos) : 0.0f);
}

template <bool kFramed>
__device__ __forceinline__ void store_row_streaming(const Rows& io, int pos, float2 v) {
  if constexpr (kFramed) {
    pos -= io.pad;
    if (pos < 0 || pos >= io.dim) return;
  }
  __stcs(io.oa + pos, v.x);
  if (io.has_b) __stcs(io.ob + pos, v.y);
}

// fft_conv_rows_staged_pass_kernel over the wave's pairs pair0 .. pair0 +
// pairs - 1: thread t is butterfly t mod (n / R) of the wave's pair w = t /
// (n / R), whose scratch row is w.
template <int R, bool kInv, int kIo>
__global__ void __launch_bounds__(kStagedThreads)
parts_waved_pass_kernel(const float* __restrict__ x, float* __restrict__ out,
                        float2* __restrict__ scratch, const float2* __restrict__ tw, int rows,
                        int half, int dim, int pad, int n_log2, int span_log2, int pair0,
                        int pairs) {
  constexpr int kRLog2 = ilog2(R);
  const long long t = static_cast<long long>(blockIdx.x) * kStagedThreads + threadIdx.x;
  const int b_log2 = n_log2 - kRLog2;
  const long long w = t >> b_log2;
  if (w >= pairs) return;
  const long long pair = pair0 + w;
  const int b = static_cast<int>(t & ((1LL << b_log2) - 1));
  const int s_log2 = span_log2 - kRLog2;
  const int s = 1 << s_log2;
  const int j = b & (s - 1);
  const int base = ((b >> s_log2) << span_log2) + j;
  const int tw_shift = n_log2 - span_log2;
  float2* z = scratch + (static_cast<size_t>(w) << n_log2);
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
      a[m] = load_row_streaming<kIo == kFramedIo>(io, base + m * s);
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
      store_row_streaming<kIo == kFramedIo>(io, base + q * s, a[q]);
    else
      z[base + q * s] = a[q];
  }
}

template <int R, bool kInv, int kIo>
int waved_pass(const float* x, float* out, float2* scratch, const float2* twn, int rows,
               int half, int dim, int pad, int n_log2, int span_log2, int pair0, int pairs,
               cudaStream_t stream) {
  const long long threads = static_cast<long long>(pairs) << (n_log2 - ilog2(R));
  const long long blocks = (threads + kStagedThreads - 1) / kStagedThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  parts_waved_pass_kernel<R, kInv, kIo><<<static_cast<unsigned>(blocks), kStagedThreads, 0,
                                          stream>>>(x, out, scratch, twn, rows, half, dim, pad,
                                                    n_log2, span_log2, pair0, pairs);
  return static_cast<int>(cudaGetLastError());
}

// One digit's pass (one-digit lengths: radix 16 at 262144, 32 at 524288)
// over a wave, reading (forward) or storing (kInv) the rows.
template <bool kInv>
int waved_digit(int r_log2, bool framed, const float* x, float* out, float2* scratch,
                const float2* twn, int rows, int half, int dim, int pad, int n_log2, int pair0,
                int pairs, cudaStream_t stream) {
#define WAVED(R)                                                                              \
  return framed ? waved_pass<R, kInv, kFramedIo>(x, out, scratch, twn, rows, half, dim, pad,  \
                                                 n_log2, n_log2, pair0, pairs, stream)        \
                : waved_pass<R, kInv, kRowsIo>(x, out, scratch, twn, rows, half, dim, pad,    \
                                               n_log2, n_log2, pair0, pairs, stream);
  switch (r_log2) {
    case 4: WAVED(16)
    case 5: WAVED(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WAVED
}

}  // namespace

// The wide form above (pushes, one cluster a pair) and fft4step.cu's (the
// split design on persistent clusters) at n 262144 (framed: K3f), the other
// arguments as fft_conv_rows_framed's.
extern "C" int parts_wide(int persistent, int framed, const void* x, void* out, const void* tw,
                          const void* h, int complex_h, int rows, int dim, int pad,
                          void* stream) {
  auto* xs = static_cast<const float*>(x);
  auto* os = static_cast<float*>(out);
  auto* t = static_cast<const float2*>(tw);
  auto* hs = static_cast<const float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  if (persistent)
    return framed ? launch_wide<true>(xs, os, t, hs, complex_h, rows, dim, pad, s)
                  : launch_wide<false>(xs, os, t, hs, complex_h, rows, dim, pad, s);
  return framed ? launch_wide_push<true>(xs, os, t, hs, complex_h, rows, dim, pad, s)
                : launch_wide_push<false>(xs, os, t, hs, complex_h, rows, dim, pad, s);
}

// The staged form at a one-digit length (n 262144 or 524288) in waves of
// `wave` pairs of rows sharing a scratch buffer of wave x n float2, the
// rows with the streaming hint; the other arguments as
// fft_conv_rows_staged's.
extern "C" int parts_staged(int framed, const void* x, void* out, const void* tw, const void* h,
                            int complex_h, int rows, int n_log2, int dim, int pad, void* scratch,
                            int wave, void* stream) {
  const int p_log2 = n_log2 - ilog2(kMaxN);
  if (staged_digit_count(p_log2) != 1 || wave < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* xs = static_cast<const float*>(x);
  auto* os = static_cast<float*>(out);
  auto* t = static_cast<const float2*>(tw);
  auto* z = static_cast<float2*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  const int half = (rows + 1) / 2;
  auto segment = fft_conv_rows_staged_segment_kernel<kMaxN>;
  cudaError_t err = cudaFuncSetAttribute(segment, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Plan<kMaxN>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = 0;
  for (int pair0 = 0; pair0 < half && !e; pair0 += wave) {
    const int pairs = wave < half - pair0 ? wave : half - pair0;
    e = waved_digit<false>(p_log2, framed != 0, xs, os, z, t + kTable, rows, half, dim, pad,
                           n_log2, pair0, pairs, st);
    if (e) break;
    segment<<<static_cast<unsigned>(pairs << p_log2), kMaxThreads, Plan<kMaxN>::kSmem, st>>>(
        z, t, static_cast<const float*>(h), complex_h, p_log2);
    if ((e = static_cast<int>(cudaGetLastError()))) break;
    e = waved_digit<true>(p_log2, framed != 0, xs, os, z, t + kTable, rows, half, dim, pad,
                          n_log2, pair0, pairs, st);
  }
  return e;
}

// The clusters of 16 of either wide form the card holds at once.
extern "C" int parts_wide_occupancy(int persistent, int framed, int* clusters) {
  if (persistent) return framed ? wide_occupancy<true>(clusters) : wide_occupancy<false>(clusters);
  return framed ? wide_push_occupancy<true>(clusters) : wide_push_occupancy<false>(clusters);
}

// The cluster form at n 262144 with a ClusterVariant's parts left out
// (16: pushes ended by cluster barriers; 17: and kept in the CTA; 19: and
// no cluster barrier: independent CTAs), in clusters of 16 or, unclustered,
// each CTA alone; the other arguments as fft_conv_rows_framed's.
extern "C" int parts_cluster16_variant(int variant, int unclustered, int framed, const void* x,
                                       void* out, const void* tw, const void* h, int complex_h,
                                       int rows, int dim, int pad, void* stream) {
  auto* xs = static_cast<const float*>(x);
  auto* os = static_cast<float*>(out);
  auto* t = static_cast<const float2*>(tw);
  auto* hs = static_cast<const float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  return framed ? parts_dispatch16<true>(variant, unclustered != 0, xs, os, t, hs, complex_h,
                                         rows, dim, pad, s)
                : parts_dispatch16<false>(variant, unclustered != 0, xs, os, t, hs, complex_h,
                                          rows, dim, pad, s);
}

// the split design at C 16 (a radix-16 pass over stride 16384, lanes on
// consecutive j, the whole 16384 body on each CTA, remote loads back).
extern "C" int parts_split_cluster16(int framed, const void* x, void* out, const void* tw,
                                    const void* h, int complex_h, int rows, int dim, int pad,
                                    void* stream) {
  auto* xs = static_cast<const float*>(x);
  auto* os = static_cast<float*>(out);
  auto* t = static_cast<const float2*>(tw);
  auto* hs = static_cast<const float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(framed ? fft_cluster_pr16_kernel<16, true, 0>
                                              : fft_cluster_pr16_kernel<16, false, 0>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  return framed ? launch_pr16<16, true, 0>(xs, os, t, hs, complex_h, rows, dim, pad, s)
                : launch_pr16<16, false, 0>(xs, os, t, hs, complex_h, rows, dim, pad, s);
}
#endif  // FFT4STEP_KERNELS_ONLY
