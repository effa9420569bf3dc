// B3, what K1's loaders fetch: the fetches alone, with no band work, each
// storing only an 8 x 128 corner of what it fetched so that nothing can be
// dropped and the result can be checked.
//
// Replaces: benchmarks/dma_fetch_rate.py:windowed (its pallas_call at :73)
// and :strip (:85). On the TPU one grid step per plane of a padded uint8
// frame (12 planes of 2224 x 4096: a batch of 4 RGB 4K frames at r 32)
// fetches the plane's 10 windows of 2224 x 640 bytes at a 384-column stride,
// double-buffered (windowed), or the whole plane in one copy (strip), and
// stores [:8, :128] of the last window or of the plane.
//
// On an H100 no block holds a 1.4 MB window, so a block fetches a chunk of
// one window's rows (or of the plane's) through a shared-memory ring of row
// groups, and the grid covers every (plane, window, chunk); the block with
// the first rows of a plane's last window (or of the plane) stores them.
// - fetch_window_cp_async: 16-byte cp.async into a ring of three groups,
//   two in flight (the windows, or the strip: one window as wide as the
//   plane);
// - fetch_window_tma: the same windows as TMA 2-D box loads (boxes of 16
//   rows x 128 bytes, five a group) into a ring of four groups, each tracked
//   by an mbarrier's transaction count, one thread issuing.
// Then K1's own loaders at the tile its geometry picks, in blocks of K1's
// 256 threads holding K1's shared memory (so as many blocks share an SM),
// run from csrc/fused_dma.cu itself (included with FUSED_DMA_LOADERS_ONLY:
// its helpers and loaders, none of its kernels), in K1's loops with the
// band work left out:
// - fetch_k1_direct: the direct form's staging (load_window, the hybrid
//   body's layout): the round16(th + 2rh) halo rows in groups, two in
//   flight, each window row 16-byte cp.async copies inside the frame and
//   mirrored aligned words past its edges;
// - fetch_k1_assembled: the assembled form's (K1a) row groups of A5's
//   padded frame by 16-byte cp.async (load_rect), two in flight where
//   three buffers fit.
// Both stage the raw bytes, as the int8 and hybrid bodies read them. The
// last tile of each plane stores [:8, :128] of its window.
//
// What bounds it on an H100: device memory for the whole strip (each byte
// read once); L2 and the loaders' issue for the windows, which read a byte
// (1 + 2r/t) times per axis. The rates (chip_smoke.py phase 17) are bytes
// fetched per second and frame bytes per second; their ratio is the read
// amplification.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FUSED_DMA_LOADERS_ONLY
#include "../fused_dma.cu"

namespace {

// kThreads (256), cp_async16 / _commit / _wait, tc_layout, load_window and
// load_rect: csrc/fused_dma.cu's
constexpr int kStoreRows = 8, kStoreCols = 128;  // what B3 stores per plane
constexpr int kBoxCols = 128;                     // TMA box: 128 bytes x g rows
constexpr int kTmaSlots = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows 0..7 x columns 0..127 of a staged block (pitch bytes a row) to the
// plane's 8 x 128 output
__device__ __forceinline__ void store_corner(const uint8_t* staged, int pitch, uint8_t* out) {
  for (int e = threadIdx.x; e < kStoreRows * kStoreCols; e += blockDim.x)
    out[e] = staged[(e / kStoreCols) * pitch + e % kStoreCols];
}

// Block (plane, window, chunk): rows [chunk * chunk_rows, +chunk_rows) of
// the window at column win * stride, `width` bytes wide, of a plane of hp
// rows x pitch bytes, through 3 slots of g rows.
__global__ void __launch_bounds__(kThreads) fetch_window_cp_async(
    const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int hp, int pitch, int width,
    int stride, int nwin, int chunk_rows, int nchunks, int g) {
  extern __shared__ __align__(128) uint8_t ring[];
  constexpr int kSlots = 3;
  const int chunk = blockIdx.x % nchunks;
  const int win = (blockIdx.x / nchunks) % nwin;
  const int plane = blockIdx.x / (nchunks * nwin);
  const int r_begin = chunk * chunk_rows, r_end = min(hp, r_begin + chunk_rows);
  const int groups = (r_end - r_begin + g - 1) / g;
  const int pieces = width >> 4;
  const uint8_t* src = x + (static_cast<size_t>(plane) * hp + r_begin) * pitch + win * stride;
  auto issue = [&](int t) {
    if (t < groups) {
      const int nr = min(g, r_end - r_begin - t * g);
      uint8_t* dst = ring + (t % kSlots) * g * width;
      const uint8_t* s = src + static_cast<size_t>(t) * g * pitch;
      for (int e = threadIdx.x; e < nr * pieces; e += kThreads) {
        const int rr = e / pieces, q = e - rr * pieces;
        cp_async16(dst + rr * width + (q << 4), s + static_cast<size_t>(rr) * pitch + (q << 4));
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kSlots - 1; ++t) issue(t);
  const bool store = win == nwin - 1 && chunk == 0;
  for (int t = 0; t < groups; ++t) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();  // group t landed; slot (t - 1) % 3 is free
    issue(t + kSlots - 1);
    if (store && t == 0) store_corner(ring, width, out + plane * kStoreRows * kStoreCols);
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// The windows of fetch_window_cp_async as TMA boxes: group t of a chunk is
// width / 128 boxes of g rows x 128 bytes, each box stored densely (sub-box
// b at b * g * 128 of the slot), tracked by the slot's mbarrier.
__global__ void __launch_bounds__(kThreads) fetch_window_tma(
    const __grid_constant__ CUtensorMap frame, uint8_t* __restrict__ out, int hp, int width,
    int stride, int nwin, int chunk_rows, int nchunks, int g) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kTmaSlots];
  const int chunk = blockIdx.x % nchunks;
  const int win = (blockIdx.x / nchunks) % nwin;
  const int plane = blockIdx.x / (nchunks * nwin);
  const int r_begin = chunk * chunk_rows, r_end = min(hp, r_begin + chunk_rows);
  const int groups = (r_end - r_begin + g - 1) / g;
  const int boxes = width / kBoxCols, slot_bytes = g * width;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaSlots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {  // thread 0 only
    if (t >= groups) return;
    const uint32_t bar = smem_addr(&full[t % kTmaSlots]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(slot_bytes)
                 : "memory");
    const int row = plane * hp + r_begin + t * g;
    for (int b = 0; b < boxes; ++b) {
      const uint32_t dst = smem_addr(ring + (t % kTmaSlots) * slot_bytes + b * g * kBoxCols);
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
          "l"(reinterpret_cast<uint64_t>(&frame)), "r"(win * stride + b * kBoxCols), "r"(row),
          "r"(bar)
          : "memory");
    }
  };
  if (threadIdx.x == 0)
    for (int t = 0; t < kTmaSlots - 1; ++t) issue(t);
  const bool store = win == nwin - 1 && chunk == 0;
  for (int t = 0; t < groups; ++t) {
    mbar_wait(smem_addr(&full[t % kTmaSlots]), (t / kTmaSlots) & 1);
    __syncthreads();  // every thread saw group t; slot (t - 1) % 4 is free
    if (threadIdx.x == 0) issue(t + kTmaSlots - 1);
    if (store && t == 0) store_corner(ring, kBoxCols, out + plane * kStoreRows * kStoreCols);
  }
}

// K1 direct's staging of tile (blockIdx.x) of plane blockIdx.y, as
// k1_direct runs it (rows_through_stage, the hybrid body's layout): its
// round16(th + 2rh) window rows in groups of L.g, two in flight, each of
// L.sw bytes from image column j0 - rw - delta by load_window.
__global__ void __launch_bounds__(kThreads) fetch_k1_direct(
    const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int h, int w, int th, int tw,
    int rh, int rw, int nbw) {
  extern __shared__ __align__(16) uint8_t stage[];
  const TcLayout L = tc_layout(kDirect, kHybrid, th, tw, rh, rw, 0);
  const int i0 = (blockIdx.x / nbw) * th, j0 = (blockIdx.x % nbw) * tw;
  const uint8_t* xp = x + static_cast<size_t>(blockIdx.y) * h * w;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | static_cast<uintptr_t>(w)) & 15) == 0;
  const bool store = blockIdx.x == gridDim.x - 1;
  const int ngr = (L.rows + L.g - 1) / L.g;
  auto issue = [&](int t) {
    if (t < ngr) {
      load_window(stage + (t & 1) * L.g * L.sp, L.sp, xp, h, w, i0 - rh + t * L.g,
                  min(L.g, L.rows - t * L.g), j0 - rw - L.delta, 0, L.sw, vec);
    }
    cp_async_commit();
  };
  issue(0);
  for (int t = 0; t < ngr; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (store && t == 0) store_corner(stage, L.sp, out + blockIdx.y * kStoreRows * kStoreCols);
    __syncthreads();
  }
}

// K1a's staging of tile blockIdx.x of plane blockIdx.y from A5's padded
// frame (xh x xw a plane, the plane at (rh, rw)), as k1_assembled runs it
// (one window a block, the hybrid body's layout): row groups of L.g rows x
// L.sw bytes by load_rect into `slots` buffers, slots - 1 groups in flight,
// the bytes staged as they are.
template <int kSlots>
__global__ void __launch_bounds__(kThreads) fetch_k1_assembled(
    const uint8_t* __restrict__ frame, uint8_t* __restrict__ out, int xh, int xw, int th,
    int tw, int rh, int rw, int nbw) {
  extern __shared__ __align__(16) uint8_t raw[];
  const TcLayout L = tc_layout(kAssembled, kHybrid, th, tw, rh, rw, kSlots);
  const int ngr = (L.rows + L.g - 1) / L.g;
  const int i0 = (blockIdx.x / nbw) * th, j0 = (blockIdx.x % nbw) * tw;
  const uint8_t* fp = frame + static_cast<size_t>(blockIdx.y) * xh * xw;
  auto issue = [&](int t) {
    if (t < ngr) {
      load_rect(raw + (t % kSlots) * L.g * L.sp, L.sp,
                fp + static_cast<size_t>(i0 + t * L.g) * xw + j0, xw,
                min(L.g, L.rows - t * L.g), L.sw);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kSlots - 1; ++t) issue(t);
  const bool store = blockIdx.x == gridDim.x - 1;
  for (int t = 0; t < ngr; ++t) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();  // group t landed; the slot of group t - 1 is free
    issue(t + kSlots - 1);
    if (store && t == 0) store_corner(raw, L.sp, out + blockIdx.y * kStoreRows * kStoreCols);
  }
  cp_async_wait<0>();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                       &status) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &status) !=
      cudaSuccess)
    return nullptr;
#endif
  return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(fn) : nullptr;
}

}  // namespace

// B3's windows (or strips: nwin 1, width = pitch) of `planes` planes of
// hp x pitch bytes; tma 1 takes TMA boxes (width a multiple of 128, g <=
// 256), else cp.async. out: planes x 8 x 128 bytes. smem: the ring's bytes
// (3 or 4 slots of g x width). Returns the cudaError_t (0 = launched; a
// refused tensor map is cudaErrorInvalidValue).
extern "C" int fetch_windows(int tma, const void* x, void* out, int planes, int hp, int pitch,
                             int width, int stride, int nwin, int chunk_rows, int g, int smem,
                             void* stream) {
  if (planes < 1 || hp < kStoreRows || width < kStoreCols || width % 16 || stride % 16 ||
      pitch % 16 || g < kStoreRows || chunk_rows % g || (nwin - 1) * stride + width > pitch)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (hp + chunk_rows - 1) / chunk_rows;
  const dim3 grid(planes * nwin * nchunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tma) {
    auto kernel = fetch_window_cp_async;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, st>>>(static_cast<const uint8_t*>(x),
                                         static_cast<uint8_t*>(out), hp, pitch, width, stride,
                                         nwin, chunk_rows, nchunks, g);
    return static_cast<int>(cudaGetLastError());
  }
  if (width % kBoxCols || g > 256) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(pitch),
                              static_cast<cuuint64_t>(planes) * hp};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(g)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fetch_window_tma;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, st>>>(map, static_cast<uint8_t*>(out), hp, width, stride, nwin,
                                       chunk_rows, nchunks, g);
  return static_cast<int>(cudaGetLastError());
}

// K1's loaders on `planes` planes of h x w bytes at tile (th, tw) and
// support radii (rh, rw), holding smem bytes of shared memory a block (K1's
// hybrid body's): assembled 0 is the direct form's staging from x;
// assembled 1 the assembled form's cp.async from A5's frame x (xh x xw a
// plane) with `slots` (2 or 3) buffers. out: planes x 8 x 128 bytes.
// Returns the cudaError_t (0 = launched).
extern "C" int fetch_k1(int assembled, const void* x, void* out, int planes, int h, int w,
                        int th, int tw, int rh, int rw, int xh, int xw, int slots, int smem,
                        void* stream) {
  const int nbw = (w + tw - 1) / tw, nbh = (h + th - 1) / th;
  const bool tw_ok = tw == 32 || tw == 64 || tw == 128;
  const TcLayout L = tc_layout(assembled ? kAssembled : kDirect, kHybrid, th, tw, rh, rw,
                               assembled ? slots : 0);
  if (planes < 1 || !tw_ok || th < 16 || th % 16 || rh < 1 || rw < 1 ||
      L.sw < kStoreCols || L.stage > smem || (assembled && slots != 2 && slots != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nbh * nbw, planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, auto... args) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, st>>>(args...);
    return static_cast<int>(cudaGetLastError());
  };
  const uint8_t* xs = static_cast<const uint8_t*>(x);
  uint8_t* os = static_cast<uint8_t*>(out);
  if (!assembled) return run(fetch_k1_direct, xs, os, h, w, th, tw, rh, rw, nbw);
  if (slots == 3) return run(fetch_k1_assembled<3>, xs, os, xh, xw, th, tw, rh, rw, nbw);
  return run(fetch_k1_assembled<2>, xs, os, xh, xw, th, tw, rh, rw, nbw);
}
