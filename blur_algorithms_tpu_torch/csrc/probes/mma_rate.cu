// B1, the dot rate of the tensor cores: a chain of int8 or bf16 matrix
// products, each step's output cast back to the lhs type and fed back as the
// next step's lhs, by two instruction paths.
//
// Replaces: benchmarks/mxu_dot_rate.py:make_fn (its pallas_call at :61): per
// grid step, `inner` chained products a <- cast(a @ b) of an (m, k) lhs and a
// (k, n) rhs, int8 -> int32 or bf16 -> f32, where the next lhs is acc[:, :k]
// when n >= k, else concat(acc, a[:, n:]); the result is the last lhs in the
// accumulator type. Every grid step recomputes the same chain from the same
// inputs, so the result is one chain's.
//
// The chain on an H100. Rows are independent (row i of the next lhs is row i
// of this step's product, or row i of the lhs), so one 64-row panel of a (m
// padded to 64 with zero rows, k to 64 bytes with zero columns of a and rows
// of b; only the real rows and columns count as work) is one chain's unit,
// and a thread-block cluster of C CTAs shares it (C 1, 2, 4 or 8: portable
// clusters; b has at most 8 tiles of 128 columns). CTA r of the cluster owns
// tiles r, r + C, ... of b and computes them one after another. One chain
// takes C the least power of two >= the tiles, a tile a CTA: at the 1024^3
// cube 16 panels x 8 CTAs = 128 CTAs, where one block a panel gave 16. A
// launch that fills the card (the rates') takes C = 1: each CTA computes
// every tile of its panel and exchanges nothing, and `copies` such clusters
// run side by side (the clusters of the first copy store). The TPU ran its
// `steps` one after another on one core; here they run in turn inside the
// cluster.
//
// Per CTA (384 threads): one producer warpgroup, whose first thread issues
// the TMA loads, and two consumer warpgroups, each owning 64 of the tile's
// 128 columns; setmaxnreg moves the producer's registers to the consumers.
// - The panel (64 x k bytes, at most 192 KB in bf16) stays in shared memory
//   in the plain K-major layout of 8-row x 16-byte core matrices (core (g,
//   r8) at (8 g + r8) * 128 bytes), which wgmma reads through a descriptor
//   and ldmatrix reads as it is. At the start of a step it comes from a by
//   TMA boxes of 64 rows x 16 bytes (one core-matrix column each), each CTA
//   issuing every C-th box with .multicast::cluster, so every CTA of the
//   cluster receives the whole panel, counted on its `loaded` mbarrier.
// - b is stored transposed (n x k, K-major, what int8 wgmma requires) and
//   streamed by TMA (cp.async.bulk.tensor.2d) in stages of 128 columns x 64
//   bytes of K (8 KB, the 64-byte swizzle that the wgmma descriptors and the
//   ldmatrix addresses read), through a ring of 4 stages tracked by full
//   (transaction count) and empty (8 consumer warps) mbarriers. 64 bytes of
//   K, not 128: a bf16 panel of k 1536 takes 192 KB, which leaves room for
//   four 8 KB stages and not for three of 16 KB.
// - A consumer thread keeps each of its CTA's tiles of a product, cast to
//   the lhs type, in registers (8 words a tile in int8, 16 in bf16) until
//   the last one is done: every tile reads the whole panel (ptxas keeps
//   the kernel at 168 registers a thread, so eight held bf16 tiles, 128
//   words, spill: 224-232 bytes in the bf16 mma.sync instantiations, 32 in
//   the resident bf16 wgmma one, none elsewhere). Then (but after
//   the last product of a step) the cast tiles go into every CTA's panel:
//   once the cluster's hardware barrier shows that every CTA has finished
//   reading its panel (barrier.cluster.arrive.release / wait.acquire, every
//   thread of every CTA arriving), each CTA writes its tiles' cast columns
//   below min(n, k) into its own panel (one contiguous run of core-matrix
//   columns a tile), and its 256 consumer threads copy those runs into each
//   peer's panel at the same offsets by 16-byte st.shared::cluster (mapa
//   addresses), and a second cluster barrier makes them visible. Nothing
//   goes through device memory. The last product of the chain goes from the
//   registers straight to the output. The producer's thread joins each
//   barrier once it has the next product's first stages in flight (their
//   slots are free by then), its idle threads as they come.
//
// The two paths compute the same tiles from the same staging:
// - mma.sync (int8 m16n8k32, bf16 m16n8k16), the instruction the split's
//   passes run: each consumer warp 32 x 32 outputs, A fragments by ldmatrix
//   from the panel and B fragments by ldmatrix from the swizzled stage.
// - wgmma (int8 m64n64k32, bf16 m64n64k16): each consumer warpgroup its 64 x
//   64 half from shared-memory descriptors (the panel without swizzle, the
//   stage with the 64-byte one), two instructions a stage, one commit group
//   a stage, one group kept in flight (wgmma.wait_group 1) while the next
//   stage's barrier is waited for.
// A `resident` launch loads the first 4 stages of tile 0 (columns 0..127 of
// b, K bytes [0, 256)) once and K stage kc of every tile reads stage kc mod
// 4, so the result is the chain on resident_rhs(b) and is used for timing
// only (the rate of the instruction with its operands in shared memory).
//
// What bounds it on an H100: with C > 1 (one chain), the exchange after
// every product. Each CTA receives (C - 1) / C of the next panel (56 KB at
// the int8 cube) through distributed shared memory, and the cluster waits
// for it twice; measured at the cube (NVIDIA H100 80GB HBM3, 700 W,
// probes/b1_variants.py), a resident int8 wgmma product of clusters of 8
// takes ~11.4 us, of which ~2.3 are the products, ~2 the first barrier and
// ~7 the exchange and the second. The rates' launch (C = 1) has no
// exchange: resident wgmma at the cube 1148.5 int8 TOP/s (58%) and 738.7
// bf16 (75%), where one block a panel with the tiles through a device-memory
// scratch gave 808.4 and 529.9 (in turns, same card and probe). Streamed,
// the L2 (each CTA reads its tiles' columns of b once a product: 128 int8
// or 64 bf16 operations per byte): 416.9 int8, 223.8 bf16, 3.3 and 3.5
// TB/s of L2 reads. chip_smoke.py
// phase 17 prints the rates, PERF.md keeps them. The tile's K loop holds
// nothing but the barrier waits and the products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kRows = 64;        // rows of a panel: one wgmma m64
constexpr int kTile = 128;       // columns of b a CTA's tile
constexpr int kHalf = 64;        // columns of the tile a consumer warpgroup
constexpr int kStageK = 64;      // bytes of K a stage: one 64-byte swizzle row
constexpr int kStageBytes = kTile * kStageK;
constexpr int kStages = 4;
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxCluster = 8;  // portable clusters
constexpr int kMaxTiles = 8;    // tiles of b, and so of a CTA
constexpr int kBarriers = 2 * kStages + 1;  // full, empty, loaded

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, K byte) in the panel's core-matrix layout
__device__ __forceinline__ int panel_off(int row, int byte) {
  return ((byte >> 4) * 8 + (row >> 3)) * 128 + (row & 7) * 16 + (byte & 15);
}

// byte offset of (column of b, K byte) in a stage: 64-byte rows, the 16-byte
// piece c of row r at piece c ^ ((r >> 1) & 3) (TMA's 64-byte swizzle)
__device__ __forceinline__ int stage_off(int col, int byte) {
  return col * kStageK + ((((byte >> 4) ^ (col >> 1)) & 3) << 4) + (byte & 15);
}

// ---- cluster, mbarrier and TMA ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the shared::cluster address of `addr` in the CTA of rank `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}
// the same box into the same offsets of every CTA of `mask`, each counted on
// its own mbarrier at `bar`'s offset
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int x, int y, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "h"(mask)
      : "memory");
}
// 16 bytes into a peer's shared memory (a shared::cluster address)
__device__ __forceinline__ void st_peer(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// writes by the threads (generic proxy) made visible to wgmma's reads (async
// proxy): this CTA's shared memory, or every state space (a peer's too)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// the two consumer warpgroups (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---- the instructions ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16x8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_16x8(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma descriptors: the panel without swizzle (leading byte offset: the
// next core matrix along K; stride byte offset: the next 8 rows), and a
// stage with the 64-byte swizzle (8 rows of 64 bytes a repeat, 512 bytes)
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}
__device__ __forceinline__ uint64_t stage_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (static_cast<uint64_t>(2) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

struct Params {
  void* out;  // m x k in the accumulator type
  int m, k, kb, kk;  // kk = min(n, k): the columns each product replaces
  int ntile, panels, inner, steps, cluster;
};

// The cast pairs of a tile a consumer thread holds: 16 pairs (below) of 2
// bytes (int8, two pairs a word) or 4 (bf16, a word each)
template <bool kBf16>
struct Types {
  using Acc = int;
  static constexpr int kEs = 1;
  static constexpr int kWords = 8;
};
template <>
struct Types<true> {
  using Acc = float;
  static constexpr int kEs = 2;
  static constexpr int kWords = 16;
};

// columns c and c + 1 of a tile cast to the lhs type, as its bytes: int32
// -> int8 wraps, as XLA's and PyTorch's conversions do; f32 -> bf16 rounds
// to nearest even
__device__ __forceinline__ uint32_t cast_pair(int v0, int v1) {
  return (static_cast<uint32_t>(v0) & 0xFF) | ((static_cast<uint32_t>(v1) & 0xFF) << 8);
}
__device__ __forceinline__ uint32_t cast_pair(float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// pair pr of a held tile: its bytes, into the panel, and in the accumulator
// type (the chain's result)
template <bool kBf16>
__device__ __forceinline__ uint32_t held_pair(const uint32_t (&h)[Types<kBf16>::kWords], int pr) {
  if constexpr (kBf16) {
    return h[pr];
  } else {
    return (h[pr >> 1] >> (16 * (pr & 1))) & 0xFFFF;
  }
}
template <bool kBf16>
__device__ __forceinline__ void put_pair(uint8_t* dst, uint32_t bits) {
  if constexpr (kBf16) {
    *reinterpret_cast<uint32_t*>(dst) = bits;
  } else {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(bits);
  }
}
__device__ __forceinline__ void out_pair(int* o, uint32_t bits) {
  o[0] = static_cast<int8_t>(bits & 0xFF);
  o[1] = static_cast<int8_t>(bits >> 8);
}
__device__ __forceinline__ void out_pair(float* o, uint32_t bits) {
  o[0] = __uint_as_float(bits << 16);
  o[1] = __uint_as_float(bits & 0xFFFF0000u);
}

// The accumulators of a consumer thread: 16 pairs (2 columns, one row) of
// its warpgroup's 64 x 64 half. wgmma: pair p is n8 block p >> 1 of the
// warp's 16 rows; mma.sync: the warp's 32 x 32 block, m16 block p >> 3, n8
// block (p >> 1) & 3. (row, column of the tile) of pair p:
template <bool kWgmma>
__device__ __forceinline__ void pair_pos(int p, int& row, int& col) {
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, half = p & 1;
  if (kWgmma) {
    row = 16 * w + g + 8 * half;
    col = kHalf * wg + 8 * (p >> 1) + 2 * tig;
  } else {
    row = 32 * (w >> 1) + 16 * (p >> 3) + g + 8 * half;
    col = kHalf * wg + 32 * (w & 1) + 8 * ((p >> 1) & 3) + 2 * tig;
  }
}

// One stage (64 bytes of K, two k-steps of 32 bytes) into the thread's
// accumulators, acc[b] being n8 block b (wgmma) or (m16 i, n8 j) = (b >> 2,
// b & 3) (mma.sync).
template <bool kBf16>
__device__ __forceinline__ void stage_mma_sync(typename Types<kBf16>::Acc (&acc)[8][4],
                                               const uint8_t* panel, const uint8_t* stage,
                                               int kc) {
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int rbase = 32 * (w >> 1) + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int cbase = kHalf * wg + 32 * (w & 1) + (lane & 7) + ((lane >> 4) & 1) * 8;
#pragma unroll
  for (int s = 0; s < kStageK / 32; ++s) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_x4(af[i], panel + panel_off(rbase + 16 * i, kc * kStageK + 32 * s +
                                                               (lane >> 4) * 16));
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t bq[4];
      ldmatrix_x4(bq, stage + stage_off(cbase + 16 * jj, 32 * s + ((lane >> 3) & 1) * 16));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_16x8(acc[4 * i + 2 * jj], af[i], bq[0], bq[1]);
        mma_16x8(acc[4 * i + 2 * jj + 1], af[i], bq[2], bq[3]);
      }
    }
  }
}

// wgmma: the warpgroup's 64 x 64 half, two instructions, one commit group
template <bool kBf16>
__device__ __forceinline__ void stage_wgmma(typename Types<kBf16>::Acc (&acc)[8][4],
                                            uint32_t panel, uint32_t stage, int kc) {
  auto& d = reinterpret_cast<typename Types<kBf16>::Acc(&)[32]>(acc);
  const int wg = threadIdx.x >> 7;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kStageK / 32; ++s) {
    const uint64_t da = panel_desc(panel + (kc * (kStageK / 16) + 2 * s) * 1024);
    const uint64_t db = stage_desc(stage + wg * kHalf * kStageK + 32 * s);
    if constexpr (kBf16) {
      wgmma_bf16(d, da, db);
    } else {
      wgmma_s8(d, da, db);
    }
  }
  wgmma_commit();
}

int smem_bytes(int kb) { return 1024 + kStages * kStageBytes + kRows * kb + 8 * kBarriers; }

template <bool kWgmma, bool kBf16, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    mma_chain_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, Params p) {
  using Acc = typename Types<kBf16>::Acc;
  constexpr int es = Types<kBf16>::kEs;
  extern __shared__ uint8_t smem_raw[];
  // stages on 1024-byte boundaries, so that the swizzle's address bits are
  // the stage's row bits (the same offset in every CTA of the cluster)
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* panel = ring + kStages * kStageBytes;
  const uint32_t bar0 = smem_addr(panel + kRows * p.kb);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };
  const uint32_t loaded = bar0 + 16 * kStages;

  const int C = p.cluster;
  const int rank = static_cast<int>(cluster_rank());
  const int chain = blockIdx.x / C;
  const int row0 = (chain % p.panels) * kRows;
  // CTA r owns tiles r, r + C, ...: `own` of them
  const int own = rank < p.ntile ? (p.ntile - rank + C - 1) / C : 0;
  const int nkc = p.kb / kStageK;
  // cluster barriers after product pi (of steps x inner): none after the
  // chain's last, one after a step's last (the panels are free for the next
  // step's load), else two (the panels are free; the exchange is in them)
  const int products = p.steps * p.inner;
  auto syncs_after = [&](int pi) {
    return pi == products - 1 ? 0 : (pi % p.inner == p.inner - 1 ? 1 : 2);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(loaded, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any peer signals them

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: its first thread streams the tiles' stages ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const uint32_t ring_a = smem_addr(ring);
    if (threadIdx.x == kConsumers && own && kResident) {
      for (int s = 0; s < kStages && s < nkc; ++s) {  // tile 0's first stages, once
        mbar_expect_tx(full(s), kStageBytes);
        tma_load(ring_a + s * kStageBytes, &map_b, full(s), s * kStageK, 0);
      }
    }
    int pi = 0;  // the product whose barriers come next
    if (threadIdx.x == kConsumers && own && !kResident) {
      // per product: the owned tiles in turn, each its nkc stages of K
      const int per = own * nkc, total = products * per, ahead = min(kStages, per);
      for (int q = 0; q < total; ++q) {
        const int slot = q % kStages, tile = rank + C * ((q / nkc) % own);
        if (q >= kStages) mbar_wait(empty(slot), ((q / kStages) - 1) & 1);
        mbar_expect_tx(full(slot), kStageBytes);
        tma_load(ring_a + slot * kStageBytes, &map_b, full(slot), (q % nkc) * kStageK,
                 tile * kTile);
        // product pi's barriers once the next product's first stages are
        // issued: their slots held product pi's last stages, which its
        // consumers release before they reach the barrier
        if (pi < products - 1 && q == min((pi + 1) * per + ahead, total) - 1) {
          for (int b = 0; b < syncs_after(pi); ++b) cluster_sync();
          ++pi;
        }
      }
    }
    for (; pi < products - 1; ++pi)
      for (int b = 0; b < syncs_after(pi); ++b) cluster_sync();
    cluster_sync();  // no CTA leaves while a peer may still write to it
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x, lane = tid & 31;
    const uint32_t panel_a = smem_addr(panel), ring_a = smem_addr(ring);
    const uint16_t mask = static_cast<uint16_t>((1u << C) - 1);
    // exchanged bytes of tile t: its columns below kk, 64 rows
    auto xbytes = [&](int t) { return max(0, min(kTile, p.kk - kTile * t)) * es * kRows; };
    auto reload = [&]() {  // the panel from a, every C-th box from this CTA
      mbar_expect_tx(loaded, kRows * p.kb);
      for (int gch = rank; gch < p.kb / 16; gch += C) {
        if (C == 1) {
          tma_load(panel_a + gch * 1024, &map_a, loaded, 16 * gch, row0);
        } else {
          tma_load_multicast(panel_a + gch * 1024, &map_a, loaded, 16 * gch, row0, mask);
        }
      }
    };
    if (tid == 0) reload();
    if (kResident && own)
      for (int s = 0; s < kStages && s < nkc; ++s) mbar_wait(full(s), 0);

    Acc acc[8][4];
    uint32_t held[kMaxTiles][Types<kBf16>::kWords];  // the owned tiles, cast
    int q = 0;  // stages consumed
    for (int step = 0; step < p.steps; ++step) {
      mbar_wait(loaded, step & 1);
      for (int it = 0; it < p.inner; ++it) {
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          if (j >= own) continue;
#pragma unroll
          for (int b = 0; b < 8; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[b][c] = Acc(0);
          for (int kc = 0; kc < nkc; ++kc, ++q) {
            const int slot = kResident ? kc % kStages : q % kStages;
            if (!kResident) mbar_wait(full(slot), (q / kStages) & 1);
            if constexpr (kWgmma) {
              stage_wgmma<kBf16>(acc, panel_a, ring_a + slot * kStageBytes, kc);
              if (!kResident && kc > 0) {
                wgmma_wait<1>();  // the previous stage's group is done with its slot
                __syncwarp();
                if (lane == 0) mbar_arrive(empty((q - 1) % kStages));
              }
            } else {
              stage_mma_sync<kBf16>(acc, panel, ring + slot * kStageBytes, kc);
              if (!kResident) {
                __syncwarp();
                if (lane == 0) mbar_arrive(empty(slot));
              }
            }
          }
          if constexpr (kWgmma) {
            wgmma_wait<0>();
            if (!kResident) {
              __syncwarp();
              if (lane == 0) mbar_arrive(empty((q - 1) % kStages));
            }
          }
#pragma unroll
          for (int w = 0; w < Types<kBf16>::kWords; ++w) held[j][w] = 0;
#pragma unroll
          for (int pr = 0; pr < 16; ++pr)
            held[j][kBf16 ? pr : pr >> 1] |=
                cast_pair(acc[pr >> 1][2 * (pr & 1)], acc[pr >> 1][2 * (pr & 1) + 1])
                << (kBf16 ? 0 : 16 * (pr & 1));
        }
        if (step == p.steps - 1 && it == p.inner - 1) {
          // the chain's last product: the tiles' columns below kk straight
          // from the registers to the output (the first copy's clusters)
          if (chain < p.panels) {
#pragma unroll
            for (int j = 0; j < kMaxTiles; ++j) {
              if (j >= own) continue;
#pragma unroll
              for (int pr = 0; pr < 16; ++pr) {
                int row, col;
                pair_pos<kWgmma>(pr, row, col);
                col += kTile * (rank + C * j);
                if (row0 + row < p.m && col < p.kk)
                  out_pair(static_cast<Acc*>(p.out) + static_cast<size_t>(row0 + row) * p.k + col,
                           held_pair<kBf16>(held[j], pr));
              }
            }
          }
          break;
        }
        cluster_sync();  // every CTA of the cluster is done reading its panel
        if (it == p.inner - 1) {  // the step's last product: the next step reloads
          if (tid == 0) reload();
          continue;
        }
        // the cast tiles into every panel: this CTA's runs locally, then 16
        // bytes a store into its peers'
#pragma unroll
        for (int j = 0; j < kMaxTiles; ++j) {
          if (j >= own) continue;
#pragma unroll
          for (int pr = 0; pr < 16; ++pr) {
            int row, col;
            pair_pos<kWgmma>(pr, row, col);
            col += kTile * (rank + C * j);
            if (col < p.kk)
              put_pair<kBf16>(panel + panel_off(row, col * es), held_pair<kBf16>(held[j], pr));
          }
        }
        consumer_sync();
        for (int j = 0; j < own && C > 1; ++j) {
          const int t = rank + C * j, outgoing = xbytes(t) / 16;  // 16-byte pieces
          const uint32_t region = static_cast<uint32_t>(t) * kTile * es * kRows;  // its run
          for (int e = tid; e < outgoing * (C - 1); e += kConsumers) {
            const int peer = e / outgoing, piece = e - peer * outgoing;
            const uint32_t off = region + 16 * piece;
            st_peer(peer_addr(panel_a + off, peer + (peer >= rank)),
                    *reinterpret_cast<const uint4*>(panel + off));
          }
        }
        fence_async_all();
        cluster_sync();  // every run is in every panel
        fence_async_shared();
      }
    }
    // columns [kk, k) of the result: the lhs's own, never replaced, from the
    // panel, shared out over the cluster
    if (chain < p.panels && p.kk < p.k) {
      const int wide = p.k - p.kk, total = kRows * wide;
      const int lo = total * rank / C, hi = total * (rank + 1) / C;
      for (int e = lo + tid; e < hi; e += kConsumers) {
        const int i = e / wide, j = p.kk + e % wide;
        if (row0 + i >= p.m) continue;
        const uint8_t* v = panel + panel_off(i, j * es);
        if constexpr (kBf16) {
          static_cast<float*>(p.out)[static_cast<size_t>(row0 + i) * p.k + j] =
              __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(v));
        } else {
          static_cast<int*>(p.out)[static_cast<size_t>(row0 + i) * p.k + j] =
              static_cast<int>(static_cast<int8_t>(*v));
        }
      }
    }
    cluster_sync();
  }
}

template <bool kWgmma, bool kBf16, bool kResident>
cudaError_t configure(int kb, int cluster, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  auto kernel = mma_chain_kernel<kWgmma, kBf16, kResident>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kb));
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes(kb));
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

template <bool W, bool B, bool R>
struct Clusters {
  static int run(int kb, int cluster, int* clusters) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    cudaError_t err = configure<W, B, R>(kb, cluster, cfg, attr);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(static_cast<unsigned>(cluster));
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, mma_chain_kernel<W, B, R>, &cfg));
  }
};

template <bool W, bool B, bool R>
struct Launch {
  static int run(const CUtensorMap* maps, Params p, int grid, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    cudaError_t err = configure<W, B, R>(p.kb, p.cluster, cfg, attr);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.stream = stream;
    err = cudaLaunchKernelEx(&cfg, mma_chain_kernel<W, B, R>, maps[0], maps[1], p);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
};

// the instantiation for (wgmma, bf16, resident), each 0 or 1
template <template <bool, bool, bool> class F, typename... Args>
int dispatch(int wgmma, int bf16, int resident, Args... args) {
  const int key = 4 * (wgmma != 0) + 2 * (bf16 != 0) + (resident != 0);
  switch (key) {
    case 0: return F<false, false, false>::run(args...);
    case 1: return F<false, false, true>::run(args...);
    case 2: return F<false, true, false>::run(args...);
    case 3: return F<false, true, true>::run(args...);
    case 4: return F<true, false, false>::run(args...);
    case 5: return F<true, false, true>::run(args...);
    case 6: return F<true, true, false>::run(args...);
    default: return F<true, true, true>::run(args...);
  }
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

bool valid_cluster(int c) { return c == 1 || c == 2 || c == 4 || c == kMaxCluster; }

}  // namespace

// Clusters of the chain kernel (the path and type as in mma_rate_chain) that
// the card holds at once for a panel of kb bytes of K and clusters of
// `cluster` CTAs, into *clusters. Returns the cudaError_t (0 = fine).
extern "C" int mma_rate_clusters(int wgmma, int bf16, int resident, int kb, int cluster,
                                 int* clusters) {
  if (kb < kStageK || kb % kStageK || !valid_cluster(cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Clusters>(wgmma, bf16, resident, kb, cluster, clusters);
}

// The two TMA tensor maps of B1's chain, into maps (2 x 128 bytes, as the
// launch takes them): a, rows x kb bytes row-major, in boxes of 64 rows x 16
// bytes (one core-matrix column of the panel); bt, np x kb bytes, in boxes
// of 128 rows x 64 bytes with the 64-byte swizzle. Returns the cudaError_t
// (cudaErrorNotSupported where the CUDA runtime finds no encoder, cudaErrorInvalidValue
// where it refuses a map).
extern "C" int mma_rate_maps(const void* a, const void* bt, int rows, int kb, int np,
                             void* maps) {
  if (kb < kStageK || kb % kStageK || rows < kRows || rows % kRows || np < kTile || np % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap m[2];
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(kb), static_cast<cuuint64_t>(rows)};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(kb), static_cast<cuuint64_t>(np)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kb)};
  const cuuint32_t box_a[2] = {16, kRows}, box_b[2] = {kStageK, kTile};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&m[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a), dims_a, strides,
             box_a, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&m[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(bt), dims_b, strides,
             box_b, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(maps, m, sizeof(m));
  return 0;
}

// B1's chain: a (panels * 64 x kb bytes, int8 or bf16, row-major, zero
// padding) times b transposed (np x kb bytes), `inner` products a step,
// `steps` steps, through the tensor maps of mma_rate_maps, on grid / cluster
// clusters of `cluster` CTAs (1, 2, 4 or 8; cluster g on panel g mod
// panels, CTA r of a cluster on the 128-column tiles r, r + cluster, ... of
// b, at most 8 tiles; the first `panels` clusters store). m x k of the
// result in out (int32 or f32); kk = min(n, k), the columns each product
// replaces (kk * element size a multiple of 16).
// `resident` loads b's first four stages once (timing only). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int mma_rate_chain(int wgmma, int bf16, int resident, const void* maps, void* out,
                              int m, int k, int kb, int np, int kk, int panels, int inner,
                              int steps, int cluster, int grid, void* stream) {
  const int es = bf16 ? 2 : 1;
  if (kb < kStageK || kb % kStageK || np < kTile || np % kTile || kk < 1 || (kk * es) % 16 ||
      kk * es > kb || panels < 1 || m < 1 || m > panels * kRows || k < 1 || k * es > kb ||
      inner < 1 || steps < 1 || !valid_cluster(cluster) || np / kTile > kMaxTiles ||
      grid % cluster || grid / cluster < panels)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes(kb) > limit) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m2[2];
  memcpy(m2, maps, sizeof(m2));
  const Params p{out, m, k, kb, kk, np / kTile, panels, inner, steps, cluster};
  return dispatch<Launch>(wgmma, bf16, resident, static_cast<const CUtensorMap*>(m2), p, grid,
                          static_cast<cudaStream_t>(stream));
}
