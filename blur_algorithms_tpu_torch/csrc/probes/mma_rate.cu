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
// of this step's product, or row i of the lhs), so a block owns a 64-row
// panel of a (m is padded to 64 with zero rows, k to 128 bytes with zero
// columns of a and rows of b; only the real rows and columns count as work)
// and runs its `steps` x `inner` products alone. The TPU ran its `steps`
// one after another on one core; here the copies run side by side: the grid
// is one block for each block the card holds at once (occupancy x SMs, at
// least one per panel), block g on panel g mod panels, and the blocks of
// the first copy store. One warpgroup (128 threads) a block.
//
// Operands. The panel (64 x k bytes, at most 96 KB int8 or 192 KB bf16)
// stays in shared memory for the whole chain in the plain K-major layout of
// 8-row x 16-byte core matrices (core (g, r8) at (8 g + r8) * 128 bytes),
// which wgmma reads through a descriptor and ldmatrix reads as it is. b
// (at most 1536 x 1024 bytes, 3 MB in bf16) fits no block's 227 KB, so the
// wrapper stores it transposed (n x k, K-major, what int8 wgmma requires)
// and every block streams it from L2 in stages of 128 columns x 128 bytes
// of K (16 KB, two in flight) by 16-byte cp.async. Each 128-column tile of
// the product is summed in registers over all of K, cast, and written to
// the block's scratch rows in device memory; after the last tile of a step
// the scratch goes back into the panel's first min(n, k) columns (the rest
// of the lhs is unchanged, as in the concat).
//
// The two paths compute the same tiles:
// - mma.sync (int8 m16n8k32, bf16 m16n8k16), the instruction the split's
//   passes run: four warps of 32 x 64 outputs, A and B fragments by
//   ldmatrix.x4 from the panel and the stage (2 + 4 ldmatrix per 16 mma).
// - wgmma (int8 m64n128k32, bf16 m64n128k16): the warpgroup's whole 64 x 128
//   tile from shared-memory descriptors, four instructions a stage, one
//   group in flight while the next stage loads.
// A `resident` launch drops the loads of b from the loop: the two stages are
// filled once and every step reads them, so the result is wrong and is used
// for timing only (the rate of the instruction with its operands in shared
// memory): no barrier but where the panel changes, and wgmma waits once
// per tile, not per stage.
//
// What bounds it on an H100: streamed, the L2 (each block reads b once per
// step: 128 int8 or 64 bf16 operations per byte, against ~590 / ~295 that
// the card's peaks need from device memory), and both paths run at the
// same rate; resident, the instruction path (mma.sync: shared-memory reads
// into registers for every fragment; wgmma: its groups, one warpgroup a
// block, one or two blocks an SM by the panel's size, a wait and an
// epilogue a tile), about half the published peaks (chip_smoke.py phase
// 17 prints the rates, PERF.md keeps them). The tile's K loop holds
// nothing but the products: with the zeroing and the wait inside one flat
// loop, ptxas injected a warpgroup.wait before every group.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // rows of a panel: one wgmma m64
constexpr int kThreads = 128;    // one warpgroup, four warps
constexpr int kTile = 128;       // columns of b per tile: wgmma n128
constexpr int kStageK = 128;     // bytes of K per stage
constexpr int kStageBytes = kTile * kStageK;
constexpr int kStages = 2;

// byte offsets of the core-matrix layouts: the panel (64 rows) and a stage
// (128 columns of b, 128 bytes of K)
__device__ __forceinline__ int panel_off(int row, int byte) {
  return ((byte >> 4) * 8 + (row >> 3)) * 128 + (row & 7) * 16 + (byte & 15);
}
__device__ __forceinline__ int stage_off(int col, int byte) {
  return ((byte >> 4) * 16 + (col >> 3)) * 128 + (col & 7) * 16 + (byte & 15);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (the next core matrix along K) and stride byte offset (the next 8
// rows), in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
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
// writes by the threads (generic proxy) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


struct Params {
  const uint8_t* a;   // (panels * 64) x kb bytes, the lhs row-major, zero-padded
  const uint8_t* bt;  // np x kb bytes, the rhs transposed, zero-padded
  void* out;          // m x k in the accumulator type
  uint8_t* scratch;   // one 64 x kkb region per block
  int m, k, kb, np, kkb, panels, inner, steps;
};

template <bool kBf16>
struct Types {
  using Acc = int;
  static constexpr int kEs = 1;
};
template <>
struct Types<true> {
  using Acc = float;
  static constexpr int kEs = 2;
};

// columns c and c + 1 of a tile cast to the lhs type: int32 -> int8 wraps,
// as XLA's and PyTorch's conversions do; f32 -> bf16 rounds to nearest even
__device__ __forceinline__ void put_pair(uint8_t* dst, int v0, int v1) {
  *reinterpret_cast<uint16_t*>(dst) =
      static_cast<uint16_t>((static_cast<uint32_t>(v0) & 0xFF) |
                            ((static_cast<uint32_t>(v1) & 0xFF) << 8));
}
__device__ __forceinline__ void put_pair(uint8_t* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

// 128 columns of b from column nt * 128, K bytes [kc * 128, +128), into a
// stage: a warp takes 8 columns x 4 pieces of 16 bytes (64 contiguous bytes
// of each column; 4 distinct 128-byte rows of the stage)
__device__ __forceinline__ void load_stage(uint8_t* stage, const uint8_t* bt, int kb, int nt,
                                           int kc) {
  for (int e = threadIdx.x; e < kTile * (kStageK / 16); e += kThreads) {
    const int lane = e & 31, grp = e >> 5;
    const int col = (grp >> 1) * 8 + (lane & 7);
    const int piece = (grp & 1) * 4 + (lane >> 3);
    cp_async16(stage + stage_off(col, piece * 16),
               bt + static_cast<size_t>(nt * kTile + col) * kb + kc * kStageK + piece * 16);
  }
}

// the first `bytes` of 64 rows of `pitch` bytes into the panel, in pieces
// of 16 bytes, consecutive threads on consecutive rows
__device__ __forceinline__ void to_panel(uint8_t* panel, const uint8_t* rows, int pitch,
                                         int bytes) {
  for (int e = threadIdx.x; e < kRows * (bytes >> 4); e += kThreads) {
    const int row = e & (kRows - 1), piece = e >> 6;
    *reinterpret_cast<uint4*>(panel + panel_off(row, piece * 16)) =
        *reinterpret_cast<const uint4*>(rows + static_cast<size_t>(row) * pitch + piece * 16);
  }
}

// One stage (4 k-steps of 32 bytes) into the tile's accumulators.
// mma.sync: warp w owns rows 32 (w >> 1) .. +32 and columns 64 (w & 1) .. +64
// of the tile, acc[i][j] its 16 x 8 block (i, j).
template <bool kBf16>
__device__ __forceinline__ void stage_mma_sync(typename Types<kBf16>::Acc (&acc)[16][4],
                                               const uint8_t* panel, const uint8_t* stage,
                                               int kc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rbase = 32 * (warp >> 1) + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int cbase = 64 * (warp & 1) + (lane & 7) + ((lane >> 4) & 1) * 8;
#pragma unroll
  for (int s = 0; s < kStageK / 32; ++s) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_x4(af[i], panel + panel_off(rbase + 16 * i, kc * kStageK + 32 * s +
                                                               (lane >> 4) * 16));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t bq[4];
      ldmatrix_x4(bq, stage + stage_off(cbase + 16 * jj, 32 * s + ((lane >> 3) & 1) * 16));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_16x8(acc[8 * i + 2 * jj], af[i], bq[0], bq[1]);
        mma_16x8(acc[8 * i + 2 * jj + 1], af[i], bq[2], bq[3]);
      }
    }
  }
}

// wgmma: the warpgroup's 64 x 128 tile, four instructions, one commit group
template <bool kBf16>
__device__ __forceinline__ void stage_wgmma(typename Types<kBf16>::Acc (&acc)[16][4],
                                            const uint8_t* panel, const uint8_t* stage,
                                            int kc) {
  auto& d = reinterpret_cast<typename Types<kBf16>::Acc(&)[64]>(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kStageK / 32; ++s) {
    const uint64_t da = wgmma_desc(panel + (kc * (kStageK / 16) + 2 * s) * 1024, 1024, 128);
    const uint64_t db = wgmma_desc(stage + 2 * s * 2048, 2048, 128);
    if constexpr (kBf16) {
      wgmma_bf16(d, da, db);
    } else {
      wgmma_s8(d, da, db);
    }
  }
  wgmma_commit();
}

// the tile's accumulators, cast, into the block's scratch rows: columns
// below kk = min(n, k) only
template <bool kWgmma, bool kBf16>
__device__ __forceinline__ void tile_to_scratch(const typename Types<kBf16>::Acc (&acc)[16][4],
                                                uint8_t* scratch, int kkb, int nt) {
  constexpr int es = Types<kBf16>::kEs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kk = kkb / es;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    // block b: (16 x 8) of warp tile (i, j) for mma.sync, n8 block b of
    // the warp's 16 rows for wgmma
    const int row = kWgmma ? 16 * warp + (lane >> 2) : 32 * (warp >> 1) + 16 * (b >> 3) +
                                                           (lane >> 2);
    const int col = nt * kTile + (kWgmma ? 8 * b : 64 * (warp & 1) + 8 * (b & 7)) +
                    2 * (lane & 3);
    if (col < kk) {
      put_pair(scratch + static_cast<size_t>(row) * kkb + col * es, acc[b][0], acc[b][1]);
      put_pair(scratch + static_cast<size_t>(row + 8) * kkb + col * es, acc[b][2], acc[b][3]);
    }
  }
}

template <bool kWgmma, bool kBf16, bool kResident>
__global__ void __launch_bounds__(kThreads, 1) mma_chain_kernel(Params p) {
  using Acc = typename Types<kBf16>::Acc;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* panel = smem;
  uint8_t* ring = smem + kRows * p.kb;
  const int panel_id = blockIdx.x % p.panels;
  uint8_t* scratch = p.scratch + static_cast<size_t>(blockIdx.x) * kRows * p.kkb;
  const uint8_t* a = p.a + static_cast<size_t>(panel_id) * kRows * p.kb;
  const int nkc = p.kb / kStageK, ntile = p.np / kTile;
  const int per_it = ntile * nkc, total = p.steps * p.inner * per_it;
  Acc acc[16][4];

  load_stage(ring, p.bt, p.kb, 0, 0);
  if (kResident && nkc > 1) load_stage(ring + kStageBytes, p.bt, p.kb, 0, 1);
  cp_async_commit();
  int q = 0;  // stages consumed so far
  for (int step = 0; step < p.steps; ++step) {
    __syncthreads();
    to_panel(panel, a, p.kb, p.kb);  // a step starts from the lhs
    for (int it = 0; it < p.inner; ++it) {
      for (int nt = 0; nt < ntile; ++nt) {
#pragma unroll
        for (int b = 0; b < 16; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[b][c] = Acc(0);
        // the tile's K, nothing but the products between its first stage
        // and its last, so that wgmma groups follow one another (resident)
        for (int kc = 0; kc < nkc; ++kc, ++q) {
          if (!kResident || (nt == 0 && kc == 0)) {  // resident: where the panel changed
            cp_async_wait<0>();
            if (kWgmma) fence_async_shared();
            __syncthreads();  // stage q and the panel are in place; stage q + 1 is free
          }
          const uint8_t* stage = ring + (kResident ? (kc & 1) : (q & 1)) * kStageBytes;
          if (!kResident) {
            if (q + 1 < total) {
              const int r1 = (q + 1) % per_it;
              load_stage(ring + ((q + 1) & 1) * kStageBytes, p.bt, p.kb, r1 / nkc, r1 % nkc);
            }
            cp_async_commit();
          }
          if constexpr (kWgmma) {
            stage_wgmma<kBf16>(acc, panel, stage, kc);
            if (!kResident) wgmma_wait<0>();
          } else {
            stage_mma_sync<kBf16>(acc, panel, stage, kc);
          }
        }
        if (kWgmma && kResident) wgmma_wait<0>();
        tile_to_scratch<kWgmma, kBf16>(acc, scratch, p.kkb, nt);
      }
      __syncthreads();  // the step's product is whole: the next lhs
      to_panel(panel, scratch, p.kkb, p.kkb);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (blockIdx.x >= p.panels) return;  // copies past the first store nothing
  const int row0 = panel_id * kRows;
  for (int e = threadIdx.x; e < kRows * p.k; e += kThreads) {
    const int i = e / p.k, j = e - i * p.k;
    if (row0 + i >= p.m) break;
    const uint8_t* v = panel + panel_off(i, j * Types<kBf16>::kEs);
    if constexpr (kBf16) {
      static_cast<float*>(p.out)[static_cast<size_t>(row0 + i) * p.k + j] =
          __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(v));
    } else {
      static_cast<int*>(p.out)[static_cast<size_t>(row0 + i) * p.k + j] =
          static_cast<int>(static_cast<int8_t>(*v));
    }
  }
}

int smem_bytes(int kb) { return kRows * kb + kStages * kStageBytes; }

template <bool kWgmma, bool kBf16, bool kResident>
int occupancy(int kb, int* blocks) {
  auto kernel = mma_chain_kernel<kWgmma, kBf16, kResident>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kb));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem_bytes(kb)));
}

template <bool kWgmma, bool kBf16, bool kResident>
int launch(const Params& p, int grid, cudaStream_t stream) {
  auto kernel = mma_chain_kernel<kWgmma, kBf16, kResident>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(p.kb));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem_bytes(p.kb), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

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

template <bool W, bool B, bool R>
struct Occupancy {
  static int run(int kb, int* blocks) { return occupancy<W, B, R>(kb, blocks); }
};
template <bool W, bool B, bool R>
struct Launch {
  static int run(Params p, int grid, cudaStream_t stream) { return launch<W, B, R>(p, grid, stream); }
};

}  // namespace

// Blocks of the chain kernel one SM holds at once for a panel of kb bytes
// of K (the path and type as in mma_rate_chain), into *blocks. Returns the
// cudaError_t (0 = fine).
extern "C" int mma_rate_blocks_per_sm(int wgmma, int bf16, int resident, int kb, int* blocks) {
  if (kb < kStageK || kb % kStageK) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Occupancy>(wgmma, bf16, resident, kb, blocks);
}

// B1's chain: a (panels * 64 x kb bytes, int8 or bf16, row-major, zero
// padding) times b transposed (np x kb bytes), `inner` products a step,
// `steps` steps, on `grid` blocks (block g on panel g mod panels; the
// first `panels` blocks store). m x k of the result in out (int32 or f32);
// kkb = min(n, k) * element size, the columns each product replaces;
// scratch: grid x 64 x kkb bytes. `resident` loads b's first two stages
// once (timing only). Returns the cudaError_t of the launch (0 = launched).
extern "C" int mma_rate_chain(int wgmma, int bf16, int resident, const void* a, const void* bt,
                              void* out, void* scratch, int m, int k, int kb, int np, int kkb,
                              int panels, int inner, int steps, int grid, void* stream) {
  if (kb < kStageK || kb % kStageK || np < kTile || np % kTile || kkb < 16 || kkb % 16 ||
      kkb > kb || panels < 1 || m < 1 || m > panels * kRows || k < 1 || inner < 1 ||
      steps < 1 || grid < panels)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt), out,
                 static_cast<uint8_t*>(scratch), m, k, kb, np, kkb, panels, inner, steps};
  return dispatch<Launch>(wgmma, bf16, resident, p, grid, static_cast<cudaStream_t>(stream));
}
