// A4's ring variant, the one `probes/a4_variants.py` times against the
// shipped kernel (assemble_rows_kernel in
// blur_algorithms_tpu_torch/csrc/fused_dma.cu): the same function, C entry
// and 2-D mapping, with each source row staged in shared memory first.
//
// A warp takes kRowsPerWarp frame rows of its CTA and keeps two of them in
// flight in a ring of two shared-memory slots, an mbarrier a slot: the row's
// 16-byte aligned span by cp.async.bulk (1-D TMA), issued by lane 0, and
// the unaligned head and tail (fewer than 16 bytes each) by the lanes. A
// slot holds source column j at byte (row mod 16) + j, so the aligned span
// lands on aligned slot bytes. The warp then writes the row's 16-byte
// output chunks from the slot (two aligned 16-byte shared loads
// funnel-shifted, or byte by byte through reflect-101 at the edges), while
// the row two ahead streams into the other slot.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o a4_ring.so probes/a4_ring.cu

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;

struct Segment {
  const uint8_t* x;
  long long plane_stride;
  long long row_stride;
  int rows;
  int reversed;
};

struct Params {
  Segment seg[3];
  uint8_t* out;
  int end0, end1, hs, w, rcb, orw, hp, wp, slot;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int reflect101(int i, int n) {
  i = abs(i);
  i = i > n - 1 ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

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

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the source row of frame row r (r < hs)
__device__ __forceinline__ const uint8_t* source_row(const Params& p, int r, int plane) {
  const int g = (r >= p.end0) + (r >= p.end1);
  const Segment s0 = p.seg[0], s1 = p.seg[1], s2 = p.seg[2];
  const uint8_t* x = g == 0 ? s0.x : g == 1 ? s1.x : s2.x;
  const long long ps = g == 0 ? s0.plane_stride : g == 1 ? s1.plane_stride : s2.plane_stride;
  const long long rs = g == 0 ? s0.row_stride : g == 1 ? s1.row_stride : s2.row_stride;
  const int rows = g == 0 ? s0.rows : g == 1 ? s1.rows : s2.rows;
  const int rev = g == 0 ? s0.reversed : g == 1 ? s1.reversed : s2.reversed;
  const int i = r - (g == 0 ? 0 : g == 1 ? p.end0 : p.end1);
  return x + static_cast<long long>(plane) * ps +
         static_cast<long long>(rev ? rows - 1 - i : i) * rs;
}

// stage source row `row` into `slot`; returns whether a bulk copy is in flight
__device__ __forceinline__ bool stage(const Params& p, const uint8_t* row, uint8_t* slot,
                                      uint64_t* bar, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  const int off = static_cast<int>(a & 15);
  const uintptr_t a0 = (a + 15) & ~uintptr_t(15), a1 = (a + p.w) & ~uintptr_t(15);
  const bool bulk = a1 > a0;
  const int head = bulk ? static_cast<int>(a0 - a) : p.w;
  const int tail = bulk ? static_cast<int>(a1 - a) : p.w;
  if (bulk && lane == 0) {
    const unsigned bytes = static_cast<unsigned>(a1 - a0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(slot + off + head)),
        "l"(reinterpret_cast<const void*>(a0)), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
  }
  for (int j = lane; j < head; j += 32) slot[off + j] = row[j];
  for (int j = tail + lane; j < p.w; j += 32) slot[off + j] = row[j];
  return bulk;
}

__global__ void __launch_bounds__(kWarps * 32) a4_ring_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + 2 * warp;
  uint8_t* slots[2] = {smem + 128 + (2 * warp) * p.slot, smem + 128 + (2 * warp + 1) * p.slot};
  if (lane < 2) bar_init(bar + lane);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const int plane = blockIdx.y, chunks = p.wp >> 4;
  const int base = blockIdx.x * kWarps * kRowsPerWarp + warp;
  const int w = p.w, rcb = p.rcb, orw = p.orw;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  bool inflight[2] = {false, false};
  unsigned parity[2] = {0u, 0u};
  int offs[2] = {0, 0};
  for (int t = 0; t < 2 && t < kRowsPerWarp; ++t) {
    const int r = base + t * kWarps;
    if (r < p.hs && r < p.hp) {
      const uint8_t* row = source_row(p, r, plane);
      offs[t] = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
      inflight[t] = stage(p, row, slots[t], bar + t, lane);
    }
  }
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int r = base + t * kWarps, s = t & 1;
    if (r >= p.hp) break;
    uint4* dst = reinterpret_cast<uint4*>(p.out) + (static_cast<size_t>(plane) * p.hp + r) * chunks;
    if (r >= p.hs) {
      for (int k = lane; k < chunks; k += 32) dst[k] = zero;
    } else {
      if (inflight[s]) {
        bar_wait(bar + s, parity[s]);
        parity[s] ^= 1u;
      }
      __syncwarp();
      const uint8_t* src = slots[s] + offs[s];
      const int sh = (offs[s] - orw) & 15;
      for (int k = lane; k < chunks; k += 32) {
        const int j0 = (k << 4) - orw;
        uint4 val = zero;
        if (j0 >= 0 && j0 + 16 <= w) {
          const uint4* q = reinterpret_cast<const uint4*>(src + j0 - sh);
          val = sh ? funnel16(q[0], q[1], sh) : q[0];
        } else if (j0 + 16 > -rcb && j0 < w + rcb) {
          unsigned q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int c = j0 + b;
            if (c >= -rcb && c < w + rcb) {
              q[b >> 2] |= static_cast<unsigned>(src[reflect101(c, w)]) << (8 * (b & 3));
            }
          }
          val = make_uint4(q[0], q[1], q[2], q[3]);
        }
        dst[k] = val;
      }
      __syncwarp();
    }
    inflight[s] = false;
    const int rn = base + (t + 2) * kWarps;
    if (t + 2 < kRowsPerWarp && rn < p.hs && rn < p.hp) {
      const uint8_t* row = source_row(p, rn, plane);
      offs[s] = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
      inflight[s] = stage(p, row, slots[s], bar + s, lane);
    }
  }
}

}  // namespace

extern "C" int assemble_padded_prepad_rows_u8(void* out, int planes, int nseg,
                                              const void* segs, int w, int rw, int orw,
                                              int hp, int wp, int device, void* stream) {
  Params p;
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
  p.slot = ((w + 15 + 15) & ~15) + 32;  // the row at (row mod 16), and the funnel's overrun
  const int smem = 128 + 2 * kWarps * p.slot;
  int current = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&current);
  // the probe runs on the current card only
  if (err == cudaSuccess && current != device) return static_cast<int>(cudaErrorInvalidDevice);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(a4_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((hp + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp), planes);
  a4_ring_kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
