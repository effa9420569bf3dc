// Spectral multiply (K5): a complex64 spectrum times a separable real
// kernel spectrum, out[b, i, j] = spec[b, i, j] * (col[i] * row[j] * scale).
//
// Replaces: blur_algorithms_tpu/pallas_kernels/spectral_multiply.py:_kernel,
// which multiplies the spectrum, bitcast to interleaved (re, im) float32
// pairs because Mosaic has no complex type, by col (x) row in one VMEM pass
// so that the outer product never reaches device memory. Here the complex64
// tensor is read in place as interleaved float pairs (what
// torch.view_as_real shows): no re/im marshalling copy. The factor is
// rounded as the plain version computes it (the f32 products col[i] *
// row[j] and then * scale, then the spectrum times that real value), so the
// two agree bit for bit.
//
// What bounds it on an H100: device memory, 8 bytes read and 8 written per
// complex value; col and row (a few KB) stay in L1/L2. The design keeps the
// instructions per byte low so that the loads and stores are the limit:
//   - the plane is blockIdx.y (a grid-stride loop past 65535 planes) and the
//     in-plane index is 32-bit: one 32-bit division by wf per pair of
//     values gives (i, j), and the pair's second value is (i, j + 1) or,
//     where the pair straddles a row end, (i + 1, 0);
//   - one thread moves two complex values with one 16-byte load and one
//     16-byte store, neighbouring threads on neighbouring pairs, with
//     streaming cache hints (__ldcs / __stcs: the spectrum is touched once);
//   - a plane whose first value is not 16-byte aligned (odd h * wf, or an
//     odd base) starts with one scalar head value, and one whose count after
//     the head is odd ends with one scalar tail value; block 0 of the plane
//     does both (tests/test_torch_fft4step_passes.py models the split and
//     checks that it covers every value once).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float factor(const float* __restrict__ col,
                                        const float* __restrict__ row,
                                        float scale, int i, int j) {
  return __fmul_rn(__fmul_rn(__ldg(col + i), __ldg(row + j)), scale);
}

__device__ __forceinline__ float2 scaled(float2 v, float s) {
  return make_float2(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
}

// odd_base: 1 where the tensor's first value is 8 (not 16) bytes past a
// 16-byte boundary; out has the same offset.
__global__ void __launch_bounds__(kThreads)
spectral_multiply_kernel(const float2* __restrict__ spec,
                         float2* __restrict__ out,
                         const float* __restrict__ col,
                         const float* __restrict__ row, float scale,
                         int planes, int h, int wf, int odd_base) {
  const unsigned m = static_cast<unsigned>(h) * static_cast<unsigned>(wf);
  const unsigned uwf = static_cast<unsigned>(wf);
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const size_t off = static_cast<size_t>(p) * m;
    const unsigned head = (static_cast<unsigned>(odd_base) + static_cast<unsigned>(off & 1)) & 1u;
    const unsigned pairs = (m - head) >> 1;
    const float2* s = spec + off;
    float2* o = out + off;
    const unsigned k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k < pairs) {
      const unsigned e = head + 2 * k;
      const unsigned i = e / uwf;
      const unsigned j = e - i * uwf;
      const float4 v = __ldcs(reinterpret_cast<const float4*>(s + head) + k);
      const float s0 = factor(col, row, scale, i, j);
      const float s1 = j + 1 < uwf ? factor(col, row, scale, i, j + 1)
                                   : factor(col, row, scale, i + 1, 0);
      __stcs(reinterpret_cast<float4*>(o + head) + k,
             make_float4(__fmul_rn(v.x, s0), __fmul_rn(v.y, s0),
                         __fmul_rn(v.z, s1), __fmul_rn(v.w, s1)));
    }
    if (blockIdx.x == 0 && threadIdx.x < 2) {
      // thread 0: the head value (index 0); thread 1: the tail (index m - 1)
      const bool has = threadIdx.x == 0 ? head == 1u : ((m - head) & 1u) == 1u;
      if (has) {
        const unsigned e = threadIdx.x == 0 ? 0u : m - 1;
        const unsigned i = e / uwf;
        o[e] = scaled(s[e], factor(col, row, scale, i, e - i * uwf));
      }
    }
  }
}

}  // namespace

// spec, out: planes x h x wf complex64 (interleaved float pairs), out at the
// same offset from a 16-byte boundary as spec; col: h floats; row: wf
// floats; grid_x x grid_y blocks of 256 threads (the wrapper's
// launch_geometry: grid_x * 256 >= h * wf / 2, grid_y = min(planes, 65535)).
// Returns the cudaError_t of the launch.
extern "C" int spectral_multiply_2d(const void* spec, void* out,
                                    const void* col, const void* row,
                                    float scale, int planes, int h, int wf,
                                    int grid_x, int grid_y, void* stream) {
  if (planes < 1 || h < 1 || wf < 1 || grid_x < 1 || grid_y < 1 ||
      grid_y > 65535 || static_cast<int64_t>(h) * wf >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t a = reinterpret_cast<uintptr_t>(spec);
  const uintptr_t b = reinterpret_cast<uintptr_t>(out);
  if (a % 8 || a % 16 != b % 16) return static_cast<int>(cudaErrorInvalidValue);
  spectral_multiply_kernel<<<dim3(grid_x, grid_y), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<float2*>(out),
      static_cast<const float*>(col), static_cast<const float*>(row), scale,
      planes, h, wf, static_cast<int>((a / 8) & 1));
  return static_cast<int>(cudaGetLastError());
}
