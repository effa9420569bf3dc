// Spectral multiply (K5): a complex64 spectrum times a separable real
// kernel spectrum, out[b, i, j] = spec[b, i, j] * (col[i] * row[j] * scale).
//
// Replaces: blur_algorithms_tpu/pallas_kernels/spectral_multiply.py:_kernel,
// which multiplies the spectrum, bitcast to interleaved (re, im) float32
// pairs because Mosaic has no complex type, by col (x) row in one VMEM pass
// so that the outer product never reaches device memory. Here the complex64
// tensor is read in place as float2 pairs (what torch.view_as_real shows):
// no re/im marshalling copy. One thread per complex value, a grid-stride
// loop; the factor is rounded as the plain version computes it (the f32
// products col[i] * row[j] and then * scale, then the spectrum times that
// real value), so the two agree bit for bit.
//
// What bounds it on an H100: device memory, 8 bytes read and 8 written per
// complex value; col and row stay in L1/L2. The loads and stores are 8-byte
// float2 accesses, neighbouring threads on neighbouring values.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
spectral_multiply_kernel(const float2* __restrict__ spec,
                         float2* __restrict__ out,
                         const float* __restrict__ col,
                         const float* __restrict__ row, float scale, int h,
                         int wf, int64_t total) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < total; k += step) {
    const int j = static_cast<int>(k % wf);
    const int i = static_cast<int>((k / wf) % h);
    const float s = __fmul_rn(__fmul_rn(__ldg(col + i), __ldg(row + j)), scale);
    const float2 v = spec[k];
    out[k] = make_float2(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
  }
}

}  // namespace

// spec, out: planes x h x wf complex64 (interleaved float pairs); col: h
// floats; row: wf floats. Returns the cudaError_t of the launch.
extern "C" int spectral_multiply_2d(const void* spec, void* out,
                                    const void* col, const void* row,
                                    float scale, int planes, int h, int wf,
                                    void* stream) {
  if (planes < 0 || h < 1 || wf < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(planes) * h * wf;
  if (total == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  if (blocks > cap) blocks = cap;
  spectral_multiply_kernel<<<static_cast<int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), static_cast<float2*>(out),
      static_cast<const float*>(col), static_cast<const float*>(row), scale,
      h, wf, total);
  return static_cast<int>(cudaGetLastError());
}
