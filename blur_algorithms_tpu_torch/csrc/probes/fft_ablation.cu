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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#define FFT4STEP_KERNELS_ONLY
#include "../fft4step.cu"

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

}  // namespace

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
