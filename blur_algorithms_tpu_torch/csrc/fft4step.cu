// Four-step FFT convolution of rows (K3 and K3f): f32 rows in, f32 rows out.
//
// Replaces: blur_algorithms_tpu/pallas_kernels/fft4step.py:_kernel (K3, rows
// already framed to the transform length n) and :_kernel_framed (K3f,
// unpadded rows of length dim, framed inside the kernel). Both compute, per
// pair of real rows (a, b), the circular correlation
//     y = IFFT(H . FFT(z)),  z = a + i b,  Re y -> row a, Im y -> row b,
// where H is the host-built correlation spectrum conj(fft(wrap_centered(
// taps, n))): real for symmetric taps, complex otherwise. The kernel is real
// in space, so the two packed rows separate by linearity either way. K3f
// frames row t of the transform as reflect-101 of the row over [0, pad),
// the row over [pad, pad + dim), reflect-101 again up to 2 pad + dim, then
// zeros to n, and stores the interior [pad, pad + dim). K3 is the same
// entry with dim = n and pad = 0, which makes the framing the identity.
//
// The TPU kernel factors n = n1 * n2 and runs each DFT stage as a dense
// matmul on the MXU (bf16x3 splits). Here one block of threads holds one
// complex row in shared memory (re and im planes, 8 n bytes: 128 KB at
// n = 16384, past the 48 KB default, so the launch raises the dynamic
// limit) and runs a mixed-radix FFT on the CUDA cores in f32:
//   n = Q * P, Q the odd part (1, 3, 5, ..., 15: transform_length plans
//   128 * (multiple of 8) past 4096) and P a power of two;
//   forward: decimation in frequency, in place: one radix-Q stage (a dense
//   Q-point DFT against a table of Q roots of unity), then radix-4 stages,
//   then one radix-2 stage when log2 P is odd. Each stage reads R values
//   a stride apart, takes their R-point DFT, multiplies by the twiddles
//   W_L^(q j) and writes them back to the same places, so one barrier per
//   stage suffices and no second buffer is needed. The spectrum is left in
//   digit-reversed order; the host stores H in that same order
//   (cuda_kernels/fft4step.py:_kernel_bin_order), so nothing is reordered;
//   multiply: H, with 1/n folded in on the host, fused into the first
//   inverse stage's loads;
//   inverse: decimation in time, the forward stages in reverse order, each
//   with conjugate twiddles before a conjugate R-point DFT. It reads the
//   digit-reversed spectrum and leaves the row in natural order.
// Twiddles are one table W_n^x = exp(-2 pi i x / n), x < n, computed on the
// host in float64 and rounded to f32 (as ops/fft_mxu._stage_consts builds
// the TPU's DFT matrices); a stage of span L reads W_L^(q j) = W_n^(q j n/L).
//
// What bounds it on an H100: device memory. At the main shapes (rows of 4K
// frames, n 4096 to 16384) the traffic is one read and one write of the
// rows, and the FFT's f32 work, ~5 n log2 n flops per direction per
// complex row, takes less time at the card's f32 rate (chip_smoke.py
// prints both bounds, PERF.md the measured times). The design spends
// more: every stage reads and writes each value in shared memory once (8
// to 14 stages a row), the late radix-4 stages have 2- to 4-way bank
// conflicts, every twiddle is a load through L1, and a row takes up to 15
// barriers; at n 16384 one 128 KB block fills an SM. The column axis is
// made contiguous by a transpose before the kernel (as the JAX package
// moves the axis last). Tensor cores (the dense stages as wgmma), TMA
// staging and reading columns in place are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxN = 16384;

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

// In-place R-point DFT of a[0..R): forward (W_R = exp(-2 pi i / R)) or
// inverse (conjugate roots, no 1/R). wq holds W_Q^k for the odd radix.
template <int R, bool kInv>
__device__ __forceinline__ void dft(float2 (&a)[R], const float2* wq) {
  if constexpr (R == 2) {
    const float2 t = a[1];
    a[1] = csub(a[0], t);
    a[0] = cadd(a[0], t);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(a[0], a[2]), t1 = csub(a[0], a[2]);
    const float2 t2 = cadd(a[1], a[3]), t3 = csub(a[1], a[3]);
    a[0] = cadd(t0, t2);
    a[2] = csub(t0, t2);
    // -i t3 = (t3.y, -t3.x); the inverse takes +i t3
    const float2 m = kInv ? make_float2(-t3.y, t3.x) : make_float2(t3.y, -t3.x);
    a[1] = cadd(t1, m);
    a[3] = csub(t1, m);
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

// One decimation-in-frequency stage of radix R over blocks of span
// L = R << lshift: x[base + q s] <- W_L^(q j) * sum_m x[base + m s] W_R^(m q)
// with s = L / R, j = the offset in the block, base = block * L + j.
template <int R>
__device__ __forceinline__ void dif_stage(float* re, float* im, int n,
                                          int lshift, int tw_step,
                                          const float2* __restrict__ tw,
                                          const float2* wq) {
  const int stride = 1 << lshift;
  for (int idx = threadIdx.x; idx < n / R; idx += blockDim.x) {
    const int j = idx & (stride - 1);
    const int base = (((idx >> lshift) * R) << lshift) + j;
    float2 a[R];
#pragma unroll
    for (int m = 0; m < R; ++m)
      a[m] = make_float2(re[base + m * stride], im[base + m * stride]);
    dft<R, false>(a, wq);
#pragma unroll
    for (int q = 1; q < R; ++q) a[q] = cmul(a[q], __ldg(tw + q * j * tw_step));
#pragma unroll
    for (int q = 0; q < R; ++q) {
      re[base + q * stride] = a[q].x;
      im[base + q * stride] = a[q].y;
    }
  }
  __syncthreads();
}

// The inverse of dif_stage (times R): conjugate twiddles, then the
// conjugate R-point DFT. The first inverse stage also multiplies by the
// spectrum h (n reals, or n interleaved complex values).
template <int R>
__device__ __forceinline__ void dit_stage(float* re, float* im, int n,
                                          int lshift, int tw_step,
                                          const float2* __restrict__ tw,
                                          const float2* wq,
                                          const float* __restrict__ h,
                                          bool complex_h) {
  const int stride = 1 << lshift;
  for (int idx = threadIdx.x; idx < n / R; idx += blockDim.x) {
    const int j = idx & (stride - 1);
    const int base = (((idx >> lshift) * R) << lshift) + j;
    float2 a[R];
#pragma unroll
    for (int m = 0; m < R; ++m)
      a[m] = make_float2(re[base + m * stride], im[base + m * stride]);
    if (h != nullptr) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int p = base + m * stride;
        if (complex_h) {
          a[m] = cmul(a[m], __ldg(reinterpret_cast<const float2*>(h) + p));
        } else {
          const float s = __ldg(h + p);
          a[m] = make_float2(a[m].x * s, a[m].y * s);
        }
      }
    }
#pragma unroll
    for (int q = 1; q < R; ++q) a[q] = cmulc(a[q], __ldg(tw + q * j * tw_step));
    dft<R, true>(a, wq);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      re[base + m * stride] = a[m].x;
      im[base + m * stride] = a[m].y;
    }
  }
  __syncthreads();
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

// One block per complex row c: real rows c and c + half (a zero row rides
// along where c + half == rows). Rows in and out have length dim.
template <int Q>
__global__ void __launch_bounds__(kMaxThreads)
fft_conv_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                     const float2* __restrict__ tw,
                     const float* __restrict__ h, int complex_h, int rows,
                     int half, int n, int p_log2, int dim, int pad) {
  extern __shared__ __align__(16) float smem[];
  float* re = smem;
  float* im = smem + n;
  float2* wq = reinterpret_cast<float2*>(smem + 2 * n);  // W_Q^k, k < Q

  const int ra = blockIdx.x;
  const int rb = blockIdx.x + half;
  const bool has_b = rb < rows;
  const float* xa = x + static_cast<size_t>(ra) * dim;
  const float* xb = x + static_cast<size_t>(rb) * dim;
  if (Q > 1) {
    for (int k = threadIdx.x; k < Q; k += blockDim.x) wq[k] = tw[k << p_log2];
  }
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int s = frame_source(t, dim, pad);
    re[t] = s >= 0 ? xa[s] : 0.0f;
    im[t] = s >= 0 && has_b ? xb[s] : 0.0f;
  }
  __syncthreads();

  // forward: radix Q, radix 4 over spans P, P/4, ..., then radix 2
  if constexpr (Q > 1) dif_stage<Q>(re, im, n, p_log2, 1, tw, wq);
  for (int lg = p_log2; lg >= 2; lg -= 2)
    dif_stage<4>(re, im, n, lg - 2, n >> lg, tw, wq);
  if (p_log2 & 1) dif_stage<2>(re, im, n, 0, n >> 1, tw, wq);

  // inverse, in reverse order; the first stage multiplies by H
  const float* hm = h;
  if (p_log2 & 1) {
    dit_stage<2>(re, im, n, 0, n >> 1, tw, wq, hm, complex_h);
    hm = nullptr;
  }
  for (int lg = 2 + (p_log2 & 1); lg <= p_log2; lg += 2) {
    dit_stage<4>(re, im, n, lg - 2, n >> lg, tw, wq, hm, complex_h);
    hm = nullptr;
  }
  if constexpr (Q > 1) dit_stage<Q>(re, im, n, p_log2, 1, tw, wq, nullptr, 0);

  float* oa = out + static_cast<size_t>(ra) * dim;
  float* ob = out + static_cast<size_t>(rb) * dim;
  for (int j = threadIdx.x; j < dim; j += blockDim.x) {
    oa[j] = re[pad + j];
    if (has_b) ob[j] = im[pad + j];
  }
}

template <int Q>
int launch_q(const float* x, float* out, const float2* tw, const float* h,
             int complex_h, int rows, int n, int p_log2, int dim, int pad,
             cudaStream_t stream) {
  const int smem = 8 * n + 16 * 8;
  auto kernel = fft_conv_rows_kernel<Q>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int half = (rows + 1) / 2;
  int threads = n / 4 < kMaxThreads ? n / 4 : kMaxThreads;
  kernel<<<half, threads, smem, stream>>>(x, out, tw, h, complex_h, rows,
                                          half, n, p_log2, dim, pad);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, void* out, const void* tw, const void* h,
           int complex_h, int rows, int n, int dim, int pad,
           cudaStream_t stream) {
  int q = n, p_log2 = 0;
  while (q > 1 && (q & 1) == 0) {
    q >>= 1;
    ++p_log2;
  }
  if (n > kMaxN || n < 256 || p_log2 < 8 || rows < 1 || dim < 1 ||
      pad < 0 || pad > dim - 1 || dim + 2 * pad > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  const float2* t = static_cast<const float2*>(tw);
  const float* hs = static_cast<const float*>(h);
  switch (q) {
    case 1: return launch_q<1>(xs, os, t, hs, complex_h, rows, n, p_log2, dim, pad, stream);
    case 3: return launch_q<3>(xs, os, t, hs, complex_h, rows, n, p_log2, dim, pad, stream);
    case 5: return launch_q<5>(xs, os, t, hs, complex_h, rows, n, p_log2, dim, pad, stream);
    case 7: return launch_q<7>(xs, os, t, hs, complex_h, rows, n, p_log2, dim, pad, stream);
    case 9: return launch_q<9>(xs, os, t, hs, complex_h, rows, n, p_log2, dim, pad, stream);
    case 11: return launch_q<11>(xs, os, t, hs, complex_h, rows, n, p_log2, dim, pad, stream);
    case 13: return launch_q<13>(xs, os, t, hs, complex_h, rows, n, p_log2, dim, pad, stream);
    case 15: return launch_q<15>(xs, os, t, hs, complex_h, rows, n, p_log2, dim, pad, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K3: rows x n floats already framed to the transform length -> rows x n.
// tw: n interleaved complex twiddles W_n^x; h: the spectrum in the kernel's
// bin order, scaled by 1/n (n floats, or 2n interleaved when complex_h).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int fft_conv_rows(const void* x, void* out, const void* tw,
                             const void* h, int complex_h, int rows, int n,
                             void* stream) {
  return launch(x, out, tw, h, complex_h, rows, n, n, 0,
                static_cast<cudaStream_t>(stream));
}

// K3f: rows x dim unpadded floats -> rows x dim, framed in the kernel with
// a reflect-101 pad of pad <= dim - 1 and zeros up to n.
extern "C" int fft_conv_rows_framed(const void* x, void* out, const void* tw,
                                    const void* h, int complex_h, int rows,
                                    int n, int dim, int pad, void* stream) {
  return launch(x, out, tw, h, complex_h, rows, n, dim, pad,
                static_cast<cudaStream_t>(stream));
}
