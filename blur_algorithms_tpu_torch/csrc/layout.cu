// Layout moves of uint8 RGB frames: interleaved (..., H, W, 3) -> planar
// (..., 3, H, W) (layout_to_planar_u8) and back (layout_from_planar_u8).
//
// Replaces no TPU kernel. The JAX package's ops/layout.py moves the channel
// axis with jnp.moveaxis, an XLA transpose. The port did the same move as
// movedim(...).contiguous(), which PyTorch runs as its generic strided
// elementwise kernel at one byte a thread: 0.85-1.08 TB/s on an H100, about
// half of blur_u8's card time on 32 RGB 4K frames at sigma 10 (the two
// moves around K1). Added so that every uint8 route moves those bytes at
// the card's bandwidth; the result is the same bytes in the same places.
//
// What bounds it on an H100: device memory alone, with no arithmetic. A move
// reads 3P bytes and writes 3P bytes an image of P = H * W pixels: 0.475 ms
// for 32 4K frames (796,262,400 bytes each way) and 0.623 ms for the
// 24000x14500 photo (1,044,000,000) at 3.35 TB/s. The design keeps the
// instructions per byte low and the accesses 16 bytes wide:
//   - in the vector body an image is one flat run of P pixels: pixel p's
//     channel c is byte 3p + c of the interleaved image and byte cP + p of
//     the planar one, so rows do not matter; blockIdx.y walks the images (a
//     grid-stride loop past 65535), and every offset is 64-bit (a batch
//     passes 2^31 bytes);
//   - the vector body: a thread moves one group of 16 pixels, 48 bytes, and
//     rearranges them in registers with 24 __byte_perm (two a 4-byte word);
//     to_planar turns the 48 interleaved bytes into one 16-byte word a
//     channel, from_planar the reverse; neighbouring threads take
//     neighbouring groups, so each plane's 16-byte accesses are coalesced
//     across the warp; the interleaved side goes through shared memory: a
//     block's 256 groups (12 KB) are loaded or stored as consecutive 16-byte
//     words, and each thread reads or writes its three words at a 48-byte
//     stride there, which puts the 8 threads of each 128-byte phase on
//     distinct banks (probes/layout_variants.py on an H100: 2.94 and 2.97
//     TB/s on 32 4K frames, a copy_ of the same bytes 3.00-3.01; the same
//     body with the interleaved side's accesses made directly, 48 bytes
//     apart, 2.96 and 2.16); streaming hints (__ldcs / __stcs): the frames
//     are touched once and are far larger than the 50 MB L2;
//   - the body takes whole runs alone: frames whose P pixels each lie in one
//     run of 3P bytes (no gap between rows, the channels interleaved or
//     planar as the move reads them), P a multiple of 16, and bases and the
//     step between frames on 16-byte boundaries; torch.empty gives the
//     output that. The package's frames take it: contiguous, P = 2160 x 3840
//     or 14500 x 24000;
//   - every other input (a crop, a view with other strides, a base off a
//     16-byte boundary, P not a multiple of 16) takes the strided path: the
//     input addressed by its strides in bytes (frame, row, pixel, channel;
//     up to kMaxLead leading dims, the wrapper merging what one stride
//     steps over and splitting the launch past that), a block a stretch of
//     one row, a thread up to 8 (to_planar) or 4 (from_planar) pixels of it
//     256 apart, three bytes each way, all its loads before its stores:
//     loads and stores coalesced by the byte (at 16 pixels a thread 1.82-1.83
//     TB/s on 2080x3640 crops of 4 4K frames on an H100, the torch expression
//     0.80; a loop that stored each pixel before the next load, 1.14-1.20).
//   tests/test_torch_layout.py models both paths (the selectors, the groups,
//   the strided addressing, the grids) and checks that they write every
//   byte once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC --fmad=false   (blur_algorithms_tpu_torch/utils/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLead = 4;  // leading dims the strided path addresses
// most pixels a thread on the strided path: to_planar 8, from_planar 4 (on
// an H100, 2080x3640 crops of 4 4K frames: 0.083-0.092 and 0.093 ms, against
// 0.100 and 0.099 at 16)
template <bool kToPlanar>
constexpr int kPixelsOf = kToPlanar ? 8 : 4;
constexpr int kMaxGridY = 65535;

// the input's frames as the strided path addresses them, in bytes: frame n
// (its leading indices, innermost last) at sum(index * lead_stride), then
// row y, pixel x, channel c at y * row + x * pixel + c * channel
struct Frames {
  int64_t lead_size[kMaxLead];
  int64_t lead_stride[kMaxLead];
  int nlead;
  int64_t h, w, row, pixel, channel;
};

// to_planar: channel kC's 4-byte word of 4 pixels from the 12 interleaved
// bytes (x, y, z) that hold them, two __byte_perm a word
template <int kC>
__device__ __forceinline__ unsigned channel(unsigned x, unsigned y, unsigned z) {
  if constexpr (kC == 0)
    return __byte_perm(__byte_perm(x, y, 0x0630), z, 0x5210);  // bytes 0, 3, 6, 9
  else if constexpr (kC == 1)
    return __byte_perm(__byte_perm(x, y, 0x0741), z, 0x6210);  // bytes 1, 4, 7, 10
  else
    return __byte_perm(__byte_perm(x, y, 0x0052), z, 0x7410);  // bytes 2, 5, 8, 11
}

// channel kC's 16 bytes of the 16 pixels in the interleaved words a, b, c
template <int kC>
__device__ __forceinline__ uint4 channel_word(uint4 a, uint4 b, uint4 c) {
  return make_uint4(channel<kC>(a.x, a.y, a.z), channel<kC>(a.w, b.x, b.y),
                    channel<kC>(b.z, b.w, c.x), channel<kC>(c.y, c.z, c.w));
}

// from_planar: the 12 interleaved bytes (x, y, z) of the 4 pixels whose
// channel words are r, g, b
__device__ __forceinline__ void interleave(unsigned r, unsigned g, unsigned b, unsigned& x,
                                           unsigned& y, unsigned& z) {
  x = __byte_perm(__byte_perm(r, g, 0x1040), b, 0x3410);  // r0 g0 b0 r1
  y = __byte_perm(__byte_perm(g, r, 0x2601), b, 0x3250);  // g1 b1 r2 g2
  z = __byte_perm(__byte_perm(r, g, 0x0730), b, 0x7216);  // b2 r3 g3 b3
}

// the vector body: image n's 3P bytes at in + n * step and out + n * 3P,
// groups of 16 pixels, a thread a group, the block's 256 groups'
// interleaved bytes staged in shared memory
template <bool kToPlanar>
__global__ void __launch_bounds__(kThreads)
layout_u8_groups_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                        int64_t images, int64_t step, int64_t pixels) {
  __shared__ uint4 stage[3 * kThreads];
  const int64_t groups = pixels >> 4;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kThreads;  // the block's first group
  const int nb = static_cast<int>(groups - g0 < kThreads ? groups - g0 : kThreads);
  const int t = threadIdx.x;
  const int64_t p0 = 16 * g0;  // the block's first pixel
  const int64_t p = p0 + 16 * t;  // this thread's group
  for (int64_t n = blockIdx.y; n < images; n += gridDim.y) {
    const uint8_t* src = in + n * step;
    uint8_t* dst = out + n * 3 * pixels;
    if (kToPlanar) {
      const uint4* s = reinterpret_cast<const uint4*>(src + 3 * p0);
      for (int k = t; k < 3 * nb; k += kThreads) stage[k] = __ldcs(s + k);
      __syncthreads();
      if (t < nb) {
        const uint4 a = stage[3 * t], b = stage[3 * t + 1], c = stage[3 * t + 2];
        __stcs(reinterpret_cast<uint4*>(dst + p), channel_word<0>(a, b, c));
        __stcs(reinterpret_cast<uint4*>(dst + pixels + p), channel_word<1>(a, b, c));
        __stcs(reinterpret_cast<uint4*>(dst + 2 * pixels + p), channel_word<2>(a, b, c));
      }
    } else {
      if (t < nb) {
        const uint4 r = __ldcs(reinterpret_cast<const uint4*>(src + p));
        const uint4 gr = __ldcs(reinterpret_cast<const uint4*>(src + pixels + p));
        const uint4 b = __ldcs(reinterpret_cast<const uint4*>(src + 2 * pixels + p));
        uint4 w[3];
        interleave(r.x, gr.x, b.x, w[0].x, w[0].y, w[0].z);
        interleave(r.y, gr.y, b.y, w[0].w, w[1].x, w[1].y);
        interleave(r.z, gr.z, b.z, w[1].z, w[1].w, w[2].x);
        interleave(r.w, gr.w, b.w, w[2].y, w[2].z, w[2].w);
        stage[3 * t] = w[0];
        stage[3 * t + 1] = w[1];
        stage[3 * t + 2] = w[2];
      }
      __syncthreads();
      uint4* d = reinterpret_cast<uint4*>(dst + 3 * p0);
      for (int k = t; k < 3 * nb; k += kThreads) __stcs(d + k, stage[k]);
    }
    __syncthreads();  // the stage serves the next image
  }
}

// the strided path: block b is stretch b % chunks of row b / chunks of all
// frames' rows; its thread t moves pixels x0 + 256 i + t of the row,
// i < per_thread <= kPixels, into the contiguous output, all its loads
// before its stores
template <bool kToPlanar, int kPixels = kPixelsOf<kToPlanar>>
__global__ void __launch_bounds__(kThreads)
layout_u8_strided_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                         const Frames f, int64_t rows, int64_t chunks, int per_thread) {
  const int64_t pixels = f.h * f.w;
  for (int64_t b = blockIdx.x; b < rows * chunks; b += gridDim.x) {
    const int64_t r = b / chunks;
    const int64_t x0 = (b - r * chunks) * per_thread * kThreads + threadIdx.x;
    const int64_t n = r / f.h, y = r - n * f.h;
    const uint8_t* src = in + y * f.row;
    int64_t m = n;  // frame n's leading indices, innermost first
#pragma unroll
    for (int k = kMaxLead - 1; k >= 0; --k) {
      if (k < f.nlead) {
        const int64_t q = m / f.lead_size[k];
        src += (m - q * f.lead_size[k]) * f.lead_stride[k];
        m = q;
      }
    }
    uint8_t v[kPixels][3];
#pragma unroll
    for (int i = 0; i < kPixels; ++i) {
      const int64_t x = x0 + i * kThreads;
      if (i < per_thread && x < f.w) {
        const uint8_t* s = src + x * f.pixel;
        v[i][0] = s[0];
        v[i][1] = s[f.channel];
        v[i][2] = s[2 * f.channel];
      }
    }
    uint8_t* dst = out + n * 3 * pixels + y * f.w * (kToPlanar ? 1 : 3);
#pragma unroll
    for (int i = 0; i < kPixels; ++i) {
      const int64_t x = x0 + i * kThreads;
      if (i < per_thread && x < f.w) {
        if (kToPlanar) {
          dst[x] = v[i][0];
          dst[pixels + x] = v[i][1];
          dst[2 * pixels + x] = v[i][2];
        } else {
          dst[3 * x] = v[i][0];
          dst[3 * x + 1] = v[i][1];
          dst[3 * x + 2] = v[i][2];
        }
      }
    }
  }
}

template <bool kToPlanar>
int launch(const void* in, void* out, const Frames& f, int device, void* stream) {
  if (f.h < 1 || f.w < 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t images = 1;
  for (int k = 0; k < f.nlead; ++k) {
    if (f.lead_size[k] < 1) return static_cast<int>(cudaErrorInvalidValue);
    images *= f.lead_size[k];
  }
  const int64_t pixels = f.h * f.w;
  // the body: each frame one run of 3P bytes, 16-byte aligned with its step
  const int64_t step = f.nlead == 1 ? f.lead_stride[0] : 3 * pixels;
  const bool run = f.h == 1 && (kToPlanar ? f.pixel == 3 && f.channel == 1
                                          : f.pixel == 1 && f.channel == pixels);
  const bool groups = run && f.nlead <= 1 && pixels % 16 == 0 && step % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  constexpr int most = kPixelsOf<kToPlanar>;
  const int per_thread = static_cast<int>(
      (f.w + kThreads - 1) / kThreads < most ? (f.w + kThreads - 1) / kThreads : most);
  const int64_t chunks = (f.w + per_thread * kThreads - 1) / (per_thread * kThreads);
  const int64_t blocks = groups ? ((pixels >> 4) + kThreads - 1) / kThreads : images * f.h * chunks;
  if (groups && blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(in);
  uint8_t* y = static_cast<uint8_t*>(out);
  if (groups) {
    const dim3 grid(static_cast<unsigned>(blocks),
                    static_cast<unsigned>(images < kMaxGridY ? images : kMaxGridY));
    layout_u8_groups_kernel<kToPlanar><<<grid, kThreads, 0, s>>>(x, y, images, step, pixels);
  } else {
    const unsigned grid = static_cast<unsigned>(blocks < 0x7fffffff ? blocks : 0x7fffffff);
    layout_u8_strided_kernel<kToPlanar><<<grid, kThreads, 0, s>>>(x, y, f, images * f.h, chunks,
                                                                 per_thread);
  }
  err = cudaGetLastError();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// dims: the leading dims' nlead sizes, then their nlead strides, then h, w
// and the row, pixel and channel strides
Frames frames(int nlead, const int64_t* dims) {
  Frames f{};
  f.nlead = nlead;
  for (int k = 0; k < nlead && k < kMaxLead; ++k) {
    f.lead_size[k] = dims[k];
    f.lead_stride[k] = dims[nlead + k];
  }
  const int64_t* frame = dims + 2 * nlead;
  f.h = frame[0];
  f.w = frame[1];
  f.row = frame[2];
  f.pixel = frame[3];
  f.channel = frame[4];
  return f;
}

}  // namespace

// in: the interleaved frames (..., H, W, 3) as `dims` describes them (see
// frames(): nlead leading dims, at most kMaxLead, then a frame's h rows of
// w pixels; strides in bytes); out: contiguous planar (..., 3, h, w), on
// card `device`, on `stream`. Returns the cudaError_t of the launch.
extern "C" int layout_to_planar_u8(const void* in, void* out, int nlead, const int64_t* dims,
                                   int device, void* stream) {
  if (nlead < 0 || nlead > kMaxLead) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(in, out, frames(nlead, dims), device, stream);
}

// in: the planar frames (..., 3, H, W), described as above (channel: the
// step between planes); out: contiguous interleaved (..., h, w, 3).
extern "C" int layout_from_planar_u8(const void* in, void* out, int nlead, const int64_t* dims,
                                     int device, void* stream) {
  if (nlead < 0 || nlead > kMaxLead) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(in, out, frames(nlead, dims), device, stream);
}
