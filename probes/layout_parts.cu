// Variants of the uint8 layout moves' vector body (csrc/layout.cu), for
// probes/layout_variants.py.
//
// Compiled after csrc/layout.cu in one translation unit: the probe writes a
// two-line file that includes both, and builds it with the package's nvcc
// flags, so the variants share the source's byte permutes. Every variant
// takes the body's case alone (contiguous frames, P a multiple of 16, both
// bases on a 16-byte boundary) and moves the same bytes as the
// source's kernel, whose interleaved side goes through shared memory; here
// every access is made directly, the interleaved side's three 16-byte
// accesses a thread 48 bytes apart across the warp:
//   0 a thread a group of 16 pixels, streaming hints;
//   1, 2 two and four groups a thread (loads of all its groups first);
//   3 one group a thread with plain loads and stores (no streaming hints).
// layout_parts returns the cudaError_t of its launch. layout_strided_parts
// launches the source's strided path with at most 4, 8 or 16 pixels a
// thread (the source takes 8 to planar, 4 back), to weigh bytes in flight
// against blocks.

namespace {

template <bool kStream>
__device__ __forceinline__ uint4 ld16(const uint4* p) {
  if constexpr (kStream) return __ldcs(p);
  else return *p;
}

template <bool kStream>
__device__ __forceinline__ void st16(uint4* p, uint4 v) {
  if constexpr (kStream) __stcs(p, v);
  else *p = v;
}

template <bool kToPlanar>
__device__ __forceinline__ void permute(const uint4 (&v)[3], uint4 (&w)[3]) {
  if constexpr (kToPlanar) {
    w[0] = channel_word<0>(v[0], v[1], v[2]);
    w[1] = channel_word<1>(v[0], v[1], v[2]);
    w[2] = channel_word<2>(v[0], v[1], v[2]);
  } else {
    interleave(v[0].x, v[1].x, v[2].x, w[0].x, w[0].y, w[0].z);
    interleave(v[0].y, v[1].y, v[2].y, w[0].w, w[1].x, w[1].y);
    interleave(v[0].z, v[1].z, v[2].z, w[1].z, w[1].w, w[2].x);
    interleave(v[0].w, v[1].w, v[2].w, w[2].y, w[2].z, w[2].w);
  }
}

// the 16-byte words of group g: interleaved at src/dst + 48 g, planes at + 16 g
template <bool kToPlanar, bool kStream>
__device__ __forceinline__ void load_group(const uint8_t* src, int64_t pixels, int64_t g,
                                           uint4 (&v)[3]) {
  if constexpr (kToPlanar) {
    const uint4* s = reinterpret_cast<const uint4*>(src + 48 * g);
    v[0] = ld16<kStream>(s);
    v[1] = ld16<kStream>(s + 1);
    v[2] = ld16<kStream>(s + 2);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c] = ld16<kStream>(reinterpret_cast<const uint4*>(src + c * pixels + 16 * g));
  }
}

template <bool kToPlanar, bool kStream>
__device__ __forceinline__ void store_group(uint8_t* dst, int64_t pixels, int64_t g,
                                            const uint4 (&w)[3]) {
  if constexpr (kToPlanar) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      st16<kStream>(reinterpret_cast<uint4*>(dst + c * pixels + 16 * g), w[c]);
  } else {
    uint4* d = reinterpret_cast<uint4*>(dst + 48 * g);
    st16<kStream>(d, w[0]);
    st16<kStream>(d + 1, w[1]);
    st16<kStream>(d + 2, w[2]);
  }
}

template <bool kToPlanar, int kG, bool kStream>
__global__ void __launch_bounds__(kThreads)
parts_direct_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int64_t images,
                    int64_t pixels) {
  const int64_t groups = pixels >> 4;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kG + threadIdx.x;
  for (int64_t n = blockIdx.y; n < images; n += gridDim.y) {
    const uint8_t* src = in + n * 3 * pixels;
    uint8_t* dst = out + n * 3 * pixels;
    uint4 v[kG][3];
#pragma unroll
    for (int i = 0; i < kG; ++i)
      if (base + i * kThreads < groups)
        load_group<kToPlanar, kStream>(src, pixels, base + i * kThreads, v[i]);
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (base + i * kThreads < groups) {
        uint4 w[3];
        permute<kToPlanar>(v[i], w);
        store_group<kToPlanar, kStream>(dst, pixels, base + i * kThreads, w);
      }
    }
  }
}

template <bool kToPlanar>
int parts_launch(int variant, const uint8_t* in, uint8_t* out, int64_t images, int64_t pixels,
                 cudaStream_t s) {
  const int g = variant == 1 ? 2 : variant == 2 ? 4 : 1;
  const int64_t blocks = ((pixels >> 4) + kThreads * g - 1) / (kThreads * g);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(images < kMaxGridY ? images : kMaxGridY));
  switch (variant) {
    case 0: parts_direct_kernel<kToPlanar, 1, true><<<grid, kThreads, 0, s>>>(in, out, images, pixels); break;
    case 1: parts_direct_kernel<kToPlanar, 2, true><<<grid, kThreads, 0, s>>>(in, out, images, pixels); break;
    case 2: parts_direct_kernel<kToPlanar, 4, true><<<grid, kThreads, 0, s>>>(in, out, images, pixels); break;
    case 3: parts_direct_kernel<kToPlanar, 1, false><<<grid, kThreads, 0, s>>>(in, out, images, pixels); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kToPlanar, int kP>
int strided_launch(const uint8_t* in, uint8_t* out, const Frames& f, cudaStream_t s) {
  int64_t images = 1;
  for (int k = 0; k < f.nlead; ++k) images *= f.lead_size[k];
  const int64_t need = (f.w + kThreads - 1) / kThreads;
  const int per = static_cast<int>(need < kP ? need : kP);
  const int64_t chunks = (f.w + per * kThreads - 1) / (per * kThreads);
  const int64_t blocks = images * f.h * chunks;
  const unsigned grid = static_cast<unsigned>(blocks < 0x7fffffff ? blocks : 0x7fffffff);
  layout_u8_strided_kernel<kToPlanar, kP><<<grid, kThreads, 0, s>>>(in, out, f, images * f.h,
                                                                   chunks, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int layout_parts(int variant, int to_planar, const void* in, void* out,
                            int64_t images, int64_t pixels, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(in), b = reinterpret_cast<uintptr_t>(out);
  if (images < 1 || pixels < 16 || pixels % 16 || a % 16 || b % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const uint8_t*>(in);
  auto* y = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return to_planar ? parts_launch<true>(variant, x, y, images, pixels, s)
                   : parts_launch<false>(variant, x, y, images, pixels, s);
}

extern "C" int layout_strided_parts(int pixels_a_thread, int to_planar, const void* in, void* out,
                                    int nlead, const int64_t* dims, void* stream) {
  if (nlead < 0 || nlead > kMaxLead) return static_cast<int>(cudaErrorInvalidValue);
  const Frames f = frames(nlead, dims);
  const auto* x = static_cast<const uint8_t*>(in);
  auto* y = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (pixels_a_thread * 2 + (to_planar ? 1 : 0)) {
    case 8: return strided_launch<false, 4>(x, y, f, s);
    case 9: return strided_launch<true, 4>(x, y, f, s);
    case 16: return strided_launch<false, 8>(x, y, f, s);
    case 17: return strided_launch<true, 8>(x, y, f, s);
    case 32: return strided_launch<false, 16>(x, y, f, s);
    case 33: return strided_launch<true, 16>(x, y, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
