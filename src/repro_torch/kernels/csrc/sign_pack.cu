// Sign-wire kernels of COCO-EF for Hopper (sm_90a), bound to Python with
// ctypes (see ../build.py and ../sign_pack.py).  Plain C interface: each
// launcher takes device pointers and a cudaStream_t, launches on that
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
// gamma and the mask are device scalars, read by the kernel: passing gamma
// by value instead made ef_sign_fused slower on the H100 (PERF.md).
//
// ef_sign_fused — replaces repro/kernels/sign_pack.py::_ef_fused_kernel
//   (:77-89, pallas_call at :112).  Per group of G coordinates:
//     acc = gamma*g + e (two roundings, no FMA: __fmul_rn/__fadd_rn),
//     scale = sum|acc| / G, reduced in one fixed order,
//     word w bit j = acc[32w+j] >= 0  (-0.0 packs as +, NaN as -),
//     c = +-scale, e' = mask > 0 ? acc - c : e.
//   Bound on the H100: device-memory bytes.  It reads g and e and writes
//   e' (12 B/coordinate) plus n/8 + 4n/G bytes of payload, and does about
//   six flops per coordinate, far below the 67 TFLOP/s f32 rate.
//   Design: one warp per group.  Lane j holds elements 32w+j, so every
//   load and store of the warp is one coalesced 128-byte line and
//   __ballot_sync(acc >= 0) is exactly the JAX word layout.  The group's
//   acc stays in registers between the reduction and the e' store, so g
//   and e are read from device memory once.  Every e element is read
//   before any e' element of its group is written, so e' may alias e
//   (the train step updates the error in place).
//
// sign_pack — replaces repro/kernels/sign_pack.py::_sign_pack_kernel
//   (:43-46, body _pack_block :32-40, pallas_call at :60).  Pack only, the
//   group machinery of ef_sign_fused without the accumulate and without e':
//     word w bit j = x[32w+j] >= 0,  scale = sum|x| / G  (same order).
//   Bound: bytes.  It reads 4 B/coordinate and writes n/8 + 4n/G bytes of
//   payload; one warp per group as in ef_sign_fused.
//
// sign_decode_reduce — replaces repro/kernels/sign_pack.py::
//   _decode_reduce_kernel (:136-145, pallas_call at :162).
//     out[x] = sum over senders i = 0..N-1, in order, from +0.0,
//              of (mask_i * (bit ? +1 : -1)) * scale_i[x / G].
//   Every product is exact, so the only rounding is the sender-order add
//   chain: the result equals the JAX sender-order sum bit for bit.  No
//   atomics and no tree over senders.
//   Bound: bytes.  It reads N*(n/8 + 4n/G) bytes of payload and writes
//   4n bytes of f32.  Design: one thread per 4 consecutive outputs (one
//   16-byte store); the 4 share one word and one scale, so payload loads
//   are broadcast within the warp and the f32 write stream is coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// One group's sign words and scale from the warp's registers (lane j holds
// elements 32w + j): scale = sum|v| / G, summed lane-sequentially, then in
// an xor butterfly (both partners add the same two values, so every lane
// ends with the bitwise-same total); word w = __ballot_sync(v[w] >= 0).
// Stores the words and the scale; returns the scale on every lane.
template <int G>
__device__ __forceinline__ float pack_group(const float (&v)[G / 32],
                                            int lane, int64_t grp,
                                            uint32_t* __restrict__ words,
                                            float* __restrict__ scales) {
  constexpr int kPerLane = G / 32;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kPerLane; ++w) s = __fadd_rn(s, fabsf(v[w]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  const float scale = __fdiv_rn(s, (float)G);

  uint32_t my_word = 0;
#pragma unroll
  for (int w = 0; w < kPerLane; ++w) {
    const uint32_t b = __ballot_sync(kFull, v[w] >= 0.f);
    if (lane == w) my_word = b;
  }
  if (lane < kPerLane) words[grp * kPerLane + lane] = my_word;
  if (lane == 0) scales[grp] = scale;
  return scale;
}

template <int G>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ef_sign_fused_kernel(const float* __restrict__ g, const float* e,
                     const float* __restrict__ gamma_p,
                     const float* __restrict__ mask_p,
                     uint32_t* __restrict__ words, float* __restrict__ scales,
                     float* __restrict__ c, float* e_out, int64_t n_groups) {
  constexpr int kPerLane = G / 32;  // words per group
  const int lane = threadIdx.x & 31;
  const int64_t grp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (grp >= n_groups) return;  // whole warp leaves together
  const float gamma = *gamma_p;
  const bool keep = *mask_p > 0.f;
  const int64_t base = grp * G + lane;

  float acc[kPerLane];
  float ev[kPerLane];
#pragma unroll
  for (int w = 0; w < kPerLane; ++w) {
    const float gv = g[base + 32 * w];
    ev[w] = e[base + 32 * w];
    acc[w] = __fadd_rn(__fmul_rn(gamma, gv), ev[w]);
  }

  const float scale = pack_group<G>(acc, lane, grp, words, scales);

#pragma unroll
  for (int w = 0; w < kPerLane; ++w) {
    const float cv = acc[w] >= 0.f ? scale : -scale;
    if (c != nullptr) c[base + 32 * w] = cv;
    e_out[base + 32 * w] = keep ? __fsub_rn(acc[w], cv) : ev[w];
  }
}

template <int G>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sign_pack_kernel(const float* __restrict__ x, uint32_t* __restrict__ words,
                 float* __restrict__ scales, int64_t n_groups) {
  constexpr int kPerLane = G / 32;
  const int lane = threadIdx.x & 31;
  const int64_t grp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (grp >= n_groups) return;  // whole warp leaves together
  const int64_t base = grp * G + lane;
  float xv[kPerLane];
#pragma unroll
  for (int w = 0; w < kPerLane; ++w) xv[w] = x[base + 32 * w];
  pack_group<G>(xv, lane, grp, words, scales);
}

template <int G>
__global__ void sign_decode_reduce_kernel(const uint32_t* __restrict__ words,
                                          const float* __restrict__ scales,
                                          const float* __restrict__ mask,
                                          float* __restrict__ out,
                                          int n_senders, int64_t n) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t x0 = q * 4;
  if (x0 >= n) return;
  const int64_t n_words = n / 32;
  const int64_t n_groups = n / G;
  const int64_t wi = x0 >> 5;
  const int shift = (int)(x0 & 31);
  const int64_t gi = x0 / G;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int i = 0; i < n_senders; ++i) {
    const uint32_t w = words[(int64_t)i * n_words + wi] >> shift;
    const float s = scales[(int64_t)i * n_groups + gi];
    const float m = mask[i];
    a0 = __fadd_rn(a0, __fmul_rn(__fmul_rn(m, (w & 1u) ? 1.f : -1.f), s));
    a1 = __fadd_rn(a1, __fmul_rn(__fmul_rn(m, (w & 2u) ? 1.f : -1.f), s));
    a2 = __fadd_rn(a2, __fmul_rn(__fmul_rn(m, (w & 4u) ? 1.f : -1.f), s));
    a3 = __fadd_rn(a3, __fmul_rn(__fmul_rn(m, (w & 8u) ? 1.f : -1.f), s));
  }
  reinterpret_cast<float4*>(out)[q] = make_float4(a0, a1, a2, a3);
}

// gridDim.x is at most 2^31 - 1 blocks
constexpr int64_t kMaxBlocks = 2147483647;

template <int G>
int launch_ef(const float* g, const float* e, const float* gamma,
              const float* mask, uint32_t* words, float* scales, float* c,
              float* e_out, int64_t n, cudaStream_t stream) {
  const int64_t n_groups = n / G;
  const int64_t blocks = (n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidConfiguration;
  ef_sign_fused_kernel<G><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                            stream>>>(g, e, gamma, mask, words, scales, c,
                                      e_out, n_groups);
  return (int)cudaGetLastError();
}

template <int G>
int launch_pack(const float* x, uint32_t* words, float* scales, int64_t n,
                cudaStream_t stream) {
  const int64_t n_groups = n / G;
  const int64_t blocks = (n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidConfiguration;
  sign_pack_kernel<G><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      x, words, scales, n_groups);
  return (int)cudaGetLastError();
}

template <int G>
int launch_decode(const uint32_t* words, const float* scales,
                  const float* mask, float* out, int n_senders, int64_t n,
                  cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t quads = n / 4;
  const int64_t blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidConfiguration;
  sign_decode_reduce_kernel<G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      words, scales, mask, out, n_senders, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Group sizes with a compiled kernel; the wrapper checks against the same
// list (SUPPORTED_GROUP_SIZES in sign_pack.py).
#define SIGN_DISPATCH(G_, CALL)                 \
  switch (G_) {                                 \
    case 32: return CALL(32);                   \
    case 64: return CALL(64);                   \
    case 128: return CALL(128);                 \
    case 256: return CALL(256);                 \
    case 512: return CALL(512);                 \
    case 1024: return CALL(1024);               \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int ef_sign_fused_launch(const float* g, const float* e,
                                    const float* gamma, const float* mask,
                                    uint32_t* words, float* scales, float* c,
                                    float* e_out, long long n,
                                    int group_size, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EF_CALL(G) launch_ef<G>(g, e, gamma, mask, words, scales, c, e_out, \
                                (int64_t)n, st)
  SIGN_DISPATCH(group_size, EF_CALL)
#undef EF_CALL
}

extern "C" int sign_pack_launch(const float* x, uint32_t* words,
                                float* scales, long long n, int group_size,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PACK_CALL(G) launch_pack<G>(x, words, scales, (int64_t)n, st)
  SIGN_DISPATCH(group_size, PACK_CALL)
#undef PACK_CALL
}

extern "C" int sign_decode_reduce_launch(const uint32_t* words,
                                         const float* scales,
                                         const float* mask, float* out,
                                         int n_senders, long long n,
                                         int group_size, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEC_CALL(G) launch_decode<G>(words, scales, mask, out, n_senders, \
                                     (int64_t)n, st)
  SIGN_DISPATCH(group_size, DEC_CALL)
#undef DEC_CALL
}
