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
//     acc = gamma*g + e (g and e widened to f32 in registers, then two
//       roundings, no FMA: __fmul_rn/__fadd_rn),
//     scale = sum|acc| / G, reduced in one fixed order,
//     word w bit j = acc[32w+j] >= 0  (-0.0 packs as +, NaN as -),
//     c = +-scale, e' = mask > 0 ? acc - c : e.
//   One instance per (g dtype, e dtype) in {f32, bf16}^2: the gradient of
//   bf16 parameters, and the error vector stored in TrainRun.ef_dtype.
//   A bf16 e' is the f32 acc - c rounded once (__float2bfloat16_rn), as
//   JAX casts the f32 e' to ef_dtype; a straggler (mask 0) stores e's own
//   bits.  This is JAX's kernel body: it reads g_ref[...].astype(f32) and
//   e_ref[...].astype(f32) (sign_pack.py:81).
//   Bound on the H100: device-memory bytes.  It reads g and e and writes
//   e' (12 B/coordinate in f32; 8 with bf16 e; 6 with bf16 g and e) plus
//   n/8 + 4n/G bytes of payload, and does about six flops per coordinate,
//   far below the 67 TFLOP/s f32 rate.
//   Design: one warp per group.  Lane j holds elements 32w+j, so every
//   load and store of the warp is one coalesced line and
//   __ballot_sync(acc >= 0) is exactly the JAX word layout.  The group's
//   acc stays in registers between the reduction and the e' store, so g
//   and e are read from device memory once.  Every e element is read
//   before any e' element of its group is written, so e' may alias e
//   (the train step updates the error in place).
//
// sign_pack — replaces repro/kernels/sign_pack.py::_sign_pack_kernel
//   (:43-46, body _pack_block :32-40, pallas_call at :60).  Pack only, the
//   group machinery of ef_sign_fused without the accumulate and without e':
//     acc = gamma * x (__fmul_rn; x widened from f32 or bf16; no gamma:
//       acc = x),
//     word w bit j = acc[32w+j] >= 0,  scale = sum|acc| / G  (same order).
//   gamma folds COCO's gamma*g into the pack, rounded once in f32 as JAX's
//   gamma * g_local, so the step neither rewrites g nor copies it to f32.
//   Bound: bytes.  It reads 4 (bf16: 2) B/coordinate and writes n/8 +
//   4n/G bytes of payload; one warp per group as in ef_sign_fused.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// f32 and bf16 storage: widening is exact, narrowing rounds to nearest even
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <int G, typename TG, typename TE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ef_sign_fused_kernel(const TG* __restrict__ g, const TE* e,
                     const float* __restrict__ gamma_p,
                     const float* __restrict__ mask_p,
                     uint32_t* __restrict__ words, float* __restrict__ scales,
                     float* __restrict__ c, TE* e_out, int64_t n_groups) {
  constexpr int kPerLane = G / 32;  // words per group
  const int lane = threadIdx.x & 31;
  const int64_t grp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (grp >= n_groups) return;  // whole warp leaves together
  const float gamma = *gamma_p;
  const bool keep = *mask_p > 0.f;
  const int64_t base = grp * G + lane;

  float acc[kPerLane];
  TE ev[kPerLane];  // e's own bits: a straggler stores them back
#pragma unroll
  for (int w = 0; w < kPerLane; ++w) {
    const float gv = widen(g[base + 32 * w]);
    ev[w] = e[base + 32 * w];
    acc[w] = __fadd_rn(__fmul_rn(gamma, gv), widen(ev[w]));
  }

  const float scale = pack_group<G>(acc, lane, grp, words, scales);

#pragma unroll
  for (int w = 0; w < kPerLane; ++w) {
    const float cv = acc[w] >= 0.f ? scale : -scale;
    if (c != nullptr) c[base + 32 * w] = cv;
    e_out[base + 32 * w] = keep ? narrow<TE>(__fsub_rn(acc[w], cv)) : ev[w];
  }
}

// gamma_p: a device scalar, or nullptr for acc = x (phase 2's re-pack)
template <int G, typename TX>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sign_pack_kernel(const TX* __restrict__ x, const float* __restrict__ gamma_p,
                 uint32_t* __restrict__ words, float* __restrict__ scales,
                 int64_t n_groups) {
  constexpr int kPerLane = G / 32;
  const int lane = threadIdx.x & 31;
  const int64_t grp =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (grp >= n_groups) return;  // whole warp leaves together
  const int64_t base = grp * G + lane;
  float xv[kPerLane];
#pragma unroll
  for (int w = 0; w < kPerLane; ++w) xv[w] = widen(x[base + 32 * w]);
  if (gamma_p != nullptr) {
    const float gamma = *gamma_p;
#pragma unroll
    for (int w = 0; w < kPerLane; ++w) xv[w] = __fmul_rn(gamma, xv[w]);
  }
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

template <int G, typename TG, typename TE>
int launch_ef(const void* g, const void* e, const float* gamma,
              const float* mask, uint32_t* words, float* scales, float* c,
              void* e_out, int64_t n, cudaStream_t stream) {
  const int64_t n_groups = n / G;
  const int64_t blocks = (n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidConfiguration;
  ef_sign_fused_kernel<G, TG, TE>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const TG*>(g), static_cast<const TE*>(e), gamma, mask,
          words, scales, c, static_cast<TE*>(e_out), n_groups);
  return (int)cudaGetLastError();
}

template <int G, typename TX>
int launch_pack(const void* x, const float* gamma, uint32_t* words,
                float* scales, int64_t n, cudaStream_t stream) {
  const int64_t n_groups = n / G;
  const int64_t blocks = (n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) return (int)cudaErrorInvalidConfiguration;
  sign_pack_kernel<G, TX><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                            stream>>>(static_cast<const TX*>(x), gamma,
                                      words, scales, n_groups);
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

// dtypes: bit 0 set = g is bf16, bit 1 set = e (and e') is bf16; f32
// otherwise (DTYPES in sign_pack.py).
extern "C" int ef_sign_fused_launch(const void* g, const void* e,
                                    const float* gamma, const float* mask,
                                    uint32_t* words, float* scales, float* c,
                                    void* e_out, long long n,
                                    int group_size, int dtypes,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define EF_G(G) launch_ef<G, TG_, TE_>(g, e, gamma, mask, words, scales, \
                                       c, e_out, (int64_t)n, st)
  switch (dtypes) {
    case 0: {
      using TG_ = float;
      using TE_ = float;
      SIGN_DISPATCH(group_size, EF_G)
    }
    case 1: {
      using TG_ = bf16;
      using TE_ = float;
      SIGN_DISPATCH(group_size, EF_G)
    }
    case 2: {
      using TG_ = float;
      using TE_ = bf16;
      SIGN_DISPATCH(group_size, EF_G)
    }
    case 3: {
      using TG_ = bf16;
      using TE_ = bf16;
      SIGN_DISPATCH(group_size, EF_G)
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EF_G
}

// gamma: a device scalar, or nullptr (acc = x); x_bf16: 0 = f32 x, 1 = bf16
extern "C" int sign_pack_launch(const void* x, const float* gamma,
                                uint32_t* words, float* scales, long long n,
                                int group_size, int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PACK_CALL(G) launch_pack<G, TX_>(x, gamma, words, scales, \
                                         (int64_t)n, st)
  if (x_bf16) {
    using TX_ = __nv_bfloat16;
    SIGN_DISPATCH(group_size, PACK_CALL)
  }
  using TX_ = float;
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
