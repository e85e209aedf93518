// Block top-K wire kernels of COCO-EF for Hopper (sm_90a), bound to Python
// with ctypes (see ../build.py and ../topk_pack.py).  Plain C interface, as
// in sign_pack.cu: each launcher takes device pointers and a cudaStream_t,
// launches on that stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
// Block sizes B in {256, 512}, 1 <= k <= 32, wire values f32 or bf16; the
// payload is written in the wire's dtypes (u16 in-block indices, values in
// the value dtype, f32 scales), so no cast pass follows.  block_topk also
// takes B = 128.
//
// Selection (warp_topk, shared by ef_topk_fused, topk_pack and block_topk)
//   replaces repro/kernels/topk_block.py::block_select / block_select_mask.
//   One warp holds one block in registers, lane j holding elements
//   32w + j.  k rounds each take the largest remaining |x| bit pattern
//   (non-negative floats order like their bits; -0.0 and +0.0 tie) and,
//   among equal patterns, the smallest position: __reduce_max_sync over
//   each lane's own largest remaining pattern, then __reduce_min_sync over
//   the positions of the lanes holding it.  Round r fills output slot r,
//   so the slots come out in lax.top_k's order (magnitude descending,
//   first occurrence winning ties) with no threshold search, tie cut or
//   sort.  Work: k rounds of two warp reductions and one shuffle, plus the
//   winning lane's rescan of its B/32 values; about k*B compares per block.
//
// ef_topk_fused — replaces repro/kernels/topk_pack.py::_ef_topk_fused_kernel
//   (:92-111, pallas_call at :137).  Per block of B coordinates:
//     acc = gamma*g + e (two roundings, no FMA: __fmul_rn/__fadd_rn),
//     select k; scale = block max |acc| (1.0 for an all-zero block);
//     val = V(sv / scale) (__fdiv_rn; bf16 by __float2bfloat16_rn, RNE);
//     c = f32(val) * scale at the kept positions, +0 elsewhere;
//     e' = mask > 0 ? acc - c : e.
//   A kept -0.0 stays -0.0 in val and c, as in JAX's jnp reference (the
//   Pallas kernel's masked sums make it +0.0: ROADMAP C7).  Every element
//   of a block is read before any e' element of it is written, so e' may
//   alias e; a straggler (mask 0) writing in place stores nothing.
//   Bound on the H100: device-memory bytes.  It reads g and e and writes e'
//   (12 B/coordinate) plus (k*(2 + sizeof(V)) + 4) bytes of payload per
//   block; the selection's k*B compares and about six flops per coordinate
//   stay below the byte time.
//
// topk_pack — replaces repro/kernels/topk_pack.py::_topk_pack_kernel
//   (:43-49, pallas_call at :63).  Pack only: idx, V(sv / scale), scale.
//   Bound: bytes (4 B/coordinate read plus the payload).
//
// block_topk — replaces repro/kernels/topk_block.py::_topk_kernel (:136-140,
//   pallas_call at :148) with block_select_mask (:57).  Sparsify: per block
//   the k largest |x| (warp_topk's set, which is lax.top_k's) keep their
//   value, bits and all (a kept -0.0 stays -0.0), everything else is +0.0;
//   x and out f32 or bf16, selection on the f32 of x.  Each block is read
//   into registers before any store, so out may alias x.
//   Bound: bytes (read and write 2 * sizeof(T) B/coordinate); the
//   selection's k*B compares per block are issue work under that stream.
//
// topk_decode_reduce — replaces repro/kernels/topk_pack.py::
//   _topk_decode_reduce_kernel (:165-171, pallas_call at :186).
//     out = +0.0; for each sender i in order: at its k in-block positions,
//     out[p] = out[p] + mask_i * (f32(val) * scale_i), each product rounded
//     on its own, as JAX's sender-order scan.
//   Elsewhere the scan adds mask_i * 0 = +0, which changes nothing: the sum
//   starts at +0.0 and a round-to-nearest sum is -0.0 only when both terms
//   are, so no element is ever -0.0.  Hence the kernel equals the scan bit
//   for bit.  Design: one warp per output block zeroes a tile in shared
//   memory; for each sender lane j < k adds entry j (a pack's k positions in
//   a block are distinct, so no atomics), then __syncwarp orders the
//   senders; the tile is stored as float4.  Positions >= B are dropped.
//   Bound: bytes (N payloads read, 4 B/coordinate written).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 32;
constexpr int kSendersAhead = 4;  // decode: senders loaded before adding

template <typename V>
__device__ __forceinline__ V to_wire(float x);
template <>
__device__ __forceinline__ float to_wire<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_wire<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float from_wire(float x) { return x; }
__device__ __forceinline__ float from_wire(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The lane's largest |x| bit pattern among its elements not yet taken
// (-1 when all are taken), the smallest such w, and x there.
template <int P>
__device__ __forceinline__ void lane_max(const float (&x)[P], unsigned taken,
                                         int& bits, int& w_max,
                                         float& v_max) {
  bits = -1;
  w_max = 0;
  v_max = 0.f;
#pragma unroll
  for (int w = 0; w < P; ++w) {
    const int b = __float_as_int(x[w]) & 0x7fffffff;
    if (!(taken & (1u << w)) && b > bits) {
      bits = b;
      w_max = w;
      v_max = x[w];
    }
  }
}

// See the file comment.  On return lane r < k holds output slot r (its
// in-block position and signed value), every lane holds the bit pattern of
// the block max |x| and the bitmask of its own kept elements.
template <int P>
__device__ __forceinline__ void warp_topk(const float (&x)[P], int k,
                                          int lane, int& slot_pos,
                                          float& slot_val, unsigned& taken,
                                          int& max_bits) {
  taken = 0;
  int bits, w_max;
  float v_max;
  lane_max(x, taken, bits, w_max, v_max);
  slot_pos = 0;
  slot_val = 0.f;
  max_bits = 0;
  for (int r = 0; r < k; ++r) {
    const int m = __reduce_max_sync(kFull, bits);
    if (r == 0) max_bits = m;
    const unsigned cand = bits == m ? (unsigned)(w_max * 32 + lane) : ~0u;
    const unsigned pos = __reduce_min_sync(kFull, cand);
    const int src = (int)(pos & 31u);
    const float v = __shfl_sync(kFull, v_max, src);
    if (lane == r) {
      slot_pos = (int)pos;
      slot_val = v;
    }
    if (lane == src) {
      taken |= 1u << w_max;
      lane_max(x, taken, bits, w_max, v_max);
    }
  }
}

__device__ __forceinline__ float safe_scale(int max_bits) {
  const float s = __int_as_float(max_bits);
  return s == 0.f ? 1.f : s;
}

template <int B, typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ef_topk_fused_kernel(const float* __restrict__ g, const float* e,
                     const float* __restrict__ gamma_p,
                     const float* __restrict__ mask_p,
                     uint16_t* __restrict__ idx, V* __restrict__ val,
                     float* __restrict__ scales, float* __restrict__ c,
                     float* e_out, int k, int64_t n_blocks) {
  constexpr int P = B / 32;  // elements per lane
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warp leaves together
  const float gamma = *gamma_p;
  const bool keep = *mask_p > 0.f;
  const int64_t base = blk * B + lane;

  float acc[P];
  float ev[P];
#pragma unroll
  for (int w = 0; w < P; ++w) {
    const float gv = g[base + 32 * w];
    ev[w] = e[base + 32 * w];
    acc[w] = __fadd_rn(__fmul_rn(gamma, gv), ev[w]);
  }

  int slot_pos, max_bits;
  float slot_val;
  unsigned taken;
  warp_topk(acc, k, lane, slot_pos, slot_val, taken, max_bits);
  const float safe = safe_scale(max_bits);
  if (lane < k) {
    idx[blk * k + lane] = (uint16_t)slot_pos;
    val[blk * k + lane] = to_wire<V>(__fdiv_rn(slot_val, safe));
  }
  if (lane == 0) scales[blk] = safe;

  const bool store_e = keep || e_out != e;
#pragma unroll
  for (int w = 0; w < P; ++w) {
    float cv = 0.f;
    float en = acc[w];  // acc - (+0.0) == acc, -0.0 included
    if (taken & (1u << w)) {
      cv = __fmul_rn(from_wire(to_wire<V>(__fdiv_rn(acc[w], safe))), safe);
      en = __fsub_rn(acc[w], cv);
    }
    if (c != nullptr) c[base + 32 * w] = cv;
    if (store_e) e_out[base + 32 * w] = keep ? en : ev[w];
  }
}

template <int B, typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_pack_kernel(const float* __restrict__ x, uint16_t* __restrict__ idx,
                 V* __restrict__ val, float* __restrict__ scales, int k,
                 int64_t n_blocks) {
  constexpr int P = B / 32;
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  const int64_t base = blk * B + lane;
  float xv[P];
#pragma unroll
  for (int w = 0; w < P; ++w) xv[w] = x[base + 32 * w];

  int slot_pos, max_bits;
  float slot_val;
  unsigned taken;
  warp_topk(xv, k, lane, slot_pos, slot_val, taken, max_bits);
  const float safe = safe_scale(max_bits);
  if (lane < k) {
    idx[blk * k + lane] = (uint16_t)slot_pos;
    val[blk * k + lane] = to_wire<V>(__fdiv_rn(slot_val, safe));
  }
  if (lane == 0) scales[blk] = safe;
}

template <int B, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_topk_kernel(const T* x, T* out, int k, int64_t n_blocks) {
  constexpr int P = B / 32;
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  const int64_t base = blk * B + lane;
  T raw[P];
  float xv[P];
#pragma unroll
  for (int w = 0; w < P; ++w) {
    raw[w] = x[base + 32 * w];
    xv[w] = from_wire(raw[w]);
  }

  int slot_pos, max_bits;
  float slot_val;
  unsigned taken;
  warp_topk(xv, k, lane, slot_pos, slot_val, taken, max_bits);
  const T zero = to_wire<T>(0.f);
#pragma unroll
  for (int w = 0; w < P; ++w)
    out[base + 32 * w] = (taken & (1u << w)) ? raw[w] : zero;
}

template <int B, typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_decode_reduce_kernel(const uint16_t* __restrict__ idx,
                          const V* __restrict__ val,
                          const float* __restrict__ scales,
                          const float* __restrict__ mask,
                          float* __restrict__ out, int n_senders, int k,
                          int64_t n_blocks) {
  __shared__ __align__(16) float tile[kWarpsPerBlock][B];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (blk >= n_blocks) return;
  float* t = tile[warp];
#pragma unroll
  for (int w = 0; w < B / 32; ++w) t[32 * w + lane] = 0.f;
  __syncwarp();

  const int64_t per_sender = n_blocks * k;
  const bool active = lane < k;
  for (int i0 = 0; i0 < n_senders; i0 += kSendersAhead) {
    int pos[kSendersAhead];
    float add[kSendersAhead];
#pragma unroll
    for (int u = 0; u < kSendersAhead; ++u) {
      const int i = i0 + u;
      pos[u] = B;  // dropped
      add[u] = 0.f;
      if (active && i < n_senders) {
        const int64_t o = i * per_sender + blk * k + lane;
        pos[u] = idx[o];
        const float sv = __fmul_rn(from_wire(val[o]), scales[i * n_blocks + blk]);
        add[u] = __fmul_rn(mask[i], sv);
      }
    }
#pragma unroll
    for (int u = 0; u < kSendersAhead; ++u) {
      if (pos[u] < B) t[pos[u]] = __fadd_rn(t[pos[u]], add[u]);
      __syncwarp();
    }
  }

  float4* o4 = reinterpret_cast<float4*>(out + blk * B);
  const float4* t4 = reinterpret_cast<const float4*>(t);
#pragma unroll
  for (int q = lane; q < B / 4; q += 32) o4[q] = t4[q];
}

// gridDim.x is at most 2^31 - 1 blocks
constexpr int64_t kMaxBlocks = 2147483647;

int grid_for(int64_t n_blocks, unsigned* grid) {
  const int64_t g = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (g > kMaxBlocks || g <= 0) return (int)cudaErrorInvalidConfiguration;
  *grid = (unsigned)g;
  return 0;
}

template <int B, typename V>
int launch_ef(const float* g, const float* e, const float* gamma,
              const float* mask, void* idx, void* val, float* scales,
              float* c, float* e_out, int64_t n, int k, cudaStream_t st) {
  unsigned grid;
  if (int err = grid_for(n / B, &grid)) return err;
  ef_topk_fused_kernel<B, V><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      g, e, gamma, mask, static_cast<uint16_t*>(idx), static_cast<V*>(val),
      scales, c, e_out, k, n / B);
  return (int)cudaGetLastError();
}

template <int B, typename V>
int launch_pack(const float* x, void* idx, void* val, float* scales,
                int64_t n, int k, cudaStream_t st) {
  unsigned grid;
  if (int err = grid_for(n / B, &grid)) return err;
  topk_pack_kernel<B, V><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      x, static_cast<uint16_t*>(idx), static_cast<V*>(val), scales, k,
      n / B);
  return (int)cudaGetLastError();
}

template <int B, typename T>
int launch_block_topk(const void* x, void* out, int64_t n, int k,
                      cudaStream_t st) {
  unsigned grid;
  if (int err = grid_for(n / B, &grid)) return err;
  block_topk_kernel<B, T><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), k, n / B);
  return (int)cudaGetLastError();
}

template <int B, typename V>
int launch_decode(const void* idx, const void* val, const float* scales,
                  const float* mask, float* out, int n_senders, int64_t n,
                  int k, cudaStream_t st) {
  unsigned grid;
  if (int err = grid_for(n / B, &grid)) return err;
  topk_decode_reduce_kernel<B, V><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const uint16_t*>(idx), static_cast<const V*>(val), scales,
      mask, out, n_senders, k, n / B);
  return (int)cudaGetLastError();
}

}  // namespace

// Block sizes and value types with a compiled kernel; the wrapper checks
// against the same lists (SUPPORTED_BLOCK_SIZES, SUPPORTED_K in
// topk_pack.py).  value_bf16: 0 = f32 values, 1 = bf16.
#define TOPK_DISPATCH(B_, BF16_, K_, CALL)                          \
  if ((K_) < 1 || (K_) > kMaxK) return (int)cudaErrorInvalidValue; \
  switch ((B_) * 2 + ((BF16_) ? 1 : 0)) {                           \
    case 512: return CALL(256, float);                              \
    case 513: return CALL(256, __nv_bfloat16);                      \
    case 1024: return CALL(512, float);                             \
    case 1025: return CALL(512, __nv_bfloat16);                     \
    default: return (int)cudaErrorInvalidValue;                     \
  }

extern "C" int ef_topk_fused_launch(const float* g, const float* e,
                                    const float* gamma, const float* mask,
                                    void* idx, void* val, float* scales,
                                    float* c, float* e_out, long long n,
                                    int block_size, int k, int value_bf16,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EF_CALL(B, V) launch_ef<B, V>(g, e, gamma, mask, idx, val, scales, \
                                      c, e_out, (int64_t)n, k, st)
  TOPK_DISPATCH(block_size, value_bf16, k, EF_CALL)
#undef EF_CALL
}

extern "C" int topk_pack_launch(const float* x, void* idx, void* val,
                                float* scales, long long n, int block_size,
                                int k, int value_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PACK_CALL(B, V) launch_pack<B, V>(x, idx, val, scales, (int64_t)n, \
                                          k, st)
  TOPK_DISPATCH(block_size, value_bf16, k, PACK_CALL)
#undef PACK_CALL
}

extern "C" int topk_decode_reduce_launch(const void* idx, const void* val,
                                         const float* scales,
                                         const float* mask, float* out,
                                         int n_senders, long long n,
                                         int block_size, int k,
                                         int value_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEC_CALL(B, V) launch_decode<B, V>(idx, val, scales, mask, out, \
                                           n_senders, (int64_t)n, k, st)
  TOPK_DISPATCH(block_size, value_bf16, k, DEC_CALL)
#undef DEC_CALL
}

// block_topk's block sizes (BLOCK_TOPK_SIZES in topk_pack.py); bf16: 0 = f32
// input and output, 1 = bf16.
extern "C" int block_topk_launch(const void* x, void* out, long long n,
                                 int block_size, int k, int bf16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TOPK_CALL(B, T) launch_block_topk<B, T>(x, out, (int64_t)n, k, st)
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  switch (block_size * 2 + (bf16 ? 1 : 0)) {
    case 256: return TOPK_CALL(128, float);
    case 257: return TOPK_CALL(128, __nv_bfloat16);
    case 512: return TOPK_CALL(256, float);
    case 513: return TOPK_CALL(256, __nv_bfloat16);
    case 1024: return TOPK_CALL(512, float);
    case 1025: return TOPK_CALL(512, __nv_bfloat16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TOPK_CALL
}
