// Block top-K wire kernels of COCO-EF for Hopper (sm_90a), bound to Python
// with ctypes (see ../build.py and ../topk_pack.py).  Plain C interface, as
// in sign_pack.cu: each launcher takes device pointers and a cudaStream_t,
// launches on that stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
// Block sizes B in {64, 128, 256, 512}, 1 <= k <= 32, wire values f32 or
// bf16; the payload is written in the wire's dtypes (u16 in-block indices,
// values in the value dtype, f32 scales), so no cast pass follows.
// block_topk takes B in {128, 256, 512}.
//
// Selection (warp_select, shared by ef_topk_fused, topk_pack and
//   block_topk) replaces repro/kernels/topk_block.py::block_select /
//   block_select_mask.  One warp holds one block in registers, lane j
//   holding the P = B/32 elements at positions 32w + j.  The output slots
//   come in lax.top_k's order: |x| bit pattern descending (non-negative
//   floats order like their bits; -0.0 and +0.0 tie), the smallest
//   position first among equal patterns.  Each element gets one 64-bit
//   key that orders exactly so: the high word is the |x| bit pattern, the
//   low word bit 31 set, 511 - position in bits 1..9 and the sign of x in
//   bit 0.  Keys are unique, so the selection is the k largest keys.
//   1. Each lane orders its P keys once, descending, by Batcher's
//      odd-even merge sort (sort_desc: 1, 5, 19 and 63 compare-exchanges
//      for P = 2, 4, 8, 16, each one 64-bit compare and four selects), and
//      writes them to the warp's slice of shared memory, column per lane,
//      then a sentinel key 0 (below every key).  A lane's head is its largest key
//      not yet taken.
//   2. Round r fills output slot r: every lane loads its head, a
//      __reduce_max_sync takes the largest high word, a second one the
//      largest low word among the lanes holding it; the one lane whose
//      head is that key moves its head on by one row.  No ballot, no
//      branch: the rounds cost the same when lanes tie (all-zero and
//      padding blocks tie in every round).  Lane 0 writes the slot's key.
//   The kernels' outputs read the slots, the block max |x| is slot 0's
//   high word, and an element is kept iff its key is at least that of the
//   last slot kept (k_send - 1): the kept set needs no per-lane state.
//   Instruction count (k = 8, B = 256, P = 8, reckoned from the source):
//   the keys about 30 warp instructions, the sort 115 (in C++ the compiler
//   split each compare-exchange into a max and a min, 8 instructions, so
//   it is written in PTX), the list 9 stores, each round about 10, the
//   slots' payload about 40: about 270 a block against the old design's
//   550 (k rounds of two warp reductions and a shuffle, then the winning
//   lane's rescan of its P values, issued by the whole warp: about 60 a
//   round).  At 10,391,520 blocks on 132 SMs of four schedulers that is
//   about 5.3 M issue cycles a scheduler, 3.0 ms at 1.755 GHz, under
//   topk_pack's byte time of 3.34 ms.  On an H100 topk_pack takes 5.0 ms
//   on random blocks and on all-zero ones alike, 4.2 ms at k = 1, and
//   each round adds 0.13 ms (tools/topk_check.py --rounds): at k = 8 the
//   serial rounds are about half of what is left above the byte time.
//   k_send (1 <= k_send <= k, the coding rank's budget) cuts what the slots
//   carry, not what is selected: slots >= k_send keep their index, carry a
//   +0 value and do not enter c or e'.  The first k_send slots in
//   lax.top_k's order are the top-k_send set with the same ties, so this is
//   JAX's budget branch (repro/core/cocoef.py:308-318) bit for bit.

// ef_topk_fused — replaces repro/kernels/topk_pack.py::_ef_topk_fused_kernel
//   (:92-111, pallas_call at :137).  Per block of B coordinates:
//     acc = gamma*g + e (g and e widened to f32 in registers, then two
//       roundings, no FMA: __fmul_rn/__fadd_rn),
//     select k; scale = block max |acc| (1.0 for an all-zero block);
//     val = V(sv / scale) (__fdiv_rn; bf16 by __float2bfloat16_rn, RNE) in
//     slots < k_send, +0 in the others;
//     c = f32(val) * scale at the positions of the first k_send slots, +0
//     elsewhere (each computed once, by the slot's lane, and handed to the
//     element's lane through shared memory);
//     e' = mask > 0 ? acc - c : e, in e's dtype.
//   One instance per (g dtype, e dtype) in {f32, bf16}^2 (and value dtype
//   and B): a bf16 e' is the f32 acc - c rounded once (__float2bfloat16_rn),
//   as JAX casts the f32 e' to ef_dtype, and a straggler stores e's own
//   bits; the k_send path is the same in every instance.
//   A kept -0.0 stays -0.0 in val and c, as in JAX's jnp reference (the
//   Pallas kernel's masked sums make it +0.0: ROADMAP C7).  Every element
//   of a block is read before any e' element of it is written, so e' may
//   alias e; a straggler (mask 0) writing in place stores nothing.
//   Bound on the H100: device-memory bytes.  It reads g and e and writes e'
//   (12 B/coordinate in f32; 8 with bf16 e; 6 with bf16 g and e) plus (k*(2 + sizeof(V)) + 4) bytes of payload per
//   block; the selection's issue work and about six flops per coordinate
//   stay below the byte time.
//
// topk_pack — replaces repro/kernels/topk_pack.py::_topk_pack_kernel
//   (:43-49, pallas_call at :63).  Pack only: idx, V(sv / scale) (+0 in
//   slots >= k_send), scale, of acc = gamma * x (__fmul_rn; x f32 or bf16,
//   widened; no gamma: acc = x).  gamma folds COCO's gamma*g into the
//   pack, rounded once in f32 as JAX's gamma * g_local.
//   Bound: bytes (4 B/coordinate read, 2 for bf16 x, plus the payload);
//   the selection's issue work is about the same time (see above).
//
// block_topk — replaces repro/kernels/topk_block.py::_topk_kernel (:136-140,
//   pallas_call at :148) with block_select_mask (:57).  Sparsify: per block
//   the k largest |x| (warp_select's set, which is lax.top_k's) keep their
//   value, bits and all (a kept -0.0 stays -0.0), everything else is +0.0;
//   x and out f32 or bf16, selection on the f32 of x.  Each block is read
//   into registers before any store, so out may alias x.
//   Bound: bytes (read and write 2 * sizeof(T) B/coordinate); the
//   selection is issue work under that stream.
//
// topk_decode_reduce — replaces repro/kernels/topk_pack.py::
//   _topk_decode_reduce_kernel (:165-171, pallas_call at :186).
//     out = +0.0; for each sender i in order: at its k in-block positions,
//     out[p] = out[p] + mask_i * (f32(val) * scale_i), each product rounded
//     on its own, as JAX's sender-order scan.
//   Elsewhere the scan adds mask_i * 0 = +0, which changes nothing: the sum
//   starts at +0.0 and a round-to-nearest sum is -0.0 only when both terms
//   are, so no element is ever -0.0.  Hence the kernel equals the scan bit
//   for bit.  Preconditions: a pack's k positions in a block are distinct
//   (so one sender's adds never meet and need no atomics); positions >= B
//   are dropped.
//   Bound: bytes (N payloads read, 4 B/coordinate written); at B = 64 the
//   payloads are 45% of them.
//   Design: the work unit is a tile of T = kDecTile / B consecutive blocks
//   (kDecTile coordinates at every B), so the work per tile and the busy
//   threads do not depend on B or k.  A persistent grid (as many CTAs as
//   fit on the SMs at the kernel's shared memory) walks the tiles.  Per
//   CTA one producer warp streams the (tile, sender) segments, in the
//   order the consumers add them, into a ring of `stages` slots; a
//   segment is three runs (T*k indices, T*k values, T scales), each one
//   1-D bulk copy (cp.async.bulk, completing on the slot's full mbarrier)
//   of its 16-byte aligned interior, its unaligned head and tail (under 16
//   bytes each: nb*k odd, a sender's row starting mid-granule) copied by
//   the producer's lanes.  A slot holds one segment, so N is not bounded
//   by shared memory, and the copies of the next `stages` segments are in
//   flight while one is added.  The eight consumer warps add a sender's
//   T*k entries into the f32 tile in shared memory, all threads busy, one
//   named barrier between senders (the sender order); then each consumer
//   warp writes its 1/8 of the tile with one bulk store (cp.async.bulk
//   shared -> global).  The tile is double-buffered: a warp zeroes its
//   chunk of the other buffer once its own store of that buffer has been
//   read (cp.async.bulk.wait_group.read), while the next tile's segments
//   land.  The ring's stage count is the most (up to kDecMaxStages) that
//   lets two CTAs share an SM, else one CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 32;

// topk_decode_reduce's plan (see the file comment).  The two macros let
// tools/topk_check.py --decode build variants for a sweep.
#ifndef TOPK_DECODE_TILE
#define TOPK_DECODE_TILE 8192
#endif
#ifndef TOPK_DECODE_STAGES
#define TOPK_DECODE_STAGES 8
#endif
constexpr int kDecTile = TOPK_DECODE_TILE;     // coordinates a tile
constexpr int kDecMaxStages = TOPK_DECODE_STAGES;
constexpr int kDecConsumerWarps = 8;
constexpr int kDecConsumers = kDecConsumerWarps * 32;
constexpr int kDecThreads = kDecConsumers + 32;  // + the producer warp
constexpr int kDecChunk = kDecTile / kDecConsumerWarps;  // a warp's store
// shared memory: two output tiles, then full[] and empty[] mbarriers, then
// the ring
constexpr int kDecBars = 2 * kDecTile * 4;
constexpr int kDecRing = kDecBars + 16 * kDecMaxStages;
static_assert(kDecTile % 512 == 0 && kDecChunk % 128 == 0,
              "a tile holds whole blocks of every B; a warp's chunk is "
              "stored and zeroed as float4 by its 32 lanes");
static_assert(kDecTile / 64 * kMaxK * kMaxK <= (1 << 20),
              "entry / k as (entry * ceil(2^20 / k)) >> 20 is exact for "
              "entry < T*k when T*k*k <= 2^20");
static_assert(kDecMaxStages >= 2 && kDecRing % 16 == 0, "ring layout");

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

using u64 = unsigned long long;
constexpr u64 kSentinel = 0;  // below every key: real low words have bit 31

// The key of the element at in-block position pos (see the file comment).
__device__ __forceinline__ u64 cand_key(float x, int pos) {
  const unsigned b = __float_as_uint(x);
  return ((u64)(b & 0x7fffffffu) << 32) |
         (0x80000000u | ((unsigned)(511 - pos) << 1) | (b >> 31));
}

// Compare-exchange: the larger key to a, the smaller to b.  One 64-bit
// compare feeds both selects (in C++ the compiler splits them into a max
// and a min with a compare each: eight instructions instead of six).
__device__ __forceinline__ void ce(u64& a, u64& b) {
  asm("{\n\t.reg .pred p;\n\t.reg .b64 t;\n\t"
      "mov.b64 t, %0;\n\t"
      "setp.gt.u64 p, %1, %0;\n\t"
      "selp.b64 %0, %1, %0, p;\n\t"
      "selp.b64 %1, t, %1, p;\n\t}"
      : "+l"(a), "+l"(b));
}

// Batcher's odd-even merge sort of a lane's P keys, descending.  The
// compare-exchange lists are read by the CPU twin of this selection
// (tests/test_torch_select.py), which replays them step for step.
template <int P>
__device__ __forceinline__ void sort_desc(u64 (&v)[P]);
#define CE(a, b) ce(v[a], v[b])
template <>
__device__ __forceinline__ void sort_desc<2>(u64 (&v)[2]) {
  CE(0, 1);
}
template <>
__device__ __forceinline__ void sort_desc<4>(u64 (&v)[4]) {
  CE(0, 1); CE(2, 3); CE(0, 2); CE(1, 3); CE(1, 2);
}
template <>
__device__ __forceinline__ void sort_desc<8>(u64 (&v)[8]) {
  CE(0, 1); CE(2, 3); CE(4, 5); CE(6, 7); CE(0, 2); CE(1, 3); CE(4, 6);
  CE(5, 7); CE(1, 2); CE(5, 6); CE(0, 4); CE(1, 5); CE(2, 6); CE(3, 7);
  CE(2, 4); CE(3, 5); CE(1, 2); CE(3, 4); CE(5, 6);
}
template <>
__device__ __forceinline__ void sort_desc<16>(u64 (&v)[16]) {
  CE(0, 1); CE(2, 3); CE(4, 5); CE(6, 7); CE(8, 9); CE(10, 11); CE(12, 13);
  CE(14, 15); CE(0, 2); CE(1, 3); CE(4, 6); CE(5, 7); CE(8, 10); CE(9, 11);
  CE(12, 14); CE(13, 15); CE(1, 2); CE(5, 6); CE(9, 10); CE(13, 14);
  CE(0, 4); CE(1, 5); CE(2, 6); CE(3, 7); CE(8, 12); CE(9, 13); CE(10, 14);
  CE(11, 15); CE(2, 4); CE(3, 5); CE(10, 12); CE(11, 13); CE(1, 2);
  CE(3, 4); CE(5, 6); CE(9, 10); CE(11, 12); CE(13, 14); CE(0, 8);
  CE(1, 9); CE(2, 10); CE(3, 11); CE(4, 12); CE(5, 13); CE(6, 14);
  CE(7, 15); CE(4, 8); CE(5, 9); CE(6, 10); CE(7, 11); CE(2, 4); CE(3, 5);
  CE(6, 8); CE(7, 9); CE(10, 12); CE(11, 13); CE(1, 2); CE(3, 4); CE(5, 6);
  CE(7, 8); CE(9, 10); CE(11, 12); CE(13, 14);
}
#undef CE

// A warp's shared memory for the selection: each lane's sorted keys and a
// sentinel (column per lane), then the k output slots.  ef_topk_fused
// reuses `list` for c once the rounds are done.
template <int P>
struct Select {
  u64 list[P + 1][32];
  u64 slot[kMaxK];
};

// See the file comment.  x[w] is the element at in-block position
// 32w + lane.  On return (after a __syncwarp) slot r < k of `s` holds the
// key of output slot r (decode_slot).
template <int P>
__device__ __forceinline__ void warp_select(const float (&x)[P], int k,
                                            int lane, Select<P>& s) {
  u64 v[P];
#pragma unroll
  for (int w = 0; w < P; ++w) v[w] = cand_key(x[w], 32 * w + lane);
  sort_desc<P>(v);
#pragma unroll
  for (int i = 0; i < P; ++i) s.list[i][lane] = v[i];
  s.list[P][lane] = kSentinel;
  const u64* head = &s.list[0][lane];
  for (int r = 0; r < k; ++r) {
    const u64 key = *head;
    const int hi = (int)(key >> 32);
    const int m_hi = __reduce_max_sync(kFull, hi);
    const unsigned c = hi == m_hi ? (unsigned)key : 0u;
    const unsigned m_lo = __reduce_max_sync(kFull, c);
    head += c == m_lo ? 32 : 0;  // the one winner moves on
    if (lane == 0) s.slot[r] = ((u64)(unsigned)m_hi << 32) | m_lo;
  }
  __syncwarp();
}

// Output slot `key` as (in-block position, signed value).
__device__ __forceinline__ void decode_slot(u64 key, int& pos, float& x) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  pos = 511 - (int)((lo >> 1) & 511u);
  x = __uint_as_float(hi | (lo << 31));
}

// sv / scale, rounded as IEEE division (__fdiv_rn).  A zero quotient is
// sv itself (+-0 over a positive scale keeps its sign), and skipping the
// division there keeps all-zero and padding blocks off its slow path for
// special operands.
__device__ __forceinline__ float scaled(float sv, float scale) {
  return sv == 0.f ? sv : __fdiv_rn(sv, scale);
}

__device__ __forceinline__ float safe_scale(int max_bits) {
  const float s = __int_as_float(max_bits);
  return s == 0.f ? 1.f : s;
}

template <int B, typename V, typename TG, typename TE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ef_topk_fused_kernel(const TG* __restrict__ g, const TE* e,
                     const float* __restrict__ gamma_p,
                     const float* __restrict__ mask_p,
                     uint16_t* __restrict__ idx, V* __restrict__ val,
                     float* __restrict__ scales, float* __restrict__ c,
                     TE* e_out, int k, int k_send, int64_t n_blocks) {
  constexpr int P = B / 32;  // elements per lane
  __shared__ Select<P> sel[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (blk >= n_blocks) return;  // whole warp leaves together
  const float gamma = *gamma_p;
  const bool keep = *mask_p > 0.f;
  const int64_t base = blk * B + lane;

  float acc[P];
  TE ev[P];  // e's own bits: a straggler stores them back
#pragma unroll
  for (int w = 0; w < P; ++w) {
    const float gv = from_wire(g[base + 32 * w]);
    ev[w] = e[base + 32 * w];
    acc[w] = __fadd_rn(__fmul_rn(gamma, gv), from_wire(ev[w]));
  }

  Select<P>& s = sel[warp];
  warp_select(acc, k, lane, s);
  const float safe = safe_scale((int)(s.slot[0] >> 32));
  const u64 last_sent = s.slot[k_send - 1];  // kept: keys down to this one
  float* cs = reinterpret_cast<float*>(&s.list[0][0]);  // B floats
  if (lane < k) {
    int pos;
    float sv;
    decode_slot(s.slot[lane], pos, sv);
    V wv = to_wire<V>(0.f);
    if (lane < k_send) {
      wv = to_wire<V>(scaled(sv, safe));
      cs[pos] = __fmul_rn(from_wire(wv), safe);
    }
    idx[blk * k + lane] = (uint16_t)pos;
    val[blk * k + lane] = wv;
  }
  if (lane == 0) scales[blk] = safe;
  __syncwarp();

  const bool store_e = keep || e_out != e;
#pragma unroll
  for (int w = 0; w < P; ++w) {
    float cv = 0.f;
    float en = acc[w];  // acc - (+0.0) == acc, -0.0 included
    if (cand_key(acc[w], 32 * w + lane) >= last_sent) {
      cv = cs[32 * w + lane];
      en = __fsub_rn(acc[w], cv);
    }
    if (c != nullptr) c[base + 32 * w] = cv;
    if (store_e) e_out[base + 32 * w] = keep ? to_wire<TE>(en) : ev[w];
  }
}

// gamma_p: a device scalar, or nullptr for acc = x (the global route's
// rounds, phase 2)
template <int B, typename V, typename TX>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
topk_pack_kernel(const TX* __restrict__ x, const float* __restrict__ gamma_p,
                 uint16_t* __restrict__ idx, V* __restrict__ val,
                 float* __restrict__ scales, int k, int k_send,
                 int64_t n_blocks) {
  constexpr int P = B / 32;
  __shared__ Select<P> sel[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (blk >= n_blocks) return;
  const int64_t base = blk * B + lane;
  float xv[P];
#pragma unroll
  for (int w = 0; w < P; ++w) xv[w] = from_wire(x[base + 32 * w]);
  if (gamma_p != nullptr) {
    const float gamma = *gamma_p;
#pragma unroll
    for (int w = 0; w < P; ++w) xv[w] = __fmul_rn(gamma, xv[w]);
  }

  Select<P>& s = sel[warp];
  warp_select(xv, k, lane, s);
  const float safe = safe_scale((int)(s.slot[0] >> 32));
  if (lane < k) {
    int pos;
    float sv;
    decode_slot(s.slot[lane], pos, sv);
    idx[blk * k + lane] = (uint16_t)pos;
    val[blk * k + lane] =
        to_wire<V>(lane < k_send ? scaled(sv, safe) : 0.f);
  }
  if (lane == 0) scales[blk] = safe;
}

template <int B, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_topk_kernel(const T* x, T* out, int k, int64_t n_blocks) {
  constexpr int P = B / 32;
  __shared__ Select<P> sel[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (blk >= n_blocks) return;
  const int64_t base = blk * B + lane;
  T raw[P];
  float xv[P];
#pragma unroll
  for (int w = 0; w < P; ++w) {
    raw[w] = x[base + 32 * w];
    xv[w] = from_wire(raw[w]);
  }

  warp_select(xv, k, lane, sel[warp]);
  const u64 last = sel[warp].slot[k - 1];  // kept: keys down to this one
  const T zero = to_wire<T>(0.f);
#pragma unroll
  for (int w = 0; w < P; ++w)
    out[base + 32 * w] =
        cand_key(xv[w], 32 * w + lane) >= last ? raw[w] : zero;
}

// --- topk_decode_reduce (see the file comment) ----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory; completion counts them on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from shared to
// global memory, in this thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warps' barrier (named barrier 1; the producer warp is not in
// it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDecConsumers) : "memory");
}

// One run of a segment: `bytes` bytes at global `src`, elements of ES
// bytes, copied to shared memory so that global byte x lands at
// dst + (src & 15) + (x - src).  The 16-byte aligned interior is returned
// for one bulk copy; the head and tail outside it (under 16 bytes each)
// are copied here, lanes 0-7 the head's elements and 8-15 the tail's.
struct Interior {
  const void* src;
  uint32_t dst, bytes;
};

template <int ES>
__device__ __forceinline__ Interior stage_run(const void* src, int bytes,
                                              unsigned char* dst, int lane) {
  using E = typename std::conditional<ES == 2, uint16_t, uint32_t>::type;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), b = a + bytes;
  const uintptr_t a16 = (a + 15) & ~uintptr_t(15), b16 = b & ~uintptr_t(15);
  const uintptr_t lo = a16 < b ? a16 : b;     // head [a, lo)
  const uintptr_t hi = b16 > lo ? b16 : lo;   // interior [lo, hi), tail [hi, b)
  unsigned char* d = dst + (a & 15);          // global byte a
  const uintptr_t x = (lane < 8 ? a : hi) + (lane & 7) * ES;
  if (lane < 16 && x < (lane < 8 ? lo : b))
    *reinterpret_cast<E*>(d + (x - a)) = *reinterpret_cast<const E*>(x);
  return {reinterpret_cast<const void*>(lo), smem_addr(d + (lo - a)),
          static_cast<uint32_t>(hi - lo)};
}

template <int B, typename V>
__global__ void __launch_bounds__(kDecThreads)
topk_decode_reduce_kernel(const uint16_t* __restrict__ idx,
                          const V* __restrict__ val,
                          const float* __restrict__ scales,
                          const float* __restrict__ mask,
                          float* __restrict__ out, int n_senders, int k,
                          int64_t n_blocks, int stages, int idx_area,
                          int val_area, int slot_bytes) {
  constexpr int T = kDecTile / B;  // blocks a tile
  extern __shared__ __align__(128) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);
  const uint32_t full = smem_addr(smem + kDecBars);
  const uint32_t empty = full + 8 * kDecMaxStages;
  unsigned char* ring = smem + kDecRing;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n_tiles = (n_blocks + T - 1) / T;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kDecConsumerWarps);  // a lane 0 per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < kDecConsumerWarps) {  // tile buffer 0 starts at +0.0
    float4* z = reinterpret_cast<float4*>(tiles + warp * kDecChunk);
    for (int q = lane; q < kDecChunk / 4; q += 32)
      z[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  if (warp == kDecConsumerWarps) {
    // producer: the segments (tile, sender) in the consumers' order
    int sl = 0;
    uint32_t use = 0;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t b0 = t * T;
      const int nt = (int)(n_blocks - b0 < T ? n_blocks - b0 : T);
      for (int i = 0; i < n_senders; ++i) {
        if (use > 0) mbar_wait(empty + 8 * sl, (use - 1) & 1);
        unsigned char* seg = ring + sl * slot_bytes;
        const int64_t e0 = (int64_t)i * n_blocks + b0;  // the segment's block
        const Interior r[3] = {
            stage_run<2>(idx + e0 * k, nt * k * 2, seg, lane),
            stage_run<sizeof(V)>(val + e0 * k, nt * k * (int)sizeof(V),
                                 seg + idx_area, lane),
            stage_run<4>(scales + e0, nt * 4, seg + idx_area + val_area,
                         lane)};
        __threadfence_block();
        __syncwarp();  // the heads and tails are in before the arrival
        if (lane == 0) {
          const uint32_t bar = full + 8 * sl;
          mbar_expect_tx(bar, r[0].bytes + r[1].bytes + r[2].bytes);
#pragma unroll
          for (int q = 0; q < 3; ++q)
            if (r[q].bytes) bulk_load(r[q].dst, r[q].src, r[q].bytes, bar);
        }
        if (++sl == stages) {
          sl = 0;
          ++use;
        }
      }
    }
    return;
  }

  // consumers: thread tid adds entries tid, tid + 256, ... of a segment
  const uint32_t magic = ((1u << 20) + k - 1) / k;  // e / k = e*magic >> 20
  int sl = 0;
  uint32_t use = 0, buf = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const int64_t b0 = t * T;
    const int nt = (int)(n_blocks - b0 < T ? n_blocks - b0 : T);
    float* tile = tiles + buf * kDecTile;
    for (int i = 0; i < n_senders; ++i) {
      mbar_wait(full + 8 * sl, use & 1);
      const unsigned char* seg = ring + sl * slot_bytes;
      const int64_t e0 = (int64_t)i * n_blocks + b0;
      const uint16_t* si = reinterpret_cast<const uint16_t*>(
          seg + (reinterpret_cast<uintptr_t>(idx + e0 * k) & 15));
      const V* sv = reinterpret_cast<const V*>(
          seg + idx_area + (reinterpret_cast<uintptr_t>(val + e0 * k) & 15));
      const float* ss = reinterpret_cast<const float*>(
          seg + idx_area + val_area +
          (reinterpret_cast<uintptr_t>(scales + e0) & 15));
      const float m = __ldg(mask + i);
      const int ne = nt * k;
#pragma unroll 4
      for (int e = tid; e < ne; e += kDecConsumers) {
        const int blk = (int)(((uint32_t)e * magic) >> 20);
        const int pos = si[e];
        const float add = __fmul_rn(m, __fmul_rn(from_wire(sv[e]), ss[blk]));
        if (pos < B) {
          float* p = tile + blk * B + pos;
          *p = __fadd_rn(*p, add);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sl);
      if (++sl == stages) {
        sl = 0;
        ++use;
      }
      if (i + 1 < n_senders) consumers_sync();  // the sender order
    }
    // the other buffer (the previous tile's) is zeroed for the next tile
    // once this warp's store of it has read it
    if (lane == 0) bulk_wait_read();
    __syncwarp();
    float4* z = reinterpret_cast<float4*>(tiles + (buf ^ 1) * kDecTile +
                                          warp * kDecChunk);
#pragma unroll
    for (int q = lane; q < kDecChunk / 4; q += 32)
      z[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    fence_proxy_async();
    consumers_sync();
    const int64_t c0 = (int64_t)warp * kDecChunk;
    const int64_t len = (int64_t)nt * B - c0 < kDecChunk
                            ? (int64_t)nt * B - c0 : kDecChunk;
    if (lane == 0 && len > 0)
      bulk_store(out + b0 * B + c0, smem_addr(tile + c0),
                 static_cast<uint32_t>(len * 4));
  }
  if (lane == 0) bulk_wait();
}

// gridDim.x is at most 2^31 - 1 blocks
constexpr int64_t kMaxBlocks = 2147483647;

int grid_for(int64_t n_blocks, unsigned* grid) {
  const int64_t g = (n_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (g > kMaxBlocks || g <= 0) return (int)cudaErrorInvalidConfiguration;
  *grid = (unsigned)g;
  return 0;
}

template <int B, typename V, typename TG, typename TE>
int launch_ef(const void* g, const void* e, const float* gamma,
              const float* mask, void* idx, void* val, float* scales,
              float* c, void* e_out, int64_t n, int k, int k_send,
              cudaStream_t st) {
  unsigned grid;
  if (int err = grid_for(n / B, &grid)) return err;
  ef_topk_fused_kernel<B, V, TG, TE><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const TG*>(g), static_cast<const TE*>(e), gamma, mask,
      static_cast<uint16_t*>(idx), static_cast<V*>(val), scales, c,
      static_cast<TE*>(e_out), k, k_send, n / B);
  return (int)cudaGetLastError();
}

template <int B, typename V, typename TX>
int launch_pack(const void* x, const float* gamma, void* idx, void* val,
                float* scales, int64_t n, int k, int k_send,
                cudaStream_t st) {
  unsigned grid;
  if (int err = grid_for(n / B, &grid)) return err;
  topk_pack_kernel<B, V, TX><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const TX*>(x), gamma, static_cast<uint16_t*>(idx),
      static_cast<V*>(val), scales, k, k_send, n / B);
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
  constexpr int T = kDecTile / B;
  const int64_t n_blocks = n / B;
  if (n_blocks <= 0 || n_senders < 0) return (int)cudaErrorInvalidValue;
  // a ring slot: each run's area holds the run shifted by its global
  // address mod 16
  const int idx_area = (T * k * 2 + 15) / 16 * 16 + 16;
  const int val_area = (T * k * (int)sizeof(V) + 15) / 16 * 16 + 16;
  const int slot_bytes = idx_area + val_area + T * 4 + 16;
  int dev, sms, per_sm, per_block, reserved;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return (int)err;
  // the most stages (<= kDecMaxStages) with which two CTAs share an SM,
  // else with which one CTA fits
  int stages = (per_sm / 2 - reserved - kDecRing) / slot_bytes;
  if (stages < 2) stages = (per_block - kDecRing) / slot_bytes;
  stages = stages < kDecMaxStages ? stages : kDecMaxStages;
  if (stages < 2) return (int)cudaErrorInvalidConfiguration;
  const int bytes = kDecRing + stages * slot_bytes;
  auto kernel = topk_decode_reduce_kernel<B, V>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kDecThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (n_blocks + T - 1) / T;
  const int64_t resident = (int64_t)sms * per_sm;
  const int64_t grid = n_tiles < resident ? n_tiles : resident;
  kernel<<<(unsigned)grid, kDecThreads, bytes, st>>>(
      static_cast<const uint16_t*>(idx), static_cast<const V*>(val), scales,
      mask, out, n_senders, k, n_blocks, stages, idx_area, val_area,
      slot_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// Block sizes and value types with a compiled kernel; the wrapper checks
// against the same lists (SUPPORTED_BLOCK_SIZES, SUPPORTED_K in
// topk_pack.py).  value_bf16: 0 = f32 values, 1 = bf16; 1 <= k_send <= k.
#define TOPK_DISPATCH(B_, BF16_, K_, CALL)                          \
  if ((K_) < 1 || (K_) > kMaxK) return (int)cudaErrorInvalidValue; \
  switch ((B_) * 2 + ((BF16_) ? 1 : 0)) {                           \
    case 128: return CALL(64, float);                               \
    case 129: return CALL(64, __nv_bfloat16);                       \
    case 256: return CALL(128, float);                              \
    case 257: return CALL(128, __nv_bfloat16);                      \
    case 512: return CALL(256, float);                              \
    case 513: return CALL(256, __nv_bfloat16);                      \
    case 1024: return CALL(512, float);                             \
    case 1025: return CALL(512, __nv_bfloat16);                     \
    default: return (int)cudaErrorInvalidValue;                     \
  }

// dtypes: bit 0 set = g is bf16, bit 1 set = e (and e') is bf16; f32
// otherwise (DTYPES in topk_pack.py).
extern "C" int ef_topk_fused_launch(const void* g, const void* e,
                                    const float* gamma, const float* mask,
                                    void* idx, void* val, float* scales,
                                    float* c, void* e_out, long long n,
                                    int block_size, int k, int k_send,
                                    int value_bf16, int dtypes,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (k_send < 1 || k_send > k) return (int)cudaErrorInvalidValue;
#define EF_CALL(B, V) launch_ef<B, V, TG_, TE_>(                       \
    g, e, gamma, mask, idx, val, scales, c, e_out, (int64_t)n, k, k_send, \
    st)
  switch (dtypes) {
    case 0: {
      using TG_ = float;
      using TE_ = float;
      TOPK_DISPATCH(block_size, value_bf16, k, EF_CALL)
    }
    case 1: {
      using TG_ = bf16;
      using TE_ = float;
      TOPK_DISPATCH(block_size, value_bf16, k, EF_CALL)
    }
    case 2: {
      using TG_ = float;
      using TE_ = bf16;
      TOPK_DISPATCH(block_size, value_bf16, k, EF_CALL)
    }
    case 3: {
      using TG_ = bf16;
      using TE_ = bf16;
      TOPK_DISPATCH(block_size, value_bf16, k, EF_CALL)
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EF_CALL
}

// gamma: a device scalar, or nullptr (acc = x); x_bf16: 0 = f32 x, 1 = bf16
extern "C" int topk_pack_launch(const void* x, const float* gamma, void* idx,
                                void* val, float* scales, long long n,
                                int block_size, int k, int k_send,
                                int value_bf16, int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_send < 1 || k_send > k) return (int)cudaErrorInvalidValue;
#define PACK_CALL(B, V) launch_pack<B, V, TX_>(x, gamma, idx, val, scales, \
                                               (int64_t)n, k, k_send, st)
  if (x_bf16) {
    using TX_ = __nv_bfloat16;
    TOPK_DISPATCH(block_size, value_bf16, k, PACK_CALL)
  }
  using TX_ = float;
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
