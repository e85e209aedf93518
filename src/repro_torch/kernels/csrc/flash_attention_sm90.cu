// Causal GQA attention forward on Hopper's tensor cores (sm_90a), for bf16
// q, k, v; bound to Python with ctypes (see ../build.py and
// ../flash_attention.py).  Plain C interface: the launcher takes device
// pointers and a cudaStream_t, makes the TMA tensor maps on the host,
// launches on that stream, does not synchronise, allocates nothing, and
// returns a CUDA error code (0 on success) so the wrapper can raise.
//
// flash_attention (bf16) — replaces repro/kernels/flash_attention.py::
//   _flash_kernel (:34-55, pallas_call at :67) for bf16 inputs; f32 inputs
//   keep the CUDA-core kernel of flash_attention.cu.  For q (B, H, S, hd),
//   pre-scaled, and k, v (B, H/groups, S, hd), kv head h / groups:
//     s[i][j] = sum_d q[i][d] * k[j][d]       (bf16 products, exact in f32)
//     s = softcap > 0 ? softcap * tanh(s / softcap) : s
//     s = (j <= i && j > i - window) ? s : -1e30
//     o[i] = sum_j p[i][j] v[j] / max(sum_j p[i][j], 1e-30),
//            p[i][j] = exp(s[i][j] - max_j s[i][j])
//   rounded once to bf16, walked tile by tile with an online softmax in f32
//   (running max, running sum, accumulator rescaled by exp(m - m_new)).
//   Masked scores stay -1e30 as in JAX, never -inf (see flash_attention.cu:
//   a row wholly masked in a tile is rescaled to exactly 0 by its first
//   real score).
//
// Bound on the H100: operations.  A global layer of the serve slice (B 32,
// H 8, S 8192, hd 288) does 4 hd flops on each of 8.6e9 unmasked (q, k)
// pairs: 9.9e12 flops, 10.0 ms at 989 TFLOP/s bf16, against 0.6 GB of q,
// k, v and o.  Three things keep a simple tensor-core kernel from it:
//   - p cannot be rounded once to bf16 for p.v: that misses the stated
//     tolerance (one bf16 ulp of the output) on about 8% of the entries.
//     The kernel splits p = p_hi + p_lo, both bf16 (p_lo = bf16(p - p_hi)
//     keeps 16 of p's bits), and runs p_hi.v + p_lo.v into the f32
//     accumulator: 6 hd flops per pair instead of 4, 15 ms of MMA work.
//   - the softmax is about as much work as the MMAs: per pair the softcap,
//     the mask, the max, exp, the sum and the split, on the f32 and MUFU
//     pipes.  The softcap is s * (1 / cap) and tanh from ex2.approx and
//     rcp.approx (`fast_tanh`), not an IEEE divide and tanhf, which cost
//     about 14 ms of a global layer; p is exp2f((s - m) * log2 e), and O
//     is rescaled only where a row's maximum moved.  All stay well inside
//     the tolerance.
//   - ptxas serialises every wgmma of a kernel in which one sits on a path
//     it cannot prove warp-uniform.  The warp index comes through a
//     shuffle, and every tile runs the same wgmmas.
// Design:
//   - one CTA per (b, q head, tile of 128 query rows); q tiles fastest,
//     the last (heaviest) first; three warpgroups: two consumers of 64
//     rows each (setmaxnreg 240), one producer whose first thread issues
//     the TMA copies (setmaxnreg 24);
//   - TMA with 3-D tensor maps over (hd, S, B*H) for q and (hd, S, B*Hkv)
//     for k and v, so rows past S and columns past hd arrive as zeros;
//     boxes of 32 columns with a 64-byte swizzle, so hd 288 is 9 boxes
//     with no padding (hd is padded to a multiple of 96, the p.v MMA's
//     width: 16 and 64 run as 96);
//   - Q (128 x hd) loaded once; K and V tiles of 64 keys through a
//     two-stage ring (221,184 B of shared memory at hd 288), K and V with
//     full and empty mbarriers of their own: K is released once S is done,
//     V a turn later after O += P.V; tiles wholly above the diagonal or
//     below the window are never loaded;
//   - S = Q.K^T: wgmma m64n64k16, A and B from shared memory (K-major),
//     hd / 16 steps;
//   - the softmax in registers on the accumulator layout: each thread
//     holds 2 rows x 16 keys, a row's 4 lanes meet in xor shuffles; the
//     mask is applied only on diagonal, window-edge and ragged tiles (a
//     tile in which no row of a warpgroup keeps a key is masked whole and
//     adds exactly 0);
//   - O += P.V: the accumulator layout of S is the register-A fragment of
//     wgmma, so p_hi and p_lo go from registers straight into two
//     m64n96k16 wgmmas per 16 keys and 96 columns, V as the MN-major B
//     operand in shared memory; O (64 x hd in f32) stays in registers;
//   - overlap: a consumer issues S of tile j and O += P.V of tile j - 1
//     together, waits for S alone and computes the softcap and p while
//     its P.V still runs; the two consumers run free, so one's softmax
//     also runs under the other's MMAs (a strict turn-taking of the two
//     with named barriers measured 2-3% slower);
//   - epilogue: divide by max(l, 1e-30) with __fdiv_rn, round once to
//     bf16, store rows < S and columns < hd.
// No atomics and no split over keys: the same inputs give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;        // query rows per CTA
constexpr int kBK = 64;         // keys per tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kBox = 32;        // columns of one TMA box (64 bytes)
constexpr int kRowBytes = 64;   // one row of a box in shared memory
constexpr int kThreads = 384;   // consumers: warpgroups 0, 1; producer: 2
constexpr float kNeg = -1e30f;  // JAX's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of the kernel for hd padded to 96 * NC: Q's boxes, then
// per stage K's boxes and V's boxes, then the mbarriers.  Every box starts
// 1024-byte aligned, as the 64-byte swizzle's 512-byte atoms need.
template <int NC>
struct Layout {
  static constexpr int kBoxes = 3 * NC;
  static constexpr int kQBox = kBQ * kRowBytes;
  static constexpr int kKVBox = kBK * kRowBytes;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kStage = 2 * kBoxes * kKVBox;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + 1024;
};

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

// One box (32 columns x rows) of a 3-D tensor map into shared memory;
// completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for the 64-byte swizzle: start
// address, leading and stride byte offsets (in 16-byte units), layout 2.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of wgmmas are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence, issue and wait (which name no registers of their own).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) . B (64 x 16, smem,
// K-major)^T; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 96, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x 96,
// smem, MN-major).
__device__ __forceinline__ void wgmma_pv(float (&d)[48], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// tanh(y) = 1 - 2 / (e^{2y} + 1) with the sign of y, from ex2.approx and
// rcp.approx: 2 MUFU and a few f32 operations where tanhf takes about 20;
// its error (about 1e-7 absolute, 5e-6 in a score capped at 50) moves p
// by about 5e-6 relative, far inside the bf16 output's ulp (2**-8).
__device__ __forceinline__ float fast_tanh(float y) {
  const float e = exp2f(2.885390081777927f * fabsf(y));   // e^{2|y|}
  return copysignf(1.f - __fdividef(2.f, e + 1.f), y);
}

// O += p_hi.V + p_lo.V for one tile of 64 keys: 16 keys a step, 96 columns
// a chunk, V (the tile's boxes from sV) as the MN-major B operand.
template <int NC>
__device__ __forceinline__ void issue_pv(float (&acc)[NC][48],
                                         const uint32_t* phi,
                                         const uint32_t* plo, uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t dv =
          sw64_desc(sV + 3 * c * (kBK * kRowBytes) + 16 * kk * kRowBytes,
                    kBK * kRowBytes, 8 * kRowBytes);
      wgmma_pv(acc[c], phi + 4 * kk, dv);
      wgmma_pv(acc[c], plo + 4 * kk, dv);
    }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           __nv_bfloat16* __restrict__ o, int H, int B, int S, int hd,
           int groups, float softcap, int window, int n_qtiles) {
  using L = Layout<NC>;
  constexpr int NB = L::kBoxes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sKV = base + L::kQ;
  const uint32_t bar_q = base + L::kBars;
  // per stage: K arrived, V arrived, K released, V released (+ 8 * stage)
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  // block -> (q tile, h, b), q tiles fastest and the last (heaviest)
  // first: the CTAs in flight at once share few (b, kv head)s, so their K
  // and V tiles come from L2
  int64_t idx = blockIdx.x;
  const int q0 = (n_qtiles - 1 - (int)(idx % n_qtiles)) * kBQ;
  idx /= n_qtiles;
  const int h = (int)(idx % H);
  const int b = (int)(idx / H);
  const int zq = b * H + h, zk = b * (H / groups) + h / groups;
  // key tiles [t_lo, t_hi): keys j > i - window for some row i >= q0, and
  // j < min(q0 + kBQ, S)
  const int64_t lo_w = (int64_t)q0 - window + 1;
  const int t_lo = lo_w > 0 ? (int)(lo_w / kBK) : 0;
  const int t_hi = (min(q0 + kBQ, S) + kBK - 1) / kBK;
  const int n_tiles = t_hi - t_lo;

  // the warp index through a shuffle, so ptxas sees it warp-uniform and
  // keeps every wgmma on a uniform path (else it serialises them)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2);    // one arrival per consumer
      mbar_init(empty_v + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int bx = 0; bx < NB; ++bx)
        tma_load(sQ + bx * L::kQBox, &tq, bar_q, bx * kBox, q0, zq);
      // K and V of a tile have barriers of their own: K is released once
      // S = Q.K^T is done, V only after O += P.V, a turn later
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, t0 = (t_lo + i) * kBK;
        const uint32_t parity = ((i / kStages) - 1) & 1;
        const uint32_t dK = sKV + s * L::kStage, dV = dK + NB * L::kKVBox;
        if (i >= kStages) mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, NB * L::kKVBox);
        for (int bx = 0; bx < NB; ++bx)
          tma_load(dK + bx * L::kKVBox, &tk, full_k + 8 * s, bx * kBox, t0,
                   zk);
        if (i >= kStages) mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, NB * L::kKVBox);
        for (int bx = 0; bx < NB; ++bx)
          tma_load(dV + bx * L::kKVBox, &tv, full_v + 8 * s, bx * kBox, t0,
                   zk);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2;                    // consumer 0 or 1
    const int qw0 = q0 + 64 * wg;                // its first row
    const int r0 = qw0 + 16 * (warp & 3) + (lane >> 2);   // rows r0, r0 + 8
    const int cq = 2 * (lane & 3);               // columns cq, cq + 1 of
                                                 // each 8-column block
    const uint32_t sQw = sQ + 64 * wg * kRowBytes;
    float acc[NC][48], sc[32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 48; ++i) acc[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;   // rows r0, r0 + 8
    const bool leader = (warp & 3) == 0 && lane == 0;   // signals the ring
    const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
    // p of the tile before (none before tile 0: zeros against V_0, an
    // exact no-op), waiting for its O += P.V
    uint32_t phi[16], plo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) phi[i] = plo[i] = 0u;
    mbar_wait(bar_q, 0);

    // Every tile runs the same wgmmas, also one in which no row of this
    // warpgroup keeps a key (its scores are all masked, so it adds 0):
    // wgmmas under a condition would be serialised.
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int t0 = (t_lo + i) * kBK;
      const int pv = i > 0 ? i - 1 : 0;        // the tile whose V is used
      const int sv = pv % kStages;
      mbar_wait(full_k + 8 * s, (i / kStages) & 1);
      mbar_wait(full_v + 8 * sv, (pv / kStages) & 1);

      // S = Q.K^T of this tile and O += P.V of the last one, issued
      // together; the softmax of this tile runs while the P.V (and the
      // other warpgroup's MMAs) still run
      pin(sc);
#pragma unroll
      for (int c = 0; c < NC; ++c) pin(acc[c]);
      wgmma_fence();
      const uint32_t sK = sKV + s * L::kStage;
#pragma unroll
      for (int t = 0; t < 2 * NB; ++t)
        wgmma_qk(sc,
                 sw64_desc(sQw + (t >> 1) * L::kQBox + (t & 1) * 32, 16,
                           8 * kRowBytes),
                 sw64_desc(sK + (t >> 1) * L::kKVBox + (t & 1) * 32, 16,
                           8 * kRowBytes),
                 t > 0);
      wgmma_commit();
      issue_pv<NC>(acc, phi, plo, sKV + sv * L::kStage + NB * L::kKVBox);
      wgmma_commit();
      wgmma_wait<1>();   // S is done; P.V of the last tile may still run
      pin(sc);
      if (leader) mbar_arrive(empty_k + 8 * s);

      // softcap, mask, row max (a row's 16 scores here, 64 over its quad);
      // the mask only where a tile crosses the diagonal, the window's
      // edge or S
      const bool edge = t0 + kBK - 1 > qw0 || t0 <= qw0 + 63 - window ||
                        t0 + kBK > S;
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e];
          if (softcap > 0.f) x = softcap * fast_tanh(x * inv_cap);
          if (edge) {
            const int qpos = r0 + 8 * (e >> 1);
            const int kpos = t0 + 8 * j + cq + (e & 1);
            const bool keep =
                kpos < S && kpos <= qpos && kpos > qpos - window;
            x = keep ? x : kNeg;
          }
          sc[4 * j + e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f((m0 - mn0) * kLog2e);
      const float al1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;

      // p in f32, in place of the scores
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mr = e < 2 ? mn0 : mn1;
          const float p = exp2f((sc[4 * j + e] - mr) * kLog2e);
          sc[4 * j + e] = p;
          if (e < 2)
            ps0 += p;
          else
            ps1 += p;
        }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;

      // the last tile's P.V is done: V's stage goes back, O and P are free
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) pin(acc[c]);
      if (leader && i > 0) mbar_arrive(empty_v + 8 * sv);
      // p split into bf16 p_hi + p_lo, packed as wgmma's A fragment:
      // register 2j + r holds keys 8j + cq, + 1 of row r0 + 8r
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float pa = sc[4 * j + 2 * r], pb = sc[4 * j + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pa, pb);
          const float2 hf = __bfloat1622float2(hi);
          phi[2 * j + r] = bf16x2_bits(hi);
          plo[2 * j + r] =
              bf16x2_bits(__floats2bfloat162_rn(pa - hf.x, pb - hf.y));
        }
      if (al0 != 1.f || al1 != 1.f) {   // the row maxima moved
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 12; ++j) {
            acc[c][4 * j] *= al0;
            acc[c][4 * j + 1] *= al0;
            acc[c][4 * j + 2] *= al1;
            acc[c][4 * j + 3] *= al1;
          }
      }
    }
    {   // the last tile's O += P.V
      const int sv = (n_tiles - 1) % kStages;
      mbar_wait(full_v + 8 * sv, ((n_tiles - 1) / kStages) & 1);
#pragma unroll
      for (int c = 0; c < NC; ++c) pin(acc[c]);
      wgmma_fence();
      issue_pv<NC>(acc, phi, plo, sKV + sv * L::kStage + NB * L::kKVBox);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) pin(acc[c]);
    }

    // epilogue: the quad's partial sums, one division, one rounding
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(kFull, l0, off);
      l1 += __shfl_xor_sync(kFull, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + (int64_t)zq * S * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = 96 * c + 8 * j + cq;
        if (col >= hd) continue;
        if (r0 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r0 * hd + col) =
              __floats2bfloat162_rn(__fdiv_rn(acc[c][4 * j], d0),
                                    __fdiv_rn(acc[c][4 * j + 1], d0));
        if (r0 + 8 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)(r0 + 8) * hd +
                                             col) =
              __floats2bfloat162_rn(__fdiv_rn(acc[c][4 * j + 2], d1),
                                    __fdiv_rn(acc[c][4 * j + 3], d1));
      }
  }
}

// cuTensorMapEncodeTiled, taken from the driver at run time so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a contiguous (Z, S, hd) bf16 tensor, boxes of 32 columns
// x `rows` rows of one z, 64-byte swizzle; reads outside the tensor give 0.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int S, int Z,
              int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)Z};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)hd * 2 * (cuuint64_t)S};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, void* o, int B, int H, int S, int hd,
           int groups, float softcap, int window, cudaStream_t st) {
  constexpr int bytes = Layout<NC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (S + kBQ - 1) / kBQ;
  const int64_t blocks = (int64_t)n_qtiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_sm90<NC><<<(unsigned)blocks, kThreads, bytes, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, B, S, hd, groups,
      softcap, window, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o, contiguous and 16-byte aligned; 8 <= hd <= 288 with
// hd % 8 == 0 (TMA's 16-byte row strides); window > 0 (the wrapper maps
// "no window" to 1 << 30, as JAX does); H % groups == 0.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int H, int S, int hd, int groups,
                                           float softcap, int window,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || S < 1 || hd < 8 || hd > 288 || hd % 8 != 0 ||
      groups < 1 || H % groups != 0 || window < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
      15)
    return (int)cudaErrorInvalidValue;
  const int Hkv = H / groups;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, hd, S, B * H, kBQ) ||
      !make_map(&mk, k, hd, S, B * Hkv, kBK) ||
      !make_map(&mv, v, hd, S, B * Hkv, kBK))
    return (int)cudaErrorInvalidValue;
  switch ((hd + 95) / 96) {
    case 1:
      return launch<1>(mq, mk, mv, o, B, H, S, hd, groups, softcap, window,
                       st);
    case 2:
      return launch<2>(mq, mk, mv, o, B, H, S, hd, groups, softcap, window,
                       st);
    default:
      return launch<3>(mq, mk, mv, o, B, H, S, hd, groups, softcap, window,
                       st);
  }
}
