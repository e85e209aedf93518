// Causal GQA attention forward for f32 inputs on the CUDA cores (sm_90a);
// bf16 inputs go to the tensor-core kernel of flash_attention_sm90.cu.
// Bound to Python with ctypes (see ../build.py and ../flash_attention.py).
// Plain C interface: the launcher takes device pointers and a
// cudaStream_t, launches on that stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so the wrapper can raise on a
// refused launch.
//
// flash_attention — replaces repro/kernels/flash_attention.py::_flash_kernel
//   (:34-55, pallas_call at :67) for f32 inputs.  For q (B, H, S, hd),
//   pre-scaled, and k, v (B, H/groups, S, hd), with kv head h / groups:
//     s[i][j] = sum_d q[i][d] * k[j][d]              (summed in f64 from the
//                                                      widened inputs, then
//                                                      rounded to f32)
//     s = softcap > 0 ? softcap * tanh(s / softcap) : s
//     s = (j <= i && j > i - window) ? s : -1e30
//     o[i] = sum_j exp(s[i][j] - m_i) v[j] / max(sum_j exp(s[i][j] - m_i),
//                                                 1e-30),  m_i = max_j s[i][j]
//   in f32.  The JAX kernel holds a whole row of scores at once; here the
//   row is walked tile by tile with an online softmax
//   (running max m, running sum l, accumulator rescaled by exp(m - m_new)).
//   Masked scores stay -1e30, as in JAX, never -inf: a tile in which a row
//   is wholly masked gives m = -1e30 and p = 1 on garbage, which the first
//   real score rescales by exp(-1e30 - m_real) = 0 exactly, and every row
//   has its diagonal, so no inf - inf ever arises.  expf, tanhf and an IEEE
//   division follow the JAX kernel's f32 arithmetic; the sums run in
//   another order than XLA's, so the result agrees with the plain version
//   within a stated tolerance, not bit for bit.
//   Bound on the H100: operations, 4 * hd flops per unmasked (q, k) pair,
//   half of them (q.k) on the f64 pipe (34 TFLOP/s) and half (p.v) on the
//   f32 pipe (67 TFLOP/s); bf16 tensor cores would round the inputs, so
//   f32 stays on the CUDA cores.  It runs only where a caller
//   asks for f32 (the serve path's dtype is bf16).
//   Design: one block of 256 threads per
//   (b, q head, tile of 64 query rows), heavy tiles (late rows, which see
//   the most keys) scheduled first.  The q tile sits in shared memory as
//   f32 for the whole block; k and v tiles of 32 rows are staged through
//   shared memory in turn, skipping tiles wholly above the diagonal or
//   wholly below the window.  Thread (ty, tx) of a 16 x 16 grid owns rows
//   ty + 16i (i < 4): in the score phase key columns tx + 16j (j < 2), in
//   the p.v phase output columns 4tx + 64jj (+0..3) in registers, so the
//   row statistics it needs are its own and the 16 threads of a row meet
//   in xor shuffles (every lane ends with the bitwise-same max and sum).
//   Row strides of 64*NJ + 4 floats keep the float4 reads of shared memory
//   free of bank conflicts.  Offsets are 64-bit.  No atomics: a run is
//   deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // key/value rows per tile
constexpr int kThreads = 256;    // a 16 x 16 grid
constexpr int kPS = kBK + 1;     // row stride of the p tile
constexpr float kNeg = -1e30f;   // JAX's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }

// Rows [0, rows) of a contiguous (rows, hd) source into shared memory of
// row stride ld, widened to f32; rows [rows, cap) get zeros.  Columns
// hd..ld-1 are never written (zeroed once at the start of the block).
// 16-byte loads where every row starts 16-byte aligned, else one element
// at a time.
template <typename T>
__device__ void load_rows(float* dst, const T* __restrict__ src, int rows,
                          int cap, int hd, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = hd % kVec == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    const int n = rows * hd / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint4 raw = __ldg(s4 + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      const int r = i * kVec / hd, c = i * kVec - r * hd;
      float* d = dst + r * ld + c;
#pragma unroll
      for (int u = 0; u < kVec; ++u) d[u] = widen(e[u]);
    }
  } else {
    const int n = rows * hd;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / hd;
      dst[r * ld + i - r * hd] = widen(src[i]);
    }
  }
  const int nz = (cap - rows) * hd;
  for (int i = threadIdx.x; i < nz; i += kThreads) {
    const int r = i / hd;
    dst[(rows + r) * ld + i - r * hd] = 0.f;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int B, int S,
          int hd, int groups, float softcap, int window, int n_qtiles) {
  constexpr int LD = 64 * NJ + 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                       // (kBQ, LD)
  float* Ks = Qs + kBQ * LD;              // (kBK, LD)
  float* Vs = Ks + kBK * LD;              // (kBK, LD)
  float* Ps = Vs + kBK * LD;              // (kBQ, kPS)

  // block -> (q tile, b, h), h fastest, the last q tiles first
  int64_t idx = blockIdx.x;
  const int h = (int)(idx % H);
  idx /= H;
  const int b = (int)(idx % B);
  const int qt = n_qtiles - 1 - (int)(idx / B);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, S - q0);
  const int Hkv = H / groups;
  const T* qb = q + ((int64_t)b * H + h) * S * hd + (int64_t)q0 * hd;
  const T* kb = k + ((int64_t)b * Hkv + h / groups) * S * hd;
  const T* vb = v + ((int64_t)b * Hkv + h / groups) * S * hd;
  T* ob = o + ((int64_t)b * H + h) * S * hd + (int64_t)q0 * hd;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int total = (kBQ + 2 * kBK) * LD + kBQ * kPS;
  for (int i = tid; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  load_rows(Qs, qb, q_rows, kBQ, hd, LD);

  float m[4], l[4];
  float4 acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // keys j with j > i - window for some row i >= q0, and j < q0 + q_rows
  const int64_t lo_w = (int64_t)q0 - window + 1;
  const int64_t lo = lo_w > 0 ? lo_w : 0;
  const int hi = q0 + q_rows;
  const int hd4 = (hd + 3) & ~3;
  for (int t0 = (int)(lo / kBK) * kBK; t0 < hi; t0 += kBK) {
    const int k_rows = min(kBK, S - t0);
    load_rows(Ks, kb + (int64_t)t0 * hd, k_rows, kBK, hd, LD);
    load_rows(Vs, vb + (int64_t)t0 * hd, k_rows, kBK, hd, LD);
    __syncthreads();

    // the q.k sums in f64: each product of two f32 is exact there and the
    // hd-term sum stays far below f32's rounding, so a score is its exact
    // value rounded once (an f32 chain of up to 288 fmaf lost up to about
    // 1.5 times JAX's f32 allowance on scores far past the softcap)
    double sd[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sd[i][0] = sd[i][1] = 0.0;
    for (int d = 0; d < hd4; d += 4) {
      float4 a[4], c[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        c[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sd[i][j] = fma((double)a[i].x, (double)c[j].x, sd[i][j]);
          sd[i][j] = fma((double)a[i].y, (double)c[j].y, sd[i][j]);
          sd[i][j] = fma((double)a[i].z, (double)c[j].z, sd[i][j]);
          sd[i][j] = fma((double)a[i].w, (double)c[j].w, sd[i][j]);
        }
    }
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = (float)sd[i][j];

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int64_t qpos = q0 + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int64_t kpos = t0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(__fdiv_rn(x, softcap));
        const bool keep = kpos < S && kpos <= qpos && kpos > qpos - window;
        s[i][j] = keep ? x : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * kPS + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(kFull, ps, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        acc[i][jj].x *= alpha;
        acc[i][jj].y *= alpha;
        acc[i][jj].z *= alpha;
        acc[i][jj].w *= alpha;
      }
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 w =
            *reinterpret_cast<const float4*>(Vs + c * LD + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj].x = fmaf(p[i], w.x, acc[i][jj].x);
          acc[i][jj].y = fmaf(p[i], w.y, acc[i][jj].y);
          acc[i][jj].z = fmaf(p[i], w.z, acc[i][jj].z);
          acc[i][jj].w = fmaf(p[i], w.w, acc[i][jj].w);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float a[4] = {acc[i][jj].x, acc[i][jj].y, acc[i][jj].z,
                          acc[i][jj].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = 4 * tx + 64 * jj + u;
        if (d < hd) narrow(__fdiv_rn(a[u], den), ob + (int64_t)r * hd + d);
      }
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int S, int hd, int groups, float softcap, int window,
           cudaStream_t st) {
  constexpr int LD = 64 * NJ + 4;
  const size_t shmem = sizeof(float) * ((kBQ + 2 * kBK) * LD + kBQ * kPS);
  cudaFuncSetAttribute(flash_fwd<T, NJ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)shmem);
  const int n_qtiles = (S + kBQ - 1) / kBQ;
  const int64_t blocks = (int64_t)n_qtiles * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd<T, NJ><<<(unsigned)blocks, kThreads, shmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, B, S, hd, groups,
      softcap, window, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 q, k, v, o.  window > 0 (the wrapper maps "no window" to 1 << 30, as
// JAX does); 1 <= hd <= 288; H % groups == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int S, int hd, int groups,
                                      float softcap, int window,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || S < 1 || hd < 1 || hd > 288 || groups < 1 ||
      H % groups != 0 || window < 1)
    return (int)cudaErrorInvalidValue;
#define FA_CALL(NJ) \
  launch<float, NJ>(q, k, v, o, B, H, S, hd, groups, softcap, window, st)
  switch ((hd + 63) / 64) {
    case 1: return FA_CALL(1);
    case 2: return FA_CALL(2);
    case 3: return FA_CALL(3);
    case 4: return FA_CALL(4);
    default: return FA_CALL(5);
  }
#undef FA_CALL
}
