// Streaming vocab-tiled cross-entropy for Hopper, sm_90a: forward (B) and
// the two backward contractions (C1: d hidden, C2: d W).
//
// Replaces the Pallas TPU kernels of the JAX package's
// kernels/cross_entropy.py:
//   B  cross_entropy_fwd_pallas     hidden [T, D], w [V, D], targets [T]
//      -> lse [T], tgt_logit [T] (float32), the [T, V] logits never stored;
//   C1 cross_entropy_bwd_dh_pallas  -> dh [T, D] in hidden's dtype;
//   C2 cross_entropy_bwd_dw_pallas  -> dW [V, D] in w's dtype;
// with coef[t, v] = (exp(logit - lse[t]) - [v == target[t]]) * g[t] and the
// logits recomputed tile by tile. Inputs (float32 or bf16) are upcast to
// float32 before every product, as the TPU kernels do; vocabulary entries
// beyond V are masked (logit -1e30 in B, coefficient 0 in C1/C2); a target
// outside [0, V) never matches. The caller pads T to a multiple of 64
// (targets -1, g 0 on pad rows) and D is a multiple of 32.
//
// Design. Every kernel is built on one logits tile: 32 "rows" by 64
// "columns" over the full D, streamed through shared memory in chunks of 32
// along D (the next chunk's global loads are in flight while the current
// one is multiplied), 256 threads each owning a 2 x 4 register tile.
//
// * B: rows are 32 tokens, columns 64 vocabulary entries; a block walks a
//   contiguous range of vocab tiles, folding each into running (max, sum,
//   target logit) per row. When the token tiles alone would leave the card
//   idle (short chunks), the vocabulary is split over up to 64 blocks per
//   token tile; each writes its partial (m, l, t), and the last block of a
//   token tile to finish (a per-tile arrival counter) merges them in split
//   order, so the result does not depend on the blocks' timing.
// * C1: rows are 32 tokens, columns walk the vocabulary; the block keeps a
//   float32 accumulator [32, DS] in shared memory and adds coef @ W[., DS].
// * C2: rows are 32 vocab entries, columns walk the tokens; accumulator
//   [32, DS] += coef^T @ h[., DS].
//   The TPU kernels hold a [BT, D] or [BV, D] accumulator in VMEM. A Hopper
//   block has at most 227 KB of shared memory, and 32 rows of D = 3072
//   floats take 393 KB, so D is split into DS <= 1152 columns per block and
//   each block recomputes its logits tiles: the recompute factor is
//   ceil(D / 1152) (1 at gemma3-1b's D = 1152, 3 at llama3.2-3b's D = 3072).
//   No atomics: every output element is summed by one thread in a fixed
//   order, so C1 and C2 are deterministic.
//
// Bound: operations. B is one product of 2 T V D flops, C1 and C2 two each
// (logits, then the contraction); at gemma3-1b's vocabulary and an 8,192
// token chunk that is 4.9 TFLOP per product against ~0.6 GB of inputs.
// These versions run the products on float32 FMAs (no tensor cores).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int R = 32;          // rows of the logits tile (accumulator rows)
constexpr int C = 64;          // columns of the logits tile
constexpr int KC = 32;         // D chunk streamed through shared memory
constexpr int LDA = R + 2;     // row strides of the [KC][.] chunk tiles
constexpr int LDB = C + 4;
constexpr int LDC = C + 4;     // coefficient tile [R][C]
constexpr int DS_MAX = 1152;   // accumulator columns per block (C1, C2)
constexpr int MAX_VSPLIT = 64; // vocab splits per token tile (B)
constexpr float NEG = -1e30f;

// Four consecutive elements of T, loaded raw (converted when stored).
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() { v = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The logits tile L[r][c] = sum_d A[a0 + r][d] * B[b0 + c][d] (rows past
// na / nb read as zeros). Thread (ty = tid / 16, tx = tid % 16) returns
// L[2 ty + i][4 tx + j] in acc[i][j]. A chunk is 32 rows x 32 d (one Vec4
// per thread), a B chunk 64 x 32 (two per thread), loaded into registers
// one chunk ahead and stored transposed ([d][row]) into shared memory.
template <typename T>
__device__ __forceinline__ void logits_tile(float (&acc)[2][4], const T* __restrict__ A,
                                            int a0, int na, const T* __restrict__ B,
                                            int b0, int nb, int D, float* sA, float* sB,
                                            int tid) {
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // unit u covers row u / 8, d offset (u % 8) * 4 of the chunk
  const int ar = tid >> 3, ak = (tid & 7) * 4;
  const int br0 = tid >> 3, br1 = (tid + NT) >> 3, bk = (tid & 7) * 4;
  const bool a_ok = a0 + ar < na, b0_ok = b0 + br0 < nb, b1_ok = b0 + br1 < nb;
  const T* pa = A + (size_t)(a0 + ar) * D + ak;
  const T* pb0 = B + (size_t)(b0 + br0) * D + bk;
  const T* pb1 = B + (size_t)(b0 + br1) * D + bk;
  Vec4<T> ra, rb0, rb1;
  ra.zero(); rb0.zero(); rb1.zero();
  if (a_ok) ra.load(pa);
  if (b0_ok) rb0.load(pb0);
  if (b1_ok) rb1.load(pb1);
  for (int k0 = 0; k0 < D; k0 += KC) {
    float f[4];
    ra.get(f);
#pragma unroll
    for (int e = 0; e < 4; ++e) sA[(ak + e) * LDA + ar] = f[e];
    rb0.get(f);
#pragma unroll
    for (int e = 0; e < 4; ++e) sB[(bk + e) * LDB + br0] = f[e];
    rb1.get(f);
#pragma unroll
    for (int e = 0; e < 4; ++e) sB[(bk + e) * LDB + br1] = f[e];
    __syncthreads();
    if (k0 + KC < D) {              // the next chunk's loads fly during the product
      if (a_ok) ra.load(pa + k0 + KC);
      if (b0_ok) rb0.load(pb0 + k0 + KC);
      if (b1_ok) rb1.load(pb1 + k0 + KC);
    }
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(sA + k * LDA + 2 * ty);
      const float4 b = *reinterpret_cast<const float4*>(sB + k * LDB + 4 * tx);
      acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
      acc[0][2] = fmaf(a.x, b.z, acc[0][2]);
      acc[0][3] = fmaf(a.x, b.w, acc[0][3]);
      acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
      acc[1][2] = fmaf(a.y, b.z, acc[1][2]);
      acc[1][3] = fmaf(a.y, b.w, acc[1][3]);
    }
    __syncthreads();
  }
}

// reductions over the 16 lanes that share a row pair (one half-warp)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// B: forward. grid (Tp / R token tiles, n_split vocab splits).
template <typename T>
__global__ void __launch_bounds__(NT)
ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
              const int* __restrict__ tgt, float* __restrict__ lse,
              float* __restrict__ tl, float* __restrict__ ws, int* __restrict__ arrivals,
              int Tp, int V, int D, int n_split) {
  __shared__ __align__(16) float sA[KC * LDA];
  __shared__ __align__(16) float sB[KC * LDB];
  __shared__ int s_last;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int t0 = blockIdx.x * R, z = blockIdx.y;
  const int n_vt = (V + C - 1) / C;
  const int per = (n_vt + n_split - 1) / n_split;
  const int vt_lo = z * per, vt_hi = min(n_vt, vt_lo + per);
  int tg[2];
  float m[2], l[2], t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tg[i] = tgt[t0 + 2 * ty + i];
    m[i] = NEG;
    l[i] = 0.f;
    t[i] = 0.f;
  }
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    float acc[2][4];
    logits_tile<T>(acc, h, t0, Tp, w, vt * C, V, D, sA, sB, tid);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vid = vt * C + 4 * tx + j;
        if (vid >= V) acc[i][j] = NEG;
        mx = fmaxf(mx, acc[i][j]);
        if (vid == tg[i]) t[i] += acc[i][j];
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += expf(acc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_sum(s);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) t[i] = half_sum(t[i]);
  if (n_split == 1) {
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse[t0 + 2 * ty + i] = m[i] + logf(fmaxf(l[i], 1e-30f));
        tl[t0 + 2 * ty + i] = t[i];
      }
    return;
  }
  // partial state of split z: ws [n_split][Tp][3] = (m, l, t)
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* p = ws + ((size_t)z * Tp + t0 + 2 * ty + i) * 3;
      p[0] = m[i];
      p[1] = l[i];
      p[2] = t[i];
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(arrivals + blockIdx.x, 1) == n_split - 1;
  __syncthreads();
  if (!s_last || tid >= R) return;
  // the last block of this token tile merges the splits in split order
  const int row = t0 + tid;
  float M = NEG;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, __ldcg(ws + ((size_t)s * Tp + row) * 3));
  float L = 0.f, Tt = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* p = ws + ((size_t)s * Tp + row) * 3;
    L += __ldcg(p + 1) * expf(__ldcg(p) - M);
    Tt += __ldcg(p + 2);
  }
  lse[row] = M + logf(fmaxf(L, 1e-30f));
  tl[row] = Tt;
}

// ---------------------------------------------------------------------------
// C1 (DW == false): out = dh [Tp, D]; rows = token tiles, stream = vocab.
// C2 (DW == true):  out = dW [V, D];  rows = vocab tiles, stream = tokens.
// grid (row tiles, D slices of width ds).
template <typename T, bool DW>
__global__ void __launch_bounds__(NT, 1)
ce_bwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
              const int* __restrict__ tgt, const float* __restrict__ lse,
              const float* __restrict__ g, T* __restrict__ out, int Tp, int V, int D,
              int ds) {
  extern __shared__ __align__(16) float smem[];
  float* acc_s = smem;                  // [R][ds]
  float* sA = acc_s + R * ds;           // [KC][LDA]
  float* sB = sA + KC * LDA;            // [KC][LDB]
  float* coef = sB + KC * LDB;          // [R][LDC]
  __shared__ int s_tgt[C];
  __shared__ float s_lse[C], s_g[C];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * R;
  const int d0 = blockIdx.y * ds, dn = min(ds, D - d0);
  const T* A = DW ? w : h;              // row source
  const T* B = DW ? h : w;              // stream source
  const int na = DW ? V : Tp, nb = DW ? Tp : V;
  const int n_st = (nb + C - 1) / C;
  for (int i = tid; i < R * ds; i += NT) acc_s[i] = 0.f;
  if (!DW && tid < R) {                 // per-token values of the rows
    s_tgt[tid] = tgt[r0 + tid];
    s_lse[tid] = lse[r0 + tid];
    s_g[tid] = g[r0 + tid];
  }
  __syncthreads();
  for (int st = 0; st < n_st; ++st) {
    const int c0 = st * C;
    if (DW && tid < C) {                // per-token values of the columns
      const bool ok = c0 + tid < Tp;
      s_tgt[tid] = ok ? tgt[c0 + tid] : -1;
      s_lse[tid] = ok ? lse[c0 + tid] : 0.f;
      s_g[tid] = ok ? g[c0 + tid] : 0.f;
    }
    float acc[2][4];
    logits_tile<T>(acc, A, r0, na, B, c0, nb, D, sA, sB, tid);  // syncs first
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * ty + i, c = 4 * tx + j;
        const int tok = DW ? c : r;                       // index into s_*
        const int vid = DW ? r0 + r : c0 + c;
        float cf = 0.f;
        if (vid < V) {
          const float p = expf(acc[i][j] - s_lse[tok]);
          cf = (p - (vid == s_tgt[tok] ? 1.f : 0.f)) * s_g[tok];
        }
        coef[r * LDC + c] = cf;
      }
    __syncthreads();
    // acc_s[r][d] += sum_c coef[r][c] * B[c0 + c][d0 + d]; each column d of
    // the slice belongs to one thread, which sums this tile's 64 terms of
    // its 32 rows in registers and then adds them to the accumulator (one
    // add per tile: a sum over 262,144 vocab entries would otherwise add
    // ~1e-10 terms one by one to a ~1e-6 total and lose their digits)
    for (int d = tid; d < dn; d += NT) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = 0.f;
      const T* bcol = B + (size_t)c0 * D + d0 + d;
#pragma unroll 2
      for (int c = 0; c < C; c += 8) {
        float b[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) b[e] = c0 + c + e < nb ? to_f(bcol[(size_t)(c + e) * D]) : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(coef + r * LDC + c);
          const float4 y = *reinterpret_cast<const float4*>(coef + r * LDC + c + 4);
          float s = a[r];
          s = fmaf(x.x, b[0], s);
          s = fmaf(x.y, b[1], s);
          s = fmaf(x.z, b[2], s);
          s = fmaf(x.w, b[3], s);
          s = fmaf(y.x, b[4], s);
          s = fmaf(y.y, b[5], s);
          s = fmaf(y.z, b[6], s);
          s = fmaf(y.w, b[7], s);
          a[r] = s;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc_s[r * ds + d] += a[r];
    }
    __syncthreads();                    // coef and the s_* columns rewritten next
  }
  for (int i = tid; i < R * dn; i += NT) {
    const int r = i / dn, d = i % dn;
    if (r0 + r < na) out[(size_t)(r0 + r) * D + d0 + d] = from_f<T>(acc_s[r * ds + d]);
  }
}

size_t bwd_smem(int ds) {
  return sizeof(float) * ((size_t)R * ds + KC * LDA + KC * LDB + R * LDC);
}

template <typename T, bool DW>
int launch_bwd(const void* h, const void* w, const void* tgt, const void* lse,
               const void* g, void* out, int Tp, int V, int D, int n_ds,
               cudaStream_t stream) {
  const int ds = ((D + n_ds - 1) / n_ds + KC - 1) / KC * KC;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ce_bwd_kernel<T, DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bwd_smem(DS_MAX));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = DW ? V : Tp;
  dim3 grid((rows + R - 1) / R, n_ds);
  ce_bwd_kernel<T, DW><<<grid, NT, bwd_smem(ds), stream>>>(
      (const T*)h, (const T*)w, (const int*)tgt, (const float*)lse, (const float*)g,
      (T*)out, Tp, V, D, ds);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes the caller pads to, the largest vocab split of the forward,
// and the accumulator width that sets the backward's D slices.
int cross_entropy_token_multiple() { return 2 * R; }
int cross_entropy_vocab_tile() { return C; }
int cross_entropy_max_vsplit() { return MAX_VSPLIT; }
int cross_entropy_ds_max() { return DS_MAX; }

// B. h [Tp, D], w [V, D] (dtype 0 = float32, 1 = bfloat16), tgt [Tp] int32
// -> lse, tl [Tp] float32. n_split > 1 needs ws (n_split * Tp * 3 floats)
// and arrivals (Tp / 32 ints, zeroed). Returns a cudaError_t code.
int cross_entropy_fwd(const void* h, const void* w, const void* tgt, void* lse, void* tl,
                      void* ws, void* arrivals, int Tp, int V, int D, int dtype,
                      int n_split, void* stream) {
  if (Tp <= 0 || Tp % (2 * R) || V <= 0 || D <= 0 || D % KC || n_split < 1 ||
      n_split > MAX_VSPLIT || (n_split > 1 && (ws == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(Tp / R, n_split);
  if (dtype == 0)
    ce_fwd_kernel<float><<<grid, NT, 0, st>>>(
        (const float*)h, (const float*)w, (const int*)tgt, (float*)lse, (float*)tl,
        (float*)ws, (int*)arrivals, Tp, V, D, n_split);
  else if (dtype == 1)
    ce_fwd_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        (const __nv_bfloat16*)h, (const __nv_bfloat16*)w, (const int*)tgt, (float*)lse,
        (float*)tl, (float*)ws, (int*)arrivals, Tp, V, D, n_split);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// C1 (which == 0): out = dh [Tp, D] in h's dtype; C2 (which == 1): out = dW
// [V, D] in w's dtype. lse and g [Tp] float32 (g = 0 on rows that carry no
// loss). n_ds = number of D slices. Returns a cudaError_t code.
int cross_entropy_bwd(const void* h, const void* w, const void* tgt, const void* lse,
                      const void* g, void* out, int Tp, int V, int D, int dtype,
                      int which, int n_ds, void* stream) {
  if (Tp <= 0 || Tp % (2 * R) || V <= 0 || D <= 0 || D % KC || n_ds < 1 ||
      (D + n_ds - 1) / n_ds > DS_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && which == 0)
    return launch_bwd<float, false>(h, w, tgt, lse, g, out, Tp, V, D, n_ds, st);
  if (dtype == 0 && which == 1)
    return launch_bwd<float, true>(h, w, tgt, lse, g, out, Tp, V, D, n_ds, st);
  if (dtype == 1 && which == 0)
    return launch_bwd<__nv_bfloat16, false>(h, w, tgt, lse, g, out, Tp, V, D, n_ds, st);
  if (dtype == 1 && which == 1)
    return launch_bwd<__nv_bfloat16, true>(h, w, tgt, lse, g, out, Tp, V, D, n_ds, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
