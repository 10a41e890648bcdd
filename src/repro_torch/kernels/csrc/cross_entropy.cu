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
// logits recomputed tile by tile. The TPU kernels upcast bf16 h and W to
// float32 before each product; a product of two bf16 values is exact in
// float32, so bf16 tensor-core products with float32 sums compute the same
// logits (only the order of the sums differs). Vocabulary entries beyond V
// are masked (logit -1e30 in B, coefficient 0 in C1/C2); a target outside
// [0, V) never matches. The caller pads T to a multiple of 64 (targets -1,
// g 0 on pad rows) and D is a multiple of 32.
//
// Bound: operations. B is one product of 2 T V D flops, C1 and C2 two each
// (logits, then the contraction): on gemma3-1b's head (V 262,144, D 1,152)
// and a 28,032-token train chunk, 16.9 TFLOP per product, 17.1 ms at the
// H100's 989 TFLOP/s for bf16, against ~0.67 GB of inputs (0.2 ms).
//
// bf16 (the train paths): three kernels on mma.sync m16n8k16 (bf16
// operands, float32 sums), 8 warps, tiles brought into shared memory by
// cp.async and read into fragments by ldmatrix (helpers in sm90_mma.cuh).
//
// * B, ce_fwd_mma_kernel: a block owns 128 tokens and walks a contiguous
//   range of 128-entry vocab tiles; each tile's logits [128, 128] come from
//   a 3-stage ring of 64-column chunks of h and W (2 x 18 KB a stage), each
//   warp a 32 x 64 piece. The online softmax stays in registers: each
//   thread keeps (max, sum) over its own columns for its 4 rows across all
//   tiles of its range (the one thread whose columns hold a row's target
//   writes its logit to shared memory); at the end the 4 lanes of a row
//   merge by shuffles, then the two warps of a row through shared memory.
//   128 registers, 109 KB: two blocks per SM.
//   Reuse: every (block, vocab tile) reads its 128 h rows and 128 W rows
//   over D from L2: T V D 2 (1/128 + 1/128) bytes, 265 GB on the gemma
//   chunk. The grid is ordered so that the resident blocks stay in L2:
//   block b takes token tile b / S and vocab split b % S with S ~
//   sqrt(2 * SMs) (17 on the H100), so the 264 blocks of a wave hold ~16 h
//   tiles and ~17 W ranges and walk them in step (~10 MB at D 1,152): h
//   comes from device memory once, W once per wave (~14 waves, 8.5 GB).
//   Each split writes its partial (m, l, t); the last block of a token tile
//   to finish (a per-tile arrival counter) merges them in split order, so
//   the result does not depend on the blocks' timing.
// * C1, ce_bwd_dh_mma_kernel<NP>: a thread-block cluster owns 64 tokens; its
//   G CTAs (one per SM) split D into slices of 64 NP <= 384 columns (G = 3
//   at gemma3-1b's D 1,152, 5 at hymba's 1,600, 8 at llama3.2-3b's 3,072;
//   at most 16), or of 448 (NP 7) where that brings G from above 8 to 8
//   (qwen2-vl-7b's D 3,584): on the H100 7 clusters of 10 or 14 CTAs are
//   resident at once (70 or 98 of 132 SMs), 15 of 7 (PERF.md). A CTA
//   keeps its h slice [64, slice] resident and walks all vocab tiles of
//   64, the next W tile [64, slice] loading (cp.async, double buffer)
//   while this one serves both products:
//   - P1: partial logits [64, 64] over its columns (16 x 32 a warp, two
//     sets of sums for independent MMAs);
//   - the partials, stored in fragment order, summed over the cluster
//     through distributed shared memory in rank order (16-byte loads), so
//     every CTA holds the same logits; the W copies are issued between the
//     two halves of the cluster barrier;
//   - the coefficient, formed in registers and rounded to bf16 (the one
//     rounding the TPU kernel does not make: it meets bf16 only as the
//     next product's operand), to shared memory, since every warp needs
//     all 64 rows of it;
//   - P2: dh[64, slice] += coef [64, 64] @ W[64, slice], 32 rows x a
//     quarter of the slice a warp, the float32 accumulator in registers
//     (16 NP a thread; 119-205 registers with the logits and addressing
//     up to NP 6, one CTA per SM, 188 KB of shared memory at NP 6). NP is
//     a template parameter so that no MMA is guarded at run time.
//   The cluster is what keeps the accumulator in registers without a
//   recompute: one CTA's registers hold [32, 1152] at most, and a token
//   tile of 32 reads all of W from L2 twice (once per product) for every
//   32 tokens (1.19 TB on the gemma chunk: bound by L2 on the H100). Here
//   each W element leaves L2 once per 64 tokens and serves both products:
//   T V D 2 / 64 bytes, 265 GB on the gemma chunk, plus the exchange of
//   partial logits through distributed shared memory, (G - 1) 16 KB per
//   CTA and tile. Clusters run in token order, so a wave (~44 clusters,
//   ~2,800 tokens) walks the vocabulary in step and reads W from device
//   memory once. What bounds it now: P1's ldmatrix traffic (3 per 4 MMAs)
//   and the exchange's latency; wgmma would read each operand tile once
//   per warpgroup.
//   Precision: dh sums up to 262,144 vocab terms of ~1e-10 into totals of
//   ~1e-6; mma.sync adds 16 terms at a time into the float32 accumulator,
//   16,384 adds at most.
// * C2, ce_bwd_dw_mma_kernel<NP>: C1's design with the roles of h and W
//   swapped (one body, ce_bwd_mma_body<NP, DW>): a cluster owns 64
//   vocabulary entries, its CTAs keep their W slice [64, slice] resident
//   and walk all token tiles of 64, the next h tile [64, slice] (and its
//   tokens' lse, g and target, into shared memory) loading while this one
//   serves both products. P1 gives the partial logits [64 vocab, 64
//   tokens], summed over the cluster in rank order; the coefficient (0 for
//   an entry past V: hymba's V of 32,001 leaves a ragged last tile; pad
//   tokens carry g = 0) is rounded to bf16 as P2's operand, as in C1; P2
//   accumulates dW [64, slice] += coef @ h [64 tokens, slice] in registers
//   over all token tiles, and the one owner writes it once, in w's dtype:
//   no atomics. Traffic: each h element leaves L2 once per 64 vocabulary
//   entries (T V D 2 / 64 bytes, 265 GB on the gemma chunk, as for C1);
//   clusters run in vocab order, so a wave walks the tokens in step and
//   reads h from device memory about once per wave. dW sums up to ~28k
//   token terms per element, 16 per mma.sync.
//
// float32 (train_verify and its exact checks) keeps FMA bodies on one 32 x
// 64 logits tile over the full D, streamed through shared memory in
// chunks of 32 along D, 256 threads each owning a 2 x 4 register tile:
// * B (ce_fwd_kernel): rows are 32 tokens, columns 64 vocabulary entries;
//   a block walks a contiguous range of vocab tiles, folding each into
//   running (max, sum, target logit) per row; short chunks split the
//   vocabulary over up to 64 blocks per token tile, merged as above. A
//   target past V is dropped first (it would meet a masked column of the
//   last, padded tile).
// * C1 (ce_bwd_kernel<dh>): rows are 32 tokens, columns walk the
//   vocabulary; a float32 accumulator [32, DS] in shared memory.
// * C2 (ce_bwd_kernel<dw>): rows are 32 vocab entries, columns walk the
//   tokens; accumulator [32, DS] += coef^T @ h[., DS].
//   A Hopper block has at most 227 KB of shared memory, so D is split into
//   DS <= 1152 columns per block and each block recomputes its logits.
// No atomics on outputs: every output element has one writer that sums
// in a fixed order, so every kernel is deterministic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "sm90_mma.cuh"

namespace cg = cooperative_groups;

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

// Four consecutive elements of T, loaded raw (converted when stored); the
// FMA kernels run float32 only (bf16 runs the tensor-core kernels below).
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

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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
    const int x = tgt[t0 + 2 * ty + i];
    tg[i] = x >= 0 && x < V ? x : -1;    // past V it would meet a masked column
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
               const void* g, void* out, int Tp, int V, int D, int ds,
               cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ce_bwd_kernel<T, DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bwd_smem(DS_MAX));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = DW ? V : Tp;
  dim3 grid((rows + R - 1) / R, (D + ds - 1) / ds);
  ce_bwd_kernel<T, DW><<<grid, NT, bwd_smem(ds), stream>>>(
      (const T*)h, (const T*)w, (const int*)tgt, (const float*)lse, (const float*)g,
      (T*)out, Tp, V, D, ds);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (the header sets out the design)

using bf16 = __nv_bfloat16;
constexpr int NTM = 256;            // threads: 8 warps
constexpr int PADK = 8;             // bf16 padding per shared row (ldmatrix banks)
constexpr float LOG2E = 1.4426950408889634f;

// B
constexpr int FB_T = 128;           // tokens per block
constexpr int FB_V = 128;           // vocab entries per tile
constexpr int FB_K = 64;            // D columns per stage
constexpr int FB_LD = FB_K + PADK;
constexpr int FB_STAGES = 3;
constexpr int FB_STAGE = (FB_T + FB_V) * FB_LD;   // bf16 elements a stage
constexpr size_t FB_SMEM = sizeof(bf16) * FB_STAGES * FB_STAGE;

// C1
constexpr int DH_T = 64;            // tokens per cluster
constexpr int DH_V = 64;            // vocab entries per tile
constexpr int DG_MAX = 384;         // D columns per CTA of the cluster
constexpr int DG_WIDE = 448;        // ... where 384 would need more than 8 CTAs
constexpr int DH_GRAN = 64;         // their multiple: 4 column quarters x 16
constexpr int DH_MAX_CLUSTER = 16;  // CTAs per cluster (non-portable above 8)
constexpr int DH_LDC = DH_V + PADK; // coefficient tile [DH_T][DH_LDC]
// row stride of the h and W tiles of a CTA of 64 NP columns, and its shared
// memory (188 KB at NP 6, 212 KB at 7)
template <int NP>
__host__ __device__ constexpr int dh_ldg() { return 64 * NP + PADK; }
template <int NP>
constexpr size_t dh_smem() {
  return sizeof(bf16) * (size_t)((DH_T + 2 * DH_V) * dh_ldg<NP>() + DH_T * DH_LDC) +
         sizeof(float) * 2 * DH_T * DH_V;
}

// Issue the copy of ROWS rows (row0 .. of src [n_rows, D]; rows at or past
// n_rows zero-filled) x KC columns (k0 ..; columns at or past D zero-filled)
// into dst [ROWS][LD]: thread tid copies 16 bytes of rows tid / (KC / 8) +
// i * NTM / (KC / 8).
template <int ROWS, int KC_, int LD>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int n_rows, int k0, int D, int tid) {
  constexpr int CH = KC_ / 8, STEP = NTM / CH;
  static_assert(NTM % CH == 0 && ROWS % STEP == 0, "tile not a multiple of a pass");
  const int r = tid / CH, ch = tid % CH, col = k0 + ch * 8;
  const bool col_ok = col < D;
  const bf16* p = src + (size_t)(row0 + r) * D + col;
  bf16* q = dst + r * LD + ch * 8;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const bool ok = col_ok && row0 + r + i * STEP < n_rows;
    cp_async16(q + i * STEP * LD, ok ? p + (size_t)i * STEP * D : src, ok);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x, ~2 ulp; 0 far below
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (m, l) of two partial softmax sums over the same row -> their union
__device__ __forceinline__ void merge_ml(float& m, float& l, float mo, float lo) {
  const float M = fmaxf(m, mo);
  l = l * exp2f((m - M) * LOG2E) + lo * exp2f((mo - M) * LOG2E);
  m = M;
}

// B, bf16. 1-D grid of n_tt * n_split blocks: block b takes token tile
// b / n_split and vocab split b % n_split (tiles [z n_vt / S, (z + 1) n_vt / S)).
__global__ void __launch_bounds__(NTM, 2)
ce_fwd_mma_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                  const int* __restrict__ tgt, float* __restrict__ lse,
                  float* __restrict__ tl, float* __restrict__ ws,
                  int* __restrict__ arrivals, int Tp, int V, int D, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float s_t[FB_T];         // target logits (one writer a row: its tile's column)
  __shared__ int s_tg[FB_T];          // targets, -1 outside [0, V)
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;      // 32-row strip, 64-column half
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tt = blockIdx.x / n_split, z = blockIdx.x % n_split;
  const int t0 = tt * FB_T;
  const int n_vt = (V + FB_V - 1) / FB_V;
  const int vt_lo = (int)((long long)z * n_vt / n_split);
  const int vt_hi = (int)((long long)(z + 1) * n_vt / n_split);
  const int n_k = (D + FB_K - 1) / FB_K;
  const int n_steps = (vt_hi - vt_lo) * n_k;

  // this thread's rows: 32 wm + 16 mi + 8 hh + g8; a target outside [0, V)
  // never matches
  float m[2][2], l[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[mi][hh] = NEG;
      l[mi][hh] = 0.f;
    }
  if (tid < FB_T) {                   // ordered before any use by the loop's barrier
    const int x = t0 + tid < Tp ? tgt[t0 + tid] : -1;
    s_tg[tid] = x >= 0 && x < V ? x : -1;
    s_t[tid] = 0.f;
  }

  // step s: vocab tile vt_lo + s / n_k, D columns (s % n_k) * FB_K ..
  auto issue = [&](int s) {
    if (s < n_steps) {
      bf16* st = ring + (s % FB_STAGES) * FB_STAGE;
      const int k0 = (s % n_k) * FB_K;
      copy_tile<FB_T, FB_K, FB_LD>(st, h, t0, Tp, k0, D, tid);
      copy_tile<FB_V, FB_K, FB_LD>(st + FB_T * FB_LD, w, (vt_lo + s / n_k) * FB_V, V, k0, D,
                                   tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < FB_STAGES - 1; ++s) issue(s);

  const int a_off = (32 * wm + (lane & 15)) * FB_LD + (lane >> 4) * 8;
  const int b_off = (64 * wn + ((lane >> 4) << 3) + (lane & 7)) * FB_LD + ((lane >> 3) & 1) * 8;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<FB_STAGES - 2>();   // step s has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; step s - 1's stage is free
    issue(s + FB_STAGES - 1);
    const bf16* sA = ring + (s % FB_STAGES) * FB_STAGE;
    const bf16* sB = sA + FB_T * FB_LD;
#pragma unroll
    for (int kk = 0; kk < FB_K; kk += 16) {
      uint32_t a0[4], a1[4];
      ldsm4(a0, sA + a_off + kk);
      ldsm4(a1, sA + a_off + 16 * FB_LD + kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, sB + b_off + np * 16 * FB_LD + kk);
        mma16816(acc[0][2 * np], a0, b[0], b[1]);
        mma16816(acc[0][2 * np + 1], a0, b[2], b[3]);
        mma16816(acc[1][2 * np], a1, b[0], b[1]);
        mma16816(acc[1][2 * np + 1], a1, b[2], b[3]);
      }
    }
    if (s % n_k != n_k - 1) continue;
    // the tile's logits are complete: fold them into (m, l, t) per row;
    // column of acc[.][nj][2 hh + e] is c0 + 8 nj + e
    const int v0 = (vt_lo + s / n_k) * FB_V;
    const int c0 = v0 + 64 * wn + 2 * t4;
    const bool tail = v0 + FB_V > V;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[mi][hh];
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!tail || c0 + 8 * nj + e < V) mx = fmaxf(mx, acc[mi][nj][2 * hh + e]);
        const float mxl = mx * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(fmaf(acc[mi][nj][2 * hh + e], LOG2E, -mxl));
            sum += (!tail || c0 + 8 * nj + e < V) ? p : 0.f;
          }
        l[mi][hh] = l[mi][hh] * fast_exp2((m[mi][hh] - mx) * LOG2E) + sum;
        m[mi][hh] = mx;
        const int rel = s_tg[32 * wm + 16 * mi + 8 * hh + g8] - c0;
        if (rel >= 0 && rel < 64) {
#pragma unroll
          for (int nj = 0; nj < 8; ++nj)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (rel == 8 * nj + e) s_t[32 * wm + 16 * mi + 8 * hh + g8] = acc[mi][nj][2 * hh + e];
        }
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  }
  cp_async_wait<0>();

  // merge the 4 lanes of a row (shuffles), then the two column halves
  // (shared memory, half 1 into half 0): a fixed order
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[mi][hh], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[mi][hh], off);
        merge_ml(m[mi][hh], l[mi][hh], mo, lo);
      }
  __syncthreads();                    // the ring is free: reuse it
  float* red = reinterpret_cast<float*>(smem_raw);   // [FB_T][2]
  if (wn == 1 && t4 == 0)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* p = red + (32 * wm + 16 * mi + 8 * hh + g8) * 2;
        p[0] = m[mi][hh];
        p[1] = l[mi][hh];
      }
  __syncthreads();
  if (wn == 0 && t4 == 0)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 32 * wm + 16 * mi + 8 * hh + g8, row = t0 + r;
        const float* p = red + r * 2;
        merge_ml(m[mi][hh], l[mi][hh], p[0], p[1]);
        const float tt_ = s_t[r];
        if (row >= Tp) continue;
        if (n_split == 1) {
          lse[row] = m[mi][hh] + logf(fmaxf(l[mi][hh], 1e-30f));
          tl[row] = tt_;
        } else {              // partial state of split z: ws [n_split][Tp][3]
          float* q = ws + ((size_t)z * Tp + row) * 3;
          q[0] = m[mi][hh];
          q[1] = l[mi][hh];
          q[2] = tt_;
        }
      }
  if (n_split == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(arrivals + tt, 1) == n_split - 1;
  __syncthreads();
  if (!s_last || tid >= FB_T || t0 + tid >= Tp) return;
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

// Dynamic shared memory above 48 KB, and the largest carveout so that two
// B blocks fit on one SM; once per kernel.
template <typename K>
int allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  done = e == cudaSuccess;
  return (int)e;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// C1 and C2, bf16: one body, two kernels. A cluster of G CTAs owns 64
// resident rows; CTA c of it owns the D columns [c dg, min((c + 1) dg, D))
// of them, dg = 64 NP (G = ceil(D / dg); 1-D grid of n_res_tiles * G
// blocks). The CTA walks every tile of 64 streamed rows; per tile: the
// partial logits over the CTA's columns (P1), summed over the cluster
// through distributed shared memory in rank order (so every CTA holds the
// same logits), the coefficient, then out[resident rows, columns] += coef
// @ streamed tile[., columns] (P2). The streamed tile [64][dg] serves both
// products and the next one loads while this one is in use; the resident
// rows [64][dg] stay in shared memory.
//   C1 (DW false): resident = 64 tokens of h, streamed = vocab tiles of W,
//                  out = dh; the per-token lse, g, target are the rows'.
//   C2 (DW true):  resident = 64 vocabulary entries of W (rows at or past V
//                  zero-filled, coefficient 0), streamed = token tiles of h
//                  (Tp is a multiple of 64: every tile is whole), out = dW;
//                  the per-token lse, g, target are the columns', loaded
//                  with each tile.
template <int NP, bool DW>
__device__ __forceinline__ void ce_bwd_mma_body(const bf16* __restrict__ h,
                                                const bf16* __restrict__ w,
                                                const int* __restrict__ tgt,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ g,
                                                bf16* __restrict__ out, int Tp, int V, int D) {
  static_assert(DH_T == DH_V, "resident and streamed tiles share one size");
  constexpr int R64 = DH_T;
  constexpr int DG = 64 * NP, QW = 16 * NP;   // columns of the CTA, of a warp in P2
  constexpr int DH_LDG = dh_ldg<NP>();
  constexpr int CHR = DG / 8;                 // 16-byte chunks of a row
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sR = reinterpret_cast<bf16*>(smem_raw);        // [R64][DH_LDG] resident
  bf16* sS = sR + R64 * DH_LDG;                        // [2][R64][DH_LDG] streamed
  float4* xS = reinterpret_cast<float4*>(sS + 2 * R64 * DH_LDG);  // [2][4][NTM]
  bf16* sC = reinterpret_cast<bf16*>(xS + 2 * 4 * NTM);           // [R64][DH_LDC]
  __shared__ float s_lse[2][R64], s_g[2][R64];   // C2: the streamed tokens'
  __shared__ int s_tg[2][R64];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int G = (D + DG - 1) / DG, rank = (int)cluster.block_rank();
  const int r0 = (blockIdx.x / G) * R64, d0 = rank * DG, dn = min(DG, D - d0);
  const bf16* res = DW ? w : h;
  const bf16* str = DW ? h : w;
  const int n_res = DW ? V : Tp, n_str = DW ? Tp : V;
  const int n_st = (n_str + R64 - 1) / R64;

  // copies: warp w takes rows w, w + 8, ..; lane l chunks l, l + 32 of a
  // row (columns at or past D zero-filled, rows at or past n_rows too)
  constexpr int CPL = (CHR + 31) / 32;
  auto load_rows = [&](bf16* dst, const bf16* __restrict__ src, int row0, int n_rows) {
    for (int r = warp; r < R64; r += NTM / 32) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int ch = lane + 32 * j;
        if (ch < CHR) {
          const bool ok = row0 + r < n_rows && d0 + ch * 8 < D;
          cp_async16(dst + r * DH_LDG + ch * 8,
                     ok ? src + (size_t)(row0 + r) * D + d0 + ch * 8 : src, ok);
        }
      }
    }
  };
  // C2: the per-token values of streamed tile st (lse, g, target; one word
  // a thread)
  auto load_tokens = [&](int buf, int st) {
    if (DW && tid < 3 * R64) {
      const int which = tid / R64, r = tid % R64, row = st * R64 + r;
      const void* src = which == 0 ? (const void*)(lse + row)
                      : which == 1 ? (const void*)(g + row) : (const void*)(tgt + row);
      void* dst = which == 0 ? (void*)&s_lse[buf][r]
                : which == 1 ? (void*)&s_g[buf][r] : (void*)&s_tg[buf][r];
      cp_async4(dst, src, true);
    }
  };
  load_rows(sR, res, r0, n_res);
  load_rows(sS, str, 0, n_str);
  load_tokens(0, 0);
  cp_async_commit();

  // P1: 16 rows x 32 streamed columns a warp; P2: 32 rows x QW columns
  const int wm = warp & 3, wn = warp >> 2;
  const int pm = warp & 1, pq = warp >> 1;
  // this thread's logits rows 16 wm + 8 hh + g8: C1 their tokens' lse (log2
  // units), g and target; C2 their vocabulary entries
  float lse2[2] = {0.f, 0.f}, gr[2] = {0.f, 0.f};
  int tg[2] = {-1, -1}, vid_r[2] = {0, 0};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 16 * wm + 8 * hh + g8;
    if (DW) {
      vid_r[hh] = row;
    } else {
      lse2[hh] = lse[row] * LOG2E;
      gr[hh] = g[row];
      const int x = tgt[row];
      tg[hh] = x >= 0 && x < V ? x : -1;
    }
  }
  const int a1_off = (16 * wm + (lane & 15)) * DH_LDG + (lane >> 4) * 8;
  const int b1_off = (32 * wn + ((lane >> 4) << 3) + (lane & 7)) * DH_LDG + ((lane >> 3) & 1) * 8;
  const int c_off = (32 * pm + (lane & 15)) * DH_LDC + (lane >> 4) * 8;
  const int x_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * DH_LDG + pq * QW + (lane >> 4) * 8;
  float acc[2][2 * NP][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2 * NP; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    const int buf = st & 1;
    const bf16* St = sS + buf * R64 * DH_LDG;
    cp_async_wait<0>();               // tile st has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; P2 of tile st - 1 is done

    // P1: partial logits over this CTA's columns, two sets of sums (even
    // and odd 16-column steps) for twice the independent products
    float s0[4][4], s1[4][4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s0[nj][e] = s1[nj][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < dn; kk += 32) {
      uint32_t a[4], b[4];
      ldsm4(a, sR + a1_off + kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldsm4(b, St + b1_off + np * 16 * DH_LDG + kk);
        mma16816(s0[2 * np], a, b[0], b[1]);
        mma16816(s0[2 * np + 1], a, b[2], b[3]);
      }
      ldsm4(a, sR + a1_off + kk + 16);    // dn is a multiple of 32
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldsm4(b, St + b1_off + np * 16 * DH_LDG + kk + 16);
        mma16816(s1[2 * np], a, b[0], b[1]);
        mma16816(s1[2 * np + 1], a, b[2], b[3]);
      }
    }
    // the partials in fragment order: thread tid's 16 values at [4][NTM]
    float4* xs = xS + buf * 4 * NTM;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      xs[nj * NTM + tid] = make_float4(s0[nj][0] + s1[nj][0], s0[nj][1] + s1[nj][1],
                                       s0[nj][2] + s1[nj][2], s0[nj][3] + s1[nj][3]);
    cluster_arrive();                 // this CTA's partials are written
    if (st + 1 < n_st) {
      load_rows(sS + (buf ^ 1) * R64 * DH_LDG, str, (st + 1) * R64, n_str);
      load_tokens(buf ^ 1, st + 1);
    }
    cp_async_commit();
    cluster_wait();                   // ... and every other CTA's
    // the logits: the partials summed in rank order
    float4 sum[4];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) sum[nj] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < DH_MAX_CLUSTER; ++r) {
      if (r < G) {
        const float4* xr = cluster.map_shared_rank(xs, r);
        float4 v[4];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) v[nj] = xr[nj * NTM + tid];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          sum[nj].x += v[nj].x;
          sum[nj].y += v[nj].y;
          sum[nj].z += v[nj].z;
          sum[nj].w += v[nj].w;
        }
      }
    }
    // coef = (exp(S - lse) - [v == target]) g, 0 for a vocabulary entry
    // past V, as bf16
    {
      const int cl = 32 * wn + 2 * t4, c0 = st * R64;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float sv[2] = {hh ? sum[nj].z : sum[nj].x, hh ? sum[nj].w : sum[nj].y};
          float cf[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = cl + 8 * nj + e;
            if (DW) {                 // row: vocabulary entry; column: token c
              const float p = fast_exp2(fmaf(sv[e], LOG2E, -s_lse[buf][c] * LOG2E));
              cf[e] = vid_r[hh] < V
                          ? (p - (vid_r[hh] == s_tg[buf][c] ? 1.f : 0.f)) * s_g[buf][c]
                          : 0.f;
            } else {                  // row: token; column: vocabulary entry
              const int vid = c0 + c;
              const float p = fast_exp2(fmaf(sv[e], LOG2E, -lse2[hh]));
              cf[e] = vid < V ? (p - (vid == tg[hh] ? 1.f : 0.f)) * gr[hh] : 0.f;
            }
          }
          *reinterpret_cast<uint32_t*>(sC + (16 * wm + 8 * hh + g8) * DH_LDC + cl + 8 * nj) =
              pack_bf16(cf[0], cf[1]);
        }
    }
    __syncthreads();
    // P2: out [32 rows, QW columns] += coef [., 64] tile [64, columns]
#pragma unroll
    for (int kk = 0; kk < R64; kk += 16) {
      uint32_t a0[4], a1[4];
      ldsm4(a0, sC + c_off + kk);
      ldsm4(a1, sC + c_off + 16 * DH_LDC + kk);
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        uint32_t b[4];
        ldsm4_t(b, St + x_off + kk * DH_LDG + 16 * np);
        mma16816(acc[0][2 * np], a0, b[0], b[1]);
        mma16816(acc[0][2 * np + 1], a0, b[2], b[3]);
        mma16816(acc[1][2 * np], a1, b[0], b[1]);
        mma16816(acc[1][2 * np + 1], a1, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();                     // no CTA leaves while others read its partials

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2 * NP; ++nj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 32 * pm + 16 * mi + 8 * hh + g8;
        const int c = pq * QW + 8 * nj + 2 * t4;
        if (c < dn && row < n_res)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * D + d0 + c) =
              pack_bf16(acc[mi][nj][2 * hh], acc[mi][nj][2 * hh + 1]);
      }
}

template <int NP>
__global__ void __launch_bounds__(NTM, 1)
ce_bwd_dh_mma_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                     const int* __restrict__ tgt, const float* __restrict__ lse,
                     const float* __restrict__ g, bf16* __restrict__ dh, int Tp, int V,
                     int D) {
  ce_bwd_mma_body<NP, false>(h, w, tgt, lse, g, dh, Tp, V, D);
}

template <int NP>
__global__ void __launch_bounds__(NTM, 1)
ce_bwd_dw_mma_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                     const int* __restrict__ tgt, const float* __restrict__ lse,
                     const float* __restrict__ g, bf16* __restrict__ dw, int Tp, int V,
                     int D) {
  ce_bwd_mma_body<NP, true>(h, w, tgt, lse, g, dw, Tp, V, D);
}

using BwdMmaKernel = void (*)(const bf16*, const bf16*, const int*, const float*, const float*,
                             bf16*, int, int, int);

// C1 (DW false) or C2 (DW true) on the tensor cores with its attributes set
// (its shared memory, clusters above 8 CTAs allowed), or null on an error
// (its code in ``err``).
template <int NP, bool DW>
BwdMmaKernel bwd_mma_kernel(int& err) {
  BwdMmaKernel kernel = DW ? ce_bwd_dw_mma_kernel<NP> : ce_bwd_dh_mma_kernel<NP>;
  static bool attr = false;
  err = 0;
  if (!attr) {
    bool smem_set = false;
    err = allow_smem(kernel, dh_smem<NP>(), smem_set);
    if (!err)
      err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return nullptr;
    attr = true;
  }
  return kernel;
}

// The launch configuration of C1 / C2 over n_res resident rows: one cluster
// of G CTAs per 64 rows (``cl`` holds its cluster attribute).
template <int NP>
cudaLaunchConfig_t bwd_mma_config(int n_res, int D, cudaStream_t st, cudaLaunchAttribute* cl) {
  const int G = (D + 64 * NP - 1) / (64 * NP);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n_res + DH_T - 1) / DH_T) * G);
  cfg.blockDim = dim3(NTM);
  cfg.dynamicSmemBytes = dh_smem<NP>();
  cfg.stream = st;
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = G;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  return cfg;
}

// C1 (DW false) or C2 (DW true) on the tensor cores, as a cluster launch.
template <int NP, bool DW>
int launch_bwd_mma(const void* h, const void* w, const void* tgt, const void* lse,
                   const void* g, void* out, int Tp, int V, int D, cudaStream_t st) {
  int err;
  const BwdMmaKernel kernel = bwd_mma_kernel<NP, DW>(err);
  if (err) return err;
  cudaLaunchAttribute cl[1];
  cudaLaunchConfig_t cfg = bwd_mma_config<NP>(DW ? V : Tp, D, st, cl);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)h, (const bf16*)w,
                                           (const int*)tgt, (const float*)lse,
                                           (const float*)g, (bf16*)out, Tp, V, D);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes the caller pads to or derives its launch geometry from, the
// largest vocab split of the forward, and the accumulator width that sets
// the backward's D slices.
int cross_entropy_token_multiple() { return 2 * R; }
int cross_entropy_vocab_tile() { return C; }
int cross_entropy_max_vsplit() { return MAX_VSPLIT; }
int cross_entropy_ds_max() { return DS_MAX; }
int cross_entropy_fwd_mma_token_tile() { return FB_T; }
int cross_entropy_mma_vocab_tile() { return FB_V; }
int cross_entropy_dh_mma_slice_multiple() { return DH_GRAN; }
int cross_entropy_dh_mma_slice_max() { return DG_MAX; }
int cross_entropy_dh_mma_slice_wide() { return DG_WIDE; }
int cross_entropy_dh_mma_max_slices() { return DH_MAX_CLUSTER; }

// B. h [Tp, D], w [V, D] (dtype 0 = float32, 1 = bfloat16), tgt [Tp] int32
// -> lse, tl [Tp] float32. n_split > 1 needs ws (n_split * Tp * 3 floats)
// and arrivals (one int per token tile, zeroed: Tp / 32 for float32,
// ceil(Tp / 128) for bf16). Returns a cudaError_t code.
int cross_entropy_fwd(const void* h, const void* w, const void* tgt, void* lse, void* tl,
                      void* ws, void* arrivals, int Tp, int V, int D, int dtype,
                      int n_split, void* stream) {
  if (Tp <= 0 || Tp % (2 * R) || V <= 0 || D <= 0 || D % KC || n_split < 1 ||
      n_split > MAX_VSPLIT || (n_split > 1 && (ws == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    ce_fwd_kernel<float><<<dim3(Tp / R, n_split), NT, 0, st>>>(
        (const float*)h, (const float*)w, (const int*)tgt, (float*)lse, (float*)tl,
        (float*)ws, (int*)arrivals, Tp, V, D, n_split);
  } else if (dtype == 1) {
    if (n_split > (V + FB_V - 1) / FB_V) return (int)cudaErrorInvalidValue;
    static bool attr = false;
    const int e = allow_smem(ce_fwd_mma_kernel, FB_SMEM, attr);
    if (e) return e;
    const int n_tt = (Tp + FB_T - 1) / FB_T;
    ce_fwd_mma_kernel<<<n_tt * n_split, NTM, FB_SMEM, st>>>(
        (const bf16*)h, (const bf16*)w, (const int*)tgt, (float*)lse, (float*)tl,
        (float*)ws, (int*)arrivals, Tp, V, D, n_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// C1 (which == 0): out = dh [Tp, D] in h's dtype; C2 (which == 1): out = dW
// [V, D] in w's dtype. lse and g [Tp] float32 (g = 0 on rows that carry no
// loss). ds = width of a D slice (ceil(D / ds) slices): for float32 a
// multiple of 32, at most DS_MAX; for bf16 C1 and C2 the columns of one CTA
// of the cluster, a multiple of 64, at most DG_WIDE, at most 16 slices.
// Returns a cudaError_t code.
int cross_entropy_bwd(const void* h, const void* w, const void* tgt, const void* lse,
                      const void* g, void* out, int Tp, int V, int D, int dtype,
                      int which, int ds, void* stream) {
  if (Tp <= 0 || Tp % (2 * R) || V <= 0 || D <= 0 || D % KC || ds <= 0 || ds % KC ||
      ds > DS_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && which == 0)
    return launch_bwd<float, false>(h, w, tgt, lse, g, out, Tp, V, D, ds, st);
  if (dtype == 0 && which == 1)
    return launch_bwd<float, true>(h, w, tgt, lse, g, out, Tp, V, D, ds, st);
  if (dtype == 1) {
    if (Tp % DH_T || ds % DH_GRAN || ds > DG_WIDE || (D + ds - 1) / ds > DH_MAX_CLUSTER)
      return (int)cudaErrorInvalidValue;
#define CE_MMA(NP)                                                                      \
  return which ? launch_bwd_mma<NP, true>(h, w, tgt, lse, g, out, Tp, V, D, st)          \
               : launch_bwd_mma<NP, false>(h, w, tgt, lse, g, out, Tp, V, D, st)
    switch (ds / DH_GRAN) {
      case 1: CE_MMA(1);
      case 2: CE_MMA(2);
      case 3: CE_MMA(3);
      case 4: CE_MMA(4);
      case 5: CE_MMA(5);
      case 6: CE_MMA(6);
      case 7: CE_MMA(7);
    }
#undef CE_MMA
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of bf16 C1 (which == 0) or C2 (which == 1) at D columns
// in slices of ds (as for cross_entropy_bwd) the card holds at once
// (cudaOccupancyMaxActiveClusters) into ``*n``; 0 means such a cluster
// cannot launch. Returns a cudaError_t code.
int cross_entropy_bwd_max_active_clusters(int D, int ds, int which, int* n) {
  if (D <= 0 || D % KC || ds <= 0 || ds % DH_GRAN || ds > DG_WIDE ||
      (D + ds - 1) / ds > DH_MAX_CLUSTER || n == nullptr)
    return (int)cudaErrorInvalidValue;
#define CE_OCC(NP)                                                                     \
  {                                                                                    \
    int err;                                                                           \
    const BwdMmaKernel kernel =                                                        \
        which ? bwd_mma_kernel<NP, true>(err) : bwd_mma_kernel<NP, false>(err);        \
    if (err) return err;                                                               \
    cudaLaunchAttribute cl[1];                                                         \
    cudaLaunchConfig_t cfg = bwd_mma_config<NP>(DH_T, D, 0, cl);                       \
    return (int)cudaOccupancyMaxActiveClusters(n, (const void*)kernel, &cfg);          \
  }
  switch (ds / DH_GRAN) {
    case 1: CE_OCC(1);
    case 2: CE_OCC(2);
    case 3: CE_OCC(3);
    case 4: CE_OCC(4);
    case 5: CE_OCC(5);
    case 6: CE_OCC(6);
    case 7: CE_OCC(7);
  }
#undef CE_OCC
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
