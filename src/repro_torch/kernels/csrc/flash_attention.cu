// Packed-varlen causal flash attention (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel kernels/flash_attention.py::
// flash_attention_pallas (body ``_kernel``) of the JAX package. Same
// function: q [T,Hq,DK], k [S,Hkv,DK], v [S,Hkv,DV] -> o [T,Hq,DV]
// token-major, int32 seg/pos per row; query head h reads kv head
// h / (Hq/Hkv);
//   attend(i, j) iff seg_q[i] == seg_kv[j] && seg_q[i] >= 0
//                 && (!causal || pos_kv[j] <= pos_q[i])
//                 && (window <= 0 || pos_q[i] - pos_kv[j] < window)
// online softmax in float32; a row with no attended key is written as 0.
// Every kernel is a template on the key width DK (q and k) and the value
// width DV (v, o and their gradients), instantiated at (16, 16), (32, 32)
// (the reduced configs), (64, 64), (128, 128), (160, 160) (stablelm-12b),
// (256, 256) and MLA's (192, 128) (deepseek-v2-lite: 128 nope + 64 rope
// channels of q and k, 128 of v): Q K^T runs over DK columns, P V and the
// output over DV, so nothing is padded to a wider head. Any multiple of 16
// instantiates: a warp's half of a 16-wide accumulator is one 8-column
// tile, which the backward's products load with ldmatrix .x2.
// For training the forward can also write each row's log-sum-exp
// lse [Hq, T] (float32; -inf for a row with no attended key), and two
// backward kernels (below the forward) compute dq and dk/dv from it.
//
// Design. The TPU kernel carries (m, l, acc) across a sequential grid
// axis over KV tiles; blocks on the card run in no order, so here a block
// owns one (query tile, query head, KV split) triple and loops over its
// share of the KV tiles itself, with the running state on chip.
//
// bf16 (the train and serving paths): flash_fwd_mma_kernel<DK, DV>.
// * What bounds it: operations on the train chunks (two products of 2 Dh
//   flops per live (query, key, head): 0.84 ms at the H100's bf16 rate on
//   a 28k-row gemma3-1b chunk against a few ms of bytes), bytes in serving
//   (a mixed engine step reads a long packed KV buffer for a few queries
//   each: a few hundredths of a ms).
// * Products on the tensor cores: S = Q K^T and O += P V as bf16 mma.sync
//   m16n8k16 with float32 sums, fragments by ldmatrix (.trans for V).
//   A product of two bf16 values is exact in float32, so S is the TPU
//   kernel's S up to the order of the sums. The one new rounding: P is
//   formed in float32 (the row sums l use it so) and rounded to bf16 as P
//   V's A operand, where the TPU kernel keeps P in float32.
// * 64-row tiles, 4 warps; a warp owns 16 whole query rows, so the online
//   softmax runs in registers: a row's max and sum need only the shuffles
//   of the 4 lanes of an m16n8 quad. The S accumulator is P V's A operand
//   in place (register to register, no shared memory). O stays float32 in
//   registers (Dh / 2 a thread: 128 at Dh 256); Q's fragments are read
//   from shared memory at every k-step rather than held.
// * Exact KV ranges instead of a scan: each query tile walks only [lo, hi]
//   of the KV tiles holding a live pair with it (flash_bwd_tiles_kernel's
//   ranges, which the op computes once and hands to the backward), skips a
//   tile inside the range on one O(1) test of the two tiles' summaries, and
//   applies the per-element mask only on tiles that one test per tile
//   cannot prove fully live.
// * Copies: Q once; K and V of 64 rows by cp.async. V of tile t is in
//   flight while S = Q K_t^T computes, K of the next live tile while the
//   softmax and P V run (one buffer each: 101 KB at Dh 256, two blocks an
//   SM).
// * Split KV only where the grid does not fill the card (the serving
//   engine's short query sets: a decode row shares a query tile with
//   others and attends its whole context): split z takes a contiguous
//   piece of the query tile's range and writes a float32 partial (m, l,
//   unnormalised acc), which flash_combine_kernel merges (flash-decoding).
//   A training chunk runs unsplit and writes o and lse directly. The grid
//   is 1-D with the query head fastest, so the heads of a GQA group read
//   each K/V tile from L2 side by side.
// * Rows past T or S in the last tile are dead (zero-filled copies,
//   masked pairs); a row with no live key is written as 0, lse -inf. No
//   atomics: two launches give the same bits.
//
// float32 (the float32 serving verify and the train_verify phases, held to
// 1e-5): flash_fwd_kernel<float, DK, DV> keeps float32 FMAs from shared
// memory on 32 x 32 tiles (register-blocked 4x2 score and 4x(DV/16) output tiles
// per thread), one thread per row for the online softmax, every KV tile
// tested pair by pair before it is loaded, and the KV tiles dealt
// round-robin to up to MAX_SPLIT blocks per query tile (merged by
// flash_combine_kernel, launched through its own entry point). Inputs are
// converted to float32 once, when a tile lands in shared memory, with
// 16-byte global loads issued in batches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 32;        // KV rows per tile
constexpr int NT = 128;       // threads: 8 row groups (ty) x 16 columns (tx)
constexpr int MAX_SPLIT = 16;
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the mask rule above for one (query row, key row) pair
__device__ __forceinline__ bool attends(int sq, int pq, int sk, int pk, int causal,
                                        int window) {
  return sq >= 0 && sk == sq && (!causal || pk <= pq) && (window <= 0 || pq - pk < window);
}

// 16 bytes of T -> float32 values into dst[0 .. 16/sizeof(T))
__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}

// Copy ``rows`` rows of D elements (row r at src + r * stride elements)
// into shared memory as float32 with row stride LD. Lane-consecutive
// threads take consecutive rows, so the shared-memory stores (odd LD)
// hit distinct banks; each thread keeps up to 8 16-byte loads in flight.
template <typename T, int D, int LD, int NTH = NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride,
                                          int rows, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;                 // 16-byte chunks per row
  const int total = rows * CH;
  for (int base = 0; base < total; base += 8 * NTH) {
    uint4 buf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = base + i * NTH + tid;
      if (c < total) {
        const int r = c % rows, ch = c / rows;
        buf[i] = __ldg(reinterpret_cast<const uint4*>(src + r * stride + ch * VEC));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = base + i * NTH + tid;
      if (c < total) {
        const int r = c % rows, ch = c / rows;
        float f[VEC];
        unpack(buf[i], f, T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[r * LD + ch * VEC + e] = f[e];
      }
    }
  }
}

template <int DK, int DV>
constexpr size_t smem_bytes() {
  // sQ, sK: [BQ|BK][DK + 1] floats; sV: [BK][DV + 1]; sP: [BQ][BK + 1]
  return sizeof(float) * (size_t)(2 * BQ * (DK + 1) + BK * (DV + 1) + BQ * (BK + 1));
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ pos_q, const int* __restrict__ seg_kv,
                 const int* __restrict__ pos_kv, T* __restrict__ out,
                 float2* __restrict__ ws_ml, float* __restrict__ ws_acc,
                 float* __restrict__ lse, int T_, int S, int Hq, int Hkv, int causal,
                 int window, float scale, int n_split) {
  static_assert(BQ == 32 && BK == 32 && NT == 128, "thread map assumes 32x32 tiles");
  static_assert(DK % 16 == 0 && DV % 16 == 0, "DK and DV must be multiples of 16");
  constexpr int LDK = DK + 1;       // odd row strides: conflict-free column reads
  constexpr int LDV = DV + 1;
  constexpr int LP = BK + 1;
  constexpr int DJ = DV / 16;       // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LDK;
  float* sV = sK + BK * LDK;
  float* sP = sV + BK * LDV;
  __shared__ int s_segq[BQ], s_posq[BQ], s_segk[BK], s_posk[BK];
  __shared__ float s_m[BQ], s_l[BQ], s_alpha[BQ];
  __shared__ int s_rng[2];          // live query rows: segment min / max

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, z = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q0 = (size_t)blockIdx.x * BQ;
  const size_t k_stride = (size_t)Hkv * DK, v_stride = (size_t)Hkv * DV;

  load_tile<T, DK, LDK>(sQ, q + (q0 * Hq + h) * DK, (size_t)Hq * DK, BQ, tid);
  if (tid < BQ) {
    const int sg = seg_q[q0 + tid];
    s_segq[tid] = sg;
    s_posq[tid] = pos_q[q0 + tid];
    s_m[tid] = NEG;
    s_l[tid] = 0.f;
    // warp 0 reduces the live rows' segment range (BQ == warp size)
    int smin = sg >= 0 ? sg : INT_MAX, smax = sg >= 0 ? sg : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
      smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
    }
    if (tid == 0) { s_rng[0] = smin; s_rng[1] = smax; }
  }
  __syncthreads();
  const int qsmin = s_rng[0], qsmax = s_rng[1];

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_kv = S / BK;
  if (qsmax >= 0 && z < n_kv) {     // else: no live query row / no tiles
    // this tile's key metadata is prefetched one iteration ahead
    int nsg = 0, nps = 0;
    if (tid < BK) { nsg = seg_kv[z * BK + tid]; nps = pos_kv[z * BK + tid]; }
    for (int kt = z; kt < n_kv; kt += n_split) {
      const int sg = nsg, ps = nps;
      if (tid < BK && kt + n_split < n_kv) {
        nsg = seg_kv[(kt + n_split) * BK + tid];
        nps = pos_kv[(kt + n_split) * BK + tid];
      }
      int live = 0;
      if (tid < BK) {
        s_segk[tid] = sg;
        s_posk[tid] = ps;
        if (sg >= qsmin && sg <= qsmax) {
          for (int r = 0; r < BQ && !live; ++r) {
            const int pq = s_posq[r];
            live = s_segq[r] == sg && (!causal || ps <= pq) &&
                   (window <= 0 || pq - ps < window);
          }
        }
      }
      if (!__syncthreads_or(live)) continue;   // no live pair: skip the tile

      const size_t k0 = (size_t)kt * BK;
      load_tile<T, DK, LDK>(sK, k + k0 * k_stride + (size_t)hk * DK, k_stride, BK, tid);
      load_tile<T, DV, LDV>(sV, v + k0 * v_stride + (size_t)hk * DV, v_stride, BK, tid);
      __syncthreads();

      // scores: rows ty + 8i, columns tx + 16j
      float sc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DK; ++d) {
        float qv[4], kv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 8 * i) * LDK + d];
#pragma unroll
        for (int j = 0; j < 2; ++j) kv[j] = sK[(tx + 16 * j) * LDK + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
        const int sq = s_segq[r], pq = s_posq[r];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j;
          const bool ok = sq >= 0 && s_segk[c] == sq &&
                          (!causal || s_posk[c] <= pq) &&
                          (window <= 0 || pq - s_posk[c] < window);
          sP[r * LP + c] = ok ? sc[i][j] * scale : -INFINITY;
        }
      }
      __syncthreads();

      // online softmax, one thread per query row
      if (tid < BQ) {
        float* row = sP + tid * LP;
        float mx = -INFINITY;
        for (int c = 0; c < BK; ++c) mx = fmaxf(mx, row[c]);
        const float m_prev = s_m[tid];
        const float m_new = fmaxf(m_prev, mx);
        const float alpha = expf(m_prev - m_new);
        float lsum = 0.f;
        for (int c = 0; c < BK; ++c) {
          const float s = row[c];
          const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
          row[c] = p;
          lsum += p;
        }
        s_l[tid] = s_l[tid] * alpha + lsum;
        s_m[tid] = m_new;
        s_alpha[tid] = alpha;
      }
      __syncthreads();

      // acc = acc * alpha + P @ V; rows ty + 8i, columns tx + 16j
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s_alpha[ty + 8 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
      }
      for (int c = 0; c < BK; ++c) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 8 * i) * LP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float vv = sV[c * LDV + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
      __syncthreads();              // sK/sV/sP/s_segk are rewritten next tile
    }
  }

  const size_t TH = (size_t)T_ * Hq;
  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
      const float l = s_l[r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float o = l > 0.f ? acc[i][j] / l : 0.f;
        out[((q0 + r) * Hq + h) * DV + tx + 16 * j] = from_f<T>(o);
      }
    }
    if (lse != nullptr && tid < BQ)
      lse[(size_t)h * T_ + q0 + tid] = s_l[tid] > 0.f ? s_m[tid] + logf(s_l[tid]) : -INFINITY;
    return;
  }
  // partial state of split z; acc only where the row met a live key
  if (tid < BQ)
    ws_ml[z * TH + (q0 + tid) * Hq + h] = make_float2(s_m[tid], s_l[tid]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    if (s_l[r] > 0.f) {
      float* dst = ws_acc + (z * TH + (q0 + r) * Hq + h) * DV;
#pragma unroll
      for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = acc[i][j];
    }
  }
}

// Merge the n_split partial states of each (row, head): one block per pair.
template <typename T, int D>
__global__ void flash_combine_kernel(const float2* __restrict__ ws_ml,
                                     const float* __restrict__ ws_acc,
                                     T* __restrict__ out, float* __restrict__ lse,
                                     int TH, int Hq, int n_split) {
  const size_t row = blockIdx.x;
  float w[MAX_SPLIT];
  float M = NEG, L = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float2 ml = ws_ml[z * (size_t)TH + row];
    if (ml.y > 0.f) M = fmaxf(M, ml.x);
  }
#pragma unroll
  for (int z = 0; z < MAX_SPLIT; ++z) {
    w[z] = 0.f;
    if (z < n_split) {
      const float2 ml = ws_ml[z * (size_t)TH + row];
      if (ml.y > 0.f) {
        w[z] = expf(ml.x - M);
        L += ml.y * w[z];
      }
    }
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int z = 0; z < MAX_SPLIT; ++z)
      if (w[z] > 0.f) a += ws_acc[(z * (size_t)TH + row) * D + d] * w[z];
    out[row * D + d] = from_f<T>(L > 0.f ? a / L : 0.f);
  }
  if (lse != nullptr && threadIdx.x == 0)   // row = t * Hq + h -> lse[h, t]
    lse[(row % Hq) * (size_t)(TH / Hq) + row / Hq] = L > 0.f ? M + logf(L) : -INFINITY;
}

// ---------------------------------------------------------------------------
// Backward (kernel A', the gradient of the TPU kernel
// src/repro/kernels/flash_attention.py:89 flash_attention_pallas; the JAX
// package has no backward kernel and differentiates its jnp attention).
// Two passes with no atomics: each output element is written by exactly one
// block, in a fixed order, so two launches give the same bits.
//
// q, k are DK wide, v, o, dout DV wide (dq and dk DK, dv DV).
//
//   P = exp(S * scale - lse)   (the forward's per-row lse; P = 0 outside the
//                               mask, so a row with lse = -inf adds nothing)
//   Delta = rowsum(dO * O),  dP = dO V^T,  dS = P * (dP - Delta),
//   dV = P^T dO,  dQ = scale * dS K,  dK = scale * dS^T Q.
//
// * flash_bwd_dq_kernel runs first: one block per (query tile, query head).
//   It walks the KV tiles that can hold a live pair, accumulating dQ, and
//   writes its rows' Delta to a float32 [Hq, T] buffer. float32: Delta
//   from the float32 output, before the walk. bf16: the output is rounded
//   to bf16, and Delta0 = rowsum(dO * O) from it is off by dO . (O -
//   bf16(O)), which moves dQ and dK by that error times sum_j P K and
//   sum_i P Q: past the bf16 tolerance on short rows. So the walk uses
//   Delta0 in dS and also sums the exact Delta = sum_j P dP (= dO . P V) and
//   PK = sum_j P K; at its end dQ = dQ0 - (Delta - Delta0) PK, one more
//   product a tile, and the exact Delta is what it writes.
// * flash_bwd_dkdv_kernel: one block per (KV tile, KV head). For each query
//   head of its GQA group it walks the query tiles that can hold a live
//   pair, reading lse and Delta of their rows, accumulating dK and dV.
//
// Which tiles a block walks. A third small kernel, flash_bwd_tiles_kernel
// (below the passes), launched first, hands each block a range of tiles
// (per query tile its KV tiles, per KV tile its query tiles: the first and
// the last tile holding a pair that attends, whatever the rows' order) and
// a summary of every tile (segment min / max, position min / max of its
// live rows). Inside the range a tile is skipped on one O(1) test of the
// two summaries; every element computed still gets the exact per-pair mask,
// but for tiles where one test per tile shows that every pair attends (both
// tiles' rows live and of one segment, inside the causal limit and the
// window).
//
// What bounds it: operations. Per live (query, key, head) the backward does
// five products (S recomputed and dK of 2 DK flops, dP and dV of 2 DV in the
// dk/dv pass; S and dQ of 2 DK, dP of 2 DV in the dq pass), against bytes
// read about once, so at the training shapes the bound is the bf16
// tensor-core rate. (The bf16 dq pass adds a sixth, PK of 2 DK, above.)
//
// bf16 inputs (the train paths): 64-row tiles, 8 warps. Q, dO, K and V stay
// bf16 in shared memory with rows padded by 8 elements (16 bytes), so the
// eight row addresses of every ldmatrix fall in distinct bank groups. All
// six products are mma.sync m16n8k16 bf16 -> float32. The streamed tiles
// (Q, dO and their rows' lse and Delta in the dk/dv pass; K, V in the dq
// pass) come in by cp.async into a double buffer, the next tile's copy in
// flight while the current one computes. In each tile a warp takes 16 rows
// x 32 columns of S and dP; P and dS are formed in float32 and rounded to
// bf16 only into shared memory, as the operand of the next product; then a
// warp takes 16 rows x Dh/2 columns of the accumulators (dK and dV, or dQ and PK),
// which stay float32 in registers (at Dh 256: 128 per thread for dK + dV;
// at (192, 128): 48 + 32).
// Rows at or past T or S in the last 64-row tile are dead here (zero-filled
// copies, masked pairs); nothing is padded again.
//
// float32 inputs (the float32 verify phases, held to 1e-5) keep float32
// arithmetic with no TF32: 32-row tiles widened in shared memory and
// float32 FMAs, walking the same kind of ranges with the exact per-tile
// live test, Delta written by the dq pass and read by the dk/dv pass.
constexpr int NTB = 256;    // threads of a backward block (8 warps)
constexpr int BB = 64;      // bf16 backward: rows per tile, both sides

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;  // q [T, Hq, DK]; o, dout [T, Hq, DV];
                                     // k [S, Hkv, DK]; v [S, Hkv, DV]
  const float* lse;                  // [Hq, T] from the forward
  float* delta;                      // [Hq, T]: written by dq, read by dk/dv
  const int *seg_q, *pos_q, *seg_kv, *pos_kv;
  const int2* range;                 // per block tile: [lo, hi] of the other side
  const int4* q_sum;                 // per query tile: seg min/max, pos min/max
  const int4* kv_sum;                // per KV tile: the same
  void *dq, *dk, *dv;
  int T, S, Hq, Hkv, causal, window;
  float scale;
};

// Can a query tile with summary a and a KV tile with summary b hold a live
// pair? (A tile with no live row has seg min > seg max.)
__device__ __forceinline__ bool may_attend(int4 a, int4 b, int causal, int window) {
  return max(a.x, b.x) <= min(a.y, b.y) && (!causal || b.z <= a.w) &&
         (window <= 0 || a.z - b.w < window);
}

// --- float32: FMA bodies on 32-row tiles ------------------------------------

template <int DK, int DV>
constexpr size_t bwd_f32_smem_bytes() {
  return sizeof(float) * (size_t)(2 * 32 * (DK + 1) + 2 * 32 * (DV + 1) + 2 * 32 * 33);
}

// Delta_r = sum_d dO[r, d] * O[r, d] for the BQ rows of a query tile: warp w
// takes rows 4w .. 4w + 3 (dO from shared memory, O from global memory).
template <int D, int LD>
__device__ __forceinline__ void row_delta(float* s_delta, const float* sdO, const float* o,
                                          size_t q0, int h, int Hq, int tid) {
  static_assert(NTB / 32 * 4 == BQ, "8 warps x 4 rows");
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    const float* orow = o + ((q0 + r) * Hq + h) * D;
    float a = 0.f;
    for (int d = lane; d < D; d += 32) a = fmaf(orow[d], sdO[r * LD + d], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) s_delta[r] = a;
  }
}

// S^T and dP^T (dkdv_f32: key rows, query columns) or S and dP (dq_f32:
// query rows, key columns) of a thread's 2 x 2 elements: s += a_i . b_j over
// DK columns, p += c_i . e_j over DV (row strides DK + 1 and DV + 1), each sum
// in column order.
template <int DK, int DV>
__device__ __forceinline__ void pair_products(float (&s)[2][2], float (&p)[2][2],
                                              const float* a0, const float* a1,
                                              const float* b0, const float* b1,
                                              const float* c0, const float* c1,
                                              const float* e0, const float* e1) {
  constexpr int DC = DK < DV ? DK : DV;
#pragma unroll 4
  for (int d = 0; d < DC; ++d) {
    s[0][0] = fmaf(a0[d], b0[d], s[0][0]);
    s[0][1] = fmaf(a0[d], b1[d], s[0][1]);
    s[1][0] = fmaf(a1[d], b0[d], s[1][0]);
    s[1][1] = fmaf(a1[d], b1[d], s[1][1]);
    p[0][0] = fmaf(c0[d], e0[d], p[0][0]);
    p[0][1] = fmaf(c0[d], e1[d], p[0][1]);
    p[1][0] = fmaf(c1[d], e0[d], p[1][0]);
    p[1][1] = fmaf(c1[d], e1[d], p[1][1]);
  }
#pragma unroll 4
  for (int d = DC; d < DK; ++d) {
    s[0][0] = fmaf(a0[d], b0[d], s[0][0]);
    s[0][1] = fmaf(a0[d], b1[d], s[0][1]);
    s[1][0] = fmaf(a1[d], b0[d], s[1][0]);
    s[1][1] = fmaf(a1[d], b1[d], s[1][1]);
  }
#pragma unroll 4
  for (int d = DC; d < DV; ++d) {
    p[0][0] = fmaf(c0[d], e0[d], p[0][0]);
    p[0][1] = fmaf(c0[d], e1[d], p[0][1]);
    p[1][0] = fmaf(c1[d], e0[d], p[1][0]);
    p[1][1] = fmaf(c1[d], e1[d], p[1][1]);
  }
}

template <int DK, int DV>
__device__ void dkdv_f32(const BwdArgs& a) {
  using T = float;
  constexpr int LDK = DK + 1, LDV = DV + 1, LP = BQ + 1, DJK = DK / 16, DJV = DV / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LDK;
  float* sQ = sV + BK * LDV;
  float* sdO = sQ + BQ * LDK;
  float* sP = sdO + BQ * LDV;       // [BK][BQ + 1]: P^T
  float* sdS = sP + BK * LP;        // [BK][BQ + 1]: dS^T
  __shared__ int s_segq[BQ], s_posq[BQ], s_segk[BK], s_posk[BK];
  __shared__ float s_lse[BQ], s_delta[BQ];

  const T *q = (const T*)a.q, *k = (const T*)a.k, *v = (const T*)a.v,
          *dout = (const T*)a.dout;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hk = blockIdx.y, G = a.Hq / a.Hkv, T_ = a.T;
  const size_t k0 = (size_t)blockIdx.x * BK;
  const size_t k_stride = (size_t)a.Hkv * DK, v_stride = (size_t)a.Hkv * DV;
  const size_t q_stride = (size_t)a.Hq * DK, o_stride = (size_t)a.Hq * DV;

  load_tile<T, DK, LDK, NTB>(sK, k + k0 * k_stride + (size_t)hk * DK, k_stride, BK, tid);
  load_tile<T, DV, LDV, NTB>(sV, v + k0 * v_stride + (size_t)hk * DV, v_stride, BK, tid);
  if (tid < BK) {
    s_segk[tid] = a.seg_kv[k0 + tid];
    s_posk[tid] = a.pos_kv[k0 + tid];
  }
  __syncthreads();

  float dK[2][DJK], dV[2][DJV];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < DJK; ++j) dK[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DJV; ++j) dV[i][j] = 0.f;
  }

  const int2 rg = a.range[blockIdx.x];
  for (int qt = rg.x; qt <= rg.y; ++qt) {
    int live = 0;
    if (tid < BQ) {
      const int sg = a.seg_q[qt * BQ + tid], ps = a.pos_q[qt * BQ + tid];
      s_segq[tid] = sg;
      s_posq[tid] = ps;
      for (int c = 0; c < BK && !live; ++c)
        live = attends(sg, ps, s_segk[c], s_posk[c], a.causal, a.window);
    }
    if (!__syncthreads_or(live)) continue;   // no live pair: skip the tile
    const size_t q0 = (size_t)qt * BQ;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      load_tile<T, DK, LDK, NTB>(sQ, q + q0 * q_stride + (size_t)h * DK, q_stride, BQ, tid);
      load_tile<T, DV, LDV, NTB>(sdO, dout + q0 * o_stride + (size_t)h * DV, o_stride, BQ,
                                 tid);
      if (tid < BQ) {
        s_lse[tid] = a.lse[(size_t)h * T_ + q0 + tid];
        s_delta[tid] = a.delta[(size_t)h * T_ + q0 + tid];
      }
      __syncthreads();
      // S^T and dP^T: key rows ty + 16 i, query columns tx + 16 j
      float st[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dpt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      pair_products<DK, DV>(st, dpt, sK + ty * LDK, sK + (ty + 16) * LDK, sQ + tx * LDK,
                            sQ + (tx + 16) * LDK, sV + ty * LDV, sV + (ty + 16) * LDV,
                            sdO + tx * LDV, sdO + (tx + 16) * LDV);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = ty + 16 * i, r = tx + 16 * j;
          const bool ok = attends(s_segq[r], s_posq[r], s_segk[c], s_posk[c], a.causal,
                                  a.window);
          const float p = ok ? expf(st[i][j] * a.scale - s_lse[r]) : 0.f;
          sP[c * LP + r] = p;
          sdS[c * LP + r] = p * (dpt[i][j] - s_delta[r]);
        }
      __syncthreads();
      for (int r = 0; r < BQ; ++r) {
        const float pa = sP[ty * LP + r], pb = sP[(ty + 16) * LP + r];
        const float ga = sdS[ty * LP + r], gb = sdS[(ty + 16) * LP + r];
#pragma unroll
        for (int j = 0; j < DJV; ++j) {
          const float dov = sdO[r * LDV + tx + 16 * j];
          dV[0][j] = fmaf(pa, dov, dV[0][j]);
          dV[1][j] = fmaf(pb, dov, dV[1][j]);
        }
#pragma unroll
        for (int j = 0; j < DJK; ++j) {
          const float qv = sQ[r * LDK + tx + 16 * j];
          dK[0][j] = fmaf(ga, qv, dK[0][j]);
          dK[1][j] = fmaf(gb, qv, dK[1][j]);
        }
      }
      __syncthreads();              // sQ, sdO, sP, sdS, s_lse, s_delta rewritten next
    }
  }
  T *dk = (T*)a.dk, *dv = (T*)a.dv;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (k0 + ty + 16 * i) * a.Hkv + hk;
#pragma unroll
    for (int j = 0; j < DJK; ++j) dk[row * DK + tx + 16 * j] = dK[i][j] * a.scale;
#pragma unroll
    for (int j = 0; j < DJV; ++j) dv[row * DV + tx + 16 * j] = dV[i][j];
  }
}

template <int DK, int DV>
__device__ void dq_f32(const BwdArgs& a) {
  using T = float;
  constexpr int LDK = DK + 1, LDV = DV + 1, LP = BK + 1, DJ = DK / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LDK;
  float* sK = sdO + BQ * LDV;
  float* sV = sK + BK * LDK;
  float* sdS = sV + BK * LDV;       // [BQ][BK + 1]
  __shared__ int s_segq[BQ], s_posq[BQ], s_segk[BK], s_posk[BK];
  __shared__ float s_lse[BQ], s_delta[BQ];

  const T *q = (const T*)a.q, *k = (const T*)a.k, *v = (const T*)a.v,
          *dout = (const T*)a.dout;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, T_ = a.T;
  const int h = blockIdx.y, hk = h / (a.Hq / a.Hkv);
  const size_t q0 = (size_t)blockIdx.x * BQ;
  const size_t k_stride = (size_t)a.Hkv * DK, v_stride = (size_t)a.Hkv * DV;
  const size_t q_stride = (size_t)a.Hq * DK, o_stride = (size_t)a.Hq * DV;

  load_tile<T, DK, LDK, NTB>(sQ, q + q0 * q_stride + (size_t)h * DK, q_stride, BQ, tid);
  load_tile<T, DV, LDV, NTB>(sdO, dout + q0 * o_stride + (size_t)h * DV, o_stride, BQ, tid);
  if (tid < BQ) {
    s_segq[tid] = a.seg_q[q0 + tid];
    s_posq[tid] = a.pos_q[q0 + tid];
    s_lse[tid] = a.lse[(size_t)h * T_ + q0 + tid];
  }
  __syncthreads();
  row_delta<DV, LDV>(s_delta, sdO, (const T*)a.o, q0, h, a.Hq, tid);
  __syncthreads();
  if (tid < BQ) a.delta[(size_t)h * T_ + q0 + tid] = s_delta[tid];

  float dQ[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dQ[i][j] = 0.f;

  const int2 rg = a.range[blockIdx.x];
  for (int kt = rg.x; kt <= rg.y; ++kt) {
    int live = 0;
    if (tid < BK) {
      const int sg = a.seg_kv[kt * BK + tid], ps = a.pos_kv[kt * BK + tid];
      s_segk[tid] = sg;
      s_posk[tid] = ps;
      for (int r = 0; r < BQ && !live; ++r)
        live = attends(s_segq[r], s_posq[r], sg, ps, a.causal, a.window);
    }
    if (!__syncthreads_or(live)) continue;   // no live pair: skip the tile
    const size_t k0 = (size_t)kt * BK;
    load_tile<T, DK, LDK, NTB>(sK, k + k0 * k_stride + (size_t)hk * DK, k_stride, BK, tid);
    load_tile<T, DV, LDV, NTB>(sV, v + k0 * v_stride + (size_t)hk * DV, v_stride, BK, tid);
    __syncthreads();
    // S and dP: query rows ty + 16 i, key columns tx + 16 j
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    pair_products<DK, DV>(s, dp, sQ + ty * LDK, sQ + (ty + 16) * LDK, sK + tx * LDK,
                          sK + (tx + 16) * LDK, sdO + ty * LDV, sdO + (ty + 16) * LDV,
                          sV + tx * LDV, sV + (tx + 16) * LDV);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const bool ok = attends(s_segq[r], s_posq[r], s_segk[c], s_posk[c], a.causal,
                                a.window);
        const float p = ok ? expf(s[i][j] * a.scale - s_lse[r]) : 0.f;
        sdS[r * LP + c] = p * (dp[i][j] - s_delta[r]);
      }
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      const float ga = sdS[ty * LP + c], gb = sdS[(ty + 16) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kv = sK[c * LDK + tx + 16 * j];
        dQ[0][j] = fmaf(ga, kv, dQ[0][j]);
        dQ[1][j] = fmaf(gb, kv, dQ[1][j]);
      }
    }
    __syncthreads();                // sK, sV, sdS, s_segk rewritten next tile
  }
  T* dq = (T*)a.dq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t base = ((q0 + ty + 16 * i) * a.Hq + h) * DK + tx;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[base + 16 * j] = dQ[i][j] * a.scale;
  }
}

// --- bf16: tensor-core bodies on 64-row tiles --------------------------------

constexpr int LDB_PAD = 8;          // bf16 elements of padding per shared row
constexpr int LDPS = BB + LDB_PAD;  // row stride of the P / dS tiles
constexpr float LOG2E = 1.4426950408889634f;

template <int DK, int DV>
constexpr size_t bwd_bf16_smem_bytes() {
  // three [BB][DK + 8] tiles and three [BB][DV + 8] ones (one of each
  // resident, one of each streamed and double-buffered) and two
  // [BB][BB + 8] tiles (P^T and dS^T, or P and dS)
  return sizeof(__nv_bfloat16) *
         (size_t)(3 * BB * (DK + LDB_PAD) + 3 * BB * (DV + LDB_PAD) + 2 * BB * LDPS);
}

// Issue the copy of BB rows (row0 .. row0 + BB - 1 of ``src``, row r at
// src + r * stride; rows at or past ``n_rows`` zero-filled) into dst [BB][D + 8].
template <int D, int NTH = NTB>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int row0, int n_rows, int tid) {
  constexpr int CH = D / 8;         // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < BB * CH; c += NTH) {
    const int r = c / CH, ch = c % CH;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * (D + LDB_PAD) + ch * 8,
               src + (size_t)(ok ? row0 + r : 0) * stride + ch * 8, ok);
  }
}

// acc += A B^T over k = k0 .. k1 (16 columns a step), A [16][.] (row stride
// LA), B the 32 rows of the product's columns (row stride LB): one strip's
// piece of one product; a_off / b_off are the lane's ldmatrix offsets.
template <int LA, int LB>
__device__ __forceinline__ void strip_step(float (&acc)[4][4], const __nv_bfloat16* A,
                                           const __nv_bfloat16* B, int a_off, int b_off,
                                           int kk) {
  uint32_t a[4], b[4];
  ldsm4(a, A + a_off + kk);
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    ldsm4(b, B + np * 16 * LB + b_off + kk);
    mma16816(acc[2 * np], a, b[0], b[1]);
    mma16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// Two products on one 16-row strip: acc0 += A0 B^T over depth D0 and
// acc1 += A1 C^T over depth D1, A0 [16][D0] and A1 [16][D1] (rows of their
// tiles), B [BB][D0] / C [BB][D1] from their 32 rows n0 .. n0 + 31 (the
// product's columns); rows are padded by 8 elements. This is S = Q K^T (over
// DK) and dP = dO V^T (over DV) for a warp's 16 x 32 piece. Both run
// interleaved over their common depth, then the deeper one alone; each sum is
// in column order.
template <int D0, int D1>
__device__ __forceinline__ void strip_products(float (&acc0)[4][4], float (&acc1)[4][4],
                                               const __nv_bfloat16* A0,
                                               const __nv_bfloat16* A1,
                                               const __nv_bfloat16* B,
                                               const __nv_bfloat16* C, int lane) {
  constexpr int L0 = D0 + LDB_PAD, L1 = D1 + LDB_PAD, DC = D0 < D1 ? D0 : D1;
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_col = ((lane >> 3) & 1) * 8;
  const int a0_off = a_row * L0 + a_col, a1_off = a_row * L1 + a_col;
  const int b_off = b_row * L0 + b_col, c_off = b_row * L1 + b_col;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[j][e] = acc1[j][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < DC; kk += 16) {
    strip_step<L0, L0>(acc0, A0, B, a0_off, b_off, kk);
    strip_step<L1, L1>(acc1, A1, C, a1_off, c_off, kk);
  }
#pragma unroll
  for (int kk = DC; kk < D0; kk += 16) strip_step<L0, L0>(acc0, A0, B, a0_off, b_off, kk);
#pragma unroll
  for (int kk = DC; kk < D1; kk += 16) strip_step<L1, L1>(acc1, A1, C, a1_off, c_off, kk);
}

// acc = A B^T over depth D, A [16][D] (a strip's rows), B the 32 rows of
// the product's columns (row stride D + 8): one product of strip_products
// alone, in the same column order (so the same bits), holding one set of
// fragments and unrolled by 2 (the dq pass, which also holds PK: at Dk 256
// two products' fragments in flight spilled).
template <int D>
__device__ __forceinline__ void strip_product(float (&acc)[4][4], const __nv_bfloat16* A,
                                              const __nv_bfloat16* B, int lane) {
  constexpr int L = D + LDB_PAD;
  const int a_off = (lane & 15) * L + (lane >> 4) * 8;
  const int b_off = (((lane >> 4) << 3) + (lane & 7)) * L + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 16) strip_step<L, L>(acc, A, B, a_off, b_off, kk);
}

// acc += A X over k = 0 .. BB: A [16][BB] bf16 (a warp's rows of P^T, dS^T
// or dS, row stride LDPS), X [BB][D] (row stride D + 8), the warp's NJ x 8
// columns from column n0: pairs of 8-column tiles by ldmatrix .x4, an odd
// last one (D = 16: NJ = 1) by .x2.
template <int D, int NJ>
__device__ __forceinline__ void accumulate(float (&acc)[NJ][4], const __nv_bfloat16* A,
                                           const __nv_bfloat16* X, int n0, int lane) {
  constexpr int LD = D + LDB_PAD;
  const int a_off = (lane & 15) * LDPS + (lane >> 4) * 8;
  const int x_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0 + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < BB; kk += 16) {
    uint32_t a[4];
    ldsm4(a, A + a_off + kk);
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t b[4];
      ldsm4_t(b, X + x_off + kk * LD + np * 16);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
    if constexpr (NJ % 2 == 1) {
      uint32_t b[2];
      ldsm2_t(b, X + x_off + kk * LD + (NJ / 2) * 16);
      mma16816(acc[NJ - 1], a, b[0], b[1]);
    }
  }
}

// The next tile index after ``t`` up to ``hi`` whose summary may meet
// ``own``'s (``own_q``: own is the query tile), or -1.
__device__ __forceinline__ int next_live(int t, int hi, int4 own, const int4* other, bool own_q,
                                         int causal, int window) {
  for (; t <= hi; ++t) {
    const int4 o = __ldg(other + t);
    if (own_q ? may_attend(own, o, causal, window) : may_attend(o, own, causal, window))
      return t;
  }
  return -1;
}

template <int DK, int DV>
__device__ void dkdv_bf16(const BwdArgs& a) {
  using bf = __nv_bfloat16;
  // NJK, NJV: 8-column tiles of a warp's DK / 2 and DV / 2
  constexpr int LDK = DK + LDB_PAD, LDV = DV + LDB_PAD, NJK = DK / 16, NJV = DV / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sK = reinterpret_cast<bf*>(smem_raw);
  bf* sV = sK + BB * LDK;
  bf* sQ = sV + BB * LDV;           // [2][BB][LDK]
  bf* sdO = sQ + 2 * BB * LDK;      // [2][BB][LDV]
  bf* sP = sdO + 2 * BB * LDV;      // [BB][LDPS]: P^T (key rows, query columns)
  bf* sdS = sP + BB * LDPS;         // [BB][LDPS]: dS^T
  __shared__ int s_segk[BB], s_posk[BB];
  __shared__ int s_segq[2][BB], s_posq[2][BB];
  __shared__ float s_lse[2][BB], s_dlt[2][BB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;      // 16-row strip, column half
  const int g8 = lane >> 2, t4 = lane & 3;
  const int hk = blockIdx.y, G = a.Hq / a.Hkv, T_ = a.T, S = a.S;
  const int k0 = blockIdx.x * BB;
  const int n_q = (T_ + BB - 1) / BB;
  const size_t k_stride = (size_t)a.Hkv * DK, v_stride = (size_t)a.Hkv * DV;
  const size_t q_stride = (size_t)a.Hq * DK, o_stride = (size_t)a.Hq * DV;
  const bf *q = (const bf*)a.q, *dout = (const bf*)a.dout;

  copy_rows<DK>(sK, (const bf*)a.k + (size_t)hk * DK, k_stride, k0, S, tid);
  copy_rows<DV>(sV, (const bf*)a.v + (size_t)hk * DV, v_stride, k0, S, tid);
  cp_async_commit();
  if (tid < BB) {
    const bool ok = k0 + tid < S;
    s_segk[tid] = ok ? a.seg_kv[k0 + tid] : -2;
    s_posk[tid] = ok ? a.pos_kv[k0 + tid] : 0;
  }
  const int4 own = a.kv_sum[blockIdx.x];
  const int2 rg = a.range[blockIdx.x];
  // every key row live and of one segment: then a query tile whose rows
  // all meet every key row (one test per tile, below) needs no pair test
  const bool k_full = __syncthreads_and(tid >= BB || (k0 + tid < S && s_segk[tid] >= 0)) &&
                      own.x == own.y;

  // the streamed tile of step (g, qt): Q and dO rows of head h, their
  // segments, positions, lse and Delta
  auto issue = [&](int buf, int step) {
    const int h = hk * G + step / n_q, q0 = (step % n_q) * BB;
    copy_rows<DK>(sQ + buf * BB * LDK, q + (size_t)h * DK, q_stride, q0, T_, tid);
    copy_rows<DV>(sdO + buf * BB * LDV, dout + (size_t)h * DV, o_stride, q0, T_, tid);
    const int which = tid / BB, r = tid % BB;   // NTB == 4 * BB: one word each
    const bool ok = q0 + r < T_;
    const size_t row = ok ? (size_t)(q0 + r) : 0;
    const void* src = which == 0 ? (const void*)(a.seg_q + row)
                    : which == 1 ? (const void*)(a.pos_q + row)
                    : which == 2 ? (const void*)(a.lse + (size_t)h * T_ + row)
                                 : (const void*)(a.delta + (size_t)h * T_ + row);
    void* dst = which == 0 ? (void*)&s_segq[buf][r] : which == 1 ? (void*)&s_posq[buf][r]
              : which == 2 ? (void*)&s_lse[buf][r] : (void*)&s_dlt[buf][r];
    cp_async4(dst, src, ok);
  };
  // steps are g * n_q + qt over the live query tiles of the range
  auto advance = [&](int step) {
    int g = step < 0 ? 0 : step / n_q, qt = step < 0 ? rg.x : step % n_q + 1;
    for (; g < G; ++g, qt = rg.x) {
      const int t = next_live(qt, rg.y, own, a.q_sum, false, a.causal, a.window);
      if (t >= 0) return g * n_q + t;
    }
    return -1;
  };

  float dK[NJK][4], dV[NJV][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int j = 0; j < NJK; ++j) dK[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NJV; ++j) dV[j][e] = 0.f;
  }

  int step = advance(-1), buf = 0;
  if (step >= 0) issue(0, step);
  cp_async_commit();
  const float sl2 = a.scale * LOG2E;
  while (step >= 0) {
    const int nxt = advance(step);
    if (nxt >= 0) issue(buf ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();             // K, V and this step's tile have landed
    const int n_valid = T_ - (step % n_q) * BB;   // query rows of this tile
    bool pred = true;               // on the rows whose seg / pos this thread copied
    if (k_full && tid < 2 * BB) {
      const int r = tid % BB;
      if (tid < BB) {
        pred = r < n_valid && s_segq[buf][r] == own.x;
      } else {
        const int ps = s_posq[buf][r];
        pred = (!a.causal || ps >= own.w) && (a.window <= 0 || ps - own.z < a.window);
      }
    }
    const bool full = __syncthreads_and(k_full && pred);   // every pair live
    const bf* Qb = sQ + buf * BB * LDK;
    const bf* dOb = sdO + buf * BB * LDV;
    {
      // S^T = K Q^T and dP^T = V dO^T: key rows 16 wr .., query columns 32 wc ..
      float st[4][4], dpt[4][4];
      strip_products<DK, DV>(st, dpt, sK + 16 * wr * LDK, sV + 16 * wr * LDV,
                             Qb + 32 * wc * LDK, dOb + 32 * wc * LDV, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int kr = 16 * wr + g8 + 8 * hh;
          const int qc = 32 * wc + 8 * j + 2 * t4;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = qc + e;
            const bool ok = full || (c < n_valid && attends(s_segq[buf][c], s_posq[buf][c],
                                                            s_segk[kr], s_posk[kr], a.causal,
                                                            a.window));
            p[e] = ok ? exp2f(st[j][2 * hh + e] * sl2 - s_lse[buf][c] * LOG2E) : 0.f;
            ds[e] = p[e] * (dpt[j][2 * hh + e] - s_dlt[buf][c]);
          }
          *reinterpret_cast<uint32_t*>(sP + kr * LDPS + qc) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(sdS + kr * LDPS + qc) = pack_bf16(ds[0], ds[1]);
        }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q: key rows 16 wr .., columns wc * DV / 2 ..
    // and wc * DK / 2 ..
    accumulate<DV, NJV>(dV, sP + 16 * wr * LDPS, dOb, wc * (DV / 2), lane);
    accumulate<DK, NJK>(dK, sdS + 16 * wr * LDPS, Qb, wc * (DK / 2), lane);
    __syncthreads();                // buf and sP / sdS are rewritten next
    buf ^= 1;
    step = nxt;
  }
  cp_async_wait<0>();

  bf *dk = (bf*)a.dk, *dv = (bf*)a.dv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k0 + 16 * wr + g8 + 8 * hh;
    if (row >= S) continue;
    const size_t base = (size_t)row * a.Hkv + hk;
#pragma unroll
    for (int j = 0; j < NJK; ++j)
      *reinterpret_cast<uint32_t*>(dk + base * DK + wc * (DK / 2) + 8 * j + 2 * t4) =
          pack_bf16(dK[j][2 * hh] * a.scale, dK[j][2 * hh + 1] * a.scale);
#pragma unroll
    for (int j = 0; j < NJV; ++j)
      *reinterpret_cast<uint32_t*>(dv + base * DV + wc * (DV / 2) + 8 * j + 2 * t4) =
          pack_bf16(dV[j][2 * hh], dV[j][2 * hh + 1]);
  }
}

template <int DK, int DV>
__device__ void dq_bf16(const BwdArgs& a) {
  using bf = __nv_bfloat16;
  constexpr int LDK = DK + LDB_PAD, LDV = DV + LDB_PAD, NJ = DK / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sQ = reinterpret_cast<bf*>(smem_raw);
  bf* sdO = sQ + BB * LDK;
  bf* sK = sdO + BB * LDV;          // [2][BB][LDK]
  bf* sV = sK + 2 * BB * LDK;       // [2][BB][LDV]
  bf* sdS = sV + 2 * BB * LDV;      // [BB][LDPS]: dS (query rows, key columns)
  bf* sP = sdS + BB * LDPS;         // [BB][LDPS]: P (query rows, key columns)
  __shared__ int s_segq[BB], s_posq[BB];
  __shared__ float s_lse[BB], s_dlt[BB], s_dsum[2][BB];
  __shared__ int s_segk[2][BB], s_posk[2][BB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, hk = h / (a.Hq / a.Hkv), T_ = a.T, S = a.S;
  const int q0 = blockIdx.x * BB;
  const size_t k_stride = (size_t)a.Hkv * DK, v_stride = (size_t)a.Hkv * DV;
  const size_t q_stride = (size_t)a.Hq * DK, o_stride = (size_t)a.Hq * DV;
  const bf *k = (const bf*)a.k + (size_t)hk * DK, *v = (const bf*)a.v + (size_t)hk * DV;

  copy_rows<DK>(sQ, (const bf*)a.q + (size_t)h * DK, q_stride, q0, T_, tid);
  copy_rows<DV>(sdO, (const bf*)a.dout + (size_t)h * DV, o_stride, q0, T_, tid);
  cp_async_commit();
  if (tid < BB) {
    const bool ok = q0 + tid < T_;
    s_segq[tid] = ok ? a.seg_q[q0 + tid] : -2;
    s_posq[tid] = ok ? a.pos_q[q0 + tid] : 0;
    s_lse[tid] = ok ? a.lse[(size_t)h * T_ + q0 + tid] : 0.f;
  }
  const int4 own = a.q_sum[blockIdx.x];
  const int2 rg = a.range[blockIdx.x];

  auto issue = [&](int buf, int kt) {
    const int r0 = kt * BB;
    copy_rows<DK>(sK + buf * BB * LDK, k, k_stride, r0, S, tid);
    copy_rows<DV>(sV + buf * BB * LDV, v, v_stride, r0, S, tid);
    if (tid < 2 * BB) {
      const int r = tid % BB;
      const bool ok = r0 + r < S;
      const int* src = (tid < BB ? a.seg_kv : a.pos_kv) + (ok ? r0 + r : 0);
      cp_async4(tid < BB ? &s_segk[buf][r] : &s_posk[buf][r], src, ok);
    }
  };

  int kt = next_live(rg.x, rg.y, own, a.kv_sum, true, a.causal, a.window), buf = 0;
  if (kt >= 0) issue(0, kt);
  cp_async_commit();

  // Delta0 = rowsum(dO * O) of this tile's rows from the bf16 output, once:
  // warp w takes rows 8w .. 8w + 7, dO from shared memory, O from global
  // memory. And: every query row live and of one segment? (as k_full in
  // the dk/dv pass)
  cp_async_wait<1>();
  const bool q_full = __syncthreads_and(tid >= BB || s_segq[tid] >= 0) && own.x == own.y;
#pragma unroll
  for (int i = 0; i < BB / 8; ++i) {
    const int r = warp * (BB / 8) + i;
    float acc = 0.f;
    if (q0 + r < T_) {
      const bf* orow = (const bf*)a.o + ((size_t)(q0 + r) * a.Hq + h) * DV;
      for (int c = lane; c < DV / 8; c += 32) {
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(orow + c * 8));
        const uint4 dv = *reinterpret_cast<const uint4*>(sdO + r * LDV + c * 8);
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc = fmaf(__uint_as_float(ow[e] << 16), __uint_as_float(dw[e] << 16), acc);
          acc = fmaf(__uint_as_float(ow[e] & 0xffff0000u), __uint_as_float(dw[e] & 0xffff0000u),
                     acc);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) s_dlt[r] = acc;
  }

  // dQ0 = sum_j P (dP - Delta0) K and PK = sum_j P K in registers; the
  // exact Delta = sum_j P dP of row r, column half c in s_dsum[c][r] (each
  // tile's part added by the one thread that owns (c, r))
  float dQ[NJ][4], PK[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dQ[j][e] = PK[j][e] = 0.f;
  if (tid < 2 * BB) s_dsum[tid / BB][tid % BB] = 0.f;

  const float sl2 = a.scale * LOG2E;
  while (kt >= 0) {
    const int nxt = next_live(kt + 1, rg.y, own, a.kv_sum, true, a.causal, a.window);
    if (nxt >= 0) issue(buf ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();             // this tile has landed
    const int n_valid = S - kt * BB;  // key rows of this tile
    bool pred = true;               // on the rows whose seg / pos this thread copied
    if (q_full && tid < 2 * BB) {
      const int r = tid % BB;
      if (tid < BB) {
        pred = r < n_valid && s_segk[buf][r] == own.x;
      } else {
        const int ps = s_posk[buf][r];
        pred = (!a.causal || ps <= own.z) && (a.window <= 0 || own.w - ps < a.window);
      }
    }
    // every pair live? (the first time, the barrier also publishes s_dlt)
    const bool full = __syncthreads_and(q_full && pred);
    const bf* Kb = sK + buf * BB * LDK;
    const bf* Vb = sV + buf * BB * LDV;
    {
      // S = Q K^T, then dP = dO V^T: query rows 16 wr .., key columns 32 wc ..
      float s[4][4], dp[4][4], dsum[2] = {0.f, 0.f};
      strip_product<DK>(s, sQ + 16 * wr * LDK, Kb + 32 * wc * LDK, lane);
      strip_product<DV>(dp, sdO + 16 * wr * LDV, Vb + 32 * wc * LDV, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qr = 16 * wr + g8 + 8 * hh;
          const int kc = 32 * wc + 8 * j + 2 * t4;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = kc + e;
            const bool ok = full || (c < n_valid && attends(s_segq[qr], s_posq[qr],
                                                            s_segk[buf][c], s_posk[buf][c],
                                                            a.causal, a.window));
            p[e] = ok ? exp2f(s[j][2 * hh + e] * sl2 - s_lse[qr] * LOG2E) : 0.f;
            dsum[hh] = fmaf(p[e], dp[j][2 * hh + e], dsum[hh]);
            ds[e] = p[e] * (dp[j][2 * hh + e] - s_dlt[qr]);
          }
          *reinterpret_cast<uint32_t*>(sP + qr * LDPS + kc) = pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(sdS + qr * LDPS + kc) = pack_bf16(ds[0], ds[1]);
        }
      // this tile's part of Delta: the four lanes of a row, then its owner
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dsum[hh] += __shfl_xor_sync(0xffffffffu, dsum[hh], 1);
        dsum[hh] += __shfl_xor_sync(0xffffffffu, dsum[hh], 2);
        if (t4 == 0) s_dsum[wc][16 * wr + g8 + 8 * hh] += dsum[hh];
      }
    }
    __syncthreads();
    // dQ += dS K and PK += P K: query rows 16 wr .., columns wc * DK / 2 ..
    accumulate<DK, NJ>(dQ, sdS + 16 * wr * LDPS, Kb, wc * (DK / 2), lane);
    accumulate<DK, NJ>(PK, sP + 16 * wr * LDPS, Kb, wc * (DK / 2), lane);
    __syncthreads();                // buf, sP and sdS are rewritten next
    buf ^= 1;
    kt = nxt;
  }
  cp_async_wait<0>();

  // The exact Delta: the two column halves in order. dQ = dQ0 - (Delta -
  // Delta0) PK; the dk/dv pass reads Delta.
  __syncthreads();
  if (tid < BB && q0 + tid < T_)
    a.delta[(size_t)h * T_ + q0 + tid] = s_dsum[0][tid] + s_dsum[1][tid];

  bf* dq = (bf*)a.dq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * wr + g8 + 8 * hh, row = q0 + r;
    const float corr = s_dsum[0][r] + s_dsum[1][r] - s_dlt[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = wc * (DK / 2) + 8 * j + 2 * t4;
      if (row < T_)
        *reinterpret_cast<uint32_t*>(dq + ((size_t)row * a.Hq + h) * DK + col) =
            pack_bf16(fmaf(-corr, PK[j][2 * hh], dQ[j][2 * hh]) * a.scale,
                      fmaf(-corr, PK[j][2 * hh + 1], dQ[j][2 * hh + 1]) * a.scale);
    }
  }
}

// The tile ranges and summaries both passes walk, for tiles of R <= 64
// rows (R = BB for bf16, BQ for float32). One block per tile, query tiles
// first: it writes its tile's summary (segment min, max, position min, max
// of its live rows; [INT_MAX, -1, INT_MAX, INT_MIN] if none) and its range
// of the other side's tiles: the first and the last tile holding a pair
// that attends, [n_other, -1] if none. The scans run from both ends, eight
// candidate tiles at a time (one per warp): a warp reduces its candidate's
// summary, and only a candidate whose summary can meet this tile's is
// tested pair by pair, so a scan mostly stops at its first live tile.
// Deterministic: every output element is written by one block.
__device__ __forceinline__ int4 warp_summary(int sg0, int ps0, int sg1, int ps1) {
  int4 r = make_int4(sg0 >= 0 ? sg0 : INT_MAX, sg0 >= 0 ? sg0 : -1,
                     sg0 >= 0 ? ps0 : INT_MAX, sg0 >= 0 ? ps0 : INT_MIN);
  if (sg1 >= 0) {
    r.x = min(r.x, sg1); r.y = max(r.y, sg1);
    r.z = min(r.z, ps1); r.w = max(r.w, ps1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r.x = min(r.x, __shfl_xor_sync(0xffffffffu, r.x, off));
    r.y = max(r.y, __shfl_xor_sync(0xffffffffu, r.y, off));
    r.z = min(r.z, __shfl_xor_sync(0xffffffffu, r.z, off));
    r.w = max(r.w, __shfl_xor_sync(0xffffffffu, r.w, off));
  }
  return r;
}

__global__ void __launch_bounds__(NTB)
flash_bwd_tiles_kernel(const int* __restrict__ seg_q, const int* __restrict__ pos_q,
                       const int* __restrict__ seg_kv, const int* __restrict__ pos_kv,
                       int2* __restrict__ kv_range, int2* __restrict__ q_range,
                       int4* __restrict__ q_sum, int4* __restrict__ kv_sum, int T_, int S,
                       int R, int causal, int window) {
  __shared__ int s_seg[64], s_pos[64];
  __shared__ int4 s_own;
  __shared__ int s_hit[NTB / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_q = (T_ + R - 1) / R, n_kv = (S + R - 1) / R;
  const bool own_q = blockIdx.x < n_q;
  const int t = own_q ? blockIdx.x : blockIdx.x - n_q;
  const int *seg = own_q ? seg_q : seg_kv, *pos = own_q ? pos_q : pos_kv;
  const int *oseg = own_q ? seg_kv : seg_q, *opos = own_q ? pos_kv : pos_q;
  const int n_rows = own_q ? T_ : S, n_orows = own_q ? S : T_;
  const int n_other = own_q ? n_kv : n_q;

  // this tile's rows (dead past n_rows) and summary
  if (tid < 64) {
    const int row = t * R + tid;
    const bool ok = tid < R && row < n_rows;
    s_seg[tid] = ok ? seg[row] : -2;
    s_pos[tid] = ok ? pos[row] : 0;
  }
  __syncthreads();
  if (warp == 0) {
    const int4 own = warp_summary(s_seg[lane], s_pos[lane], s_seg[lane + 32], s_pos[lane + 32]);
    if (lane == 0) {
      s_own = own;
      (own_q ? q_sum : kv_sum)[t] = own;
    }
  }
  __syncthreads();
  const int4 own = s_own;
  int2 rg = make_int2(n_other, -1);
  if (own.x <= own.y) {
    // dir 0: the first live tile from the start; dir 1: from the end
    for (int dir = 0; dir < 2; ++dir) {
      for (int base = 0; base < n_other; base += NTB / 32) {
        const int j = dir == 0 ? base + warp : n_other - 1 - base - warp;
        bool live = false;
        if (j >= 0 && j < n_other) {
          int sg[2], ps[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = lane + 32 * h, row = j * R + r;
            const bool ok = r < R && row < n_orows;
            sg[h] = ok ? oseg[row] : -2;
            ps[h] = ok ? opos[row] : 0;
          }
          const int4 other = warp_summary(sg[0], ps[0], sg[1], ps[1]);
          if (own_q ? may_attend(own, other, causal, window)
                    : may_attend(other, own, causal, window)) {
            for (int k = 0; k < R && !live; ++k) {
#pragma unroll
              for (int h = 0; h < 2; ++h)
                live |= own_q ? attends(s_seg[k], s_pos[k], sg[h], ps[h], causal, window)
                              : attends(sg[h], ps[h], s_seg[k], s_pos[k], causal, window);
              live = __any_sync(0xffffffffu, live);
            }
          }
        }
        if (lane == 0) s_hit[warp] = live;
        __syncthreads();
        int hit = -1;               // the first candidate of this round that is live
        for (int w = NTB / 32 - 1; w >= 0; --w)
          if (s_hit[w]) hit = dir == 0 ? base + w : n_other - 1 - base - w;
        __syncthreads();
        if (hit >= 0) {
          if (dir == 0) rg.x = hit; else rg.y = hit;
          break;
        }
      }
    }
  }
  if (tid == 0) (own_q ? kv_range : q_range)[t] = rg;
}


// --- forward, bf16: tensor-core body on 64-row tiles (the source note at the
// top of this file sets out the design) ---------------------------------------
constexpr int NTF = 128;            // threads of a bf16 forward block: 4 warps
constexpr float LN2 = 0.6931471805599453f;

struct FwdArgs {
  const __nv_bfloat16 *q, *k, *v;    // q [T, Hq, DK]; k [S, Hkv, DK]; v [S, Hkv, DV]
  const int *seg_q, *pos_q, *seg_kv, *pos_kv;
  const int2* range;                 // per query tile: [lo, hi] of its KV tiles
  const int4* q_sum;                 // per query tile: seg min/max, pos min/max
  const int4* kv_sum;                // per KV tile: the same
  __nv_bfloat16* out;                // [T, Hq, DV] (n_split == 1)
  float2* ws_ml;                     // [n_split, T, Hq] (m, l) (n_split > 1)
  float* ws_acc;                     // [n_split, T, Hq, DV] (n_split > 1)
  float* lse;                        // [Hq, T] or null (n_split == 1)
  int T, S, Hq, Hkv, causal, window, n_split;
  float scale;
};

template <int DK, int DV>
constexpr size_t fwd_bf16_smem_bytes() {
  // Q, K tiles [BB][DK + 8], the V tile [BB][DV + 8]
  return sizeof(__nv_bfloat16) * (size_t)(BB * (2 * (DK + LDB_PAD) + DV + LDB_PAD));
}

// Blocks per SM the registers must leave room for (the shared memory fits
// them: 101 KB a block at Dh 256, 67 KB at (192, 128), 63 KB at 160, 52 KB
// at 128, 28 KB at 64); four at Dh 64 would cap a thread at 128 registers,
// which spills, and three at Dh 160 (168 registers) spill too. The output
// accumulator (DV / 2 floats a thread) sets the registers.
template <int DK, int DV>
constexpr int fwd_min_blocks() {
  return DV > 128 ? 2 : 3;
}

// One block per (64-row query tile, query head, KV split): 1-D grid, the
// query head fastest, so that the heads of a GQA group (and of one query
// tile) run side by side and read each K/V tile from L2. Warp w owns query
// rows 16 w .. 16 w + 15 of the tile.
template <int DK, int DV>
__global__ void __launch_bounds__(NTF, fwd_min_blocks<DK, DV>())
    flash_fwd_mma_kernel(const FwdArgs a) {
  using bf = __nv_bfloat16;
  // NJ: 8-column tiles of a warp's output
  constexpr int LDK = DK + LDB_PAD, LDV = DV + LDB_PAD, NJ = DV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* sQ = reinterpret_cast<bf*>(smem_raw);
  bf* sK = sQ + BB * LDK;
  bf* sV = sK + BB * LDK;
  __shared__ int s_segk[2][BB], s_posk[2][BB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int T_ = a.T, S = a.S, n_q = (T_ + BB - 1) / BB;
  const int h = blockIdx.x % a.Hq, qt = (blockIdx.x / a.Hq) % n_q;
  const int z = blockIdx.x / (a.Hq * n_q);
  const int hk = h / (a.Hq / a.Hkv), q0 = qt * BB;
  const size_t k_stride = (size_t)a.Hkv * DK, v_stride = (size_t)a.Hkv * DV;
  const size_t q_stride = (size_t)a.Hq * DK;
  const bf *k = a.k + (size_t)hk * DK, *v = a.v + (size_t)hk * DV;

  // this thread's query rows 16 warp + g8 + 8 hh (dead at or past T)
  int sq[2], pq[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * warp + g8 + 8 * hh;
    sq[hh] = row < T_ ? a.seg_q[row] : -2;
    pq[hh] = row < T_ ? a.pos_q[row] : 0;
  }
  const int4 own = a.q_sum[qt];
  // split z walks a contiguous piece of the query tile's range
  int lo = a.range[qt].x, hi = a.range[qt].y;
  if (a.n_split > 1 && hi >= lo) {
    const long long len = hi - lo + 1;
    const int base = lo;
    lo = base + (int)(z * len / a.n_split);
    hi = base + (int)((z + 1) * len / a.n_split) - 1;
  }

  // K and the seg / pos of its rows (thread tid copies seg (tid < BB) or
  // pos of row tid % BB)
  auto issue_k = [&](int buf, int kt) {
    const int r0 = kt * BB, r = tid % BB;
    copy_rows<DK, NTF>(sK, k, k_stride, r0, S, tid);
    const bool ok = r0 + r < S;
    const int* src = (tid < BB ? a.seg_kv : a.pos_kv) + (ok ? r0 + r : 0);
    cp_async4(tid < BB ? &s_segk[buf][r] : &s_posk[buf][r], src, ok);
  };
  copy_rows<DK, NTF>(sQ, a.q + (size_t)h * DK, q_stride, q0, T_, tid);
  int kt = next_live(lo, hi, own, a.kv_sum, true, a.causal, a.window), buf = 0;
  if (kt >= 0) issue_k(0, kt);
  cp_async_commit();
  // every query row live and of one segment: then a KV tile whose rows all
  // meet every query row (one test per tile, below) needs no pair test
  const bool q_full =
      __syncthreads_and(tid >= BB || (q0 + tid < T_ && a.seg_q[q0 + tid] >= 0)) &&
      own.x == own.y;

  float o[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // log2 units; l per thread
  const float sl2 = a.scale * LOG2E;
  const int a_off = (16 * warp + (lane & 15)) * LDK + (lane >> 4) * 8;
  const int b_off = (((lane >> 4) << 3) + (lane & 7)) * LDK + ((lane >> 3) & 1) * 8;
  const int x_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * LDV + (lane >> 4) * 8;

  while (kt >= 0) {
    const int nxt = next_live(kt + 1, hi, own, a.kv_sum, true, a.causal, a.window);
    cp_async_wait<0>();             // Q, K and this tile's seg / pos have landed
    const int n_valid = S - kt * BB;  // key rows of this tile
    bool pred = true;               // on the row whose seg / pos this thread copied
    if (q_full) {
      const int r = tid % BB;
      if (tid < BB) {
        pred = r < n_valid && s_segk[buf][r] == own.x;
      } else {
        const int ps = s_posk[buf][r];
        pred = (!a.causal || ps <= own.z) && (a.window <= 0 || own.w - ps < a.window);
      }
    }
    // every pair live? The barrier also publishes every thread's copies and
    // ends the last tile's P V (sV is free)
    const bool full = __syncthreads_and(q_full && pred);
    copy_rows<DV, NTF>(sV, v, v_stride, kt * BB, S, tid);   // in flight during S
    cp_async_commit();

    // S = Q K^T over DK: the warp's 16 rows x 64 keys, Q's fragments from
    // shared memory
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DK; kk += 16) {
      uint32_t qa[4];
      ldsm4(qa, sQ + a_off + kk);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, sK + np * 16 * LDK + b_off + kk);
        mma16816(s[2 * np], qa, b[0], b[1]);
        mma16816(s[2 * np + 1], qa, b[2], b[3]);
      }
    }
    __syncthreads();                // every warp is done with sK
    if (nxt >= 0) issue_k(buf ^ 1, nxt);
    cp_async_commit();

    // mask and online softmax in registers: row g8 + 8 hh of the strip is
    // held by the 4 lanes of a quad, 16 keys each
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t4 + e;
          const bool ok = full || (c < n_valid && attends(sq[hh], pq[hh], s_segk[buf][c],
                                                          s_posk[buf][c], a.causal, a.window));
          const float x = ok ? s[j][2 * hh + e] * sl2 : -INFINITY;
          s[j][2 * hh + e] = x;
          mx[hh] = fmaxf(mx[hh], x);
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      const float base = m_new == -INFINITY ? 0.f : m_new;   // a row with no live key yet
      const float alpha = exp2f(m[hh] - base);
      m[hh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * hh + e] - base);
          s[j][2 * hh + e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        o[j][2 * hh] *= alpha;
        o[j][2 * hh + 1] *= alpha;
      }
    }
    cp_async_wait<1>();             // this tile's V has landed (the next K may not)
    __syncthreads();
    // O += P V over DV columns: P rounded to bf16 as the A operand, straight
    // from the S fragments (the m16n8 accumulator layout is the m16k16 A
    // layout)
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      uint32_t pa[4] = {pack_bf16(s[2 * k2][0], s[2 * k2][1]),
                        pack_bf16(s[2 * k2][2], s[2 * k2][3]),
                        pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]),
                        pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3])};
#pragma unroll
      for (int np = 0; np < DV / 16; ++np) {
        uint32_t b[4];
        ldsm4_t(b, sV + x_off + k2 * 16 * LDV + np * 16);
        mma16816(o[2 * np], pa, b[0], b[1]);
        mma16816(o[2 * np + 1], pa, b[2], b[3]);
      }
    }
    buf ^= 1;
    kt = nxt;
  }
  cp_async_wait<0>();

  // the row sums over the quad; then the output (or the split's partial)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + 16 * warp + g8 + 8 * hh;
    if (row >= T_) continue;
    const float lv = l[hh];
    if (a.n_split == 1) {
      const float inv = lv > 0.f ? 1.f / lv : 0.f;
      bf* dst = a.out + ((size_t)row * a.Hq + h) * DV + 2 * t4;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
      if (a.lse != nullptr && t4 == 0)
        a.lse[(size_t)h * T_ + row] = lv > 0.f ? (m[hh] + log2f(lv)) * LN2 : -INFINITY;
    } else {
      // partial state of split z in natural-log units, acc only where l > 0
      const size_t idx = (size_t)z * T_ * a.Hq + (size_t)row * a.Hq + h;
      if (t4 == 0) a.ws_ml[idx] = make_float2(lv > 0.f ? m[hh] * LN2 : NEG, lv);
      if (lv > 0.f) {
        float* dst = a.ws_acc + idx * DV + 2 * t4;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[j][2 * hh], o[j][2 * hh + 1]);
      }
    }
  }
}

// Blocks per SM the compiler must leave registers for: two at Dh <= 64 in
// bf16 (the tiles take 75 KB of shared memory at 64), else one.
template <typename T, int DK, int DV>
constexpr int bwd_min_blocks() {
  return std::is_same<T, __nv_bfloat16>::value && DK <= 64 && DV <= 64 ? 2 : 1;
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(NTB, bwd_min_blocks<T, DK, DV>())
    flash_bwd_dkdv_kernel(const BwdArgs a) {
  if constexpr (std::is_same<T, float>::value) dkdv_f32<DK, DV>(a);
  else dkdv_bf16<DK, DV>(a);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(NTB, bwd_min_blocks<T, DK, DV>())
    flash_bwd_dq_kernel(const BwdArgs a) {
  if constexpr (std::is_same<T, float>::value) dq_f32<DK, DV>(a);
  else dq_bf16<DK, DV>(a);
}
template <typename T, int DK, int DV>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg_q,
               const void* pos_q, const void* seg_kv, const void* pos_kv, void* out,
               void* ws_ml, void* ws_acc, void* lse, int T_, int S, int Hq, int Hkv,
               int causal, int window, float scale, int n_split, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(T_ / BQ, Hq, n_split);
  flash_fwd_kernel<T, DK, DV><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg_q, (const int*)pos_q,
      (const int*)seg_kv, (const int*)pos_kv, (T*)out, (float2*)ws_ml,
      (float*)ws_acc, (float*)lse, T_, S, Hq, Hkv, causal, window, scale, n_split);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int launch_fwd_mma(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_bf16_smem_bytes<DK, DV>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_q = (a.T + BB - 1) / BB;
  flash_fwd_mma_kernel<DK, DV><<<n_q * a.Hq * a.n_split, NTF, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_combine(const void* ws_ml, const void* ws_acc, void* out, void* lse, int T_,
                   int Hq, int n_split, cudaStream_t stream) {
  flash_combine_kernel<T, D><<<T_ * Hq, 64, 0, stream>>>(
      (const float2*)ws_ml, (const float*)ws_acc, (T*)out, (float*)lse, T_ * Hq, Hq,
      n_split);
  return (int)cudaGetLastError();
}

template <typename T, int DK, int DV>
int launch_bwd(bool dq_pass, const BwdArgs& a, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr size_t smem = f32 ? bwd_f32_smem_bytes<DK, DV>() : bwd_bf16_smem_bytes<DK, DV>();
  constexpr int B = f32 ? BQ : BB;
  static bool attr_set[2] = {false, false};
  void (*kernel)(const BwdArgs) =
      dq_pass ? flash_bwd_dq_kernel<T, DK, DV> : flash_bwd_dkdv_kernel<T, DK, DV>;
  if (!attr_set[dq_pass]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set[dq_pass] = true;
  }
  dim3 grid = dq_pass ? dim3((a.T + B - 1) / B, a.Hq) : dim3((a.S + B - 1) / B, a.Hkv);
  kernel<<<grid, NTB, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tile sizes the caller must pad T and S to (seg = -2 on pad rows),
// and the largest KV split.
int flash_attention_block_q() { return BQ; }
int flash_attention_block_kv() { return BK; }
int flash_attention_max_split() { return MAX_SPLIT; }

// The (key, value) widths the library is built for: (Dk, Dv) -> CASE(type,
// DK, DV); the merge pass dispatches on the value width alone.
#define FA_WIDTHS(CASE, TYPE)                                      \
  if (Dk == 16 && Dv == 16) CASE(TYPE, 16, 16);                    \
  if (Dk == 32 && Dv == 32) CASE(TYPE, 32, 32);                    \
  if (Dk == 64 && Dv == 64) CASE(TYPE, 64, 64);                    \
  if (Dk == 128 && Dv == 128) CASE(TYPE, 128, 128);                \
  if (Dk == 160 && Dv == 160) CASE(TYPE, 160, 160);                \
  if (Dk == 256 && Dv == 256) CASE(TYPE, 256, 256);                \
  if (Dk == 192 && Dv == 128) CASE(TYPE, 192, 128)
#define FA_DISPATCH(CASE)                                          \
  if (dtype == 0) {                                                \
    FA_WIDTHS(CASE, float);                                        \
  } else if (dtype == 1) {                                         \
    FA_WIDTHS(CASE, __nv_bfloat16);                                \
  }                                                                \
  return (int)cudaErrorInvalidValue

// The float32 split pass (bf16 runs flash_attention_fwd_mma). q, k are Dk
// wide, v and out Dv wide. dtype must be 0 (float32), the one this entry
// takes. With n_split == 1 it
// writes ``out`` (and, if ``lse`` is not null, the rows' log-sum-exp into
// lse [Hq, T] float32); with n_split > 1 it writes only the partial states:
// ws_ml must hold n_split * T * Hq float2 (m, l) and ws_acc n_split * T * Hq
// * Dv floats (uninitialised is fine; acc is written only where l > 0), and
// flash_attention_combine merges them into ``out`` (and ``lse``). Returns a
// cudaError_t code (0 = ok); cudaErrorInvalidValue for a shape or dtype
// this library does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* seg_q, const void* pos_q, const void* seg_kv,
                        const void* pos_kv, void* out, void* ws_ml, void* ws_acc,
                        void* lse, int T, int S, int Hq, int Hkv, int Dk, int Dv, int dtype,
                        int causal, int window, float scale, int n_split,
                        void* stream) {
  if (T <= 0 || S <= 0 || T % BQ || S % BK || Hkv <= 0 || Hq % Hkv ||
      n_split < 1 || n_split > MAX_SPLIT ||
      (n_split > 1 && (ws_ml == nullptr || ws_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_CASE(TYPE, DK, DV)                                                          \
  return launch_fwd<TYPE, DK, DV>(q, k, v, seg_q, pos_q, seg_kv, pos_kv, out, ws_ml,   \
                                  ws_acc, lse, T, S, Hq, Hkv, causal, window, scale,   \
                                  n_split, st)
  if (dtype == 0) {
    FA_WIDTHS(FA_CASE, float);
  }
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

// The bf16 forward on the tensor cores (flash_fwd_mma_kernel). q, k, v
// bfloat16 as for flash_attention_fwd (q, k Dk wide, v and out Dv);
// ``range``, ``q_sum`` and ``kv_sum`` are the metadata's tile ranges and
// summaries for tiles of BB = 64 rows
// (flash_attention_bwd_tiles with R = 64; only ``range`` per query tile and
// the summaries are read). n_split == 1 writes ``out`` (and ``lse`` if not
// null); n_split > 1 writes the partial states for flash_attention_combine
// (ws_ml, ws_acc as for flash_attention_fwd): split z of a query tile walks
// [lo + z len / n_split, lo + (z + 1) len / n_split) of its range [lo, hi],
// len = hi - lo + 1. Returns a cudaError_t code.
int flash_attention_fwd_mma(const void* q, const void* k, const void* v, const void* seg_q,
                            const void* pos_q, const void* seg_kv, const void* pos_kv,
                            const void* range, const void* q_sum, const void* kv_sum,
                            void* out, void* ws_ml, void* ws_acc, void* lse, int T, int S,
                            int Hq, int Hkv, int Dk, int Dv, int causal, int window,
                            float scale, int n_split, void* stream) {
  if (T <= 0 || S <= 0 || T % BQ || S % BK || Hkv <= 0 || Hq % Hkv || n_split < 1 ||
      n_split > MAX_SPLIT || range == nullptr || q_sum == nullptr || kv_sum == nullptr ||
      (n_split == 1 && out == nullptr) ||
      (n_split > 1 && (ws_ml == nullptr || ws_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  FwdArgs a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
            (const int*)seg_q, (const int*)pos_q, (const int*)seg_kv, (const int*)pos_kv,
            (const int2*)range, (const int4*)q_sum, (const int4*)kv_sum,
            (__nv_bfloat16*)out, (float2*)ws_ml, (float*)ws_acc, (float*)lse,
            T, S, Hq, Hkv, causal, window, n_split, scale};
  cudaStream_t st = (cudaStream_t)stream;
#define FM_CASE(TYPE, DK, DV) return launch_fwd_mma<DK, DV>(a, st)
  FA_WIDTHS(FM_CASE, __nv_bfloat16);
#undef FM_CASE
  return (int)cudaErrorInvalidValue;
}

// The merge pass: out [T, Hq, D] (dtype as above; D a value width of
// FA_WIDTHS: 16, 32, 64, 128, 160 or 256) and, if ``lse`` is not null,
// lse [Hq, T] from the n_split partial states that flash_attention_fwd
// wrote. Returns a cudaError_t code.
int flash_attention_combine(const void* ws_ml, const void* ws_acc, void* out, void* lse,
                            int T, int Hq, int D, int dtype, int n_split, void* stream) {
  if (T <= 0 || Hq <= 0 || n_split < 2 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FC_ONE(TYPE, DIM) \
  if (D == DIM) return launch_combine<TYPE, DIM>(ws_ml, ws_acc, out, lse, T, Hq, n_split, st)
#define FC_CASE(TYPE) \
  FC_ONE(TYPE, 16);   \
  FC_ONE(TYPE, 32);   \
  FC_ONE(TYPE, 64);   \
  FC_ONE(TYPE, 128);  \
  FC_ONE(TYPE, 160);  \
  FC_ONE(TYPE, 256)
  if (dtype == 0) {
    FC_CASE(float);
  } else if (dtype == 1) {
    FC_CASE(__nv_bfloat16);
  }
#undef FC_CASE
#undef FC_ONE
  return (int)cudaErrorInvalidValue;
}

// Rows per tile of the backward passes for a dtype (0 = float32,
// 1 = bfloat16): the tiles of the ranges and summaries the wrapper passes.
int flash_attention_bwd_block(int dtype) { return dtype == 1 ? BB : BQ; }

// The ranges and summaries of tiles of ``R`` rows (32 or 64) that both
// passes read (see flash_bwd_tiles_kernel): kv_range [n_q, 2], q_range
// [n_kv, 2], q_sum [n_q, 4], kv_sum [n_kv, 4], int32, n_q = ceil(T / R),
// n_kv = ceil(S / R). Returns a cudaError_t code.
int flash_attention_bwd_tiles(const void* seg_q, const void* pos_q, const void* seg_kv,
                              const void* pos_kv, void* kv_range, void* q_range, void* q_sum,
                              void* kv_sum, int T, int S, int R, int causal, int window,
                              void* stream) {
  if (T <= 0 || S <= 0 || (R != BQ && R != BB)) return (int)cudaErrorInvalidValue;
  const int n = (T + R - 1) / R + (S + R - 1) / R;
  flash_bwd_tiles_kernel<<<n, NTB, 0, (cudaStream_t)stream>>>(
      (const int*)seg_q, (const int*)pos_q, (const int*)seg_kv, (const int*)pos_kv,
      (int2*)kv_range, (int2*)q_range, (int4*)q_sum, (int4*)kv_sum, T, S, R, causal, window);
  return (int)cudaGetLastError();
}

// The two backward passes. Inputs: q [T, Hq, Dk], o, dout [T, Hq, Dv],
// k [S, Hkv, Dk], v [S, Hkv, Dv], the forward's lse [Hq, T] (all
// contiguous, T and S padded as for the forward), the rows' int32 seg and
// pos; per tile of the tile size above,
// ``range`` (int32 [n, 2]: for the dq pass per query tile its KV tiles
// [lo, hi], for the dk/dv pass per KV tile its query tiles) and the
// summaries ``q_sum`` / ``kv_sum`` (int32 [n, 4]: segment min, max and
// position min, max of the tile's live rows). ``delta`` (float32 [Hq, T]) is
// written by the dq pass, which runs first, and read by the dk/dv pass.
// Returns a cudaError_t code.
#define FB_ARGS(DQ, DK, DV)                                                               \
  BwdArgs a{q, k, v, o, dout, (const float*)lse, (float*)delta, (const int*)seg_q,         \
            (const int*)pos_q, (const int*)seg_kv, (const int*)pos_kv, (const int2*)range, \
            (const int4*)q_sum, (const int4*)kv_sum, DQ, DK, DV, T, S, Hq, Hkv, causal,   \
            window, scale}
#define FB_CHECK                                                                      \
  if (T <= 0 || S <= 0 || T % BQ || S % BK || Hkv <= 0 || Hq % Hkv || delta == nullptr || \
      range == nullptr || q_sum == nullptr || kv_sum == nullptr)                       \
    return (int)cudaErrorInvalidValue

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* delta, const void* seg_q,
                           const void* pos_q, const void* seg_kv, const void* pos_kv,
                           const void* range, const void* q_sum, const void* kv_sum, void* dq,
                           int T, int S, int Hq, int Hkv, int Dk, int Dv, int dtype,
                           int causal, int window, float scale, void* stream) {
  FB_CHECK;
  FB_ARGS(dq, nullptr, nullptr);
  cudaStream_t st = (cudaStream_t)stream;
#define FQ_CASE(TYPE, DK, DV) return launch_bwd<TYPE, DK, DV>(true, a, st)
  FA_DISPATCH(FQ_CASE);
#undef FQ_CASE
}

int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, const void* delta,
                             const void* seg_q, const void* pos_q, const void* seg_kv,
                             const void* pos_kv, const void* range, const void* q_sum,
                             const void* kv_sum, void* dk, void* dv, int T, int S, int Hq,
                             int Hkv, int Dk, int Dv, int dtype, int causal, int window,
                             float scale, void* stream) {
  FB_CHECK;
  FB_ARGS(nullptr, dk, dv);
  cudaStream_t st = (cudaStream_t)stream;
#define FK_CASE(TYPE, DK, DV) return launch_bwd<TYPE, DK, DV>(false, a, st)
  FA_DISPATCH(FK_CASE);
#undef FK_CASE
}

#undef FB_ARGS
#undef FB_CHECK
#undef FA_DISPATCH
#undef FA_WIDTHS

}  // extern "C"
