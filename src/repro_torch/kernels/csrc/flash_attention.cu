// Packed-varlen causal flash attention (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel kernels/flash_attention.py::
// flash_attention_pallas (body ``_kernel``) of the JAX package. Same
// function: q [T,Hq,D], k [S,Hkv,D], v [S,Hkv,D] token-major, int32
// seg/pos per row; query head h reads kv head h / (Hq/Hkv);
//   attend(i, j) iff seg_q[i] == seg_kv[j] && seg_q[i] >= 0
//                 && (!causal || pos_kv[j] <= pos_q[i])
//                 && (window <= 0 || pos_q[i] - pos_kv[j] < window)
// online softmax in float32; a row with no attended key is written as 0.
// For training the forward can also write each row's log-sum-exp
// lse [Hq, T] (float32; -inf for a row with no attended key), and two
// backward kernels (below the forward) compute dq and dk/dv from it.
//
// Design. The TPU kernel carries (m, l, acc) across a sequential grid
// axis over KV tiles; blocks on the card run in no order, so here a block
// owns one (query tile of BQ rows, query head, KV split) triple and loops
// over its share of the KV tiles itself, with the running state in
// registers and shared memory:
//
// * Tile skipping. Before loading a KV tile the block tests every key row
//   of it against every query row of its tile (segment, causal, window)
//   and skips tiles with no live pair. The serving engine's packed KV
//   buffer is mostly other requests' context rows, and local layers see a
//   512-row window of contexts up to 4k, so most tiles are skipped.
// * Split KV. Decode tokens (one per request) share query tiles and each
//   attends its whole context, so one block per query tile would walk
//   thousands of tiles in series. The KV tiles are dealt round-robin to
//   ``n_split`` blocks per query tile; each writes its partial
//   (m, l, unnormalised acc) to a float32 workspace and a second kernel,
//   launched through its own entry point, merges them (flash-decoding).
//   ``n_split == 1`` writes the output directly.
//
// Bound. At the serving shapes (gemma3-1b: Hq=4, Hkv=1, D=256) the work
// per byte is high (a K/V row meets up to 512 queries x 4 heads), and the
// roofline bound of a mixed engine step is a few hundredths of a ms. This
// version does its products with plain float32 FMAs from shared memory
// (register-blocked 4x2 score and 4x(D/16) output tiles per thread), which
// keeps it well above that bound; mma/wgmma tiles are the next step.
// Inputs are converted to float32 once, when a tile lands in shared
// memory, with 16-byte global loads issued in batches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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
__device__ __forceinline__ void unpack(const uint4& u, float* dst, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);            // low half first
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK, sV: [BQ|BK][D + 1] floats; sP: [BQ][BK + 1] floats
  return sizeof(float) * (size_t)(3 * BQ * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ pos_q, const int* __restrict__ seg_kv,
                 const int* __restrict__ pos_kv, T* __restrict__ out,
                 float2* __restrict__ ws_ml, float* __restrict__ ws_acc,
                 float* __restrict__ lse, int T_, int S, int Hq, int Hkv, int causal,
                 int window, float scale, int n_split) {
  static_assert(BQ == 32 && BK == 32 && NT == 128, "thread map assumes 32x32 tiles");
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int LD = D + 1;         // odd row stride: conflict-free column reads
  constexpr int LP = BK + 1;
  constexpr int DJ = D / 16;        // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  __shared__ int s_segq[BQ], s_posq[BQ], s_segk[BK], s_posk[BK];
  __shared__ float s_m[BQ], s_l[BQ], s_alpha[BQ];
  __shared__ int s_rng[2];          // live query rows: segment min / max

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, z = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q0 = (size_t)blockIdx.x * BQ;
  const size_t kv_stride = (size_t)Hkv * D;

  load_tile<T, D, LD>(sQ, q + (q0 * Hq + h) * D, (size_t)Hq * D, BQ, tid);
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
      load_tile<T, D, LD>(sK, k + k0 * kv_stride + (size_t)hk * D, kv_stride, BK, tid);
      load_tile<T, D, LD>(sV, v + k0 * kv_stride + (size_t)hk * D, kv_stride, BK, tid);
      __syncthreads();

      // scores: rows ty + 8i, columns tx + 16j
      float sc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 8 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 2; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
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
          const float vv = sV[c * LD + tx + 16 * j];
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
        out[((q0 + r) * Hq + h) * D + tx + 16 * j] = from_f<T>(o);
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
      float* dst = ws_acc + (z * TH + (q0 + r) * Hq + h) * D;
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
// Backward. The JAX package has no backward kernel: it differentiates its
// plain jnp flash attention. Here the forward is a CUDA kernel, so its
// gradient is one too, in two passes with no atomics (each output element
// is written by exactly one block, so results are deterministic):
//
// * flash_bwd_dkdv_kernel: one block per (KV tile of BK rows, KV head). It
//   loops over the query tiles that can see its tile (the forward's exact
//   live-pair test) and, for each, over the query heads of its GQA group,
//   accumulating dK and dV of its rows in registers.
// * flash_bwd_dq_kernel: one block per (query tile, query head); it loops
//   over the live KV tiles, accumulating dQ.
//
// Both recompute P = exp(S * scale - lse) from the forward's per-row lse
// (P = 0 outside the mask, so a fully masked row, lse = -inf, contributes
// nothing) and take Delta = rowsum(dO * O) per query row themselves:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - Delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// Bound: like the forward, operations (7 products of 2 Dh flops per live
// (query, key, head) triple against the forward's 2) at the training
// shapes. Tiles are float32 in shared memory (four [32][D + 1] tiles: 137 KB
// at D = 256) and the products run on float32 FMAs; 256 threads, 16 row
// groups (ty) x 16 columns (tx): a thread owns rows ty and ty + 16 and the
// columns tx + 16 j of its accumulators.
constexpr int NTB = 256;

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (size_t)(4 * 32 * (D + 1) + 2 * 32 * 33);
}

// Delta_r = sum_d dO[r, d] * O[r, d] for the BQ rows of a query tile: warp w
// takes rows 4w .. 4w + 3 (dO from shared memory, O from global memory).
template <typename T, int D, int LD>
__device__ __forceinline__ void row_delta(float* s_delta, const float* sdO, const T* o,
                                          size_t q0, int h, int Hq, int tid) {
  static_assert(NTB / 32 * 4 == BQ, "8 warps x 4 rows");
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    const T* orow = o + ((q0 + r) * Hq + h) * D;
    float a = 0.f;
    for (int d = lane; d < D; d += 32) a = fmaf(to_f(orow[d]), sdO[r * LD + d], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) s_delta[r] = a;
  }
}

// segment range of the live rows among BQ == BK == 32 rows (warp 0 only)
__device__ __forceinline__ void seg_range(int sg, int* s_rng, int tid) {
  int smin = sg >= 0 ? sg : INT_MAX, smax = sg >= 0 ? sg : INT_MIN;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
    smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
  }
  if (tid == 0) { s_rng[0] = smin; s_rng[1] = smax; }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTB)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ o,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const int* __restrict__ seg_q, const int* __restrict__ pos_q,
                      const int* __restrict__ seg_kv, const int* __restrict__ pos_kv,
                      T* __restrict__ dk, T* __restrict__ dv, int T_, int Hq, int Hkv,
                      int causal, int window, float scale) {
  constexpr int LD = D + 1, LP = BQ + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;        // [BK][BQ + 1]: P^T
  float* sdS = sP + BK * LP;        // [BK][BQ + 1]: dS^T
  __shared__ int s_segq[BQ], s_posq[BQ], s_segk[BK], s_posk[BK];
  __shared__ float s_lse[BQ], s_delta[BQ];
  __shared__ int s_rng[2];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hk = blockIdx.y, G = Hq / Hkv;
  const size_t k0 = (size_t)blockIdx.x * BK;
  const size_t kv_stride = (size_t)Hkv * D, q_stride = (size_t)Hq * D;

  load_tile<T, D, LD, NTB>(sK, k + k0 * kv_stride + (size_t)hk * D, kv_stride, BK, tid);
  load_tile<T, D, LD, NTB>(sV, v + k0 * kv_stride + (size_t)hk * D, kv_stride, BK, tid);
  if (tid < BK) {
    const int sg = seg_kv[k0 + tid];
    s_segk[tid] = sg;
    s_posk[tid] = pos_kv[k0 + tid];
    seg_range(sg, s_rng, tid);
  }
  __syncthreads();
  const int ksmin = s_rng[0], ksmax = s_rng[1];

  float dK[2][DJ], dV[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dK[i][j] = dV[i][j] = 0.f;

  const int n_q = T_ / BQ;
  if (ksmax >= 0) {                 // else: no live key row in this tile
    // the next query tile's metadata is prefetched one iteration ahead
    int nsg = 0, nps = 0;
    if (tid < BQ) { nsg = seg_q[tid]; nps = pos_q[tid]; }
    for (int qt = 0; qt < n_q; ++qt) {
      const int sg = nsg, ps = nps;
      if (tid < BQ && qt + 1 < n_q) {
        nsg = seg_q[(qt + 1) * BQ + tid];
        nps = pos_q[(qt + 1) * BQ + tid];
      }
      int live = 0;
      if (tid < BQ) {
        s_segq[tid] = sg;
        s_posq[tid] = ps;
        if (sg >= ksmin && sg <= ksmax)
          for (int c = 0; c < BK && !live; ++c)
            live = attends(sg, ps, s_segk[c], s_posk[c], causal, window);
      }
      if (!__syncthreads_or(live)) continue;   // no live pair: skip the tile
      const size_t q0 = (size_t)qt * BQ;
      for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        load_tile<T, D, LD, NTB>(sQ, q + q0 * q_stride + (size_t)h * D, q_stride, BQ, tid);
        load_tile<T, D, LD, NTB>(sdO, dout + q0 * q_stride + (size_t)h * D, q_stride, BQ,
                                 tid);
        if (tid < BQ) s_lse[tid] = lse[(size_t)h * T_ + q0 + tid];
        __syncthreads();
        row_delta<T, D, LD>(s_delta, sdO, o, q0, h, Hq, tid);
        // S^T and dP^T: key rows ty + 16 i, query columns tx + 16 j
        float st[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dpt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float ka = sK[ty * LD + d], kb = sK[(ty + 16) * LD + d];
          const float va = sV[ty * LD + d], vb = sV[(ty + 16) * LD + d];
          const float qa = sQ[tx * LD + d], qb = sQ[(tx + 16) * LD + d];
          const float oa = sdO[tx * LD + d], ob = sdO[(tx + 16) * LD + d];
          st[0][0] = fmaf(ka, qa, st[0][0]);
          st[0][1] = fmaf(ka, qb, st[0][1]);
          st[1][0] = fmaf(kb, qa, st[1][0]);
          st[1][1] = fmaf(kb, qb, st[1][1]);
          dpt[0][0] = fmaf(va, oa, dpt[0][0]);
          dpt[0][1] = fmaf(va, ob, dpt[0][1]);
          dpt[1][0] = fmaf(vb, oa, dpt[1][0]);
          dpt[1][1] = fmaf(vb, ob, dpt[1][1]);
        }
        __syncthreads();            // s_delta is written
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = ty + 16 * i, r = tx + 16 * j;
            const bool ok = attends(s_segq[r], s_posq[r], s_segk[c], s_posk[c], causal,
                                    window);
            const float p = ok ? expf(st[i][j] * scale - s_lse[r]) : 0.f;
            sP[c * LP + r] = p;
            sdS[c * LP + r] = p * (dpt[i][j] - s_delta[r]);
          }
        __syncthreads();
        for (int r = 0; r < BQ; ++r) {
          const float pa = sP[ty * LP + r], pb = sP[(ty + 16) * LP + r];
          const float ga = sdS[ty * LP + r], gb = sdS[(ty + 16) * LP + r];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            const float dov = sdO[r * LD + tx + 16 * j], qv = sQ[r * LD + tx + 16 * j];
            dV[0][j] = fmaf(pa, dov, dV[0][j]);
            dV[1][j] = fmaf(pb, dov, dV[1][j]);
            dK[0][j] = fmaf(ga, qv, dK[0][j]);
            dK[1][j] = fmaf(gb, qv, dK[1][j]);
          }
        }
        __syncthreads();            // sQ, sdO, sP, sdS, s_lse, s_delta rewritten next
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t base = ((k0 + ty + 16 * i) * Hkv + hk) * D + tx;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + 16 * j] = from_f<T>(dK[i][j] * scale);
      dv[base + 16 * j] = from_f<T>(dV[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTB)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const int* __restrict__ seg_q, const int* __restrict__ pos_q,
                    const int* __restrict__ seg_kv, const int* __restrict__ pos_kv,
                    T* __restrict__ dq, int T_, int S, int Hq, int Hkv, int causal,
                    int window, float scale) {
  constexpr int LD = D + 1, LP = BK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sdS = sV + BK * LD;        // [BQ][BK + 1]
  __shared__ int s_segq[BQ], s_posq[BQ], s_segk[BK], s_posk[BK];
  __shared__ float s_lse[BQ], s_delta[BQ];
  __shared__ int s_rng[2];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, hk = h / (Hq / Hkv);
  const size_t q0 = (size_t)blockIdx.x * BQ;
  const size_t kv_stride = (size_t)Hkv * D, q_stride = (size_t)Hq * D;

  load_tile<T, D, LD, NTB>(sQ, q + q0 * q_stride + (size_t)h * D, q_stride, BQ, tid);
  load_tile<T, D, LD, NTB>(sdO, dout + q0 * q_stride + (size_t)h * D, q_stride, BQ, tid);
  if (tid < BQ) {
    const int sg = seg_q[q0 + tid];
    s_segq[tid] = sg;
    s_posq[tid] = pos_q[q0 + tid];
    s_lse[tid] = lse[(size_t)h * T_ + q0 + tid];
    seg_range(sg, s_rng, tid);
  }
  __syncthreads();
  row_delta<T, D, LD>(s_delta, sdO, o, q0, h, Hq, tid);
  const int qsmin = s_rng[0], qsmax = s_rng[1];

  float dQ[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dQ[i][j] = 0.f;

  const int n_kv = S / BK;
  if (qsmax >= 0) {                 // else: no live query row in this tile
    int nsg = 0, nps = 0;
    if (tid < BK) { nsg = seg_kv[tid]; nps = pos_kv[tid]; }
    for (int kt = 0; kt < n_kv; ++kt) {
      const int sg = nsg, ps = nps;
      if (tid < BK && kt + 1 < n_kv) {
        nsg = seg_kv[(kt + 1) * BK + tid];
        nps = pos_kv[(kt + 1) * BK + tid];
      }
      int live = 0;
      if (tid < BK) {
        s_segk[tid] = sg;
        s_posk[tid] = ps;
        if (sg >= qsmin && sg <= qsmax)
          for (int r = 0; r < BQ && !live; ++r)
            live = attends(s_segq[r], s_posq[r], sg, ps, causal, window);
      }
      if (!__syncthreads_or(live)) continue;   // no live pair: skip the tile
      const size_t k0 = (size_t)kt * BK;
      load_tile<T, D, LD, NTB>(sK, k + k0 * kv_stride + (size_t)hk * D, kv_stride, BK, tid);
      load_tile<T, D, LD, NTB>(sV, v + k0 * kv_stride + (size_t)hk * D, kv_stride, BK, tid);
      __syncthreads();
      // S and dP: query rows ty + 16 i, key columns tx + 16 j
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qa = sQ[ty * LD + d], qb = sQ[(ty + 16) * LD + d];
        const float oa = sdO[ty * LD + d], ob = sdO[(ty + 16) * LD + d];
        const float ka = sK[tx * LD + d], kb = sK[(tx + 16) * LD + d];
        const float va = sV[tx * LD + d], vb = sV[(tx + 16) * LD + d];
        s[0][0] = fmaf(qa, ka, s[0][0]);
        s[0][1] = fmaf(qa, kb, s[0][1]);
        s[1][0] = fmaf(qb, ka, s[1][0]);
        s[1][1] = fmaf(qb, kb, s[1][1]);
        dp[0][0] = fmaf(oa, va, dp[0][0]);
        dp[0][1] = fmaf(oa, vb, dp[0][1]);
        dp[1][0] = fmaf(ob, va, dp[1][0]);
        dp[1][1] = fmaf(ob, vb, dp[1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const bool ok = attends(s_segq[r], s_posq[r], s_segk[c], s_posk[c], causal,
                                  window);
          const float p = ok ? expf(s[i][j] * scale - s_lse[r]) : 0.f;
          sdS[r * LP + c] = p * (dp[i][j] - s_delta[r]);
        }
      __syncthreads();
      for (int c = 0; c < BK; ++c) {
        const float ga = sdS[ty * LP + c], gb = sdS[(ty + 16) * LP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float kv = sK[c * LD + tx + 16 * j];
          dQ[0][j] = fmaf(ga, kv, dQ[0][j]);
          dQ[1][j] = fmaf(gb, kv, dQ[1][j]);
        }
      }
      __syncthreads();              // sK, sV, sdS, s_segk rewritten next tile
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t base = ((q0 + ty + 16 * i) * Hq + h) * D + tx;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[base + 16 * j] = from_f<T>(dQ[i][j] * scale);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg_q,
               const void* pos_q, const void* seg_kv, const void* pos_kv, void* out,
               void* ws_ml, void* ws_acc, void* lse, int T_, int S, int Hq, int Hkv,
               int causal, int window, float scale, int n_split, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(T_ / BQ, Hq, n_split);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg_q, (const int*)pos_q,
      (const int*)seg_kv, (const int*)pos_kv, (T*)out, (float2*)ws_ml,
      (float*)ws_acc, (float*)lse, T_, S, Hq, Hkv, causal, window, scale, n_split);
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

template <typename T, int D>
int launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, const void* seg_q, const void* pos_q,
                    const void* seg_kv, const void* pos_kv, void* dk, void* dv, int T_,
                    int S, int Hq, int Hkv, int causal, int window, float scale,
                    cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(S / BK, Hkv);
  flash_bwd_dkdv_kernel<T, D><<<grid, NTB, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      (const float*)lse, (const int*)seg_q, (const int*)pos_q, (const int*)seg_kv,
      (const int*)pos_kv, (T*)dk, (T*)dv, T_, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, const void* seg_q, const void* pos_q,
                  const void* seg_kv, const void* pos_kv, void* dq, int T_, int S, int Hq,
                  int Hkv, int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(T_ / BQ, Hq);
  flash_bwd_dq_kernel<T, D><<<grid, NTB, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      (const float*)lse, (const int*)seg_q, (const int*)pos_q, (const int*)seg_kv,
      (const int*)pos_kv, (T*)dq, T_, S, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tile sizes the caller must pad T and S to (seg = -2 on pad rows),
// and the largest KV split.
int flash_attention_block_q() { return BQ; }
int flash_attention_block_kv() { return BK; }
int flash_attention_max_split() { return MAX_SPLIT; }

#define FA_DISPATCH(CASE)                                  \
  if (dtype == 0) {                                        \
    if (D == 64) CASE(float, 64);                          \
    if (D == 128) CASE(float, 128);                        \
    if (D == 256) CASE(float, 256);                        \
  } else if (dtype == 1) {                                 \
    if (D == 64) CASE(__nv_bfloat16, 64);                  \
    if (D == 128) CASE(__nv_bfloat16, 128);                \
    if (D == 256) CASE(__nv_bfloat16, 256);                \
  }                                                        \
  return (int)cudaErrorInvalidValue

// The split pass. dtype: 0 = float32, 1 = bfloat16. With n_split == 1 it
// writes ``out`` (and, if ``lse`` is not null, the rows' log-sum-exp into
// lse [Hq, T] float32); with n_split > 1 it writes only the partial states:
// ws_ml must hold n_split * T * Hq float2 (m, l) and ws_acc n_split * T * Hq
// * D floats (uninitialised is fine; acc is written only where l > 0), and
// flash_attention_combine merges them into ``out`` (and ``lse``). Returns a
// cudaError_t code (0 = ok); cudaErrorInvalidValue for a shape or dtype
// this library does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* seg_q, const void* pos_q, const void* seg_kv,
                        const void* pos_kv, void* out, void* ws_ml, void* ws_acc,
                        void* lse, int T, int S, int Hq, int Hkv, int D, int dtype,
                        int causal, int window, float scale, int n_split,
                        void* stream) {
  if (T <= 0 || S <= 0 || T % BQ || S % BK || Hkv <= 0 || Hq % Hkv ||
      n_split < 1 || n_split > MAX_SPLIT ||
      (n_split > 1 && (ws_ml == nullptr || ws_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_CASE(TYPE, DIM)                                                          \
  return launch_fwd<TYPE, DIM>(q, k, v, seg_q, pos_q, seg_kv, pos_kv, out, ws_ml,    \
                               ws_acc, lse, T, S, Hq, Hkv, causal, window, scale,    \
                               n_split, st)
  FA_DISPATCH(FA_CASE);
#undef FA_CASE
}

// The merge pass: out [T, Hq, D] (dtype as above) and, if ``lse`` is not
// null, lse [Hq, T] from the n_split partial states that flash_attention_fwd
// wrote. Returns a cudaError_t code.
int flash_attention_combine(const void* ws_ml, const void* ws_acc, void* out, void* lse,
                            int T, int Hq, int D, int dtype, int n_split, void* stream) {
  if (T <= 0 || Hq <= 0 || n_split < 2 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FC_CASE(TYPE, DIM) \
  return launch_combine<TYPE, DIM>(ws_ml, ws_acc, out, lse, T, Hq, n_split, st)
  FA_DISPATCH(FC_CASE);
#undef FC_CASE
}

// Backward, dK/dV pass: dk, dv [S, Hkv, D] from q, o, dout [T, Hq, D],
// k, v [S, Hkv, D] and the forward's lse [Hq, T] (all contiguous, T and S
// padded as for the forward). Returns a cudaError_t code.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, const void* seg_q,
                             const void* pos_q, const void* seg_kv, const void* pos_kv,
                             void* dk, void* dv, int T, int S, int Hq, int Hkv, int D,
                             int dtype, int causal, int window, float scale,
                             void* stream) {
  if (T <= 0 || S <= 0 || T % BQ || S % BK || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FB_CASE(TYPE, DIM)                                                             \
  return launch_bwd_dkdv<TYPE, DIM>(q, k, v, o, dout, lse, seg_q, pos_q, seg_kv, pos_kv, \
                                    dk, dv, T, S, Hq, Hkv, causal, window, scale, st)
  FA_DISPATCH(FB_CASE);
#undef FB_CASE
}

// Backward, dQ pass: dq [T, Hq, D] from the same inputs. Returns a
// cudaError_t code.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, const void* seg_q,
                           const void* pos_q, const void* seg_kv, const void* pos_kv,
                           void* dq, int T, int S, int Hq, int Hkv, int D, int dtype,
                           int causal, int window, float scale, void* stream) {
  if (T <= 0 || S <= 0 || T % BQ || S % BK || Hkv <= 0 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FQ_CASE(TYPE, DIM)                                                             \
  return launch_bwd_dq<TYPE, DIM>(q, k, v, o, dout, lse, seg_q, pos_q, seg_kv, pos_kv,   \
                                  dq, T, S, Hq, Hkv, causal, window, scale, st)
  FA_DISPATCH(FQ_CASE);
#undef FQ_CASE
}

#undef FA_DISPATCH

}  // extern "C"
